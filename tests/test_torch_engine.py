"""Port parity and packaging: the engine end to end.

(a) The port's `SlamEngine(device="cpu")` against the reference's
    `SlamEngine` (host preprocessing) over six synthetic frames of a small
    config where matching engages, with the reference's RANSAC draws
    injected.
    Per step: before each sweep the port's engine takes the reference
    engine's state (`convert.state_from_numpy`) and that frame's reference
    features, so range image, preprocess, bucketing, map growth, matching,
    RANSAC, gate, ICP, insert and the packed row are held as in
    tests/test_torch_pipeline.py: integer fields exact, poses within 1 mm
    and 1e-4 rad.
    Free-running: each engine keeps its own state and computes its own
    features.  The feature stages agree bit for bit except where the
    reference's compiled eigen-solves round differently (see
    tests/test_torch_features.py), which moves a few keypoints' B-SHOTs
    and, through them, a few matches.  Measured: counts within 3, map sizes
    within 1, poses within 0.37 mm, ATE 133.58 vs 133.62 mm.  Held: counts
    within 5, poses within 2 mm and 1e-4 rad, ATE within 5 mm.
(b) Every module of the port imports, and one CPU step runs, with `jax`
    and `bshot_slam_tpu` made unimportable; so do the pipelined engine with
    the backend (keyframes, loop closure, pose graph, corrections) and a
    bundle adjustment over its keyframes.
(c) `SlamEngine()` without a device raises when no card is visible; the
    two modes not ported yet (fused device preprocess, meshes) raise
    NotImplementedError.
(d) Importing the port builds nothing and creates no build directory.
"""

import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bshot_slam_tpu.config as jc
import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu.io import synthetic
from bshot_slam_tpu.odometry import pipeline as jpipe
from bshot_slam_tpu.odometry.engine import SlamEngine as JaxEngine
from bshot_slam_tpu.utils.metrics import ate_rmse
from bshot_slam_tpu_torch.convert import state_from_numpy
from bshot_slam_tpu_torch.odometry import engine as tengine
from bshot_slam_tpu_torch.odometry import pipeline as tpipe

ROOT = pathlib.Path(__file__).resolve().parents[1]


def small_cfg(m):
    return m.SlamConfig(
        sensor=m.SensorConfig(n_azimuth=512),
        preprocess=m.PreprocessConfig(max_points=8192),
        keypoints=m.KeypointConfig(top_k=192),
        descriptor=m.DescriptorConfig(max_neighbors=96),
        match=m.MatchConfig(ransac_iterations=512),
        map=m.MapConfig(capacity=8192),
    )


def _torch_features(f) -> tpipe.FrameFeatures:
    return tpipe.FrameFeatures(*[
        torch.tensor(np.asarray(x).view(np.int32) if x.dtype == np.uint32
                     else np.asarray(x)) for x in f])


def _state_dict(st) -> dict:
    d = {f"map.{f}": np.array(getattr(st.map, f)) for f in st.map._fields}
    d.update({f"ref.{f}": np.array(getattr(st.ref, f)) for f in st.ref._fields})
    d["ref_pose"] = np.array(st.ref_pose)
    d["frame_idx"] = np.array(st.frame_idx)
    return d


@pytest.fixture(scope="module")
def engines():
    """The reference engine's run, recording per step its input state, its
    RANSAC draws and its features; the port's engine run per step from
    those, and free-running."""
    cfg, tcfg = small_cfg(jc), small_cfg(tc)
    sweeps, gt = synthetic.render_sequence(6, cfg.sensor, step_mm=300.0,
                                           noise_mm=10.0, seed=11, n_firings=512)
    states, draws, feats = [], [], []
    step = jpipe.odometry_step_compact

    def recording_step(state, points, n_valid, key, *args, **kw):
        states.append(_state_dict(state))  # before the step donates it
        draws.append(np.asarray(jax.random.uniform(
            key, (cfg.match.ransac_iterations, 3))))
        state, diag = step(state, points, n_valid, key, *args, **kw)
        feats.append(_torch_features(diag.features))
        return state, diag

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "odometry_step_compact", recording_step)
        je = JaxEngine(cfg, seed=0, tile=1024)
        for sw in sweeps:
            je.process_sweep(sw)

    stepped = tengine.SlamEngine(tcfg, seed=0, tile=1024, device="cpu",
                                 draws=draws)
    with pytest.MonkeyPatch.context() as mp:
        frame = iter(feats)
        mp.setattr(tpipe, "compute_features", lambda *a, **k: next(frame))
        for st, sw in zip(states, sweeps):
            stepped.state = state_from_numpy(st, device="cpu")
            stepped.process_sweep(sw)

    free = tengine.SlamEngine(tcfg, seed=0, tile=1024, device="cpu", draws=draws)
    for sw in sweeps:
        free.process_sweep(sw)
    gt_pos = (np.linalg.inv(gt[0])[None] @ gt)[:, :3, 3]
    return je, stepped, free, gt_pos


def _pose_close(a, b, mm):
    assert np.abs(a.pose[:3, 3] - b.pose[:3, 3]).max() <= mm
    assert np.abs(a.pose[:3, :3] - b.pose[:3, :3]).max() <= 1e-4


def test_engine_step_exact(engines):
    je, stepped, _, _ = engines
    assert len(stepped.records) == len(je.records) == 6
    for i, (a, b) in enumerate(zip(je.records, stepped.records)):
        got = (b.n_mutual, b.n_inliers, b.gated, b.map_size, b.n_dropped)
        assert got == (a.n_mutual, a.n_inliers, a.gated, a.map_size,
                       a.n_dropped), f"frame {i}"
        _pose_close(a, b, 1.0)
    assert min(r.n_inliers for r in je.records[1:]) >= 15


def test_engine_matches_reference(engines):
    je, _, te, gt_pos = engines
    assert len(te.records) == len(je.records) == 6
    for a, b in zip(je.records, te.records):
        assert abs(a.n_mutual - b.n_mutual) <= 5
        assert abs(a.n_inliers - b.n_inliers) <= 5
        assert abs(a.map_size - b.map_size) <= 5
        assert a.gated == b.gated
        _pose_close(a, b, 2.0)
    assert min(r.n_inliers for r in te.records[1:]) >= 15
    ate_j = ate_rmse(je.trajectory, gt_pos, align=False)
    ate_t = ate_rmse(te.trajectory, gt_pos, align=False)
    assert abs(ate_j - ate_t) <= 5.0
    np.testing.assert_allclose(te.poses[0], np.eye(4), atol=1e-6)


_STANDALONE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["bshot_slam_tpu"] = None
import numpy as np, torch
import bshot_slam_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from bshot_slam_tpu_torch import tiny_config
from bshot_slam_tpu_torch.io import synthetic
from bshot_slam_tpu_torch.odometry.engine import SlamEngine
cfg = tiny_config()
sweeps, _ = synthetic.render_sequence(1, cfg.sensor, seed=3,
                                      n_firings=cfg.sensor.n_azimuth)
rec = SlamEngine(cfg, device="cpu", tile=256).process_sweep(sweeps[0])
assert rec.map_size > 0 and np.allclose(rec.pose, np.eye(4))
from bshot_slam_tpu_torch.backend.ba import ba_solve
eng = SlamEngine(cfg, device="cpu", tile=256, pipelined=True, fetch_every=2,
                 enable_backend=True, keep_corr=True)
for sw in sweeps + sweeps:
    eng.process_sweep(sw)
assert eng.flush() is not None and len(eng.records) == 2
poses, edges = eng.optimize_backend()
assert poses.shape[1:] == (4, 4) and "n_landmarks_moved" in eng.apply_backend_corrections()
ba_solve(eng.build_ba_problem(), gn_iterations=1, cg_iterations=2)
assert "jax" not in {k for k, v in sys.modules.items() if v is not None}
print("ok")
"""


def test_port_runs_without_jax():
    out = subprocess.run([sys.executable, "-c", _STANDALONE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.SlamEngine(tc.tiny_config())
    with pytest.raises(NotImplementedError):
        tengine.SlamEngine(tc.tiny_config(), device="cpu", host_preprocess=False)
    with pytest.raises(NotImplementedError):
        tengine.SlamEngine(tc.tiny_config(), device="cpu", mesh=object())


_NO_BUILD = r"""
import importlib, pkgutil, subprocess, sys
def refuse(*a, **k):
    raise AssertionError("a subprocess was started while importing")
subprocess.Popen = subprocess.run = refuse
import bshot_slam_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from bshot_slam_tpu_torch.kernels import _build
assert not _build._LIBS
print(_build.BUILD_DIR)
"""


def test_import_builds_nothing():
    build = ROOT / "build" / "kernels"
    before = sorted(build.iterdir()) if build.exists() else None
    out = subprocess.run([sys.executable, "-c", _NO_BUILD], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert pathlib.Path(out.stdout.strip()) == build
    after = sorted(build.iterdir()) if build.exists() else None
    assert after == before
