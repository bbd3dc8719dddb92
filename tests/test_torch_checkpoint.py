"""The port's checkpoints against the reference's, on the CPU.

(a) Files the reference (`bshot_slam_tpu.checkpoint`) writes load into the
    port equal field by field: the odometry state and pose history, the
    keyframe store, the loop edges, the keyframe-policy counters and the
    host mirrors; the port's generator stays as seeded (a reference file
    holds a JAX key, which cannot drive it).
(b) Files the port writes load in the reference equal field by field, its
    key being `jax.random.PRNGKey(seed)`.
(c) A format-1 state file loads with frame_born -1 and n_dropped 0; unknown
    versions raise; no backend file leaves the engine untouched; a random
    state saved on one device type does not load on another.
(d) A port run saved after 3 of 8 frames (right after a backend pass) and
    resumed in a fresh engine gives records, keyframe store, state and loop
    edges bit-identical to the uninterrupted run, whose second pass re-anchors
    landmarks born before the resume; synchronous and pipelined.

The states come from a short run of the port's engine on the tiny config
with the backend; the reference writes and reads them as numpy arrays
(its checkpoint module converts through `jnp.asarray` only).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bshot_slam_tpu.checkpoint as jck
import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu.backend.keyframes import KeyframeStore as JKeyframeStore
from bshot_slam_tpu.backend.loop_closure import LoopEdge as JLoopEdge
from bshot_slam_tpu.odometry.mapstore import MapState as JMapState
from bshot_slam_tpu.odometry.pipeline import FrameFeatures as JFrameFeatures
from bshot_slam_tpu.odometry.pipeline import OdometryState as JOdometryState
from bshot_slam_tpu_torch import checkpoint, convert
from bshot_slam_tpu_torch.backend.loop_closure import LoopEdge
from bshot_slam_tpu_torch.io import synthetic
from bshot_slam_tpu_torch.odometry.engine import SlamEngine


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other engine test files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = tc.tiny_config()
    return dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, keyframe_every=1, lc_min_gap=2, lc_max_dist_mm=8000.0,
        lc_min_inliers=3))  # low enough that the tiny drive verifies closures


def _drive(n=8):
    cfg = _cfg()
    sweeps, _ = synthetic.render_sequence(n, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                          seed=4, yaw_rate_rad=2 * np.pi / n,
                                          n_firings=cfg.sensor.n_azimuth)
    return sweeps


def _engine(seed=0, **kw):
    cfg = _cfg()
    return SlamEngine(cfg, seed=seed, tile=cfg.runtime.point_tile, device="cpu",
                      enable_backend=True, **kw)


EDGE = dict(kf_i=2, kf_j=0, n_inliers=42, rmse_mm=87.5)


@pytest.fixture(scope="module")
def ran():
    """A port engine after 3 frames, with one verified loop edge added."""
    eng = _engine(seed=7)
    for sw in _drive()[:3]:
        eng.process_sweep(sw)
    z = np.eye(4, dtype=np.float32)
    z[:3, 3] = [100.0, -50.0, 10.0]
    eng.loop_edges = [LoopEdge(z=z, **EDGE)]
    return eng


def _state_fields(d):
    """convert's state dict under the file's names."""
    return {k.replace(".", "_"): v for k, v in d.items()}


def _jax_state(d):
    a = {k: jnp.asarray(v) for k, v in d.items()}
    return JOdometryState(
        map=JMapState(*[a[f"map.{f}"] for f in JMapState._fields]),
        ref=JFrameFeatures(*[a[f"ref.{f}"] for f in JFrameFeatures._fields]),
        ref_pose=a["ref_pose"], frame_idx=a["frame_idx"])


def _edges(edges):
    return [(e.kf_i, e.kf_j, e.n_inliers, float(e.rmse_mm), np.asarray(e.z).tobytes())
            for e in edges]


def test_port_reads_reference_files(tmp_path, ran):
    d = convert.state_to_numpy(ran.state)
    kf = convert.keyframes_to_numpy(ran.keyframes)
    assert d["map.descriptors"].dtype == np.uint32 and int(kf["count"]) == 3
    # The reference's save_backend reads these engine attributes.
    jeng = types.SimpleNamespace(
        keyframes=JKeyframeStore(*[jnp.asarray(kf[f]) for f in JKeyframeStore._fields]),
        loop_edges=[JLoopEdge(**e._asdict()) for e in ran.loop_edges],
        _last_kf_pose=ran._last_kf_pose, _frames_since_kf=ran._frames_since_kf,
        key=jax.random.PRNGKey(123))
    ck = str(tmp_path / "ref")
    jck.save_state(ck, _jax_state(d), ran.poses)
    jck.save_backend(ck, jeng)

    eng = _engine(seed=7)
    eng.state, poses = checkpoint.load_state(ck, device="cpu")
    assert checkpoint.load_backend(ck, eng)
    got = convert.state_to_numpy(eng.state)
    for k in d:
        assert got[k].dtype == d[k].dtype, k
        np.testing.assert_array_equal(got[k], d[k], err_msg=k)
    np.testing.assert_array_equal(poses, ran.poses)
    got_kf = convert.keyframes_to_numpy(eng.keyframes)
    for k in kf:
        np.testing.assert_array_equal(got_kf[k], kf[k], err_msg=k)
    assert _edges(eng.loop_edges) == _edges(ran.loop_edges)
    np.testing.assert_array_equal(eng._last_kf_pose, ran._last_kf_pose)
    assert eng._frames_since_kf == ran._frames_since_kf
    assert eng._kf_count == ran._kf_count == 3
    np.testing.assert_array_equal(np.stack(eng._kf_positions), np.stack(ran._kf_positions))
    seeded = torch.Generator().manual_seed(7).get_state()
    assert torch.equal(eng.generator.get_state(), seeded)


def test_reference_reads_port_files(tmp_path, ran):
    ck = str(tmp_path / "port")
    checkpoint.save_state(ck, ran.state, ran.poses)
    checkpoint.save_backend(ck, ran)
    st, poses = jck.load_state(ck)
    want = _state_fields(convert.state_to_numpy(ran.state))
    got = {f"map_{f}": np.asarray(getattr(st.map, f)) for f in st.map._fields}
    got.update({f"ref_{f}": np.asarray(getattr(st.ref, f)) for f in st.ref._fields})
    got.update(ref_pose=np.asarray(st.ref_pose), frame_idx=np.asarray(st.frame_idx))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_array_equal(poses, ran.poses)
    jeng = types.SimpleNamespace()
    assert jck.load_backend(ck, jeng)
    kf = convert.keyframes_to_numpy(ran.keyframes)
    for f in JKeyframeStore._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jeng.keyframes, f)), kf[f],
                                      err_msg=f)
    assert _edges(jeng.loop_edges) == _edges(ran.loop_edges)
    np.testing.assert_array_equal(np.asarray(jeng.key), np.asarray(jax.random.PRNGKey(7)))
    assert jeng._kf_count == ran._kf_count
    assert jeng._frames_since_kf == ran._frames_since_kf


def test_format_1_and_unknown_versions(tmp_path, ran):
    d = _state_fields(convert.state_to_numpy(ran.state))
    v1 = {k: v for k, v in d.items() if k not in ("map_frame_born", "map_n_dropped")}
    (tmp_path / "v1").mkdir()
    np.savez_compressed(tmp_path / "v1" / "slam_state.npz", version=1, poses=ran.poses, **v1)
    st, _ = checkpoint.load_state(str(tmp_path / "v1"), device="cpu")
    assert (st.map.frame_born == -1).all() and int(st.map.n_dropped) == 0
    got = _state_fields(convert.state_to_numpy(st))
    for k in v1:
        np.testing.assert_array_equal(got[k], v1[k], err_msg=k)
    (tmp_path / "v3").mkdir()
    np.savez_compressed(tmp_path / "v3" / "slam_state.npz", version=3, poses=ran.poses, **d)
    np.savez_compressed(tmp_path / "v3" / "backend_state.npz", version=2)
    with pytest.raises(ValueError, match="version 3"):
        checkpoint.load_state(str(tmp_path / "v3"), device="cpu")
    eng = _engine()
    with pytest.raises(ValueError, match="backend checkpoint version"):
        checkpoint.load_backend(str(tmp_path / "v3"), eng)
    assert not checkpoint.load_backend(str(tmp_path / "v1"), eng)
    assert eng._kf_count == 0 and not eng.loop_edges


def test_random_state_stays_on_its_device_type(tmp_path, ran):
    ck = tmp_path / "ck"
    checkpoint.save_backend(str(ck), ran)
    with np.load(ck / "backend_state.npz") as z:
        fields = dict(z)
    fields["torch_rng_device"] = np.asarray("cuda")
    np.savez_compressed(ck / "backend_state.npz", **fields)
    eng = _engine()
    with pytest.raises(ValueError, match="saved by a cuda engine"):
        checkpoint.load_backend(str(ck), eng)
    assert eng._kf_count == 0


@pytest.mark.parametrize("pipelined", [False, True])
def test_resume_is_bit_identical(tmp_path, pipelined):
    sweeps = _drive()
    kw = dict(backend_every=3, pipelined=pipelined, fetch_every=2)
    full = _engine(**kw)
    half = _engine(**kw)
    ck = str(tmp_path / "ck")
    for i, sw in enumerate(sweeps):
        full.process_sweep(sw)
        if i < 3:
            half.process_sweep(sw)
    full.flush()
    assert not half._pending  # the pass at frame 3 drained it
    checkpoint.save_state(ck, half.state, half.poses)
    checkpoint.save_backend(ck, half)

    res = _engine(**kw)
    res.state, prior = checkpoint.load_state(ck, device="cpu")
    res._place_state()
    assert checkpoint.load_backend(ck, res)
    assert prior.shape == (3, 4, 4)
    for sw in sweeps[3:]:
        res.process_sweep(sw)
    res.flush()

    assert full.loop_edges  # the last pass verified closures
    assert len(res.records) == 5
    for i, (a, b) in enumerate(zip(res.records, full.records[3:])):
        np.testing.assert_array_equal(a.pose, b.pose, err_msg=f"frame {i + 3}")
        assert (a.n_inliers, a.n_mutual, a.gated, a.map_size, a.icp_rmse) == \
            (b.n_inliers, b.n_mutual, b.gated, b.map_size, b.icp_rmse)
        np.testing.assert_array_equal(a.corr_stats, b.corr_stats)
    for to_numpy, what in ((convert.keyframes_to_numpy, "keyframes"),
                           (convert.state_to_numpy, "state")):
        got, want = to_numpy(getattr(res, what)), to_numpy(getattr(full, what))
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{what} {k}")
    assert _edges(res.loop_edges) == _edges(full.loop_edges)
    assert torch.equal(res.generator.get_state(), full.generator.get_state())
    assert _edges(res.optimize_backend()[1]) == _edges(full.optimize_backend()[1])
