"""Port parity: the engine with the device preprocess (`host_preprocess=False`).

(a) The port's synchronous fused engine against the reference's
    (`SlamEngine(host_preprocess=False)`, synchronous) over five frames of
    the tiny config, with the reference's RANSAC draws injected.  Held as
    in tests/test_torch_engine.py: counts within 5, poses within 2 mm and
    1e-4 rad (the feature stage's floats part from the reference's at its
    compiled eigen-solves, tests/test_torch_features.py).
(b) The pipelined fused engine against the synchronous fused engine, bit
    for bit, through a bucket overflow: a port of tests/test_odometry_e2e.py's
    `_overflow_sequence`, whose kept-point count spikes where the predictor
    cannot foresee it, so the frame aborts on the device and is re-run at
    its exact bucket, and the frames after it run at a predicted bucket
    above their exact one; and through a window overflow (a 256-row window
    over a prefilled map).
(c) `odometry_step_fused` on a cloud that overflows its bucket: every state
    field passes through, and the packed tail carries the real count, the
    bucket and committed = 0; with room, it commits what the deferred step
    commits on the same cloud.
(d) The fused engine against the host-preprocess engine, whose clouds
    differ by trig rounding (< 0.05 mm): counts within 2, poses within 1 mm
    (measured: counts equal, poses within 0.21 mm).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bshot_slam_tpu.config as jc
import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu.odometry import pipeline as jpipe
from bshot_slam_tpu.odometry.engine import SlamEngine as JaxEngine
from bshot_slam_tpu_torch import convert
from bshot_slam_tpu_torch.io import synthetic
from bshot_slam_tpu_torch.odometry import pipeline as tpipe
from bshot_slam_tpu_torch.odometry.engine import SlamEngine
from tests.test_torch_engine_modes import _prefilled, _same_records, _windowed
from tests.torch_kernel_cases import overflow_sequence

N_FRAMES = 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other engine test files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tile(cfg):
    return cfg.runtime.point_tile


@pytest.fixture(scope="module")
def sweeps():
    cfg = tc.tiny_config()
    sw, _ = synthetic.render_sequence(N_FRAMES, cfg.sensor, step_mm=300.0,
                                      noise_mm=10.0, seed=11,
                                      n_firings=cfg.sensor.n_azimuth)
    return sw


@pytest.fixture(scope="module")
def fused_sync(sweeps):
    """The reference's synchronous fused run (recording each step's RANSAC
    draws) and the port's with those draws."""
    jcfg, tcfg = jc.tiny_config(), tc.tiny_config()
    draws = []
    step = jpipe.odometry_step

    def recording_step(state, points, pmask, key, *args, **kw):
        draws.append(np.asarray(jax.random.uniform(
            key, (jcfg.match.ransac_iterations, 3))))
        return step(state, points, pmask, key, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "odometry_step", recording_step)
        je = JaxEngine(jcfg, seed=0, tile=_tile(jcfg), host_preprocess=False)
        for sw in sweeps:
            je.process_sweep(sw)
    te = SlamEngine(tcfg, seed=0, tile=_tile(tcfg), device="cpu", draws=draws,
                    host_preprocess=False)
    for sw in sweeps:
        te.process_sweep(sw)
    return je, te


def test_fused_engine_matches_reference(fused_sync):
    je, te = fused_sync
    assert len(te.records) == len(je.records) == N_FRAMES
    for a, b in zip(je.records, te.records):
        assert abs(a.n_mutual - b.n_mutual) <= 5
        assert abs(a.n_inliers - b.n_inliers) <= 5
        assert abs(a.map_size - b.map_size) <= 5
        assert a.gated == b.gated
        assert np.abs(a.pose[:3, 3] - b.pose[:3, 3]).max() <= 2.0
        assert np.abs(a.pose[:3, :3] - b.pose[:3, :3]).max() <= 1e-4
    assert max(r.n_inliers for r in te.records) >= 4  # matching engages
    np.testing.assert_allclose(te.poses[0], np.eye(4), atol=1e-6)


def test_fused_engine_matches_host_engine(sweeps):
    cfg = tc.tiny_config()
    host = SlamEngine(cfg, seed=0, tile=_tile(cfg), device="cpu")
    fused = SlamEngine(cfg, seed=0, tile=_tile(cfg), device="cpu",
                       host_preprocess=False)
    for sw in sweeps:
        host.process_sweep(sw)
        fused.process_sweep(sw)
    for a, b in zip(host.records, fused.records):
        for x, y in ((a.n_mutual, b.n_mutual), (a.n_inliers, b.n_inliers),
                     (a.map_size, b.map_size)):
            assert abs(x - y) <= 2
        assert np.abs(a.pose - b.pose).max() <= 1.0


def _bucketed():
    cfg = tc.tiny_config()
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, cloud_buckets=(512, 1024, 2048)))


def test_pipelined_fused_bucket_overflow_is_bit_identical(monkeypatch):
    cfg = _bucketed()
    buckets = []
    fused = tpipe.odometry_step_fused

    def recording(*args):
        buckets.append(args[7])
        return fused(*args)

    monkeypatch.setattr(tpipe, "odometry_step_fused", recording)
    frames = overflow_sequence(cfg, base=400, spike=1200)
    vert = np.deg2rad(np.sort(np.array(cfg.sensor.vertical_angles_deg))).astype(np.float32)
    runs = []
    for pipelined in (False, True):
        eng = SlamEngine(cfg, seed=0, tile=_tile(cfg), device="cpu",
                         host_preprocess=False, pipelined=pipelined, fetch_every=4)
        for r, az in frames:
            eng.process_range_image(r, az, vert)
        eng.flush()
        runs.append(eng)
    sync, pipe = runs
    assert pipe.n_redispatched > 0, "the spike did not overflow its bucket"
    # The spike aborted at 512; the frame after the re-runs ran at 2048,
    # four times its exact bucket, as the spike's decaying floor predicts.
    assert buckets == [512] * 5 + [2048]
    _same_records(pipe.records, sync.records)
    assert [r.map_size for r in sync.records][-1] > 0


def test_pipelined_fused_window_overflow_is_bit_identical():
    cfg = _windowed(tc)
    sw, _ = synthetic.render_sequence(6, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                      seed=0, n_firings=cfg.sensor.n_azimuth)
    runs = []
    for pipelined in (False, True):
        eng = SlamEngine(cfg, seed=0, device="cpu", tile=_tile(cfg),
                         pipelined=pipelined, fetch_every=3, host_preprocess=False)
        d = convert.state_to_numpy(eng.state)
        eng.state = convert.state_from_numpy(
            _prefilled(d, np.random.default_rng(3), 200, 300, cfg), device="cpu")
        for s in sw:
            eng.process_sweep(s)
        eng.flush()
        runs.append(eng)
    sync, pipe = runs
    assert pipe.n_redispatched > 0  # a window overflowed and was re-run
    _same_records(pipe.records, sync.records)


def _image(cfg, sweep):
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image

    ri = build_range_image(sweep, cfg.sensor)
    return torch.tensor(np.stack([ri.range_mm, ri.azimuth_rad])), torch.tensor(ri.vert_rad)


def test_fused_step_aborts_on_bucket_overflow(sweeps):
    cfg = tc.tiny_config()
    state = tpipe.init_state(cfg, device="cpu")
    range_az, vert = _image(cfg, sweeps[0])
    draws = torch.rand((cfg.match.ransac_iterations, 3),
                       generator=torch.Generator().manual_seed(0))
    ok = torch.ones((), dtype=torch.bool)
    pcfg = cfg.preprocess
    _, _, nv = tpipe.ingest(range_az[0], range_az[1], vert, None, pcfg, pcfg.max_points)
    nv = int(nv)
    bucket = 256
    assert nv > bucket
    new, committed, diag = tpipe.odometry_step_fused(
        state, ok, range_az, vert, None, pcfg, cfg, bucket, draws, _tile(cfg))
    assert not bool(committed)
    for a, b in zip(convert.state_to_numpy(new).values(),
                    convert.state_to_numpy(state).values()):
        np.testing.assert_array_equal(a, b)
    tail = diag.packed[tpipe.IDX_N_VALID:].numpy()
    np.testing.assert_array_equal(tail, [nv, bucket, 0.0])

    # With room it commits the deferred step's result on the same cloud.
    new, committed, diag = tpipe.odometry_step_fused(
        state, ok, range_az, vert, None, pcfg, cfg, pcfg.max_points, draws, _tile(cfg))
    pts, pmask, n_valid = tpipe.ingest(range_az[0], range_az[1], vert, None, pcfg,
                                       pcfg.max_points)
    want, want_c, want_diag = tpipe.odometry_step_deferred(
        state, ok, pts, pmask, n_valid, draws, cfg, _tile(cfg))
    assert bool(committed) and bool(want_c)
    torch.testing.assert_close(diag.packed, want_diag.packed, rtol=0, atol=0)
    assert int(new.frame_idx) == 1
