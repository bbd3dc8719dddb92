"""Port parity: the device preprocess (`ops.preprocess`) against the reference.

On the CPU, where the ground walk runs kernel F's plain version:
(a) `preprocess` classes and `valid` cell-exact, and points within 0.05 mm,
    on rendered sweeps (two frames of a 512-bin drive, a frame of the
    adversarial scene with self-car returns), a random image with dropouts
    and extreme ranges, and tests/test_preprocess.py's flat-ground and wall
    scenes;
(b) `_ground_scan` (the plain walk) equal to the reference's from the same
    points, on every kernel F case of tests/torch_kernel_cases.py (lost
    returns, columns without a return, the self-car box, curbs after which
    the ground restarts); `_occlusion_pass` equal on the reference's
    classes;
(c) `extract_cloud`: the same count, order and zero padding, with and
    without a select list, with `save_sel=False`, and with `max_points`
    below the kept count and above the cell count; points within 0.05 mm;
(d) the fused ingest (`pipeline.ingest`) against the engine's native host
    ingest (`host_cloud`): the same count, the same points in the same
    order within 0.05 mm, at the same bucket.
The 0.05 mm covers float32 trig that rounds differently in XLA, PyTorch and
the C library (one ulp of a coordinate is <= 0.004 mm at 40 m).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bshot_slam_tpu.config as jc
import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu.io import synthetic as jsynthetic
from bshot_slam_tpu.ops import preprocess as jpp
from bshot_slam_tpu.ops.rangeimage import build_range_image as j_range_image
from bshot_slam_tpu_torch.io import synthetic
from bshot_slam_tpu_torch.odometry import pipeline
from bshot_slam_tpu_torch.odometry.engine import host_cloud, pick_bucket
from bshot_slam_tpu_torch.ops import preprocess as tpp
from bshot_slam_tpu_torch.ops.rangeimage import build_range_image
from tests.test_preprocess import _render_ri
from tests.torch_kernel_cases import F_CASES, walk_case

PT_MM = 0.05


def _walls():
    sensor = jc.SensorConfig(n_azimuth=96)
    scene = jsynthetic.Scene(boxes=[jsynthetic.Box((-20000, 9000, 0),
                                                   (20000, 12000, 12000))])
    pose = jsynthetic.straight_trajectory(1)[0]
    return j_range_image(jsynthetic.render_sweep(scene, sensor, pose, n_firings=96),
                         sensor)


def _random_image(seed=9, A=512):
    rng = np.random.default_rng(seed)
    sensor = jc.SensorConfig(n_azimuth=A)
    R = sensor.n_rings
    r = rng.uniform(0, 40000, (R, A)).astype(np.float32)
    r[rng.random((R, A)) < 0.3] = 0.0
    az = np.broadcast_to(np.linspace(0, 2 * np.pi, A, endpoint=False,
                                     dtype=np.float32), (R, A)).copy()
    vert = np.deg2rad(np.sort(np.asarray(sensor.vertical_angles_deg))).astype(np.float32)
    return r, az, vert


@pytest.fixture(scope="module")
def scenes():
    sensor = jc.SensorConfig(n_azimuth=512)
    drive, _ = jsynthetic.render_sequence(2, sensor, step_mm=400.0, noise_mm=20.0,
                                          seed=3, n_firings=512)
    adv, _ = jsynthetic.render_sequence(1, sensor, noise_mm=20.0, seed=5,
                                        n_firings=512, adversarial=True)
    images = {f"drive{i}": j_range_image(sw, sensor) for i, sw in enumerate(drive)}
    images["adversarial"] = j_range_image(adv[0], sensor)
    images["flat"] = _render_ri(seed=0, boxes=False)[0]
    images["walls"] = _walls()
    out = {k: (ri.range_mm, ri.azimuth_rad, ri.vert_rad) for k, ri in images.items()}
    out["random"] = _random_image()
    return out


def _both(r, az, vert):
    cfg = jc.PreprocessConfig()
    want = jpp.preprocess(jnp.asarray(r), jnp.asarray(az), jnp.asarray(vert), cfg)
    got = tpp.preprocess(torch.tensor(r), torch.tensor(az), torch.tensor(vert),
                         tc.PreprocessConfig())
    return want, got


SCENES = ("drive0", "drive1", "adversarial", "random", "flat", "walls")


@pytest.mark.parametrize("name", SCENES)
def test_preprocess_matches_reference(scenes, name):
    want, got = _both(*scenes[name])
    np.testing.assert_array_equal(got.classes.numpy(), np.asarray(want.classes))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.classes.dtype == torch.int32
    np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), rtol=0, atol=PT_MM)
    # every class shows up where the scene has it
    assert set(np.unique(np.asarray(want.classes))) >= ({0, 1} if name != "flat" else {1})


@pytest.mark.parametrize("name", F_CASES)
def test_ground_scan_matches_reference(name):
    c = walk_case(name)
    args = (c["range_mm"], c["azimuth_rad"], c["vert_rad"], c["xyz"])
    want = jpp._ground_scan(*map(jnp.asarray, args), jc.PreprocessConfig())
    got = tpp._ground_scan(*map(torch.tensor, args), tc.PreprocessConfig())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ("drive0", "adversarial", "random"))
def test_occlusion_pass_matches_reference(scenes, name):
    r, az, vert = scenes[name]
    want_res = jpp.preprocess(jnp.asarray(r), jnp.asarray(az), jnp.asarray(vert),
                              jc.PreprocessConfig())
    base = jpp._ground_scan(jnp.asarray(r), jnp.asarray(az), jnp.asarray(vert),
                            want_res.xyz, jc.PreprocessConfig())
    got = tpp._occlusion_pass(torch.tensor(r), torch.tensor(az),
                              torch.tensor(np.asarray(base)), tc.PreprocessConfig())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_res.classes))
    assert (got.numpy() == 3).any()


@pytest.mark.parametrize("max_points,select,save_sel", [
    (8192, None, True), (1200, None, True), (500, "half", True),
    (20000, "half", True), (8192, "half", False), (8192, None, False),
])
def test_extract_cloud_matches_reference(scenes, max_points, select, save_sel):
    want_res, got_res = _both(*scenes["drive0"])
    sel = None
    if select:
        sel = np.random.default_rng(4).random(got_res.valid.shape) < 0.5
    j_sel = jnp.asarray(sel) if sel is not None else jnp.ones_like(want_res.valid)
    pts_j, m_j = jpp.extract_cloud(want_res, j_sel, max_points, save_sel)
    pts_t, m_t = tpp.extract_cloud(got_res, None if sel is None else torch.tensor(sel),
                                   max_points, save_sel)
    assert pts_t.shape == (max_points, 3) and m_t.shape == (max_points,)
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    np.testing.assert_allclose(pts_t.numpy(), np.asarray(pts_j), rtol=0, atol=PT_MM)
    assert not pts_t[~m_t].any()  # zero padding
    n = int(m_t.sum())
    assert (n > 0) == (save_sel or select is not None)
    if max_points in (1200, 500):
        assert n == max_points  # the cloud is cut at max_points


def _port_cfg(n_az=512):
    cfg = tc.default_config()
    return tc.SlamConfig(sensor=tc.SensorConfig(n_azimuth=n_az),
                         preprocess=cfg.preprocess,
                         runtime=tc.RuntimeConfig(cloud_buckets=(2048, 4096, 8192)))


@pytest.mark.parametrize("frame,select", [(0, False), (1, False), (2, True)])
def test_fused_cloud_matches_host_cloud(frame, select):
    cfg = _port_cfg()
    sweeps, _ = synthetic.render_sequence(3, cfg.sensor, step_mm=400.0, noise_mm=20.0,
                                          seed=7, n_firings=512, adversarial=frame == 2)
    ri = build_range_image(sweeps[frame], cfg.sensor)
    sel = (np.random.default_rng(frame).random(ri.range_mm.shape) < 0.7
           if select else None)
    want, nv = host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad, sel, cfg)
    pcfg = cfg.preprocess
    pts, pmask, n_valid = pipeline.ingest(
        torch.tensor(ri.range_mm), torch.tensor(ri.azimuth_rad),
        torch.tensor(ri.vert_rad), None if sel is None else torch.tensor(sel), pcfg,
        pcfg.max_points)
    assert int(n_valid) == nv > 500 and n_valid.dtype == torch.int32
    assert pick_bucket(int(n_valid), cfg) == want.shape[0]
    np.testing.assert_array_equal(pmask.numpy(), np.arange(pcfg.max_points) < nv)
    np.testing.assert_allclose(pts[:nv].numpy(), want[:nv], rtol=0, atol=PT_MM)
    assert not pts[nv:].any()
