"""The HDL-64E S2 preset (`config.hdl64e_config`, the KITTI odometry
benchmark's sensor) on the CPU: what is its own.  What it shares with the
VLS-128 preset (rows sorted, the preset's fit and settings, the benchmark's
file, host ingest, three chained frames, the refusals, the CLI and the
cell's planted faults) runs on both presets in `tests/test_torch_vls128.py`.

(a) The preset's 64 angles in the S2 manual's nominal block spacing.
(b) `pick_bucket` above 49152 as `slambench/reference/ingest.py` picks.
(c) `cloud.truncated_rows` counts the kept points a small `max_points`
    cuts, `frame_stats` the frames truncated and the padded share;
    `engine.kept_rows` counts what extraction keeps.
"""

import dataclasses

import numpy as np
import pytest
import torch

import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu_torch.io import synthetic
from bshot_slam_tpu_torch.kernels import neighborhood as K
from bshot_slam_tpu_torch.odometry import engine as engine_mod
from bshot_slam_tpu_torch.odometry.engine import SlamEngine, pick_bucket
from bshot_slam_tpu_torch.ops import preprocess_host
from bshot_slam_tpu_torch.ops.rangeimage import build_range_image
from bshot_slam_tpu_torch.utils import profiling
from bshot_slam_tpu_torch.utils.profiling import RECORDER
from slambench.reference import config as ref_config
from slambench.reference import ingest

N_AZ = 256


@pytest.fixture(autouse=True)
def _one_thread_recorder_off():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    RECORDER.disable()
    RECORDER.clear()
    yield
    RECORDER.disable()
    RECORDER.clear()
    torch.set_num_threads(n)


def tiny64(max_points: int = 2048) -> tc.SlamConfig:
    """`tiny_config`'s sizes on the HDL-64E preset's sensor (few azimuth
    bins), car box, sensor height and cloud ladder."""
    full, t = tc.hdl64e_config(), tc.tiny_config()
    return t.replace(
        sensor=dataclasses.replace(full.sensor, n_azimuth=N_AZ),
        preprocess=dataclasses.replace(full.preprocess, max_points=max_points),
        runtime=dataclasses.replace(t.runtime, cloud_buckets=full.runtime.cloud_buckets))


def reference_cfg(cfg: tc.SlamConfig):
    """The reference's view of `cfg` (the configuration file's form)."""
    return ref_config.from_json(
        {s: dataclasses.asdict(getattr(cfg, s)) for s in ref_config.SECTIONS})


def sweeps64(sensor, n: int = 3, n_firings: int = 241, noise_mm: float = 20.0):
    """Sweeps of `default_scene(0)` at 1.73 m, fewer firings than bins as
    the HDL-64E's 2083 in 2176."""
    poses = synthetic.straight_trajectory(n, 400.0, sensor_height_mm=1730.0,
                                          yaw_rate_rad=0.05)
    scene = synthetic.default_scene(0)
    return [synthetic.render_sweep(scene, sensor, p, noise_mm=noise_mm, seed=i,
                                   n_firings=n_firings) for i, p in enumerate(poses)]


# -- (a) the preset -----------------------------------------------------------


def test_preset_angles_in_nominal_spacing():
    s = tc.HDL64E_SENSOR
    a = np.asarray(s.vertical_angles_deg)
    assert s.name == "HDL-64E S2" and s.n_rings == 64 and a.shape == (64,)
    assert s.distance_scale_mm == 2.0
    np.testing.assert_allclose(np.diff(a[:32]), -1.0 / 3.0, atol=1e-12)
    np.testing.assert_allclose(np.diff(a[32:]), -0.5, atol=1e-12)
    assert a[0] == 2.0 and a[32] == pytest.approx(-8.83)
    assert a[31] == pytest.approx(2.0 - 31 / 3) and a[63] == pytest.approx(-24.33)
    assert len(set(a.tolist())) == 64
    assert s.n_azimuth >= 2083  # a bin for every firing of a turn


# -- (b) the cloud ladder ------------------------------------------------------


@pytest.mark.parametrize("n,bucket", [(49152, 49152), (49153, 65536), (65536, 65536),
                                      (65537, 98304), (98305, 131072), (120799, 131072),
                                      (131072, 131072), (140000, 131072)])
def test_pick_bucket_above_49152(n, bucket):
    cfg = tc.hdl64e_config()
    assert pick_bucket(n, cfg) == bucket
    assert ingest.pick_bucket(n, cfg.runtime.cloud_buckets, cfg.preprocess.max_points) == bucket


# -- (c) the cloud counters ---------------------------------------------------


def test_truncated_rows_count_a_cloud_cut_at_max_points():
    sweeps = sweeps64(tiny64().sensor)
    kept = []
    for sw in sweeps:
        _, n = ingest.host_cloud(sw.azimuth_deg, sw.ring, sw.distance,
                                 reference_cfg(tiny64(K.MAX_ROWS)))
        kept.append(n)
    cap = (min(kept) + max(kept)) // 2
    assert min(kept) < cap < max(kept)  # frames under and over the cap
    cfg = tiny64(cap)
    RECORDER.enable("cpu")
    eng = SlamEngine(cfg, seed=0, device="cpu", tile=cfg.runtime.point_tile)
    for sw in sweeps:
        eng.process_sweep(sw)
    RECORDER.disable()
    rec = RECORDER.records()
    by = {}
    for c in rec["counts"]:
        if c["name"].startswith("cloud."):
            by.setdefault(c["frame"][1], {})[c["name"]] = c["n"]
    assert sorted(by) == list(range(len(sweeps)))
    for i, n in enumerate(kept):
        assert by[i] == {"cloud.rows": min(n, cap), "cloud.bucket_rows": cap,
                         "cloud.truncated_rows": max(n - cap, 0)}
    stats = profiling.frame_stats(rec, {eng.serial})
    assert stats["truncated_frames"] == sum(n > cap for n in kept)
    rows = sum(min(n, cap) for n in kept)
    assert stats["padded_pct"] == pytest.approx(100.0 * (1 - rows / (cap * len(kept))))
    assert stats["cloud_counts"]["cloud.truncated_rows"] == sum(max(n - cap, 0) for n in kept)


def test_kept_rows_counts_what_extraction_keeps():
    cfg = tiny64(K.MAX_ROWS)
    sw = sweeps64(cfg.sensor, n=1)[0]
    ri = build_range_image(sw, cfg.sensor)
    cl, _, _ = preprocess_host.preprocess_host(ri.range_mm, ri.azimuth_rad, ri.vert_rad,
                                               cfg.preprocess)
    _, nv = engine_mod.host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad, None, cfg)
    assert engine_mod.kept_rows(cl, ri.range_mm, None) == nv
    sel = np.zeros(cl.shape, bool)
    sel[:, : N_AZ // 2] = True
    _, n_sel = engine_mod.host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad, sel, cfg)
    assert engine_mod.kept_rows(cl, ri.range_mm, sel) == n_sel < nv
