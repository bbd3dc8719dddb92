"""The traffic generator against the port's `io/synthetic.py`, which it
copies: the same scene, trajectory and ray cast."""

import math

import numpy as np
import pytest
import torch

from bshot_slam_tpu_torch.config import VLP16_SENSOR, SensorConfig
from bshot_slam_tpu_torch.io import synthetic
from slambench.traffic import prefill, render


def test_scene_is_default_scene_zero():
    boxes = render.scene_boxes(0)
    want = synthetic.default_scene(0).boxes
    assert boxes.shape == (len(want), 2, 3)
    for got, box in zip(boxes, want):
        np.testing.assert_array_equal(got, [box.lo, box.hi])


def test_circle_is_straight_trajectory():
    got = render.circle_trajectory(129, 400.0, 2 * math.pi / 129, 2450.0)
    want = synthetic.straight_trajectory(129, 400.0, yaw_rate_rad=2 * math.pi / 129)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sensor,n_firings", [(SensorConfig(), 96), (VLP16_SENSOR, 80)])
def test_ticks_match_render_sweep(sensor, n_firings):
    """Noise off, the same poses and firing count: every return within one
    2 mm distance tick of `render_sweep`'s, the same returns present, and
    the firing order and shared arrays the same."""
    poses = render.circle_trajectory(40, 400.0, 2 * math.pi / 40, 2450.0)[::13]
    ticks = render.render_ticks(poses, sensor.vertical_angles_deg, n_firings,
                                render.scene_boxes(0), sensor.distance_scale_mm,
                                0.0, None, "cpu", frames_per_call=2)
    shared = render.sweep_arrays(sensor.n_rings, n_firings)
    scene = synthetic.default_scene(0)
    for pose, got in zip(poses, ticks):
        want = synthetic.render_sweep(scene, sensor, pose, n_firings=n_firings)
        np.testing.assert_array_equal(shared["azimuth_deg"], want.azimuth_deg)
        np.testing.assert_array_equal(shared["ring"], want.ring)
        np.testing.assert_array_equal(shared["intensity"], want.intensity)
        np.testing.assert_array_equal(got > 0, want.distance > 0)
        diff = np.abs(got.astype(np.int64) - want.distance.astype(np.int64))
        assert diff.max() <= 1
        assert (got > 0).sum() > 0.3 * got.size


def test_noise_is_drawn_from_the_seed():
    poses = render.circle_trajectory(3, 400.0, 0.05, 2450.0)

    def ticks(seed):
        g = torch.Generator().manual_seed(seed)
        return render.render_ticks(poses, SensorConfig().vertical_angles_deg, 64,
                                   render.scene_boxes(0), 2.0, 20.0, g, "cpu")

    a, b, c = ticks(7), ticks(7), ticks(8)
    np.testing.assert_array_equal(a, b)
    assert (a != c).mean() > 0.5
    clean = render.render_ticks(poses, SensorConfig().vertical_angles_deg, 64,
                                render.scene_boxes(0), 2.0, 0.0, None, "cpu")
    hit = clean > 0
    np.testing.assert_array_equal(a > 0, hit)
    spread_mm = np.std(2.0 * (a[hit].astype(np.float64) - clean[hit]))
    assert 15.0 < spread_mm < 25.0


def test_prefill_rows():
    g = torch.Generator().manual_seed(3)
    rows = prefill.prefill_rows(1000, 10.0, 10000.0, 11, g, "cpu")
    again = prefill.prefill_rows(1000, 10.0, 10000.0, 11, torch.Generator().manual_seed(3), "cpu")
    for k in rows:
        assert torch.equal(rows[k], again[k])
    pos = rows["positions"]
    assert pos.shape == (1000, 3) and rows["descriptors"].shape == (1000, 11)
    assert float(pos.min()) >= 1.9e6 and float(pos.max()) <= 2.1e6
    assert torch.equal(pos, torch.trunc(pos / 10.0) * 10.0)
    assert torch.equal(rows["blocks"], torch.round(pos / 10000.0).to(torch.int32))
    assert rows["descriptors"].dtype == torch.int32
    assert 0.0 <= float(rows["seg_ratios"].min()) and float(rows["seg_ratios"].max()) < 1.0
