"""The JAX package's full-width drive fixture (`tests/fixtures/torch_jax_drive.npz`,
written by tests/torch_reference_drive.py), which `chip_smoke.py` phase [6]
holds the card's run against.

(a) The fixture describes the port's drive: its recorded configuration is
    the port's `default_config()` (top-k exact, as the port's always is),
    its arguments are `bench_torch`'s, and its ground truth is the port's
    `straight_trajectory` of that drive.
(b) The JAX package regenerates the fixture's first 3 poses within 1e-3 mm
    (the frames do not depend on how many are rendered).
(c) chip_smoke's comparison of a run against the fixture, given the
    fixture's own records, finds no difference.
"""

import importlib.util
import math
import pathlib
import types

import numpy as np

import bench_torch
from tests import torch_reference_drive as trd

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_fixture_is_the_ports_drive():
    import dataclasses

    from bshot_slam_tpu_torch.config import default_config
    from bshot_slam_tpu_torch.io import synthetic

    fx = trd.load()
    cfg = default_config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, exact_topk=True))
    assert fx["meta"]["config"] == trd.config_dict(cfg)
    assert fx["meta"]["args"] == trd.ARGS
    a = trd.ARGS
    assert (a["n_frames"], a["prefill"], a["fetch_every"]) == (
        bench_torch.N_FRAMES, bench_torch.PREFILL_LANDMARKS, bench_torch.FETCH_EVERY)
    n = a["n_frames"]
    assert fx["poses"].shape == (n, 4, 4) and fx["inliers"].shape == (n,)
    gt = synthetic.straight_trajectory(n, step_mm=a["step_mm"],
                                       yaw_rate_rad=2 * math.pi / n)
    np.testing.assert_array_equal(fx["gt"], gt)
    assert int(fx["cursor"]) > a["prefill"]
    assert max(fx["inliers"][-8:]) >= cfg.match.gate_min_inliers


def test_jax_regenerates_the_first_poses():
    fx = trd.load()
    got = trd.run(3)
    np.testing.assert_array_equal(got["inliers"], fx["inliers"][:3])
    np.testing.assert_allclose(got["poses"][:, :3, 3], fx["poses"][:3, :3, 3], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["poses"][:, :3, :3], fx["poses"][:3, :3, :3], rtol=0,
                               atol=1e-6)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_comparison_of_the_fixture_with_itself():
    from bshot_slam_tpu_torch.config import default_config

    fx = trd.load()
    poses = fx["poses"]
    eng = types.SimpleNamespace(
        records=[types.SimpleNamespace(pose=p, n_inliers=int(k))
                 for p, k in zip(poses, fx["inliers"])],
        trajectory=poses[:, :3, 3].astype(np.float64),
        state=types.SimpleNamespace(map=types.SimpleNamespace(cursor=int(fx["cursor"]))))
    jd = _chip_smoke().reference_drive(default_config(), eng, fx["gt"])
    assert jd["config_equal"] and jd["drive_equal"]
    assert jd["mm_max"] < 1e-6 and jd["deg_max"] < 1e-4 and jd["first_over"] is None
    assert jd["ate_between"] == 0.0 and jd["ate_card"] == jd["ate_ref"] > 0
    assert jd["cursor_card"] == jd["cursor_ref"]
