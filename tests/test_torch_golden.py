"""The port on the golden PCAP against the reference's committed CPU gold.

`bshot_slam_tpu_torch/tools/run_golden.py --cpu` replays
tests/fixtures/golden.pcap through the port's engine on the CPU at the
golden configuration and must meet tests/test_golden_trajectory.py's
limits: under 60 mm from `golden_traj.txt`, ATE against `golden_gt.txt`
under 8% of the path, and the pose gate's inliers on every frame after the
first.  One intra-op thread (~22 s).
"""

import contextlib
import dataclasses
import io
import json

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_golden_config_is_the_reference_small_cfg():
    from bshot_slam_tpu_torch.tools.run_golden import golden_config
    from tests.test_odometry_e2e import small_cfg

    assert dataclasses.asdict(golden_config()) == dataclasses.asdict(small_cfg())


def test_port_reproduces_the_golden_trajectory(tmp_path):
    from bshot_slam_tpu_torch.tools import run_golden

    out = tmp_path / "golden.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_golden.main(["--cpu", "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert json.loads(buf.getvalue()) == res
    for key in ("platform", "device", "exact_topk", "n_frames", "path_len_mm",
                "ate_vs_cpu_gold_mm", "ate_vs_ground_truth_mm",
                "cpu_gold_ate_vs_ground_truth_mm", "min_inliers"):  # the reference tool's
        assert key in res, key
    assert res["n_frames"] == 8 and res["device"] == "cpu" and res["exact_topk"]
    assert res["ate_vs_cpu_gold_mm"] < 60.0, res
    assert res["ate_vs_ground_truth_mm"] < 0.08 * res["path_len_mm"], res
    assert res["min_inliers"] >= res["gate_min_inliers"], res
