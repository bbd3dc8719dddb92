#!/usr/bin/env python3
"""The port's trajectory on the golden PCAP against the committed CPU gold — `tools/run_golden_tpu.py` on PyTorch.

    python3 bshot_slam_tpu_torch/tools/run_golden.py [--out build/golden_torch.json] [--cpu]

Replays `tests/fixtures/golden.pcap` (8 sweeps) through the port's engine
at the golden configuration (`golden_config`, a copy of
tests/test_odometry_e2e.py's `small_cfg`; `SlamEngine(cfg, seed=0,
tile=1024)`) on the card, or on the CPU with `--cpu`, and measures how far
its trajectory lies from the reference's committed CPU run
(`tests/fixtures/golden_traj.txt`) and from the ray-cast ground truth
(`golden_gt.txt`).  tests/test_golden_trajectory.py holds the reference to
60 mm from that gold, under 8% of the path against ground truth, and the
pose gate's inliers on every frame after the first.

Prints and writes one JSON object with the reference tool's keys, plus the
card's name and power limit.  `exact_topk` is always true: the port's
top-k is exact.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
FIXTURES = ROOT / "tests" / "fixtures"


def golden_config():
    """tests/test_odometry_e2e.py's `small_cfg`: the configuration the
    golden fixture was recorded at."""
    from bshot_slam_tpu_torch.config import (
        DescriptorConfig, KeypointConfig, MapConfig, MatchConfig, PreprocessConfig,
        SensorConfig, SlamConfig,
    )

    return SlamConfig(
        sensor=SensorConfig(n_azimuth=512),
        preprocess=PreprocessConfig(max_points=8192),
        keypoints=KeypointConfig(top_k=192),
        descriptor=DescriptorConfig(max_neighbors=96),
        match=MatchConfig(ransac_iterations=512),
        map=MapConfig(capacity=8192),
    )


def replay(device) -> dict:
    """The golden PCAP through the port on `device`: the reference tool's
    measurements, and the pose gate's inlier threshold."""
    import numpy as np

    from bshot_slam_tpu_torch.io import pcap, velodyne
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.utils import trajectory as traj_io
    from bshot_slam_tpu_torch.utils.metrics import ate_rmse

    cfg = golden_config()
    payloads, _ = pcap.read_udp_payloads(str(FIXTURES / "golden.pcap"))
    sweeps = velodyne.sweeps_from_payloads(payloads, cfg.sensor)
    eng = SlamEngine(cfg, seed=0, tile=1024, device=device)
    for sw in sweeps:
        eng.process_sweep(sw)

    gold = traj_io.load_xyz(str(FIXTURES / "golden_traj.txt"))
    gt = traj_io.load_xyz(str(FIXTURES / "golden_gt.txt"))
    traj = eng.trajectory
    path_len = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return {
        "platform": eng.device.type,
        "exact_topk": True,
        "n_frames": len(sweeps),
        "path_len_mm": round(path_len, 1),
        "ate_vs_cpu_gold_mm": round(float(ate_rmse(traj, gold, align=False)), 2),
        "ate_vs_ground_truth_mm": round(float(ate_rmse(traj, gt, align=False)), 2),
        "cpu_gold_ate_vs_ground_truth_mm": round(float(ate_rmse(gold, gt, align=False)), 2),
        "min_inliers": int(min(r.n_inliers for r in eng.records[1:])),
        "gate_min_inliers": cfg.match.gate_min_inliers,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "golden_torch.json"))
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU instead of the card")
    args = ap.parse_args(argv)

    from bshot_slam_tpu_torch.device import card, resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    result = {**replay(device), **card(device)}
    js = json.dumps(result)
    print(js, flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(js + "\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
