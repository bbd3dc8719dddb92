#!/usr/bin/env python3
"""Keypoint repeatability evaluation of the port — `tools/run_kp_eval.py` on PyTorch.

The reference's `kp_test` driver (test/kp_test.cpp + lidar_odometry.cpp:
392-445): per consecutive-frame SR against ISS repeatability at a 30 mm
hit radius.  Each sweep is preprocessed and extracted on the card
(`ops.preprocess`), and both detectors run there (kernels A and B for SR,
kernel A at the ISS salient radius); `--cpu` runs the plain PyTorch path on
the CPU.

Usage: run_kp_eval.py [pcap | --synthetic N] [--frames N] [--sr-type CV] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys


def device_cloud(ri, cfg, device):
    """The kept points of a range image, preprocessed and extracted on
    `device` at `max_points`: (points, mask)."""
    from bshot_slam_tpu_torch.ops import preprocess as pp
    from bshot_slam_tpu_torch.tools.run_preprocess_eval import device_preprocess

    return pp.extract_cloud(device_preprocess(ri, cfg, device), None,
                            cfg.preprocess.max_points)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pcap", nargs="?")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--skip", type=int, default=0)
    ap.add_argument("--sr-type", choices=["CV", "CVS", "CVSN"], default="CV")
    ap.add_argument("--n-azimuth", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path) instead of the card")
    args = ap.parse_args(argv)

    from bshot_slam_tpu_torch.config import default_config
    from bshot_slam_tpu_torch.device import resolve_device
    from bshot_slam_tpu_torch.ops.keypoints import (
        extract_keypoints, iss_keypoints, repeatability,
    )
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image
    from bshot_slam_tpu_torch.tools.run_preprocess_eval import load_sweeps

    device = resolve_device("cpu" if args.cpu else None)
    cfg = default_config()
    if args.n_azimuth:
        cfg = dataclasses.replace(
            cfg, sensor=dataclasses.replace(cfg.sensor, n_azimuth=args.n_azimuth))
    cfg = dataclasses.replace(
        cfg, keypoints=dataclasses.replace(cfg.keypoints, sr_type=args.sr_type))
    # A static scene, like the reference's StaticTest.
    sweeps = load_sweeps(args, cfg.sensor, step_mm=0.0, noise_mm=20.0)

    prev_sr = prev_iss = None
    for i, sw in enumerate(sweeps):
        pts, pmask = device_cloud(build_range_image(sw, cfg.sensor), cfg, device)
        sr = extract_keypoints(pts, pmask, cfg.keypoints)
        iss = iss_keypoints(pts, pmask, cfg.keypoints)
        line = (f"frame {i:3d}: SR n={int(sr.mask.sum()):4d}  "
                f"ISS n={int(iss.mask.sum()):4d}")
        if prev_sr is not None:
            r_sr = float(repeatability(sr.positions, sr.mask, *prev_sr,
                                       cfg.keypoints.repeat_radius_mm))
            r_iss = float(repeatability(iss.positions, iss.mask, *prev_iss,
                                        cfg.keypoints.repeat_radius_mm))
            line += f"  repeat SR={r_sr:.3f}  ISS={r_iss:.3f}"
        print(line)
        prev_sr = (sr.positions, sr.mask)
        prev_iss = (iss.positions, iss.mask)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    sys.exit(main())
