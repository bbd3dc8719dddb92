#!/usr/bin/env python3
"""Preprocessing evaluation of the port — `tools/run_preprocess_eval.py` on PyTorch.

The reference's `pointcloud_preprocessing` driver (test/
pointcloud_preprocessing.cpp), headless: per-frame class histograms,
ground-removal accuracy against labelled select lists, and class-coloured
PLY export instead of the OpenCV viewer.  Each sweep is classified on the
card by `ops.preprocess` (`--cpu`: its plain PyTorch path on the CPU).

Usage: run_preprocess_eval.py [pcap | --synthetic N] [--select labels.txt]
       [--vert-init -0.6] [--ply-out dir] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import sys


def read_select_lists(path: str):
    """Per-frame selected point indices (the reference's SelectedPoints
    format: one line of indices per frame)."""
    import numpy as np

    with open(path) as f:
        return [np.asarray([int(tok) for tok in line.split()], np.int64) for line in f]


def load_sweeps(args, sensor, **synthetic_kw):
    """The sweeps of a PCAP, or `--synthetic N` rendered frames; cut to
    `--frames` when given."""
    from bshot_slam_tpu_torch.io import pcap as pcap_io
    from bshot_slam_tpu_torch.io import synthetic, velodyne

    if args.synthetic:
        sweeps, _ = synthetic.render_sequence(args.synthetic, sensor, seed=0,
                                              n_firings=sensor.n_azimuth,
                                              **synthetic_kw)
    else:
        if not args.pcap:
            raise SystemExit("provide a PCAP path or --synthetic N")
        payloads, _ = pcap_io.read_udp_payloads(args.pcap)
        sweeps = velodyne.sweeps_from_payloads(payloads, sensor, skip=args.skip)
    return sweeps[:args.frames] if args.frames else sweeps


def device_preprocess(ri, cfg, device):
    """`ops.preprocess` of a range image on `device`."""
    import torch

    from bshot_slam_tpu_torch.ops import preprocess as pp

    def put(a):
        return torch.as_tensor(a, device=device)

    return pp.preprocess(put(ri.range_mm), put(ri.azimuth_rad), put(ri.vert_rad),
                         cfg.preprocess)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pcap", nargs="?")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--skip", type=int, default=0)
    ap.add_argument("--select", help="per-frame selected point index file "
                    "(reference SelectedPoints format: lines of indices)")
    ap.add_argument("--vert-init", type=float, default=-0.6)
    ap.add_argument("--lowpt-th", type=float, default=-2000.0)
    ap.add_argument("--n-azimuth", type=int, default=0)
    ap.add_argument("--ply-out", help="export class-colored PLY per frame")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path) instead of the card")
    args = ap.parse_args(argv)

    from bshot_slam_tpu_torch.config import default_config
    from bshot_slam_tpu_torch.device import resolve_device
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image
    from bshot_slam_tpu_torch.utils.metrics import ground_accuracy
    from bshot_slam_tpu_torch.viz.export import save_classified_cloud

    device = resolve_device("cpu" if args.cpu else None)
    cfg = default_config()
    if args.n_azimuth:
        cfg = dataclasses.replace(
            cfg, sensor=dataclasses.replace(cfg.sensor, n_azimuth=args.n_azimuth))
    cfg = dataclasses.replace(cfg, preprocess=dataclasses.replace(
        cfg.preprocess, vert_init_rad=args.vert_init, lowpt_th_mm=args.lowpt_th))
    sweeps = load_sweeps(args, cfg.sensor, noise_mm=20.0)
    select_lists = read_select_lists(args.select) if args.select else []
    if args.ply_out:
        os.makedirs(args.ply_out, exist_ok=True)

    names = ["keep", "ground", "selfcar", "occl"]
    for i, sw in enumerate(sweeps):
        sel = select_lists[i] if i < len(select_lists) else None
        ri = build_range_image(sw, cfg.sensor, selected_indices=sel)
        res = device_preprocess(ri, cfg, device)
        cls, valid = res.classes.cpu().numpy(), res.valid.cpu().numpy()
        counts = {n: int(((cls == k) & valid).sum()) for k, n in enumerate(names)}
        line = f"frame {i:3d}: " + "  ".join(f"{n}={c}" for n, c in counts.items())
        if sel is not None:
            line += f"  accuracy={ground_accuracy(cls, valid, ri.selected):.3f}"
        print(line)
        if args.ply_out:
            save_classified_cloud(os.path.join(args.ply_out, f"frame_{i:04d}.ply"),
                                  res.xyz.cpu().numpy(), cls, valid)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    sys.exit(main())
