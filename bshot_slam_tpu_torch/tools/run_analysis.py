#!/usr/bin/env python3
"""Offline analysis of the port — `tools/run_analysis.py` on PyTorch.

The reference transcribes driver output into MATLAB scripts and plots them
(reference: test/Correspondences_analysis.m, correspondence distance stats
per SR variant with and without ICP; test/StaticTest_analysis.m, SR against
ISS repeatability, counts and timing; test/PCP_SP_initpos_analysis.m,
ground-removal accuracy against the vert_init parameter).  This tool runs
those experiments on a PCAP or a synthetic scene on the card (`--cpu`: the
plain PyTorch path on the CPU) and renders the same line charts as SVG,
plus a JSON of every series.

Usage:
  run_analysis.py correspondences [pcap|--synthetic N] --out DIR [--cpu]
  run_analysis.py repeatability   [pcap|--synthetic N] --out DIR [--cpu]
  run_analysis.py ground          [pcap|--synthetic N] --out DIR \\
      [--select labels.txt] [--vert-inits -0.6,-0.9,-1.2,-1.57] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time


def _base_cfg(args):
    from bshot_slam_tpu_torch.config import default_config

    cfg = default_config()
    if args.n_azimuth:
        cfg = dataclasses.replace(
            cfg, sensor=dataclasses.replace(cfg.sensor, n_azimuth=args.n_azimuth))
    return cfg


def _sweeps(args, cfg):
    from bshot_slam_tpu_torch.tools.run_preprocess_eval import load_sweeps

    return load_sweeps(args, cfg.sensor, step_mm=args.step_mm, noise_mm=20.0,
                       adversarial=args.adversarial)


def correspondences(args, device) -> dict:
    """Per-frame inlier correspondence distance stats for each SR saliency
    variant with and without ICP (reference: Correspondences_analysis.m;
    stats from lidar_odometry.cpp:304-330)."""
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.viz.charts import save_line_chart_svg

    cfg0 = _base_cfg(args)
    sweeps = _sweeps(args, cfg0)
    frames = list(range(len(sweeps)))
    out = {"frame": frames}
    for sr in ("CV", "CVS", "CVSN"):
        for icp in (False, True):
            cfg = dataclasses.replace(
                cfg0, keypoints=dataclasses.replace(cfg0.keypoints, sr_type=sr),
                match=dataclasses.replace(cfg0.match, run_icp=icp))
            eng = SlamEngine(cfg, device=device)
            recs = [eng.process_sweep(sw) for sw in sweeps]
            tag = sr + ("+ICP" if icp else "")
            out[tag] = {
                "mean": [float(r.corr_stats[0]) for r in recs],
                "std": [float(r.corr_stats[1]) for r in recs],
                "median": [float(r.corr_stats[2]) for r in recs],
                "num": [r.n_inliers for r in recs],
            }
            print(f"{tag:9s} median={out[tag]['median']}")
    tags = [k for k in out if k != "frame"]
    for stat, unit in (("median", "mm"), ("mean", "mm"), ("std", "mm"),
                       ("num", "count")):
        save_line_chart_svg(
            os.path.join(args.out, f"correspondences_{stat}.svg"), frames,
            {t: out[t][stat] for t in tags},
            f"Inlier correspondence {stat} by SR variant", "Frame", f"{stat} ({unit})")
    return out


def repeatability(args, device) -> dict:
    """SR against ISS keypoint counts, consecutive-frame repeatability at
    the 30 mm hit radius, and per-frame extraction wall time (reference:
    StaticTest_analysis.m; kp_test.cpp + lidar_odometry.cpp:392-445)."""
    import torch

    from bshot_slam_tpu_torch.ops.keypoints import (
        extract_keypoints, iss_keypoints, repeatability as repeat_fn,
    )
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image
    from bshot_slam_tpu_torch.tools.run_kp_eval import device_cloud
    from bshot_slam_tpu_torch.viz.charts import save_line_chart_svg

    cfg = _base_cfg(args)
    sweeps = _sweeps(args, cfg)
    res_by = {k: {"n": [], "t_ms": [], "repeat": []} for k in ("SR", "ISS")}
    prev = {"SR": None, "ISS": None}
    for sw in sweeps:
        pts, pmask = device_cloud(build_range_image(sw, cfg.sensor), cfg, device)
        for name, fn in (("SR", extract_keypoints), ("ISS", iss_keypoints)):
            t0 = time.perf_counter()
            kp = fn(pts, pmask, cfg.keypoints)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            res_by[name]["t_ms"].append((time.perf_counter() - t0) * 1e3)
            res_by[name]["n"].append(int(kp.mask.sum()))
            rep = 1.0 if prev[name] is None else float(repeat_fn(
                kp.positions, kp.mask, *prev[name], cfg.keypoints.repeat_radius_mm))
            res_by[name]["repeat"].append(rep)
            prev[name] = (kp.positions, kp.mask)
        print(f"frame {len(res_by['SR']['n']) - 1}: "
              + "  ".join(f"{k} n={res_by[k]['n'][-1]} rep={res_by[k]['repeat'][-1]:.3f} "
                          f"t={res_by[k]['t_ms'][-1]:.1f}ms" for k in res_by))
    frames = list(range(len(sweeps)))
    for stat, ylab in (("n", "keypoints"), ("repeat", "hit rate"), ("t_ms", "ms / frame")):
        save_line_chart_svg(
            os.path.join(args.out, f"repeatability_{stat}.svg"), frames,
            {k: res_by[k][stat] for k in res_by}, f"SR vs ISS: {ylab}", "Frame", ylab)
    return {"frame": frames, **res_by}


def ground(args, device) -> dict:
    """Ground-removal accuracy (kept / (kept + removed as ground) over
    labelled points) against the virtual initial vertical angle (reference:
    PCP_SP_initpos_analysis.m; pointcloud_preprocessing.cpp:280-286)."""
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image
    from bshot_slam_tpu_torch.tools.run_preprocess_eval import (
        device_preprocess, read_select_lists,
    )
    from bshot_slam_tpu_torch.utils.metrics import ground_accuracy
    from bshot_slam_tpu_torch.viz.charts import save_line_chart_svg

    cfg0 = _base_cfg(args)
    sweeps = _sweeps(args, cfg0)
    select = read_select_lists(args.select) if args.select else None
    series = {}
    frames = list(range(len(sweeps)))
    for vi in (float(v) for v in args.vert_inits.split(",")):
        cfg = dataclasses.replace(
            cfg0, preprocess=dataclasses.replace(cfg0.preprocess, vert_init_rad=vi))
        acc = []
        for fi, sw in enumerate(sweeps):
            sel = select[fi] if select is not None and fi < len(select) else None
            ri = build_range_image(sw, cfg.sensor, selected_indices=sel)
            r = device_preprocess(ri, cfg, device)
            acc.append(float(ground_accuracy(r.classes.cpu().numpy(),
                                             r.valid.cpu().numpy(), ri.selected)))
        series[f"vert_init {vi}"] = acc
        print(f"vert_init={vi}: acc={['%.3f' % a for a in acc]}")
    save_line_chart_svg(os.path.join(args.out, "ground_accuracy.svg"), frames, series,
                        "Ground-removal accuracy vs vert_init", "Frame", "accuracy")
    return {"frame": frames, **series}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("experiment", choices=["correspondences", "repeatability", "ground"])
    ap.add_argument("pcap", nargs="?")
    ap.add_argument("--synthetic", type=int, default=0)
    ap.add_argument("--adversarial", action="store_true",
                    help="synthetic: hardened scene (undulation, clutter, "
                         "self-car returns)")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--skip", type=int, default=0)
    ap.add_argument("--n-azimuth", type=int, default=0)
    # Default motion: a static scene for the repeatability experiment (the
    # reference's StaticTest), a moving platform for the others.
    ap.add_argument("--step-mm", type=float, default=None)
    ap.add_argument("--select", help="labeled select-list file (ground)")
    ap.add_argument("--vert-inits", default="-0.6,-0.9,-1.2,-1.57")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path) instead of the card")
    args = ap.parse_args(argv)

    from bshot_slam_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out, exist_ok=True)
    if args.step_mm is None:
        args.step_mm = 0.0 if args.experiment == "repeatability" else 400.0
    result = {"correspondences": correspondences, "repeatability": repeatability,
              "ground": ground}[args.experiment](args, device)
    jpath = os.path.join(args.out, f"{args.experiment}.json")
    with open(jpath, "w") as f:
        json.dump(result, f, indent=1)
    print(f"stats -> {jpath}; charts -> {args.out}/*.svg")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    sys.exit(main())
