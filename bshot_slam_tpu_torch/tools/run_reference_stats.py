#!/usr/bin/env python3
"""The port's statistics against the reference's published ranges — `tools/run_reference_stats.py` on PyTorch.

    python3 bshot_slam_tpu_torch/tools/run_reference_stats.py \\
        [--out build/refstats_torch.json] [--frames-static 10] [--frames-drive 6] [--cpu]

The reference's only recorded numbers are hard-coded in its MATLAB
analysis scripts from the author's HDL-32E runs:

  * StaticTest_analysis.m:6-16 — 10-frame STATIC scene: SR repeatability
    0.697-0.817 at 30 mm (1.0 on frame 1), fixed 600 SR keypoints; ISS
    repeatability 0.663-0.756, 284-302 ISS keypoints.
  * Correspondences_analysis.m:7-30 — 5-frame structural drive: inlier
    correspondence counts CV 37-69 / CVS 82-100 / CVSN 84-101, median
    distances CV 239.5-735.9 mm (174.3-287.7 with ICP).

The scenes are ray-cast synthetics configured to the same conditions (full
HDL-32E resolution, a static platform for the repeatability family, 400 mm
steps for the correspondence family), run through the port's
`tools/run_analysis.py` experiments (`repeatability`, `correspondences`)
on the card, or on the CPU with `--cpu`.  Exact equality is not expected,
the scenes differ: the check is that the port's detector, descriptor,
matcher and gate land in or near the reference's published ranges.

Writes one JSON artifact with the reference tool's keys, which names the
card and its power limit; the experiments' series and charts go to
`--workdir`.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[2]

# Known scene-driven deviations (not detector defects): the ray-cast
# static scene places structure at 8-20 m, where the HDL-32E's 1.33deg
# ring spacing (~230 mm at 10 m) starves ISS's tiny 60 mm salient ball
# (reference: lidar_odometry.cpp:447-461), so ISS fires rarely; moving
# structure closer (the adversarial near-field scene) raised ISS counts
# 31 -> 110 at median range 16.9 -> 10.6 m, confirming density (not the
# detector, which has its own unit oracles in test_keypoints.py) is the
# driver.  CVS/CVSN correspondence counts shift with the same scene
# saliency distribution; CV — the variant the reference's driver actually
# runs (odometry_test.cpp:33) — overlaps on both count and distance.
NOTES = {
    "iss_repeatability": "scene density (see module docstring NOTES)",
    "iss_count": "scene density (see module docstring NOTES)",
    "corr_count_CVS": "scene saliency distribution",
    "corr_count_CVSN": "scene saliency distribution",
}

REFERENCE = {
    "sr_repeatability": {
        "ref_range": [0.697, 0.817],
        "ref_source": "test/StaticTest_analysis.m:9",
    },
    "sr_count": {"ref_range": [600, 600],
                 "ref_source": "test/StaticTest_analysis.m:7-8"},
    "iss_repeatability": {
        "ref_range": [0.663, 0.756],
        "ref_source": "test/StaticTest_analysis.m:15",
    },
    "iss_count": {"ref_range": [284, 302],
                  "ref_source": "test/StaticTest_analysis.m:13-14"},
    "corr_count_CV": {"ref_range": [37, 69],
                      "ref_source": "test/Correspondences_analysis.m:28"},
    "corr_count_CVS": {"ref_range": [82, 100],
                       "ref_source": "test/Correspondences_analysis.m:29"},
    "corr_count_CVSN": {"ref_range": [84, 101],
                        "ref_source": "test/Correspondences_analysis.m:30"},
    "corr_median_CV_mm": {
        "ref_range": [239.5, 735.9],
        "ref_source": "test/Correspondences_analysis.m:7",
    },
    "corr_median_CV_ICP_mm": {
        "ref_range": [174.3, 287.7],
        "ref_source": "test/Correspondences_analysis.m:10-12",
    },
}


def _experiment_args(frames: int, step_mm: float, out: str) -> types.SimpleNamespace:
    """`run_analysis`'s arguments for a synthetic run at full width."""
    os.makedirs(out, exist_ok=True)
    return types.SimpleNamespace(synthetic=frames, pcap=None, frames=0, skip=0,
                                 n_azimuth=0, step_mm=step_mm, adversarial=False,
                                 out=out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=str(ROOT / "build" / "refstats_torch.json"))
    ap.add_argument("--frames-static", type=int, default=10)
    ap.add_argument("--frames-drive", type=int, default=6)
    ap.add_argument("--workdir", default=str(ROOT / "build" / "refstats"))
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU instead of the card")
    args = ap.parse_args(argv)

    from bshot_slam_tpu_torch.device import card, resolve_device
    from bshot_slam_tpu_torch.tools import run_analysis as ra

    device = resolve_device("cpu" if args.cpu else None)
    # --- static-scene repeatability family (StaticTest conditions) ---
    rep = ra.repeatability(_experiment_args(
        args.frames_static, 0.0, os.path.join(args.workdir, "rep")), device)
    # --- structural-drive correspondence family ---
    corr = ra.correspondences(_experiment_args(
        args.frames_drive, 400.0, os.path.join(args.workdir, "corr")), device)

    def rng(xs):
        xs = [x for x in xs if x == x]
        return [round(min(xs), 3), round(max(xs), 3)]

    ours = {
        # Frame 0 trivially scores 1.0 against itself in the reference's
        # protocol too (StaticTest_analysis.m:9 "1.0 frame 1"): drop it.
        "sr_repeatability": rng(rep["SR"]["repeat"][1:]),
        "sr_count": rng(rep["SR"]["n"]),
        "iss_repeatability": rng(rep["ISS"]["repeat"][1:]),
        "iss_count": rng(rep["ISS"]["n"]),
        # Frame 0 self-matches (INITIAL): exclude.
        "corr_count_CV": rng(corr["CV"]["num"][1:]),
        "corr_count_CVS": rng(corr["CVS"]["num"][1:]),
        "corr_count_CVSN": rng(corr["CVSN"]["num"][1:]),
        "corr_median_CV_mm": rng(corr["CV"]["median"][1:]),
        "corr_median_CV_ICP_mm": rng(corr["CV+ICP"]["median"][1:]),
    }
    rows = {}
    for k, ref in REFERENCE.items():
        lo, hi = ref["ref_range"]
        olo, ohi = ours[k]
        overlap = not (ohi < lo or olo > hi)
        rows[k] = {
            "ours_range": ours[k],
            "ref_range": ref["ref_range"],
            "ref_source": ref["ref_source"],
            "overlaps_reference": bool(overlap),
        }
        if not overlap and k in NOTES:
            rows[k]["disjoint_cause"] = NOTES[k]
        print(f"{k:26s} ours={ours[k]}  ref={ref['ref_range']} "
              f"({'overlap' if overlap else 'DISJOINT'})")

    out = {
        "platform": device.type,
        **card(device),
        "note": "synthetic scenes configured to the reference's published "
                "experiment conditions (its recordings are not available); "
                "the check is range proximity, not equality",
        "static_frames": args.frames_static,
        "drive_frames": args.frames_drive,
        "metrics": rows,
    }
    pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    print(f"-> {args.out}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
