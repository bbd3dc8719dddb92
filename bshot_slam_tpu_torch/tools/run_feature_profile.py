#!/usr/bin/env python3
"""The feature stage's sub-stages on the card — `tools/run_feature_profile.py` on PyTorch.

    python3 bshot_slam_tpu_torch/tools/run_feature_profile.py [--bucket 16384] \\
        [--iters 20] [--tile 2048] [--out FILE] [--cpu]

Attributes `pipeline.compute_features` (SR saliency, normals, SHOT, B-SHOT)
to its parts, each called on its own over the inputs the whole stage sees:
the moments (kernel A), the seg-ratio scores (kernel B), the keypoint
top-k, the normals from the moments (eig3), SHOT's neighbour gather and
top-k, the local reference frames alone, SHOT whole (gather, frames,
histogram), B-SHOT (binarise and pack), and the whole stage; and the two
eigen-solves alone, each through kernel I and through its plain version
on the same tensors: on the normals' covariances of every row of the
bucket and on the keypoints' LRF covariances.  The cloud is
the stage bench's (`run_stage_bench.bench_frame`: the bench drive's second
frame after the native host ingest, padded to `--bucket` rows).

Each sub-stage gets the stage bench's columns (`utils.profiling.stage_times`):
CUDA-event ms and wall ms (medians of `--iters` fenced calls), device-only
ms and device launches per call (`torch.profiler`), host ms (wall -
device).  The line "sum of parts - whole" subtracts the whole stage from
the parts that make it up (moments, seg-ratio, top-k, normals, SHOT whole,
B-SHOT): what calling them apart costs beyond calling them together.
With `--cpu` the plain PyTorch path runs on the CPU and only wall and host
ms are given.

Prints a line per sub-stage, then one JSON line with the reference tool's
keys (`stages_ms`: wall ms per call) plus every column by sub-stage and
the card's name and power limit; `--out` also writes it to a file.  It
also says how often kernel H (SHOT's neighbour selection) has to select:
the share of valid keypoints with more rows in radius than SHOT takes, and
their mean (`selection`).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

# The sub-stages whose sum is the whole stage's work.
PARTS = ("moments(kernel A sweep)", "segratio(kernel B sweep)", "keypoint top-k",
         "normals(from moments)", "shot: full (gather+LRF+hist)", "bshot binarize+pack")
WHOLE = "features fused (whole stage)"
# The eigen-solves alone: kernel I, then its plain version, on each input.
EIG3_STAGES = ("eig3 alone (normals' covariances)", "eig3 plain (normals' covariances)",
               "eig3 alone (LRF covariances)", "eig3 plain (LRF covariances)")
COLUMNS = ("wall_ms", "event_ms", "device_ms", "launches", "host_ms")


def selection(kps, kmask, points, mask, radius: float, max_neighbors: int) -> dict:
    """Rows in radius of each valid keypoint (`gather_neighbors`' test):
    how many keypoints, the share (%) with more than `max_neighbors` (kernel
    H selects) and the mean and largest count."""
    import torch

    from bshot_slam_tpu_torch.kernels import pair_d2

    d2 = pair_d2(kps, points)
    c = ((d2 <= radius * radius) & (d2 > 0) & mask[None, :])[kmask].sum(1)
    c = c.to(torch.float64).cpu()
    n = len(c)
    return {"keypoints": n,
            "saturated_pct": 100.0 * float((c > max_neighbors).sum()) / max(n, 1),
            "mean_in_radius": float(c.mean()) if n else 0.0,
            "max_in_radius": float(c.max()) if n else 0.0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--bucket", type=int, default=16384)
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU instead of the card")
    args = ap.parse_args(argv)

    import torch

    from bshot_slam_tpu_torch.config import default_config
    from bshot_slam_tpu_torch.device import card, resolve_device
    from bshot_slam_tpu_torch.kernels.eig3 import eigh3, eigh3_plain
    from bshot_slam_tpu_torch.odometry import pipeline
    from bshot_slam_tpu_torch.ops import bshot as bshot_mod
    from bshot_slam_tpu_torch.ops import shot as shot_mod
    from bshot_slam_tpu_torch.ops.keypoints import (
        neighborhood_moments, seg_ratio_scores, top_k,
    )
    from bshot_slam_tpu_torch.ops.normals import moment_covariances, normals_from_moments
    from bshot_slam_tpu_torch.tools.run_stage_bench import bench_frame, columns
    from bshot_slam_tpu_torch.utils.profiling import stage_times

    device = resolve_device("cpu" if args.cpu else None)
    cfg = default_config()
    _, pts, pmask, n_valid, _, _ = bench_frame(cfg, args.bucket)
    p = torch.as_tensor(pts, device=device)
    m = torch.as_tensor(pmask, device=device)
    kc, dc = cfg.keypoints, cfg.descriptor
    K, tile = kc.top_k, args.tile

    def moments():
        return neighborhood_moments(p, m, kc.radius_mm, tile)

    cnt, psum, outer = moments()

    def scores():
        return seg_ratio_scores(p, m, kc, tile, moments=(cnt, psum))

    sc = scores()

    def topk():
        return top_k(sc, K)

    top_scores, top_idx = topk()

    def normals():
        return normals_from_moments(p, m, cnt, psum, outer)[0]

    nrm = normals()
    kmask = torch.isfinite(top_scores)
    kps = torch.where(kmask[:, None], p[top_idx], 0.0)

    def gather():
        return shot_mod.gather_neighbors(kps, kmask, p, m, nrm, dc.shot_radius_mm,
                                         dc.max_neighbors)

    g = gather()
    sel = selection(kps, kmask, p, m, dc.shot_radius_mm, dc.max_neighbors)

    def lrf():
        return shot_mod.local_reference_frames(g, dc.shot_radius_mm)

    def shot():
        return shot_mod.shot_descriptors(kps, kmask, p, m, nrm, dc)

    desc, _ = shot()

    def bshot():
        return bshot_mod.bshot_from_shot(desc, dc)

    cov_n = moment_covariances(cnt, psum, outer)
    cov_lrf, _ = shot_mod.lrf_covariances(g, dc.shot_radius_mm)

    def whole():
        return pipeline.compute_features(p, m, cfg, tile)

    stages = {
        PARTS[0]: moments, PARTS[1]: scores, PARTS[2]: topk, PARTS[3]: normals,
        "shot: neighbor gather+topk": gather, "shot: LRF only": lrf,
        PARTS[4]: shot, PARTS[5]: bshot, WHOLE: whole,
        **dict(zip(EIG3_STAGES, (lambda: eigh3(cov_n), lambda: eigh3_plain(cov_n),
                                 lambda: eigh3(cov_lrf), lambda: eigh3_plain(cov_lrf)))),
    }
    rows = stage_times(stages, args.iters, device)
    rows["sum of parts - whole"] = {
        c: (None if rows[WHOLE][c] is None else
            sum(rows[k][c] for k in PARTS) - rows[WHOLE][c]) for c in COLUMNS}
    rows = {k: {c: (None if v[c] is None else round(v[c], 4)) for c in COLUMNS}
            for k, v in rows.items()}
    for name, row in rows.items():
        print(columns(name, row), flush=True)
    print(f"shot selection at bucket {args.bucket}: {sel['keypoints']} keypoints, "
          f"{sel['saturated_pct']:.2f}% with over {dc.max_neighbors} rows in radius, "
          f"mean {sel['mean_in_radius']:.1f}, max {sel['max_in_radius']:.0f}", flush=True)
    out = {
        **card(device),
        "platform": device.type,
        "bucket": args.bucket, "n_valid": n_valid, "iters": args.iters,
        "stages_ms": {k: v["wall_ms"] for k, v in rows.items()},
        "stages": rows,
        "selection": sel,
    }
    js = json.dumps(out)
    print(js, flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(js + "\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    sys.exit(main())
