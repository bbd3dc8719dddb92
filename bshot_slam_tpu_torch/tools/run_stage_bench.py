#!/usr/bin/env python3
"""Per-stage timing and roofline accounting of the port's odometry step — `tools/run_stage_bench.py` on PyTorch.

    python3 bshot_slam_tpu_torch/tools/run_stage_bench.py [--bucket 16384] \\
        [--prefill 65536] [--iters 20] [--tile 2048] [--out FILE] [--cpu]

Times each stage of a frame as the engine runs it, each on its own:
the host preprocess (the native classify + extract of `io.native_decoder`,
which the engine runs), `pipeline.compute_features`,
`pipeline._match_and_estimate` (deferred, as the pipelined engine calls it:
no host sync) and the map insert (`mapstore.insert_keypoints`, deferred).
The inputs are the second frame of the bench drive's first two frames
(`render_sequence(seed=0)`, 400 mm steps, 20 mm noise), padded to
`--bucket` rows, against the state after the first frame, whose map was
prefilled as `bench_torch._prefilled_map` with `--prefill` far-away
landmarks.

Per stage, on the card: the CUDA-event ms and the wall ms of a call
fenced by synchronises (medians of `--iters`), the device-only ms and
device launches per call from `torch.profiler`, and the host ms (wall -
device: dispatch, host work and syncs); then an analytic count of the
stage's dominant instructions and bytes in the port's own terms (the
per-pair counts of kernels A-E in `kernels/*.py`; each input byte read
once, each output written once), its least time on the card's peaks
(`device.card_peaks`), and the shares `mfu` (instruction time / event
time), `bw_util` (byte time / event time) and `sol_frac` (the larger).  A
card without known peaks gets no shares.  With `--cpu` the plain PyTorch
path runs on the CPU and only wall and host ms are given.  Also replays
kernel A's tile skips on the frame (`kernels.neighborhood.kept_tiles`).

Prints a line per stage, then one JSON line with the reference tool's keys
(`peaks_f32_flops_hbm`: f32 instructions/s, an FMA counted once, and bytes/s)
plus the card's name and power limit; `--out` also writes it to a file.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

# f32 instructions per RANSAC hypothesis: Kabsch's 30 power iterations on a
# 4x4 (~27 each) plus its set-up; per hypothesis and correspondence: the
# rigid transform (12), the residual (3), its norm (5) and the test (1).
KABSCH_F32 = 820
RESIDUAL_F32 = 21


def bench_frame(cfg, bucket: int):
    """(range image, points (bucket, 3) float32, mask (bucket,), n_valid,
    first frame's points, its n_valid) of the bench drive's first two
    frames after the native host ingest, the second frame padded to
    `bucket` rows."""
    import numpy as np

    from bshot_slam_tpu_torch.io import native_decoder, synthetic
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image

    sweeps, _ = synthetic.render_sequence(
        2, cfg.sensor, step_mm=400.0, noise_mm=20.0, seed=0,
        n_firings=cfg.sensor.n_azimuth)
    clouds = []
    for sw in sweeps:
        ri = build_range_image(sw, cfg.sensor)
        pts, nv, _ = native_decoder.preprocess_extract_native(
            ri.range_mm, ri.azimuth_rad, ri.vert_rad, cfg.preprocess, None,
            cfg.preprocess.max_points)
        n = min(nv, bucket)
        points = np.zeros((bucket, 3), np.float32)
        points[:n] = pts[:n]
        clouds.append((ri, points, np.arange(bucket) < n, n))
    (_, p0, _, n0), (ri, p1, m1, n1) = clouds
    return ri, p1, m1, n1, p0, n0


def tile_stats(points, mask, radius: float) -> dict:
    """Kernel A's tile skips on the cloud, in the reference tool's keys:
    (query block, candidate tile) pairs walked, pairs of tiles that hold a
    valid row, all pairs; and the radius tests the walked pairs make."""
    from bshot_slam_tpu_torch.kernels.neighborhood import TILE, kept_tiles

    keep, rows = kept_tiles(points, mask, radius, TILE)
    live = rows > 0
    executed, nv_pairs = int(keep.sum()), int(live.sum()) ** 2
    grid = keep.numel()
    return {
        "tile": TILE,
        "executed_pairs": executed,
        "cursor_live_pairs": nv_pairs,
        "grid_pairs": grid,
        "aabb_prune_rate_of_live": round(1 - executed / max(nv_pairs, 1), 4),
        "cursor_prune_rate_of_grid": round(1 - nv_pairs / max(grid, 1), 4),
        "radius_tests": int((rows[:, None] * rows[None, :])[keep].sum()),
    }


def shares(row: dict, ops: dict, nbytes: float, peaks) -> dict:
    """The analytic columns of a stage: instructions (by class) and bytes,
    and, with the card's peaks and its event time, the roofline shares."""
    out = {"gflop": sum(ops.values()) / 1e9, "mbytes": nbytes / 1e6}
    if peaks is None or not row.get("event_ms"):
        return out
    t_ops = peaks.bound_ms(0.0, ops)[0]
    t_bytes = nbytes / peaks.bytes_per_s * 1e3
    out.update(bound_ms=max(t_ops, t_bytes), mfu=round(t_ops / row["event_ms"], 6),
               bw_util=round(t_bytes / row["event_ms"], 6))
    out["sol_frac"] = max(out["mfu"], out["bw_util"])
    return out


def columns(name: str, row: dict) -> str:
    """One printed line of a stage's columns."""
    def f(key, unit=" ms"):
        v = row.get(key)
        return "-" if v is None else f"{v:.3f}{unit}"

    line = (f"{name:34s} wall {f('wall_ms')}  event {f('event_ms')}  device "
            f"{f('device_ms')} in {f('launches', '')} launches  host {f('host_ms')}")
    if "sol_frac" in row:
        line += f"  mfu={row['mfu']:.4f} bw={row['bw_util']:.4f} sol={row['sol_frac']:.4f}"
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--bucket", type=int, default=16384)
    ap.add_argument("--prefill", type=int, default=65536)
    ap.add_argument("--tile", type=int, default=2048)
    ap.add_argument("--out", default="", help="also write the JSON here")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU instead of the card")
    args = ap.parse_args(argv)

    import torch

    import bench_torch
    from bshot_slam_tpu_torch.config import default_config
    from bshot_slam_tpu_torch.device import card, card_peaks, resolve_device
    from bshot_slam_tpu_torch.geometry import se3
    from bshot_slam_tpu_torch.io import native_decoder
    from bshot_slam_tpu_torch.kernels import mapops, neighborhood
    from bshot_slam_tpu_torch.odometry import mapstore, pipeline
    from bshot_slam_tpu_torch.ops.keypoints import moment_features
    from bshot_slam_tpu_torch.utils.profiling import stage_times

    device = resolve_device("cpu" if args.cpu else None)
    cfg = default_config()
    ri, pts, pmask, n_valid, pts0, nv0 = bench_frame(cfg, args.bucket)
    pts_d = torch.as_tensor(pts, device=device)
    pm_d = torch.as_tensor(pmask, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = pipeline.init_state(cfg, device=device)._replace(
        map=bench_torch._prefilled_map(cfg, cfg.map.capacity, n=args.prefill,
                                       device=device))
    state, _ = pipeline.odometry_step_compact(
        state, torch.as_tensor(pts0, device=device), nv0, gen, cfg, args.tile)
    window = cfg.runtime.window_cap if cfg.runtime.window_compact else None

    def host():
        return native_decoder.preprocess_extract_native(
            ri.range_mm, ri.azimuth_rad, ri.vert_rad, cfg.preprocess, None,
            cfg.preprocess.max_points)

    def features():
        return pipeline.compute_features(pts_d, pm_d, cfg, args.tile)

    feats = features()

    def match():
        return pipeline._match_and_estimate(gen, feats, state, cfg, deferred=True)

    T0 = match()[0]

    def insert():
        return mapstore.insert_keypoints(
            state.map, se3.apply(T0, feats.keypoints), feats.descriptors,
            feats.scores, feats.mask, cfg.map, frame_idx=state.frame_idx,
            window_cap=window, deferred=True)

    stages = {
        "preprocess(host native)": host,
        "features(SR+normals+SHOT+BSHOT)": features,
        "match+RANSAC+ICP": match,
        "map insert": insert,
    }
    rows = stage_times(stages, args.iters, device)

    # ---- analytic model: the dominant instructions and bytes, port terms ----
    K = cfg.keypoints.top_k
    M = cfg.descriptor.max_neighbors
    H, I = cfg.match.ransac_iterations, cfg.match.icp_iterations
    b = args.bucket
    r = cfg.keypoints.radius_mm
    sweep = tile_stats(pts, pmask, r)
    tests = sweep["radius_tests"]
    nf = moment_features(pts_d[:1]).shape[1]
    acc = neighborhood.neighborhood_accumulate(pts_d, pm_d, moment_features(pts_d), r)
    within = float(acc[:, 0].sum())
    center = se3.translation(state.ref_pose)
    n_win = int(mapstore.query_mask(state.map, center, cfg.match.map_query_range_mm,
                                    cfg.map).sum())
    n_kp = int(feats.mask.sum())
    cand = n_win + int(state.ref.mask.sum())
    capacity = state.map.positions.shape[0]

    feat_ops = {"f32": float(
        tests * neighborhood.RADIUS_TEST_F32 * 2  # A and B test the same pairs
        + within * (nf + neighborhood.SEGRATIO_IN_RADIUS_F32)
        + K * b * neighborhood.RADIUS_TEST_F32  # SHOT: keypoint-cloud d2
        + K * M * (9 + 9 + 3 + 32))}  # LRF covariance, frame, cosine, 16 soft bins
    feat_bytes = b * (12 + 1) + K * (12 + 4 + 44 + 1)
    match_ops = {c: n * n_kp * cand for c, n in mapops.HAMMING_PAIR_OPS.items()}
    match_ops["f32"] = (I * n_kp * cand * mapops.EUCLID_PAIR_OPS["f32"]
                        + H * (KABSCH_F32 + K * RESIDUAL_F32)
                        + I * (KABSCH_F32 + K * RESIDUAL_F32))
    match_bytes = capacity * (12 + 1) + cand * (12 + 44 + 1) + K * (12 + 44 + 1) + 64
    ins_ops = {c: n * n_kp * n_win for c, n in mapops.DEDUP_PAIR_OPS.items()}
    ins_ops["f32"] += K * K * neighborhood.RADIUS_TEST_F32  # in-batch dedup
    ins_bytes = n_win * (12 + 4 + 12 + 1) + K * (12 + 44 + 4 + 12 + 1 + 4) * 2

    info = card(device)
    peaks = card_peaks(info["device"]) if device.type == "cuda" else None
    model = {"features(SR+normals+SHOT+BSHOT)": (feat_ops, feat_bytes),
             "match+RANSAC+ICP": (match_ops, match_bytes),
             "map insert": (ins_ops, ins_bytes)}
    total = sum(rw["wall_ms"] for rw in rows.values())
    out_rows = {}
    for name, rw in rows.items():
        entry = {"ms": round(rw["wall_ms"], 4), "pct": round(100 * rw["wall_ms"] / total, 1),
                 **{k: (None if v is None else round(v, 4)) for k, v in rw.items()}}
        if name in model:
            entry.update(shares(entry, *model[name], peaks))
        out_rows[name] = entry
        print(columns(name, entry), flush=True)

    result = {
        **info,
        "platform": device.type,
        "bucket": b,
        "n_valid": n_valid,
        "prefill": args.prefill,
        "iters": args.iters,
        "peaks_f32_flops_hbm": None if peaks is None else [peaks.f32_rate, peaks.bytes_per_s],
        "stages": out_rows,
        "total_ms": round(total, 3),
        "sweep_tiles": sweep,
        "window_rows": n_win,
        "model": "analytic dominant terms in the port's instruction counts "
                 "(kernels/*.py per-pair constants; an FMA is one f32 "
                 "instruction, against 128 f32 lanes x SM clock x SMs); bytes "
                 "read and written once; shares against the CUDA-event time",
    }
    js = json.dumps(result)
    print(js, flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(js + "\n")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    sys.exit(main())
