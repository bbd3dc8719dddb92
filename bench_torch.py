#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: end-to-end odometry frames/s on one card.

    python3 bench_torch.py            # 129 frames on the card
    python3 bench_torch.py --full     # also the step alone over prepared clouds
    python3 bench_torch.py 4 --cpu    # 4 frames of the plain path on the CPU

The port of `bench.py`, on the same drive and map: `SlamEngine.process_sweep`
end to end (range-image build, native host classify + extract, bucketing,
the odometry step, diagnostics fetched in 64-frame batches) over the 129
distinct frames of one full circle (`render_sequence(seed=0)`, 400 mm steps,
20 mm noise, yaw 2 pi / 129), with the map prefilled to 65,536 landmarks far
outside the query window (`_prefilled_map`, the same arrays as bench.py's),
in the pipelined engine (`SlamEngine(cfg, seed=0, pipelined=True,
fetch_every=64)`, each frame's step replayed from its CUDA graph, captured
once per cloud bucket and map capacity).  A warm pass, then the best of
three timed passes.

Prints bench.py's JSON line first, with its keys and metric name
(`engine_frames_per_sec_per_chip`, `vs_baseline` against the reference's
1.54 frames/s keypoint stage), then on stderr the card's name and power
limit (nvidia-smi), the final map size, inliers and re-dispatched frames.
The quality guard is bench.py's: ATE against ground truth below 10% of the
path and at least the pose gate's inliers on one of the last 8 frames, else
exit 1.  `--full` then times the odometry step alone over prepared clouds,
in two forms: the clouds the engine's host path prepares
(`odometry_step_compact`), and, as bench.py's step-only pass does, the
clouds of the device preprocess (`ops.preprocess` + `extract_cloud` at
`max_points`, sliced to `pick_bucket` of the kept count; `odometry_step`
with the mask).  Rendering the drive (in a pool of worker processes) is
not timed.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import math
import multiprocessing
import os
import pathlib
import sys
import time

import numpy as np

BASELINE_FPS = 1.0 / 0.65  # reference keypoint stage alone, optimistic
PREFILL_LANDMARKS = 65536  # >=64k map rows live during every matched frame
N_FRAMES = 129  # one full circle
FETCH_EVERY = 64


def _prefilled_map(cfg, capacity: int, n: int | None = None, device=None):
    """MapState with `n` (PREFILL_LANDMARKS by default) random valid
    landmarks placed far outside the drive's query window (bench.py's
    arrays: the same seed, draws and order), so quality is unaffected while
    matching and dedup pay the full >=64k-row cost every frame.
    `device=None` means the card."""
    import torch

    from bshot_slam_tpu_torch.odometry import mapstore

    n = PREFILL_LANDMARKS if n is None else n
    rng = np.random.default_rng(42)
    pos = rng.uniform(1.9e6, 2.1e6, (n, 3)).astype(np.float32)
    pos = np.trunc(pos / cfg.map.snap_mm) * cfg.map.snap_mm
    words = rng.integers(0, 2**32, (n, 11), dtype=np.uint32)
    seg = rng.uniform(0, 1, n).astype(np.float32)
    st = mapstore.init_map(cfg.map, capacity, device=device)

    def put(x, rows):
        x = x.clone()
        x[:n] = torch.as_tensor(rows, device=x.device)
        return x

    return st._replace(
        positions=put(st.positions, pos),
        descriptors=put(st.descriptors, words.view(np.int32)),
        seg_ratios=put(st.seg_ratios, seg),
        blocks=put(st.blocks, np.round(pos / cfg.map.block_size_mm).astype(np.int32)),
        valid=put(st.valid, np.ones(n, bool)),
        cursor=torch.tensor(n, dtype=torch.int32, device=st.cursor.device),
    )


def render_drive(cfg, n_frames: int = N_FRAMES):
    """bench.py's drive, `render_sequence(n_frames, seed=0, step 400 mm,
    noise 20 mm, yaw 2 pi / n_frames)` frame for frame, rendered in a pool
    of worker processes.  Returns (sweeps, gt poses)."""
    from bshot_slam_tpu_torch.io import synthetic

    poses = synthetic.straight_trajectory(n_frames, step_mm=400.0,
                                          yaw_rate_rad=2 * math.pi / n_frames)
    render = functools.partial(synthetic.render_sweep, synthetic.default_scene(0),
                               cfg.sensor, n_firings=cfg.sensor.n_azimuth)
    n = n_frames
    workers = max(1, min(n, (os.cpu_count() or 2) - 1))
    ctx = multiprocessing.get_context("spawn")  # no fork of a CUDA process
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        sweeps = list(pool.map(render, poses, [None] * n, [20.0] * n, range(n)))
    return sweeps, poses


def fresh_engine(cfg, device, graphs=True):
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine

    eng = SlamEngine(cfg, seed=0, pipelined=True, fetch_every=FETCH_EVERY,
                     device=device, graphs=graphs)
    eng.state = eng.state._replace(
        map=_prefilled_map(cfg, cfg.map.capacity, device=eng.device))
    eng._place_state()  # as a resume does: the engine re-derives its cursor bound
    return eng


def _wait(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def engine_pass(cfg, sweeps, device, graphs=True):
    """(frames/s, engine) of one pass of a fresh engine over the sweeps,
    flush included; `graphs`: an earlier pass's `eng.graphs` to replay
    (the engine's argument)."""
    eng = fresh_engine(cfg, device, graphs)
    _wait(eng.device)
    t0 = time.perf_counter()
    for sw in sweeps:
        eng.process_sweep(sw)
    eng.flush()
    _wait(eng.device)
    return len(sweeps) / (time.perf_counter() - t0), eng


def quality(cfg, eng, gt) -> dict:
    """bench.py's quality guard over a finished engine."""
    from bshot_slam_tpu_torch.utils.metrics import ate_rmse

    gt_rel = np.linalg.inv(gt[0])[None] @ gt
    gt_pos = gt_rel[:, :3, 3]
    ate_mm = float(ate_rmse(eng.trajectory, gt_pos, align=False))
    path_mm = float(np.linalg.norm(np.diff(gt_pos, axis=0), axis=1).sum())
    tail_inliers = [r.n_inliers for r in eng.records[-8:]]
    ok = ate_mm < 0.10 * path_mm and max(tail_inliers) >= cfg.match.gate_min_inliers
    return dict(ate_mm=ate_mm, path_mm=path_mm, tail_inliers=tail_inliers,
                quality_ok=bool(ok))


def headline(fps: float, q: dict) -> dict:
    """bench.py's JSON line."""
    return {
        "metric": "engine_frames_per_sec_per_chip",
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / BASELINE_FPS, 2),
        "ate_vs_gt_mm": round(q["ate_mm"], 1),
        "quality_ok": q["quality_ok"],
    }


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    import torch

    from bshot_slam_tpu_torch.device import card_line

    return card_line() if torch.device(device).type == "cuda" else "cpu"


def host_clouds(cfg, sweeps, device) -> list:
    """The engine's host preprocess of each sweep, uploaded: [(points
    (bucket, 3), None, n_valid)]."""
    import torch

    from bshot_slam_tpu_torch.odometry.engine import host_cloud
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image

    clouds = []
    for sw in sweeps:
        ri = build_range_image(sw, cfg.sensor)
        pts, nv = host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad, None, cfg)
        clouds.append((torch.as_tensor(pts, device=device), None, nv))
    return clouds


def device_clouds(cfg, sweeps, device) -> list:
    """bench.py's step-only clouds: each sweep's device preprocess
    (`preprocess` + `extract_cloud` at max_points, with the range image's
    select list), sliced to the bucket of its kept count: [(points, pmask,
    None)]."""
    import torch

    from bshot_slam_tpu_torch.odometry.engine import pick_bucket
    from bshot_slam_tpu_torch.ops import preprocess as pp
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image

    clouds = []
    for sw in sweeps:
        ri = build_range_image(sw, cfg.sensor)
        r, az, v, sel = (torch.as_tensor(x, device=device) for x in
                         (ri.range_mm, ri.azimuth_rad, ri.vert_rad, ri.selected))
        res = pp.preprocess(r, az, v, cfg.preprocess)
        pts, pmask = pp.extract_cloud(res, sel, cfg.preprocess.max_points)
        b = pick_bucket(int(torch.sum(pmask)), cfg)
        clouds.append((pts[:b], pmask[:b], None))
    return clouds


def step_only_fps(cfg, clouds, device) -> float:
    """Frames/s of the odometry step alone over prepared clouds on the
    device, after a warm pass over every distinct bucket:
    `odometry_step_compact` where a cloud has no mask (n_valid given),
    `odometry_step` with its mask otherwise."""
    import torch

    from bshot_slam_tpu_torch.odometry import pipeline

    state = pipeline.init_state(cfg, device=device)._replace(
        map=_prefilled_map(cfg, cfg.map.capacity, device=device))
    gen = torch.Generator(device=device).manual_seed(0)

    def step(state, cloud):
        pts, pmask, nv = cloud
        if pmask is None:
            return pipeline.odometry_step_compact(state, pts, nv, gen, cfg)[0]
        return pipeline.odometry_step(state, pts, pmask, gen, cfg)[0]

    warmed = set()
    for cloud in clouds:
        if cloud[0].shape[0] not in warmed:
            warmed.add(cloud[0].shape[0])
            state = step(state, cloud)
    _wait(device)
    t0 = time.perf_counter()
    for cloud in clouds:
        state = step(state, cloud)
    _wait(device)
    return len(clouds) / (time.perf_counter() - t0)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_frames", nargs="?", type=int, default=N_FRAMES)
    ap.add_argument("--full", action="store_true",
                    help="also time the odometry step alone over prepared "
                         "clouds, host- and device-preprocessed (stderr)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the plain PyTorch path on the CPU")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    from bshot_slam_tpu_torch.config import default_config
    from bshot_slam_tpu_torch.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    cfg = default_config()
    sweeps, gt = render_drive(cfg, args.n_frames)

    # Warm pass: builds the kernels and the native library and captures the
    # step of every (cloud bucket x map capacity) shape the timed passes will
    # hit; they replay its graphs, as the reference's passes reuse its
    # compiled programs.
    _, warm = engine_pass(cfg, sweeps, device)
    passes = [engine_pass(cfg, sweeps, device, warm.graphs) for _ in range(3)]
    fps, eng = max(passes, key=lambda p: p[0])
    q = quality(cfg, eng, gt)
    final = eng.records[-1]

    print(json.dumps(headline(fps, q)), flush=True)
    print(f"# {device_line(device)}", file=sys.stderr, flush=True)
    print(f"# engine frames/s (process_sweep end to end, {args.n_frames} distinct "
          f"frames, map >= {PREFILL_LANDMARKS}): best {fps:.3f} of "
          f"{[round(p[0], 3) for p in passes]} | final map={final.map_size} "
          f"inliers={final.n_inliers} redispatched={eng.n_redispatched} "
          f"ate={q['ate_mm']:.1f}mm/{q['path_mm']:.0f}mm device={device} "
          f"graphs={eng.graphs.captures} captured in {eng.graphs.capture_s:.2f}s "
          "(warm pass)",
          file=sys.stderr, flush=True)
    if not q["quality_ok"]:
        print(f"# QUALITY COLLAPSE: ate={q['ate_mm']:.0f}mm (path "
              f"{q['path_mm']:.0f}mm), tail inliers {q['tail_inliers']} — the "
              "frames/s headline is meaningless", file=sys.stderr, flush=True)
        return 1
    if args.full:
        print(f"# step-only (odometry_step_compact over host-preprocessed "
              f"clouds, uploaded beforehand): "
              f"{step_only_fps(cfg, host_clouds(cfg, sweeps, device), device):.3f} "
              f"frames/s", file=sys.stderr, flush=True)
        print(f"# step-only (odometry_step over device-preprocessed clouds, "
              f"prepared beforehand): "
              f"{step_only_fps(cfg, device_clouds(cfg, sweeps, device), device):.3f} "
              f"frames/s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
