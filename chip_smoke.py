#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`bshot_slam_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, one line each:
  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. the first 24 frames of the benchmark drive (synthetic HDL-32E),
     four frames of the same drive through the HDL-64E preset, whose
     largest kept cloud [3] gives kernel H, and the lap of the benchmark's
     `vls128.replay` cell (a VLS-128 in a dense street), whose largest kept
     cloud [3] gives A, B and H in their wide form;
  3. each CUDA kernel A-E and G-I at the main path's shapes against its plain
     PyTorch version (G, the ICP update: one update after D at [3]'s D
     inputs, pair count exact, transform and rmse within the stated
     tolerance): integer outputs exactly equal to the plain version
     run on CPU copies of the inputs, float outputs within the stated
     tolerance, no row differing from the plain version run on the card,
     every kernel bit-identical over two runs on the same inputs; kernel and
     plain times on the card (CUDA events, median of 25), the kernel's
     device-only time and device launches per call (`torch.profiler`) and
     the host's time per wrapper call; H (SHOT's neighbour selection: rows
     exactly the plain version's) at 600 keypoints (the card's saliency
     top-k) and 384 neighbours on the HDL-64E cloud cut to 16,384, 49,152
     and 131,072 rows, each with its keypoints' share over 384 rows in
     radius; I (the 3x3 eigen-solves: bit for bit the plain version on the
     same card tensors, where the CPU's libm may round otherwise) on the
     bench frame's normals' and LRF covariances and on the HDL-64E cloud's
     normals' covariances at those three sizes, with the plain version's
     device time and launches; A, B and H in their wide form (past
     `NARROW_ROWS`, the `wide::` kernels) on the VLS-128 cloud cut to
     131,200 and 196,608 rows and padded to 230,400: A's and B's counts
     exactly, their sums within the stated tolerance of, and H's rows
     equal to the plain version on the same card tensors, each twice
     alike, with the profiler's kernel names, times, launches and bound;
  4. `SlamEngine.process_sweep` end to end over the 24 frames, with the
     map prefilled to 65,536 far-away landmarks: frames/s (also over the
     frames that captured no CUDA graph), ATE against
     ground truth, the quality guard (ATE < 10% of path, >= 15 inliers on
     one of the last 8 frames), and every kernel launched on that path;
     then where a frame's time goes: the host preprocess alone, and a
     `torch.profiler` pass over 6 frames of a second engine replaying the
     first one's graphs (device busy time per frame, the device kernels that
     take the most of it);
     the port's own kernels per frame (kernel D: one device launch per
     ICP iteration, G one more; B and C: at most two device launches per
     call, E, G and I one; I two a frame);
  4b. the pipelined engine (`pipelined=True, fetch_every=8`) over the same
     24 frames and prefilled map: records bit-identical to phase [4]'s
     synchronous run, frames/s of both, and the synchronising calls per
     frame between drains (`torch.cuda.set_sync_debug_mode("warn")`, by
     source line); then a forced window overflow (`window_cap` 256, below
     the frames' windows) through abort and re-run, whose records must equal
     the synchronous engine's at that setting;
  4c. eviction at full capacity: the map prefilled to within one frame of
     `cfg.map.capacity`, so the pipelined engine evicts (`n_evicted`), its
     evictions replayed from a CUDA graph on the state buffers, against the
     same drive with `graphs=False`, records bit-identical; then
     `evict_keypoints` on the card, eager and through a `Graphs`, against
     the same call on CPU copies, every field exact, and the eager and the
     graphed eviction's times on the card in turns;
  4d. the backend at full width over `bench.py`'s whole drive (129 frames,
     64k-landmark prefill, `pipelined=True, enable_backend=True,
     backend_every=32`): keyframes, pairs verified, closures, the best
     candidate's inliers, each pass's time and its kernel C and D launches,
     the pass by part (keyframe histograms, pair choice, pair verification,
     the pose graph's build, the LM solve, the corrections: ms each, with a
     synchronise on either side, and device launches each in one more pass
     under `torch.profiler`),
     ATE before and after a final `apply_backend_corrections()`, the
     quality guard; then kernels C and D at the loop-verification shape
     (two of the drive's keyframes, 600 against 600) against their plain
     versions, as in phase [3];
  5. host ingest over the 129 frames: the range image, the numpy plain
     version of classify + extract (`ops.preprocess_host`) and the engine's
     native one (`io.native_decoder`), ms/frame each; classes cell-exact,
     kept counts equal and points within 0.05 mm in every frame; then a
     PCAP round trip: the first 24 frames encoded as Velodyne packets,
     written, read back by `NativeSweepStream` and run through the
     synchronous engine (prefilled map), its poses against phase [4]'s;
  5b. checkpoint on the card: phase [4d]'s run is saved
     (`checkpoint.save_state` / `save_backend`) right after its backend pass
     at frame 64, a fresh engine resumes from the files and drives frames
     64-128; its records, keyframe store and loop edges must equal the
     uninterrupted run's bit for bit;
  6. the bench: `bench_torch`'s engine pass (pipelined, `fetch_every=64`,
     64k prefill) over the 129 rendered frames, one warm pass and one timed
     pass; its JSON line, and its quality guard must hold; then its records
     against the JAX package's run of the same drive on the CPU with exact
     top-k (`tests/fixtures/torch_jax_drive.npz`, read with numpy): per-frame
     differences of the relative motions (median and max, translation and
     rotation), the first frame where one exceeds 20 mm or 0.2 degrees, each
     side's ATE against ground truth and the ATE between them; the fixture's
     configuration and drive must be this run's;
  7. the device preprocess (`host_preprocess=False`): kernel F (the ground
     walk) on every frame of the 129-frame drive against its plain version
     on the card, classes cell-exact, and against itself over two runs; the
     fused clouds (`pipeline.ingest`) against the native host ingest
     (`host_cloud`), counts equal and points within 0.05 mm; F's times
     against its bound and the fused ingest's time and device launches per
     frame (at most 60); the synchronous and the pipelined fused engines on
     [4]'s 24 frames and prefill: frames/s beside [4]'s and [4b]'s, poses
     against [4]'s, records of the two bit-identical; then a full-width
     kept-count spike (12 frames, 6000 kept points, 18000 at frame 4) whose
     pipelined run aborts and re-runs frames, records bit-identical to the
     synchronous fused run;
  8. the evaluation ops on the card: two drive frames' clouds from the
     device preprocess; kernel A at the ISS salient radius (60 mm) against
     its plain version as in [3]; `iss_keypoints` against the CPU port's
     (counts within 10%, at least 75% in common: their moments differ by
     summation order, and the saliency tests compare the eigenvalues);
     `repeatability` between the frames; `voxel_downsample` bit-identical
     over two runs;
  9. the mesh on the card (`parallel.sharded`): the compute mode; kernels
     A and B over each data rank's query range (2 and 4 ranges) of [3]'s
     cloud, bit-identical to the launch over every row; single-device
     references with `mesh_runtime_overrides`; then the engine over a
     ("data", "map") mesh of 1 rank (NCCL), 2 ranks (gloo, map 2) and 4
     ranks (gloo, data 2 x map 2), each rank a spawned process on cuda:0,
     over [4]'s 24 frames and prefill, synchronous and pipelined
     (`fetch_every=8`): records bit-identical to one device's, frames/s
     (ranks share one card: overhead, not scaling), map and live rows per
     rank, query rows per rank, A-E launches per rank, collective calls and
     payload bytes per frame by call site, synchronising calls per frame
     between drains (0 on NCCL); at 1 and 2 ranks also [4c]'s eviction
     drive (records bit-identical) and the sharded bundle adjustment
     against the dense solve (the reference's tolerances).  At 1 rank
     (NCCL) the engines, the eviction and the bundle adjustment replay
     CUDA graphs, and each runs against its eager form in turns (eager,
     graphed, graphed, eager for the synchronous drive): records, A-E
     launches and collectives per frame equal, the captures, their seconds
     and the pool's bytes, the graphed solves within `BA_LIMITS` of the
     eager ones; on gloo every engine is eager (each collective stages
     through the host with a sync, which a capture refuses);
  10. the tools on the card (`bshot_slam_tpu_torch/tools/`), each `main`
     in this process with its lines and JSON line printed: `run_golden` (the
     golden PCAP against the CPU gold: under 60 mm from it, ATE under 8% of
     the path, the pose gate's inliers on every frame after the first),
     `run_stage_bench --iters 5`, `run_feature_profile --iters 5`,
     `run_ba_bench` and `run_reference_stats`; each must exit 0, print its
     JSON line and launch the kernels its path runs;
  11. the steps replayed from CUDA graphs (`odometry.graphs`, the engine's
     default) against the eager steps (`graphs=False`), in turns within
     this call (eager, graphed, graphed, eager; the graphed runs replay the
     captures of the earlier phase's engine): [4]'s synchronous and [4b]'s
     pipelined drives, [4b]'s forced window overflow both ways (each
     aborted frame re-run through the dense step, replayed from its graph
     or eager, the same frames in both modes), [7]'s fused engines and
     spike, and [4d]'s backend drive; records (loop edges included)
     bit-identical, kernel launches equal; frames/s and launches
     a frame of each, the captures, their seconds and the bytes of the
     graphs' memory pool of the earlier run, the backend passes' ms whole
     and by part (the drive's pair verification, keyframe histograms and
     pose graph, corrections and keyframe adds replayed from graphs; its
     final pass's records, corrections and keyframe store bit-identical
     too);
  12. the backend's programs at full width, eager (`graphs=False`'s calls)
     against graphed in turns (median of 5 each): the LM pose graph of 512
     nodes made from a seed (a chain around a loop, 15 loop edges padded
     with one masked edge), `keyframe_bow` over a 512-keyframe store filled
     with [4d]'s keyframes, and BA at [10]'s size; ms, device launches a
     call, capture seconds, pool bytes, the pose graph's device time and
     heaviest kernels (`torch.profiler`); the pose graph and the histograms
     bit-identical, BA within fixed limits of its nearest eager run (its
     `index_add_` adds floats with atomics; the limits checked against the
     eager runs' spread and a planted fault) or bit-identical where they
     are; keyframe add on the full store eager and graphed, evict eager;
  13. two engines whose configurations differ only in the RANSAC inlier
     threshold share one `Graphs`: each bit-identical to its own
     `graphs=False` run; and the host cost of hashing a configuration;
  14. the graphs' pool: [4d]'s drive's `Graphs` gathers the keys a long
     drive makes: a graphed engine on it across the four map buckets (the
     map prefilled to just under each in turn) at three cloud buckets, the
     pose graph at every node bucket (8 to 512) with each loop-edge
     padding, the corrections at every node bucket, BA, each capacity's
     dense re-run step, an eviction at the hard capacity, and a drive of
     [4d]'s circle LONG_LAPS times (its keyframe store fills at 512 and
     evicts); the pool's and the state buffers' bytes after each, and the
     pool's peak, which must stay under POOL_LIMIT;
  15. one JSON line of per-kernel results (`launches` counts the main path,
     phase [4]'s engine run of `frames` frames for A-E, [7]'s synchronous
     fused run for F; `launches_per_frame` divides it; `launches_by_path`
     counts each later path alone, from 0, the mesh paths on rank 0, the
     tools' runs as `tool_<name>`; C's
     and D's `loop_verification` the 600 x 600 check), the card line again,
     and the result line {"ok": true, "device": {...}}.

Every engine steps through its CUDA graphs unless a phase says
`graphs=False` (the gloo mesh engines of [9] are eager); [6]'s timed pass
and [4]'s profile replay the captures of an earlier engine, as the
reference's runs reuse its compiled programs.

The drive is rendered once, in a pool of worker processes; the script's
wall time is printed before the JSON lines.  Checkpoints and the PCAP go
to the git-ignored `build/chip_smoke/` beside the script.

Any failed phase exits non-zero.  Without a visible CUDA device, or without
the `bshot_slam_tpu_torch` package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import functools
import importlib
import io
import json
import math
import multiprocessing
import os
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

N_FRAMES = 24
N_DRIVE = 129  # bench.py's drive, one full circle
RESUME_AT = 64  # phase [5b] saves after this many frames (a backend pass)
PREFILL = 65536
FETCH_EVERY = 8
BACKEND_EVERY = 32
OVERFLOW_WINDOW = 256  # phase [4b]'s window_cap, below the frames' windows
# Phase [12]: the pose graph at the store's full size (max_keyframes nodes)
# with FULL_LOOPS loop edges (padded with one masked edge to a multiple of
# 4).
FULL_NODES, FULL_LOOPS = 512, 15
# Phase [14]: a frame's cloud cut to this many points (a smaller bucket);
# the long drive's laps of the 129-frame circle (a keyframe about every 2
# frames: the store fills at max_keyframes and evicts).
CUT_POINTS, LONG_LAPS = 7000, 10
# Phase [14]: the most the graphs' pool may hold (10% of the card); past it
# a capacity's graphs and state buffers would have to be released once the
# map outgrows it, and the phase fails.
POOL_LIMIT = 8 * 10**9
# Phase [7]'s kept-count spike at full width: SPIKE_BASE kept points a
# frame (bucket 8192 with the predictor's headroom), SPIKE at frame
# SPIKE_AT (bucket 20480).
SPIKE_BASE, SPIKE, SPIKE_FRAMES, SPIKE_AT = 6000, 18000, 12, 4
FUSED_INGEST_MAX_LAUNCHES = 60  # device launches a frame's fused ingest may make
REPEATS = 25
# Phase [6] against the JAX package: its run of the drive, and the relative
# motion difference that marks the first frame where the two part ways.
REFERENCE_DRIVE = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures" / "torch_jax_drive.npz"
REL_MM, REL_DEG = 20.0, 0.2
# Phase [10]'s golden replay: tests/test_golden_trajectory.py's limits (mm
# from the CPU gold; ATE against ground truth as a share of the path).
GOLDEN_MM, GOLDEN_PATH_SHARE = 60.0, 0.08
# Kernels H and I are checked and timed at these cloud rows ([3]), on the largest
# of these frames of the drive through the HDL-64E preset.
SELECT_ROWS = (16384, 49152, 131072)
SELECT_FRAMES = (44, 50, 56, 62)
# Kernels A, B and H in their wide form are checked and timed at these cloud
# rows ([3]), on the largest kept cloud of the `vls128.replay` cell's lap:
# cut to the first two, padded to the last (the VLS-128 preset's max_points).
WIDE_ROWS = (131200, 196608, 230400)
# The bound of A and B counts the radius tests that a box prune at this
# grain (query rows x candidate rows) leaves: a property of the cloud, fixed
# here so that a kernel's own tiling cannot move its own bound.
PRUNE_GRAIN = 128


class SmokeError(RuntimeError):
    pass


def time_ms(fn, repeats: int = REPEATS) -> float:
    """Median of `repeats` CUDA-event timings of fn() after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, calls: int = 100) -> float:
    """Host microseconds per call of fn(), made back to back without a
    synchronise, starting on an idle device."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def measure(fn, plain_fn) -> dict:
    """The timing columns of one kernel's row."""
    from bshot_slam_tpu_torch.utils.profiling import device_profile

    device_ms, launches = device_profile(fn)
    return dict(ms=time_ms(fn), plain_ms=time_ms(plain_fn), device_ms=device_ms,
                device_launches_per_call=launches, host_us_per_call=host_us(fn))


def same_bits(a, b) -> bool:
    import torch

    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(a, b))


def bound(nbytes: float, ops: dict):
    """Least time in ms for the work on an H100 and what sets it
    (`bshot_slam_tpu_torch.device.Peaks.bound_ms`)."""
    from bshot_slam_tpu_torch.device import H100

    return H100.bound_ms(nbytes, ops)


def scaled(ops: dict, n: float) -> dict:
    return {c: k * n for c, k in ops.items()}


def radius_tests(points: np.ndarray, mask: np.ndarray, radius: float,
                 tile: int = PRUNE_GRAIN) -> float:
    """Radius tests a box prune at `tile` x `tile` rows leaves kernels A and
    B: pairs of valid rows in the (query block, candidate tile) pairs that
    are not separated (`kernels.neighborhood.kept_tiles`, the test of
    csrc/neighborhood.cu replayed on the host)."""
    from bshot_slam_tpu_torch.kernels.neighborhood import kept_tiles

    keep, rows = kept_tiles(points, mask, radius, tile)
    return float((rows[:, None] * rows[None, :])[keep].sum())


def cpu(*ts):
    return [t.detach().cpu() for t in ts]


def int_mismatch(a, b) -> int:
    return int((a.cpu() != b.cpu()).sum())


# ---------------------------------------------------------------------------
# Phase 2: data


def render_drive(cfg, n: int | None = None):
    """The first n frames (N_FRAMES by default) of bench.py's drive,
    `render_sequence(seed=0, step 400 mm, noise 20 mm, yaw 2 pi / 129)`,
    frame for frame, rendered in a pool of worker processes."""
    from bshot_slam_tpu_torch.io import synthetic

    n = N_FRAMES if n is None else n
    poses = synthetic.straight_trajectory(n, step_mm=400.0,
                                          yaw_rate_rad=2 * math.pi / N_DRIVE)
    render = functools.partial(synthetic.render_sweep, synthetic.default_scene(0),
                               cfg.sensor, n_firings=cfg.sensor.n_azimuth)
    workers = max(1, min(n, (os.cpu_count() or 2) - 1))
    ctx = multiprocessing.get_context("spawn")  # no fork of a CUDA process
    with concurrent.futures.ProcessPoolExecutor(workers, mp_context=ctx) as pool:
        sweeps = list(pool.map(render, poses, [None] * n, [20.0] * n, range(n)))
    return sweeps, poses


def hdl64e_cloud(frames=SELECT_FRAMES):
    """(the HDL-64E preset, points (bucket, 3), n_valid) of the largest
    kept cloud among `frames` of bench.py's drive with that sensor 1.73 m
    above the road."""
    from bshot_slam_tpu_torch.config import hdl64e_config
    from bshot_slam_tpu_torch.io import synthetic

    cfg = hdl64e_config()
    poses = synthetic.straight_trajectory(
        N_DRIVE, step_mm=400.0, sensor_height_mm=cfg.preprocess.sensor_height_mm,
        yaw_rate_rad=2 * math.pi / N_DRIVE)[list(frames)]
    render = functools.partial(synthetic.render_sweep, synthetic.default_scene(0),
                               cfg.sensor, n_firings=cfg.sensor.n_azimuth)
    n = len(frames)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(n, mp_context=ctx) as pool:
        sweeps = list(pool.map(render, poses, [None] * n, [20.0] * n, frames))
    points, nv = max((frame_cloud(cfg, sw) for sw in sweeps), key=lambda c: c[1])
    return cfg, points, nv


def vls128_cloud(dev):
    """(the VLS-128 preset, points (bucket, 3), n_valid) of the largest kept
    cloud of the benchmark's `vls128.replay` lap, rendered on `dev` as its
    runs render it (`slambench/harness.drive`)."""
    from slambench import cell as cell_mod
    from slambench import harness

    cell = cell_mod.load("vls128.replay")
    cfg = cell_mod.slam_config(cell.config)
    sweeps = harness.drive(cell, dev, {"start": 0})
    points, nv = max((frame_cloud(cfg, sw) for sw in sweeps), key=lambda c: c[1])
    return cfg, points, nv


def cut_to(points_np, nv: int, n: int):
    """(points (n, 3) float32, valid rows): the first rows of a cloud cut
    to n rows or padded with zero rows."""
    k = min(nv, n)
    pts = np.zeros((n, 3), np.float32)
    pts[:k] = points_np[:k]
    return pts, k


def frame_cloud(cfg, sweep):
    """The engine's host preprocess of one sweep: (points (bucket, 3),
    n_valid)."""
    from bshot_slam_tpu_torch.odometry.engine import host_cloud
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image

    ri = build_range_image(sweep, cfg.sensor)
    return host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad, ri.selected, cfg)


def prefilled_map(cfg, device, n: int | None = None, far=(1.9e6, 2.1e6)):
    """MapState at full capacity with `n` random valid landmarks far outside
    the drive's query window (the benchmark's prefill), uniform in the cube
    `far` (mm) on each axis."""
    import torch

    from bshot_slam_tpu_torch.odometry import mapstore

    n = PREFILL if n is None else n
    rng = np.random.default_rng(42)
    pos = rng.uniform(*far, (n, 3)).astype(np.float32)
    pos = np.trunc(pos / cfg.map.snap_mm) * cfg.map.snap_mm
    st = mapstore.init_map(cfg.map, cfg.map.capacity, device=device)
    words = rng.integers(0, 2**32, (n, 11), dtype=np.uint64).astype(np.uint32)

    def put(x, rows):
        x = x.clone()
        x[:n] = torch.as_tensor(rows, device=device)
        return x

    return st._replace(
        positions=put(st.positions, pos),
        descriptors=put(st.descriptors, words.view(np.int32)),
        seg_ratios=put(st.seg_ratios, rng.uniform(0, 1, n).astype(np.float32)),
        blocks=put(st.blocks, np.round(pos / cfg.map.block_size_mm).astype(np.int32)),
        valid=put(st.valid, np.ones(n, bool)),
        cursor=torch.tensor(n, dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions


def kernel_names(fn) -> list:
    """The names of the device kernels one call of fn() runs, as
    `torch.profiler` gives them."""
    from bshot_slam_tpu_torch.utils.profiling import profiled

    return sorted(e.key for e in profiled(fn, fn))


def wide_form(names: list, rows: int) -> bool:
    """True when the port's kernels among `names` are the wide ones
    (`wide::`) exactly when `rows` passes `NARROW_ROWS`."""
    from bshot_slam_tpu_torch.kernels.neighborhood import NARROW_ROWS

    own = [k for k in names if any(p in k for p in PORT_KERNELS)]
    return bool(own) and all(("wide::" in k) == (rows > NARROW_ROWS) for k in own)


def timed(fn, rows: int) -> dict:
    """The columns of a wide row's kernel: CUDA-event ms, device ms and
    launches, the kernels' names and whether they are the form `rows`
    takes."""
    from bshot_slam_tpu_torch.utils.profiling import device_profile

    device_ms, launches = device_profile(fn)
    names = kernel_names(fn)
    return dict(ms=time_ms(fn), device_ms=device_ms, device_launches_per_call=launches,
                kernels=names, wide_form=wide_form(names, rows))


def check_wide_neighborhood(cfg, points_np, nv, dev):
    """Kernels A and B in their wide form on `points_np` cut or padded to
    each of WIDE_ROWS rows: {rows: A's row}, {rows: B's row}, against the
    plain versions on the same card tensors."""
    import torch

    from bshot_slam_tpu_torch.kernels import neighborhood as K

    r = cfg.keypoints.radius_mm
    by_a, by_b = {}, {}
    for n in WIDE_ROWS:
        pts_np, k = cut_to(points_np, nv, n)
        pts = torch.as_tensor(pts_np, device=dev)
        mask = torch.arange(n, device=dev) < k
        x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
        feat = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                            y * y, y * z, z * z], dim=-1).contiguous()
        tests = radius_tests(pts_np, np.arange(n) < k, r)
        nf = feat.shape[1]

        out = K.neighborhood_accumulate(pts, mask, feat, r)
        again = K.neighborhood_accumulate(pts, mask, feat, r)
        ref = K.neighborhood_accumulate_plain(pts, mask, feat, r)
        cnt = ref[:, 0]
        scale = cnt[:, None] * feat.abs().max(dim=0).values[None, :]
        atol = torch.tensor([0.0, 1e-2, 1e-2, 1e-2] + [100.0] * 6, device=dev)
        err = (out - ref).abs()
        within = float(cnt.sum())
        b_ms, b_by = bound(n * (12 + 1 + 4 * nf + 4 * nf),
                           {"f32": tests * K.RADIUS_TEST_F32 + within * nf})
        by_a[n] = dict(
            n_valid=k, radius_tests=tests, in_radius=within,
            card_plain_rows_differ=int_mismatch(out[:, 0], cnt),
            float_out_of_tol=int((err > 1e-5 * scale + atol).any(dim=1).sum()),
            max_abs_err=float(err[:, 1:].max()), deterministic=same_bits([out], [again]),
            **timed(lambda: K.neighborhood_accumulate(pts, mask, feat, r), n),
            bound_ms=b_ms, bound_by=b_by)

        ctvec = (pts - ref[:, 1:4] / torch.clamp(cnt, min=1.0)[:, None]).contiguous()
        outb = K.segratio_accumulate(pts, mask, ctvec, r)
        againb = K.segratio_accumulate(pts, mask, ctvec, r)
        refb = K.segratio_accumulate_plain(pts, mask, ctvec, r)
        errb = (outb[:, 2] - refb[:, 2]).abs()
        scale_b = cnt * torch.linalg.norm(ctvec, dim=-1) * r
        b_ms, b_by = bound(n * (12 + 1 + 12 + 12),
                           {"f32": tests * K.RADIUS_TEST_F32
                            + within * K.SEGRATIO_IN_RADIUS_F32})
        by_b[n] = dict(
            n_valid=k, radius_tests=tests, in_radius=within,
            card_plain_rows_differ=int(((outb[:, :2] != refb[:, :2]).any(dim=1)).sum()),
            float_out_of_tol=int((errb > 1e-5 * scale_b + 1e-2).sum()),
            max_abs_err=float(errb.max()), deterministic=same_bits([outb], [againb]),
            **timed(lambda: K.segratio_accumulate(pts, mask, ctvec, r), n),
            bound_ms=b_ms, bound_by=b_by)
    return by_a, by_b


def with_rows(row: dict, by_rows: dict, what: str) -> dict:
    """`row` with `by_rows` (rows -> a size's row) beside it, their
    failures counted in its own columns."""
    row = dict(row, by_rows={**row.get("by_rows", {}), **by_rows})
    row["shapes"] += f"; {what}"
    for b in by_rows.values():
        row["card_plain_rows_differ"] += b["card_plain_rows_differ"]
        row["float_out_of_tol"] += b.get("float_out_of_tol", 0)
        row["max_abs_err"] = max(row["max_abs_err"], b.get("max_abs_err", 0.0))
        row["deterministic"] = row["deterministic"] and b["deterministic"]
        row["wide_form"] = row.get("wide_form", True) and b["wide_form"]
    return row


def check_neighborhood(cfg, points_np, nv, dev):
    """Kernels A and B on one real frame's cloud."""
    import torch

    from bshot_slam_tpu_torch.kernels import neighborhood as K

    r = cfg.keypoints.radius_mm
    N = points_np.shape[0]
    pts = torch.as_tensor(points_np, device=dev)
    mask = torch.arange(N, device=dev) < nv
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    feat = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                        y * y, y * z, z * z], dim=-1).contiguous()
    pts_c, mask_c, feat_c = cpu(pts, mask, feat)
    rows = []

    # A
    out = K.neighborhood_accumulate(pts, mask, feat, r)
    ref = K.neighborhood_accumulate_plain(pts_c, mask_c, feat_c, r)
    cnt = ref[:, 0]
    cnt_bad = int_mismatch(out[:, 0], cnt)
    scale = cnt[:, None] * feat_c.abs().max(dim=0).values[None, :]
    atol = torch.tensor([0.0, 1e-2, 1e-2, 1e-2] + [100.0] * 6)
    err = (out.cpu() - ref).abs()
    float_bad = int((err > 1e-5 * scale + atol).any(dim=1).sum())
    on_card = K.neighborhood_accumulate_plain(pts, mask, feat, r)
    card_rows = int_mismatch(out[:, 0], on_card[:, 0])
    again = K.neighborhood_accumulate(pts, mask, feat, r)
    tests = radius_tests(points_np, np.arange(N) < nv, r)
    within = float(cnt.sum())
    nf = feat.shape[1]
    b_ms, b_by = bound(N * (12 + 1 + 4 * nf + 4 * nf),
                       {"f32": tests * K.RADIUS_TEST_F32 + within * nf})
    rows.append(dict(
        name="neighborhood_accumulate",
        shapes=f"points ({N},3) n_valid {nv}, feat ({N},10); a box prune at "
               f"{PRUNE_GRAIN} rows leaves {tests:.0f} radius tests, {within:.0f} "
               f"pairs are in radius",
        source="bshot_slam_tpu_torch/csrc/neighborhood.cu",
        replaces="bshot_slam_tpu/kernels/neighborhood.py:124",
        int_mismatch=cnt_bad, float_out_of_tol=float_bad,
        max_abs_err=float(err[:, 1:].max()), card_plain_rows_differ=card_rows,
        deterministic=same_bits([out], [again]),
        **measure(lambda: K.neighborhood_accumulate(pts, mask, feat, r),
                  lambda: K.neighborhood_accumulate_plain(pts, mask, feat, r)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tolerance="counts exact; sums |err| <= 1e-5 * count * max|feat| + atol "
                  "(1e-2 for p, 100 for products): summation order only",
    ))

    # B, on the ctvec the engine feeds it
    psum = ref[:, 1:4]
    ctvec = (pts_c - psum / torch.clamp(cnt, min=1.0)[:, None]).contiguous()
    ctvec_d = ctvec.to(dev)
    outb = K.segratio_accumulate(pts, mask, ctvec_d, r)
    againb = K.segratio_accumulate(pts, mask, ctvec_d, r)
    refb = K.segratio_accumulate_plain(pts_c, mask_c, ctvec, r)
    bad_b = int_mismatch(outb[:, :2], refb[:, :2])
    errb = (outb[:, 2].cpu() - refb[:, 2]).abs()
    scale_b = cnt * torch.linalg.norm(ctvec, dim=-1) * r
    float_bad_b = int((errb > 1e-5 * scale_b + 1e-2).sum())
    on_card_b = K.segratio_accumulate_plain(pts, mask, ctvec_d, r)
    card_rows_b = int(((outb[:, :2] != on_card_b[:, :2]).any(dim=1)).sum())
    b_ms, b_by = bound(N * (12 + 1 + 12 + 12),
                       {"f32": tests * K.RADIUS_TEST_F32
                        + within * K.SEGRATIO_IN_RADIUS_F32})
    rows.append(dict(
        name="segratio_accumulate", shapes=f"points ({N},3) n_valid {nv}, ctvec ({N},3)",
        source="bshot_slam_tpu_torch/csrc/neighborhood.cu",
        replaces="bshot_slam_tpu/kernels/neighborhood.py:245",
        int_mismatch=bad_b, float_out_of_tol=float_bad_b,
        max_abs_err=float(errb.max()), card_plain_rows_differ=card_rows_b,
        deterministic=same_bits([outb], [againb]),
        **measure(lambda: K.segratio_accumulate(pts, mask, ctvec_d, r),
                  lambda: K.segratio_accumulate_plain(pts, mask, ctvec_d, r)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tolerance="pos/neg counts exact; CVS sum |err| <= 1e-5 * count * |ctvec| * r "
                  "+ 1e-2: summation order only",
    ))
    return rows


def check_shot_select(cfg, clouds, dev):
    """Kernel H on each (name, points, n_valid, rows) of `clouds`, the
    cloud cut or padded to each of its rows, with the configuration's
    keypoints (saliency top-k on the card) and neighbours."""
    import torch

    from bshot_slam_tpu_torch.kernels import neighborhood as K
    from bshot_slam_tpu_torch.ops.keypoints import extract_keypoints
    from bshot_slam_tpu_torch.tools.run_feature_profile import selection

    radius, M = cfg.descriptor.shot_radius_mm, cfg.descriptor.max_neighbors
    by_rows = {}
    for cloud, points_np, nv, sizes in clouds:
        for n in sizes:
            pts, k = cut_to(points_np, nv, n)
            p = torch.as_tensor(pts, device=dev)
            m = torch.arange(n, device=dev) < k
            kps = extract_keypoints(p, m, cfg.keypoints)
            args = (kps.positions, kps.mask, p, m, radius, M)
            got, again = K.shot_neighbors(*args), K.shot_neighbors(*args)
            c = cpu(*args[:4])
            want = K.shot_neighbors_plain(*c, radius, M)
            on_card = K.shot_neighbors_plain(*args)
            sel = selection(*c, radius, M)
            nk = sel["keypoints"]
            names = kernel_names(lambda: K.shot_neighbors(*args))
            b_ms, b_by = bound(nk * 13 + k * 13 + nk * min(M, n) * 8,
                               {"f32": nk * k * K.RADIUS_TEST_F32})
            by_rows[n] = dict(
                cloud=cloud, n_valid=k, int_mismatch=int_mismatch(got, want),
                card_plain_rows_differ=int((got != on_card).any(dim=1).sum()),
                deterministic=torch.equal(got, again), **sel,
                **measure(lambda: K.shot_neighbors(*args),
                          lambda: K.shot_neighbors_plain(*args)),
                kernels=names, wide_form=wide_form(names, n),
                bound_ms=b_ms, bound_by=b_by)
    first_rows = clouds[0][3][0]
    first = by_rows[first_rows]
    cols = ("ms", "plain_ms", "device_ms", "device_launches_per_call",
            "host_us_per_call", "bound_ms", "bound_by")
    return dict(
        name="shot_neighbors",
        shapes=f"keypoints ({first['keypoints']} valid of {cfg.keypoints.top_k}), "
               f"{M} neighbours, radius {radius:.0f} mm, "
               + ", ".join(f"{cloud} of {nv} kept points cut or padded to "
                           f"{', '.join(map(str, sizes))} rows"
                           for cloud, _, nv, sizes in clouds)
               + f" (times at {first_rows})",
        source="bshot_slam_tpu_torch/csrc/neighborhood.cu",
        replaces="none: bshot_slam_tpu/ops/shot.py:102-111 (the (K, N) scores and "
                 "lax.top_k)",
        int_mismatch=sum(r["int_mismatch"] for r in by_rows.values()),
        float_out_of_tol=0, max_abs_err=0.0,
        card_plain_rows_differ=sum(r["card_plain_rows_differ"] for r in by_rows.values()),
        deterministic=all(r["deterministic"] for r in by_rows.values()),
        wide_form=all(r["wide_form"] for r in by_rows.values()),
        **{c: first[c] for c in cols}, library_ms=None,
        tolerance="rows exact (the plain version's stable sort) at every size",
        by_rows=by_rows,
    )


def eig3_inputs(cfg, cloud, points_np, nv, n, dev, lrf=False):
    """The step's eigen-solve inputs on `points_np` (the `cloud`) cut or
    padded to n rows:
    the normals' covariances of every row (`moment_covariances`) and, with
    `lrf`, the keypoints' LRF covariances (`lrf_covariances`)."""
    import torch

    from bshot_slam_tpu_torch.ops import keypoints as kp
    from bshot_slam_tpu_torch.ops import shot
    from bshot_slam_tpu_torch.ops.normals import moment_covariances, normals_from_moments

    kc, dc = cfg.keypoints, cfg.descriptor
    k = min(nv, n)
    pts = np.zeros((n, 3), np.float32)
    pts[:k] = points_np[:k]
    p = torch.as_tensor(pts, device=dev)
    m = torch.arange(n, device=dev) < k
    cnt, psum, outer = kp.neighborhood_moments(p, m, kc.radius_mm, 2048)
    out = {f"{cloud}'s normals' covariances, {k} valid of {n} rows":
           moment_covariances(cnt, psum, outer)}
    if lrf:
        scores = kp.seg_ratio_scores(p, m, kc, 2048, moments=(cnt, psum))
        kps = kp.keypoints_from_scores(p, *kp.top_k(scores, kc.top_k))
        nrm = normals_from_moments(p, m, cnt, psum, outer)[0]
        g = shot.gather_neighbors(kps.positions, kps.mask, p, m, nrm,
                                  dc.shot_radius_mm, dc.max_neighbors)
        out[f"{cloud}'s LRF covariances of {kc.top_k} keypoints"] = \
            shot.lrf_covariances(g, dc.shot_radius_mm)[0]
    return out


def check_eig3(cfg, points_np, nv, cfg64, points64, nv64, dev):
    """Kernel I on the step's own inputs: the bench frame's normals' and LRF
    covariances, and the HDL-64E cloud's normals' covariances cut to each of
    SELECT_ROWS rows.  Its contract is the plain version on the same card
    tensors, bit for bit (the CPU's libm may round acos and cos otherwise)."""
    import torch

    from bshot_slam_tpu_torch.kernels import eig3 as E
    from bshot_slam_tpu_torch.utils.profiling import device_profile

    inputs = eig3_inputs(cfg, "bench frame", points_np, nv, points_np.shape[0], dev,
                         lrf=True)
    for n in SELECT_ROWS:
        inputs.update(eig3_inputs(cfg64, "HDL-64E cloud", points64, nv64, n, dev))
    by_input = {}
    for what, A in inputs.items():
        got, again, want = E.eigh3(A), E.eigh3(A), E.eigh3_plain(A)
        bits = [(x.view(torch.int32) != y.view(torch.int32)).flatten(1).any(dim=1)
                for x, y in zip(got, want)]
        plain_device_ms, plain_launches = device_profile(lambda: E.eigh3_plain(A))
        b_ms, b_by = bound(A.shape[0] * E.EIG3_BYTES, {})
        by_input[what] = dict(
            matrices=A.shape[0], card_plain_rows_differ=int((bits[0] | bits[1]).sum()),
            max_abs_err=max(float((x - y).abs().nan_to_num(0.0).max())
                            for x, y in zip(got, want)),
            deterministic=same_bits(got, again),
            **measure(lambda: E.eigh3(A), lambda: E.eigh3_plain(A)),
            plain_device_ms=plain_device_ms, plain_launches=plain_launches,
            bound_ms=b_ms, bound_by=b_by)
    what, first = next(iter(by_input.items()))
    cols = ("ms", "plain_ms", "device_ms", "device_launches_per_call",
            "host_us_per_call", "bound_ms", "bound_by")
    return dict(
        name="eigh3",
        shapes=f"the {what}, ({first['matrices']},3,3) (times at this "
               f"size), its LRF covariances, and an HDL-64E cloud of {nv64} kept points "
               f"cut to {', '.join(map(str, SELECT_ROWS))} rows",
        source="bshot_slam_tpu_torch/csrc/eig3.cu",
        replaces="none: bshot_slam_tpu/geometry/eig3.py:eigh3 (fused by XLA)",
        int_mismatch=0, float_out_of_tol=0,
        max_abs_err=max(r["max_abs_err"] for r in by_input.values()),
        card_plain_rows_differ=sum(r["card_plain_rows_differ"] for r in by_input.values()),
        deterministic=all(r["deterministic"] for r in by_input.values()),
        **{c: first[c] for c in cols}, library_ms=None,
        tolerance="bit for bit (int32 views) the plain version on the same card "
                  "tensors, on every input",
        by_input=by_input,
    )


def map_inputs(cfg, dev, seed: int = 3):
    """A 600-keypoint frame against a prefilled 32768-row window whose
    cursor is not tile-aligned, plus the 600-row previous-frame tail."""
    import torch

    rng = np.random.default_rng(seed)
    K, W = cfg.keypoints.top_k, cfg.runtime.window_cap
    nv = W - W // 12 - 7  # odd: not a multiple of any tile
    Cb = W + K
    a_words = rng.integers(0, 2**32, (K, 11), dtype=np.uint64).astype(np.uint32)
    b_words = rng.integers(0, 2**32, (Cb, 11), dtype=np.uint64).astype(np.uint32)
    b_words[nv:W] = 0
    b_words[rng.integers(0, nv, 40)] = a_words[:40]  # exact matches
    b_words[W + 5] = a_words[41]  # a match in the tail
    b_words[[7, 9, 11]] = a_words[42]  # a three-way tie: lowest index wins
    a_mask = rng.random(K) > 0.05
    a_mask[42] = True
    b_mask = np.zeros(Cb, bool)
    b_mask[:nv] = rng.random(nv) > 0.1
    b_mask[W:] = rng.random(K) > 0.05
    b_mask[[7, 9, 11]] = True
    q = rng.uniform(-4e4, 4e4, (K, 3)).astype(np.float32)
    ref = rng.uniform(-1e5, 1e5, (Cb, 3)).astype(np.float32)
    ref[nv:W] = 0.0
    ref[W:] = q + rng.normal(0, 300, (K, 3)).astype(np.float32)
    ref = np.trunc(ref / 10.0) * 10.0
    pos = np.trunc(q / 10.0) * 10.0
    mpos = ref[:W].copy()
    mpos[rng.integers(0, nv, K)] = pos + rng.normal(0, 500, (K, 3)).astype(np.float32)
    mpos = (np.trunc(mpos / 10.0) * 10.0).astype(np.float32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return dict(
        nv=nv, tail=W, a_words=t(a_words.view(np.int32)), a_mask=t(a_mask),
        b_words=t(b_words.view(np.int32)), b_mask=t(b_mask), q=t(q), ref=t(ref),
        pos=t(pos), blk=t(np.round(pos / 1e4).astype(np.int32)),
        seg=t(rng.random(K).astype(np.float32)), mpos=t(mpos),
        mblk=t(np.round(mpos / 1e4).astype(np.int32)),
        mseg=t(rng.random(W).astype(np.float32)), mvalid=t(np.arange(W) < nv),
    )


def check_mapops(cfg, dev):
    """Kernels C, D, E and G at the main path's shapes."""
    import torch

    from bshot_slam_tpu_torch.geometry import se3
    from bshot_slam_tpu_torch.kernels import mapops as M

    d = map_inputs(cfg, dev)
    c = {k: (v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in d.items()}
    nv, tail = d["nv"], d["tail"]
    K, Cb, W = d["a_words"].shape[0], d["b_words"].shape[0], d["mpos"].shape[0]
    nv_d = torch.tensor(nv, dtype=torch.int32, device=dev)
    rows = []

    # C
    args = (d["a_words"], d["a_mask"], d["b_words"], d["b_mask"], nv_d)
    cargs = (c["a_words"], c["a_mask"], c["b_words"], c["b_mask"], nv)
    got = M.hamming_nn_bounded(*args, tail_start=tail)
    again = M.hamming_nn_bounded(*args, tail_start=tail)
    want = M.hamming_nn_bounded_plain(*cargs, tail_start=tail)
    bad = sum(int_mismatch(g, w) for g, w in zip(got, want))
    card = M.hamming_nn_bounded_plain(*args, tail_start=tail)
    card_rows = int_mismatch(got[1], card[1]) + int_mismatch(got[3], card[3])
    assert int(got[1][42]) == 7, "three-way tie must go to the lowest index"
    live = nv + (Cb - tail)
    pairs = float(c["a_mask"].sum()) * float(c["b_mask"].sum())
    b_ms, b_by = bound(K * 45 + live * 45 + (K + Cb) * 8,
                       scaled(M.HAMMING_PAIR_OPS, pairs))
    rows.append(dict(
        name="hamming_nn_bounded", shapes=f"a ({K},11) int32, b ({Cb},11), n_valid {nv}, tail {tail}",
        source="bshot_slam_tpu_torch/csrc/mapops.cu",
        replaces="bshot_slam_tpu/kernels/mapops.py:147",
        int_mismatch=bad, float_out_of_tol=0,
        max_abs_err=float(max((g.cpu() - w).abs().max() for g, w in
                              ((got[0], want[0]), (got[2], want[2])))),
        card_plain_rows_differ=card_rows, deterministic=same_bits(got, again),
        **measure(lambda: M.hamming_nn_bounded(*args, tail_start=tail),
                  lambda: M.hamming_nn_bounded_plain(*args, tail_start=tail)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tolerance="minima and argminima exact",
    ))

    # D
    args = (d["q"], d["a_mask"], d["ref"], d["b_mask"], nv_d)
    cargs = (c["q"], c["a_mask"], c["ref"], c["b_mask"], nv)
    got = M.euclid_nn_bounded(*args, tail_start=tail)
    want = M.euclid_nn_bounded_plain(*cargs, tail_start=tail)
    bad = int_mismatch(got[1], want[1]) + int_mismatch(got[0], want[0])
    card = M.euclid_nn_bounded_plain(*args, tail_start=tail)
    again = M.euclid_nn_bounded(*args, tail_start=tail)
    b_ms, b_by = bound(K * 13 + live * 13 + K * 8, scaled(M.EUCLID_PAIR_OPS, pairs))
    rows.append(dict(
        name="euclid_nn_bounded", shapes=f"q ({K},3), ref ({Cb},3), n_valid {nv}, tail {tail}",
        source="bshot_slam_tpu_torch/csrc/mapops.cu",
        replaces="bshot_slam_tpu/kernels/mapops.py:244",
        int_mismatch=bad, float_out_of_tol=0,
        max_abs_err=float((got[0].cpu() - want[0]).abs().max()),
        card_plain_rows_differ=int_mismatch(got[1], card[1]),
        deterministic=same_bits(got, again),
        **measure(lambda: M.euclid_nn_bounded(*args, tail_start=tail),
                  lambda: M.euclid_nn_bounded_plain(*args, tail_start=tail)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tolerance="d2 and argmin exact (identical rounding)",
    ))

    # E
    r = 800.0
    args = (d["pos"], d["blk"], d["seg"], d["mpos"], d["mblk"], d["mseg"], d["mvalid"], nv_d)
    cargs = (c["pos"], c["blk"], c["seg"], c["mpos"], c["mblk"], c["mseg"], c["mvalid"], nv)
    got = M.dedup_blocked_bounded(*args, dedup_radius=r)
    again = M.dedup_blocked_bounded(*args, dedup_radius=r)
    want = M.dedup_blocked_bounded_plain(*cargs, dedup_radius=r)
    if int(want.sum()) == 0:
        raise SmokeError("dedup inputs block no newcomer; the check is empty")
    card = M.dedup_blocked_bounded_plain(*args, dedup_radius=r)
    same = ((c["blk"][:, None, :] == c["mblk"][None, :nv, :]).all(-1)
            & c["mvalid"][None, :nv] & (c["mseg"][None, :nv] >= c["seg"][:, None]))
    ops = scaled(M.DEDUP_PAIR_OPS, K * float(nv))
    for cls, n_ops in scaled(M.DEDUP_SAME_BLOCK_OPS, float(same.sum())).items():
        ops[cls] = ops.get(cls, 0.0) + n_ops
    b_ms, b_by = bound(K * 28 + nv * 29 + K, ops)
    rows.append(dict(
        name="dedup_blocked_bounded", shapes=f"pos ({K},3), map ({W},3), n_valid {nv}",
        source="bshot_slam_tpu_torch/csrc/mapops.cu",
        replaces="bshot_slam_tpu/kernels/mapops.py:328",
        int_mismatch=int_mismatch(got, want), float_out_of_tol=0, max_abs_err=0.0,
        card_plain_rows_differ=int_mismatch(got, card),
        deterministic=same_bits([got], [again]),
        **measure(lambda: M.dedup_blocked_bounded(*args, dedup_radius=r),
                  lambda: M.dedup_blocked_bounded_plain(*args, dedup_radius=r)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tolerance=f"flags exact ({int(want.sum())} of {K} blocked)",
    ))

    # G: one ICP update after D, from G's start (the identity), on D's
    # inputs above; the plain update on CPU copies and on the card.
    mcd = cfg.match.icp_max_corr_dist_mm
    src, sm, dst = d["q"], d["a_mask"], d["ref"]
    d2, nn = M.euclid_nn_bounded(src, sm, dst, d["b_mask"], nv_d, tail_start=tail)
    start = M.icp_update(src, sm, dst)
    got = M.icp_update(src, sm, dst, d2, nn, mcd, M.icp_update(src, sm, dst))
    again = M.icp_update(src, sm, dst, d2, nn, mcd, M.icp_update(src, sm, dst))
    eye = torch.eye(4)
    cd2, cnn = d2.cpu(), nn.cpu()
    want = M.icp_update_plain(eye, c["q"], c["ref"][cnn.long()], cd2, c["a_mask"], mcd, eye)
    card = M.icp_update_plain(eye.to(dev), src, dst[nn.long()], d2, sm, mcd, eye.to(dev))

    def off(g, w):  # (rotation, translation, rmse relative) differences
        T, rmse = g.transform.cpu(), float(g.rmse)
        return (float((T[:3, :3] - w[0][:3, :3].cpu()).abs().max()),
                float((T[:3, 3] - w[0][:3, 3].cpu()).abs().max()),
                abs(rmse - float(w[1])) / max(float(w[1]), 1e-30))

    cpu_off, card_off = off(got, want), off(got, card)
    tol = (1e-6, 1e-3, 1e-5)
    pairs = int(got.n_pairs)
    if pairs < 3:
        raise SmokeError(f"G's check has {pairs} pairs; the Kabsch step is not run")
    b_ms, b_by = bound(K * M.ICP_ROW_BYTES + M.ICP_CALL_BYTES,
                       {c_: n * K + M.ICP_CALL_OPS.get(c_, 0)
                        for c_, n in M.ICP_ROW_OPS.items()})
    rows.append(dict(
        name="icp_update", shapes=f"src ({K},3), dst ({Cb},3), {pairs} pairs",
        source="bshot_slam_tpu_torch/csrc/mapops.cu",
        replaces="none: bshot_slam_tpu/ops/icp.py:52 (the scan body after the NN search)",
        int_mismatch=int(pairs != int(want[2])) + int(pairs != int(card[2]))
        + int(not (torch.equal(start.transform.cpu(), eye) and torch.equal(start.cur, src))),
        float_out_of_tol=sum(x > t for x, t in zip(cpu_off + card_off, tol + tol)),
        max_abs_err=max(cpu_off[:2] + card_off[:2]),
        card_plain_rows_differ=int(float((got.cur - se3.apply(got.transform, src))
                                         .abs().max()) > 1e-3),
        deterministic=same_bits([t.reshape(-1) for t in got],
                                [t.reshape(-1) for t in again]),
        **measure(lambda: M.icp_update(src, sm, dst, d2, nn, mcd, got),
                  lambda: se3.apply(M.icp_update_plain(
                      got.transform, got.cur, dst[nn.long()], d2, sm, mcd,
                      eye.to(dev))[0], src)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        tolerance=f"pairs exact; against the CPU {cpu_off[0]:.2e} / {cpu_off[1]:.2e} mm / "
                  f"{cpu_off[2]:.2e}, the card {card_off[0]:.2e} / {card_off[1]:.2e} mm / "
                  f"{card_off[2]:.2e} (rotation within 1e-6, translation 1e-3 mm, rmse "
                  f"1e-5 relative: the sums in another order); the start exact",
    ))
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the engine


def run_engine(cfg, sweeps, gt, dev):
    import torch

    from bshot_slam_tpu_torch.kernels import eig3, mapops, neighborhood
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.utils.metrics import ate_rmse

    wrappers = {
        "neighborhood_accumulate": neighborhood.neighborhood_accumulate,
        "segratio_accumulate": neighborhood.segratio_accumulate,
        "shot_neighbors": neighborhood.shot_neighbors,
        "hamming_nn_bounded": mapops.hamming_nn_bounded,
        "euclid_nn_bounded": mapops.euclid_nn_bounded,
        "dedup_blocked_bounded": mapops.dedup_blocked_bounded,
        "icp_update": mapops.icp_update,
        "eigh3": eig3.eigh3,
    }
    eng = SlamEngine(cfg, seed=0, device=dev)
    eng.state = eng.state._replace(map=prefilled_map(cfg, dev))
    for w in wrappers.values():
        w.launches = 0
    times, captured = [], []

    def captures():
        graphs = getattr(eng, "graphs", None)  # None: an older port
        return 0 if graphs is None else graphs.captures

    for sw in sweeps:
        c0 = captures()
        t0 = time.perf_counter()
        eng.process_sweep(sw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        captured.append(captures() > c0)
    launches = {k: w.launches for k, w in wrappers.items()}
    fps = (len(times) - 1) / sum(times[1:])
    steady = [t for t, c in zip(times[1:], captured[1:]) if not c]
    gt_rel = np.linalg.inv(gt[0])[None] @ gt
    gt_pos = gt_rel[:, :3, 3]
    ate = float(ate_rmse(eng.trajectory, gt_pos, align=False))
    path = float(np.linalg.norm(np.diff(gt_pos, axis=0), axis=1).sum())
    tail_inliers = [r.n_inliers for r in eng.records[-8:]]
    return dict(fps=fps, ate_mm=ate, path_mm=path, tail_inliers=tail_inliers,
                launches=launches, map_size=eng.records[-1].map_size,
                first_frame_s=times[0], steady_frames=len(steady),
                steady_fps=len(steady) / sum(steady)), eng


def host_preprocess_ms(cfg, sweeps) -> float:
    """Mean host time of range image + classify + extract per frame."""
    t0 = time.perf_counter()
    for sw in sweeps:
        frame_cloud(cfg, sw)
    return (time.perf_counter() - t0) / len(sweeps) * 1e3


# The __global__ functions of csrc/*.cu, as the profiler names them.
PORT_KERNELS = ("pack_cloud_kernel", "accumulate_kernel", "segratio_kernel",
                "hamming_kernel", "euclid_kernel", "dedup_kernel", "icp_update_kernel",
                "shot_pack_kernel", "shot_select_kernel", "eig3_kernel")
# Most device launches a call of a wrapper may make.
MAX_DEVICE_LAUNCHES = {"segratio_accumulate": 2, "hamming_nn_bounded": 2,
                       "dedup_blocked_bounded": 1, "ground_walk": 1, "icp_update": 1,
                       "shot_neighbors": 2, "eigh3": 1}


def profile_engine(cfg, sweeps, dev, graphs=None, n: int = 6):
    """Device kernel time per frame, the heaviest device kernels and the
    port's own kernels (ms and launches per frame), over n frames of a
    fresh engine (frames 0 and 1 run before the window), replaying
    `graphs` where given (phase [4]'s, so no capture falls in the
    window)."""
    import torch

    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.utils import profiling

    eng = SlamEngine(cfg, seed=0, device=dev,
                     **({} if graphs is None else {"graphs": graphs}))
    eng.state = eng.state._replace(map=prefilled_map(cfg, dev))
    eng.process_sweep(sweeps[0])
    torch.cuda.synchronize()
    kernels = profiling.profiled(lambda: eng.process_sweep(sweeps[1]),
                       lambda: [eng.process_sweep(sw) for sw in sweeps[2:n + 2]])
    total_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:8]

    def per_frame(e, name):
        return name, e.self_device_time_total / n / 1e3, e.count / n

    own = [per_frame(e, k) for e in kernels for k in PORT_KERNELS if k in e.key]
    return (total_us / n / 1e3, sum(e.count for e in kernels) / n,
            [per_frame(e, e.key[:48]) for e in top], own)


# ---------------------------------------------------------------------------
# Phases 4b-4d: the pipelined engine, eviction, the backend


def kernel_wrappers():
    from bshot_slam_tpu_torch.kernels import eig3, mapops, neighborhood, preprocess

    return {
        "neighborhood_accumulate": neighborhood.neighborhood_accumulate,
        "segratio_accumulate": neighborhood.segratio_accumulate,
        "shot_neighbors": neighborhood.shot_neighbors,
        "hamming_nn_bounded": mapops.hamming_nn_bounded,
        "euclid_nn_bounded": mapops.euclid_nn_bounded,
        "dedup_blocked_bounded": mapops.dedup_blocked_bounded,
        "ground_walk": preprocess.ground_walk,
        "icp_update": mapops.icp_update,
        "eigh3": eig3.eigh3,
    }


def counted(fn):
    """(fn()'s result, each kernel's launches during it, counted from 0)."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {k: w.launches for k, w in wrappers.items()}


def records_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(x.pose, y.pose) and np.array_equal(x.corr_stats, y.corr_stats)
        and (x.n_inliers, x.n_mutual, x.gated, x.map_size, x.n_dropped, x.icp_rmse)
        == (y.n_inliers, y.n_mutual, y.gated, y.map_size, y.n_dropped, y.icp_rmse)
        for x, y in zip(a, b))


def drive(eng, sweeps) -> float:
    """Frames/s of eng over sweeps after the first frame, flush included."""
    import torch

    eng.process_sweep(sweeps[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for sw in sweeps[1:]:
        eng.process_sweep(sw)
    eng.flush()
    torch.cuda.synchronize()
    return (len(sweeps) - 1) / (time.perf_counter() - t0)


def sync_census(eng, sweeps):
    """Run the engine over sweeps with the sync debug mode on: per call, the
    synchronising calls and whether the call drained (finalized records);
    and the source lines of the synchronising calls made outside drains.
    A call that captured a CUDA graph (which synchronises once per key, as
    a compile would) is counted with the first call and reported as
    drained; `captured` counts such calls after the first."""
    import torch

    calls, sites, captured = [], [collections.Counter(), collections.Counter()], 0
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i, sw in enumerate(sweeps):
            n_rec, n_cap = len(eng.records), eng.graphs.captures
            with warnings.catch_warnings(record=True) as ws:
                warnings.simplefilter("always")
                eng.process_sweep(sw)
            syncs = [w for w in ws if "synchroniz" in str(w.message)]
            capturing = i > 0 and eng.graphs.captures != n_cap
            captured += capturing
            drained = len(eng.records) != n_rec or capturing
            calls.append((len(syncs), drained))
            if not drained or capturing:  # [first or capturing call, later calls]
                for w in syncs:
                    sites[0 if capturing else min(i, 1)][
                        f"{pathlib.Path(w.filename).name}:{w.lineno}"] += 1
        eng.flush()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return calls, sites, captured


def pipelined_phase(cfg, sweeps, sync_eng, dev) -> dict:
    """Phase [4b]."""
    import torch

    from bshot_slam_tpu_torch.odometry.engine import SlamEngine

    def fresh(c=cfg, pipelined=True, graphs=True):
        eng = SlamEngine(c, seed=0, device=dev, pipelined=pipelined,
                         fetch_every=FETCH_EVERY, graphs=graphs)
        eng.state = eng.state._replace(map=prefilled_map(c, dev))
        return eng

    pipe = fresh()
    fps, launches = counted(lambda: drive(pipe, sweeps))
    # The census replays the first run's graphs: a capture synchronises
    # (once per key, as a compile would), a replay does not.
    census = fresh(graphs=pipe.graphs)
    calls, sites, _ = sync_census(census, sweeps)
    between = [n for n, drained in calls[1:] if not drained]
    over = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, window_cap=OVERFLOW_WINDOW))
    runs = []
    for pipelined in (False, True):
        eng = fresh(over, pipelined)
        for sw in sweeps[:12]:
            eng.process_sweep(sw)
        eng.flush()
        runs.append(eng)
    torch.cuda.synchronize()
    return dict(
        fps=fps, launches=launches, equal=records_equal(pipe.records, sync_eng.records)
        and records_equal(census.records, sync_eng.records),
        first_call_syncs=calls[0][0], first_sites=dict(sites[0]), between=between,
        syncs_per_frame=sum(between) / max(1, len(between)), sites=dict(sites[1]),
        drain_syncs=[n for n, drained in calls if drained],
        overflow_equal=records_equal(runs[0].records, runs[1].records),
        redispatched=runs[1].n_redispatched, overflow_frames=len(runs[1].records),
        eng=pipe, overflow=runs, overflow_cfg=over)


def eviction_phase(cfg, sweeps, dev) -> dict:
    """Phase [4c]: the map starts one frame short of its hard capacity, in
    dense far blocks (so eviction takes them, not the drive's own map); the
    pipelined drive graphed (its evictions replay their graph on the state
    buffers) and eager.  Then on the map after the drive: `evict_keypoints`
    on the card twice and through a `Graphs` twice (captured, replayed),
    each against the call on CPU copies, every field; and the eager and the
    graphed eviction in turns, eager, graphed, ..., REPEATS each: CUDA
    events around the call alone (the graphed call's input is copied into
    its state buffers before the event; the eager call leaves its input as
    it was)."""
    import torch

    from bshot_slam_tpu_torch.odometry import mapstore
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.odometry.graphs import Graphs

    cap, k = cfg.map.capacity, cfg.keypoints.top_k
    runs = []
    for graphs in (True, False):
        eng = SlamEngine(cfg, seed=0, device=dev, pipelined=True, fetch_every=FETCH_EVERY,
                         graphs=graphs)
        full = prefilled_map(cfg, dev, n=cap - k - 100, far=(1.9e6, 1.95e6))
        eng.state = eng.state._replace(map=full)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, launches = counted(lambda: drive(eng, sweeps[:8]))
        runs.append((eng, launches))
    (eng, launches), (eager, eager_launches) = runs
    n_evict = min(2 * k, cap // 2)
    m = mapstore.MapState(*[t.clone() for t in eng.state.map])
    whole = eng.state._replace(map=m)
    want = mapstore.evict_keypoints(mapstore.MapState(*cpu(*m)), n_evict)
    graphs = Graphs(dev)
    outs = [mapstore.evict_keypoints(m, n_evict) for _ in range(2)]
    outs += [[t.clone() for t in graphs.evict(whole, n_evict).map] for _ in range(2)]
    exact = all(torch.equal(g.cpu(), w) for out in outs for g, w in zip(out, want))
    times = {"eager": [], "graphed": []}
    bufs = graphs.state_buffers(whole)
    for _ in range(REPEATS):
        for side in ("eager", "graphed"):
            if side == "graphed":
                graphs.state_buffers(whole)  # the map before eviction, again
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            if side == "eager":
                mapstore.evict_keypoints(m, n_evict)
            else:
                graphs.evict(bufs, n_evict)
            end.record()
            end.synchronize()
            times[side].append(start.elapsed_time(end))
    return dict(n_evicted=eng.n_evicted, launches=launches, exact=exact,
                eager_evicted=eager.n_evicted, eager_launches=eager_launches,
                records_equal=record_bytes(eng) == record_bytes(eager),
                graphed_keys=[key[:3] for key in eng.graphs._graphs if key[0] == "evict"],
                cursor=int(m.cursor), evicted_now=int(m.cursor) - int(want.cursor),
                ms=statistics.median(times["eager"]),
                graphed_ms=statistics.median(times["graphed"]),
                cpu_ms=time_ms(lambda: mapstore.evict_keypoints(
                    mapstore.MapState(*cpu(*m)), n_evict), repeats=5),
                tail_inliers=[r.n_inliers for r in eng.records[-4:]])


def backend_engine(cfg, dev, graphs=True):
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine

    return SlamEngine(cfg, seed=0, device=dev, pipelined=True, fetch_every=FETCH_EVERY,
                      enable_backend=True, backend_every=BACKEND_EVERY, graphs=graphs)


# The parts of a backend pass, in order: the keyframe histograms, the
# candidate pairs' choice on the host, the pairs' verification
# (`find_loop_closures` less the histograms and the choice), the pose graph's
# build, the LM solve, and the corrections (`apply_backend_corrections`:
# interpolation, the record loop, re-anchoring, the store's update).
PARTS = ("bow", "choice", "pairs", "build", "lm", "corrections")


@contextlib.contextmanager
def timed_parts(eng):
    """Within the block, each part of eng's backend passes is timed (a
    synchronise on either side) and wrapped in a `part:<name>` profiler
    range; yields {part: [ms per call]} with `pairs` holding the nested
    calls' whole time (`pass_parts` subtracts).  The histograms and the LM
    solve are patched on the engine's `Graphs` (eager or not: the graph
    bodies call the module functions, which must not synchronise under a
    capture)."""
    import torch

    from bshot_slam_tpu_torch.backend import loop_closure

    ms = collections.defaultdict(list)

    def wrap(name, fn):
        def timed(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.record_function("part:" + name):
                out = fn(*a, **k)
                torch.cuda.synchronize()
            ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    modules = [(loop_closure, "candidate_pairs", "choice"),
               (loop_closure, "find_loop_closures", "pairs")]
    objects = [(eng, "_pose_graph", "build"), (eng, "apply_backend_corrections",
                                                "corrections"),
               (eng.graphs, "bow", "bow"), (eng.graphs, "pose_graph", "lm")]
    saved = [(m, a, getattr(m, a)) for m, a, _ in modules]
    for obj, attr, name in modules + objects:
        setattr(obj, attr, wrap(name, getattr(obj, attr)))
    try:
        yield ms
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)
        for obj, attr, _ in objects:
            delattr(obj, attr)  # the class's method again


def pass_parts(ms: dict, i: int) -> dict:
    """Part -> ms of the i-th timed pass."""
    bow, choice, find = ms["bow"][i], ms["choice"][i], ms["pairs"][i]
    return dict(bow=bow, choice=choice, pairs=find - choice - bow,
                build=ms["build"][i], lm=ms["lm"][i], corrections=ms["corrections"][i])


def part_launches(run, dev) -> dict:
    """Part -> device launches (kernels, copies and sets `torch.profiler` saw
    run on the card) of one run() inside `timed_parts`: each launch counts
    for the innermost part range its start lies in; `pairs` excludes its
    nested parts as `pass_parts` does."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.zeros(1, device=dev).add_(1)  # the warm-up step
        torch.cuda.synchronize()
        prof.step()
        run()
        torch.cuda.synchronize()
        prof.step()
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end, e.name[5:]) for e in events
              if e.device_type == DeviceType.CPU and e.name.startswith("part:")]
    counts = dict.fromkeys(PARTS, 0)
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name.startswith("part:"):
            continue  # a part's own range on the card's timeline
        inside = [r for r in ranges if r[0] <= e.time_range.start <= r[1]]
        if inside:
            counts[min(inside, key=lambda r: r[1] - r[0])[2]] += 1
    return counts


def backend_phase(cfg, sweeps, gt, dev, ckpt: str | None, graphs=True) -> dict:
    """Phase [4d]: the whole drive with the backend, each pass timed whole
    and by part (`timed_parts`) and its kernel launches counted; saved to
    `ckpt` after RESUME_AT frames (phase [5b], the save's time not counted
    in the drive's; no save without `ckpt`).  After the drive and its final
    pass, one more pass under `torch.profiler` counts each part's device
    launches."""
    import torch

    from bshot_slam_tpu_torch import checkpoint, convert
    from bshot_slam_tpu_torch.utils.metrics import ate_rmse

    eng = backend_engine(cfg, dev, graphs)
    eng.state = eng.state._replace(map=prefilled_map(cfg, dev))
    passes = []
    optimize = eng.optimize_backend
    wrappers = kernel_wrappers()

    def timed_optimize(*a, **k):
        torch.cuda.synchronize()
        before = {n: w.launches for n, w in wrappers.items()}
        t0 = time.perf_counter()
        out = optimize(*a, **k)
        torch.cuda.synchronize()
        passes.append(dict(ms=(time.perf_counter() - t0) * 1e3, **eng.backend_stats,
                           launches={n: w.launches - before[n] for n, w in wrappers.items()}))
        return out

    eng.optimize_backend = timed_optimize
    saved = {"s": 0.0}

    def run():
        for i, sw in enumerate(sweeps):
            eng.process_sweep(sw)
            if i + 1 == RESUME_AT and ckpt is not None:
                t0 = time.perf_counter()
                saved.update(passes=len(passes), pending=len(eng._pending))
                checkpoint.save_state(ckpt, eng.state, eng.poses)
                checkpoint.save_backend(ckpt, eng)
                saved["s"] = time.perf_counter() - t0
        eng.flush()

    with warnings.catch_warnings(), timed_parts(eng) as part_ms:
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        _, launches = counted(run)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - saved["s"]
        # The uninterrupted run as phase [5b] compares it, before the final pass.
        uninterrupted = dict(records=copy.deepcopy(eng.records),
                             keyframes=convert.keyframes_to_numpy(eng.keyframes),
                             state=convert.state_to_numpy(eng.state),
                             edges=list(eng.loop_edges))
        gt_pos = (np.linalg.inv(gt[0])[None] @ gt)[:, :3, 3]
        path = float(np.linalg.norm(np.diff(gt_pos, axis=0), axis=1).sum())
        ate_before = float(ate_rmse(eng.trajectory, gt_pos, align=False))
        t0 = time.perf_counter()
        eng.optimize_backend()
        corr = eng.apply_backend_corrections()
        torch.cuda.synchronize()
        final_ms = (time.perf_counter() - t0) * 1e3
        ate_after = float(ate_rmse(eng.trajectory, gt_pos, align=False))
        final = dict(records=record_bytes(eng), correction=corr,
                     keyframes=convert.keyframes_to_numpy(eng.keyframes))
        for p, parts in enumerate(passes):
            parts["parts"] = pass_parts(part_ms, p)
            parts["corr_ms"] = parts["parts"]["corrections"]
        profiled = part_launches(lambda: (eng.optimize_backend(),
                                          eng.apply_backend_corrections()), dev)
        passes.pop()  # the profiled pass: its launches only
    return dict(eng=eng, passes=passes, launches=launches, wall_s=wall,
                saved=saved, uninterrupted=uninterrupted, final=final,
                fps=len(sweeps) / wall, path_mm=path, ate_before=ate_before,
                ate_after=ate_after, final_ms=final_ms, correction=corr,
                keyframes=eng._kf_count, map_size=eng.records[-1].map_size,
                n_evicted=eng.n_evicted, part_launches=profiled,
                tail_inliers=[r.n_inliers for r in eng.records[-8:]])


def check_loop_kernels(eng, dev):
    """Kernels C and D at the loop-verification shape: two of the drive's
    keyframes, 600 keypoints against 600, as `_verify_pair` calls them."""
    import torch

    from bshot_slam_tpu_torch.geometry import se3
    from bshot_slam_tpu_torch.kernels import mapops as M

    kf = eng.keyframes
    a, am, b, bm = (kf.descriptors[0], kf.kp_mask[0], kf.descriptors[1], kf.kp_mask[1])
    K = a.shape[0]
    rel = se3.compose(se3.inverse(kf.poses[1]), kf.poses[0])
    q = se3.apply(rel, kf.keypoints[0]).contiguous()
    r = kf.keypoints[1].contiguous()
    ca, cam, cb, cbm, cq, cr = cpu(a, am, b, bm, q, r)
    pairs = float(cam.sum()) * float(cbm.sum())
    rows = {}
    got = M.hamming_nn_bounded(a, am, b, bm, K)
    again = M.hamming_nn_bounded(a, am, b, bm, K)
    want = M.hamming_nn_bounded_plain(ca, cam, cb, cbm, K)
    card = M.hamming_nn_bounded_plain(a, am, b, bm, K)
    b_ms, b_by = bound(2 * K * 45 + 2 * K * 8, scaled(M.HAMMING_PAIR_OPS, pairs))
    rows["hamming_nn_bounded"] = dict(
        int_mismatch=sum(int_mismatch(g, w) for g, w in zip(got, want)),
        card_plain_rows_differ=int_mismatch(got[1], card[1]) + int_mismatch(got[3], card[3]),
        deterministic=same_bits(got, again),
        max_abs_err=float(max((g.cpu() - w).abs().max() for g, w in
                              ((got[0], want[0]), (got[2], want[2])))),
        **measure(lambda: M.hamming_nn_bounded(a, am, b, bm, K),
                  lambda: M.hamming_nn_bounded_plain(a, am, b, bm, K)),
        bound_ms=b_ms, bound_by=b_by, shapes=f"a ({K},11) vs b ({K},11), {pairs:.0f} valid pairs")
    got = M.euclid_nn_bounded(q, am, r, bm, K)
    again = M.euclid_nn_bounded(q, am, r, bm, K)
    want = M.euclid_nn_bounded_plain(cq, cam, cr, cbm, K)
    card = M.euclid_nn_bounded_plain(q, am, r, bm, K)
    b_ms, b_by = bound(2 * K * 13 + K * 8, scaled(M.EUCLID_PAIR_OPS, pairs))
    rows["euclid_nn_bounded"] = dict(
        int_mismatch=int_mismatch(got[1], want[1]) + int_mismatch(got[0], want[0]),
        card_plain_rows_differ=int_mismatch(got[1], card[1]),
        deterministic=same_bits(got, again),
        max_abs_err=float((got[0].cpu() - want[0]).abs().max()),
        **measure(lambda: M.euclid_nn_bounded(q, am, r, bm, K),
                  lambda: M.euclid_nn_bounded_plain(q, am, r, bm, K)),
        bound_ms=b_ms, bound_by=b_by, shapes=f"q ({K},3) vs ref ({K},3), {pairs:.0f} valid pairs")
    torch.cuda.synchronize()
    return rows


# ---------------------------------------------------------------------------
# Phases 5-6: host ingest, checkpoint / resume, the bench


def ingest_phase(cfg, sweeps) -> dict:
    """Phase [5], host side: each frame's range image, the numpy plain
    version of classify + extract and the native one, timed apart (ms per
    frame), and compared: classes cell-exact, kept counts equal, points."""
    from bshot_slam_tpu_torch.io import native_decoder as nd
    from bshot_slam_tpu_torch.ops import preprocess_host as ph
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image

    mp, pcfg = cfg.preprocess.max_points, cfg.preprocess
    t_ri = t_np = t_nat = 0.0
    cls_bad = count_bad = 0
    max_pt = 0.0
    for sw in sweeps:
        t0 = time.perf_counter()
        ri = build_range_image(sw, cfg.sensor)
        t1 = time.perf_counter()
        cl, xyz, valid = ph.preprocess_host(ri.range_mm, ri.azimuth_rad, ri.vert_rad, pcfg)
        pts, nv = ph.extract_cloud_host(cl, xyz, valid, ri.selected, mp)
        t2 = time.perf_counter()
        pts_n, nv_n, cl_n = nd.preprocess_extract_native(
            ri.range_mm, ri.azimuth_rad, ri.vert_rad, pcfg, ri.selected, mp)
        t3 = time.perf_counter()
        t_ri, t_np, t_nat = t_ri + t1 - t0, t_np + t2 - t1, t_nat + t3 - t2
        cls_bad += int((cl_n != cl).sum())
        count_bad += int(nv_n != nv)
        if nv_n == nv and nv:
            max_pt = max(max_pt, float(np.abs(pts_n - pts).max()))
    n = len(sweeps)
    return dict(frames=n, range_image_ms=t_ri / n * 1e3, numpy_ms=t_np / n * 1e3,
                native_ms=t_nat / n * 1e3, class_cells_differ=cls_bad,
                frames_count_differs=count_bad, max_point_mm=max_pt)


def pcap_phase(cfg, sweeps, sync_eng, dev, path: str) -> dict:
    """Phase [5], PCAP round trip: the sweeps encoded as Velodyne packets,
    written, read back by NativeSweepStream and run through the synchronous
    engine on the prefilled map; poses against phase [4]'s run."""
    from bshot_slam_tpu_torch.io import native_decoder as nd
    from bshot_slam_tpu_torch.io import pcap, velodyne
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine

    pcap.write_udp_payloads(path, velodyne.encode_packets(sweeps, cfg.sensor))
    eng = SlamEngine(cfg, seed=0, device=dev)
    eng.state = eng.state._replace(map=prefilled_map(cfg, dev))
    with nd.NativeSweepStream(path, cfg.sensor) as stream:
        _, launches = counted(lambda: [eng.process_frame(ri) for ri in stream])
    n = len(eng.records)
    got = np.stack([r.pose for r in eng.records])
    want = np.stack([r.pose for r in sync_eng.records[:n]])
    return dict(frames=n, launches=launches,
                max_mm=float(np.abs(got[:, :3, 3] - want[:, :3, 3]).max()),
                max_rot=float(np.abs(got[:, :3, :3] - want[:, :3, :3]).max()),
                tail_inliers=[r.n_inliers for r in eng.records[-8:]],
                map_size=eng.records[-1].map_size)


def resume_phase(cfg, sweeps, bk: dict, dev, ckpt: str) -> dict:
    """Phase [5b]: a fresh engine resumed from phase [4d]'s checkpoint drives
    the rest of the drive; compared with the uninterrupted run."""
    from bshot_slam_tpu_torch import checkpoint, convert

    eng = backend_engine(cfg, dev)
    eng.state, prior = checkpoint.load_state(ckpt, device=dev)
    eng._place_state()
    if not checkpoint.load_backend(ckpt, eng):
        raise SmokeError("no backend checkpoint was written")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, launches = counted(lambda: [eng.process_sweep(sw) for sw in sweeps[RESUME_AT:]]
                              + [eng.flush()])
    want = bk["uninterrupted"]
    kf = convert.keyframes_to_numpy(eng.keyframes)
    st = convert.state_to_numpy(eng.state)

    def edge(e):
        return (e.kf_i, e.kf_j, e.n_inliers, e.rmse_mm, np.asarray(e.z).tobytes())

    return dict(
        prior=len(prior), frames=len(eng.records), launches=launches,
        records_equal=records_equal(eng.records, want["records"][RESUME_AT:]),
        keyframes_equal=all(np.array_equal(kf[f], want["keyframes"][f]) for f in kf),
        state_equal=all(np.array_equal(st[f], want["state"][f]) for f in st),
        edges_equal=[edge(e) for e in eng.loop_edges] == [edge(e) for e in want["edges"]],
        closures=len(eng.loop_edges))


def bench_phase(cfg, sweeps, gt, dev) -> dict:
    """Phase [6]: bench_torch's engine pass over the rendered drive, one warm
    pass and one timed pass."""
    import bench_torch

    _, warm = bench_torch.engine_pass(cfg, sweeps, dev)
    (fps, eng), launches = counted(lambda: bench_torch.engine_pass(cfg, sweeps, dev,
                                                                  warm.graphs))
    q = bench_torch.quality(cfg, eng, gt)
    return dict(line=bench_torch.headline(fps, q), launches=launches, fps=fps, **q,
                map_size=eng.records[-1].map_size, inliers=eng.records[-1].n_inliers,
                redispatched=eng.n_redispatched, eng=eng,
                captures=warm.graphs.captures, capture_s=warm.graphs.capture_s)


def reference_drive(cfg, eng, gt) -> dict:
    """Phase [6] against the JAX package: the bench pass's records against
    the reference's run of the same drive on the CPU with exact top-k
    (`tests/fixtures/torch_jax_drive.npz`, written by
    tests/torch_reference_drive.py; read with numpy alone).  Per frame after
    the first, the difference of the two relative motions (translation mm,
    rotation degrees); the first frame where it exceeds REL_MM or REL_DEG;
    each side's ATE against ground truth and the ATE between them.
    `config_equal`: the fixture's configuration is this run's, the port's
    top-k being exact; `drive_equal`: its arguments and ground truth are
    this drive's."""
    import bench_torch
    from bshot_slam_tpu_torch.utils.metrics import ate_rmse

    with np.load(REFERENCE_DRIVE) as z:
        ref = {k: z[k] for k in z.files}
    meta = json.loads(str(ref["meta"]))
    ours = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime,
                                                                exact_topk=True))
    config_equal = json.loads(json.dumps(dataclasses.asdict(ours))) == meta["config"]
    a = meta["args"]
    drive_equal = bool(
        (a["n_frames"], a["prefill"], a["fetch_every"], a["pipelined"], a["backend"])
        == (len(gt), bench_torch.PREFILL_LANDMARKS, bench_torch.FETCH_EVERY, True, False)
        and np.abs(ref["gt"] - gt).max() < 1e-6)

    def motions(P):
        P = P.astype(np.float64)
        return np.linalg.inv(P[:-1]) @ P[1:]

    d = np.linalg.inv(motions(ref["poses"])) @ motions(np.stack([r.pose for r in eng.records]))
    mm = np.linalg.norm(d[:, :3, 3], axis=1)
    cos = np.clip((np.trace(d[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1.0, 1.0)
    deg = np.degrees(np.arccos(cos))
    over = np.nonzero((mm > REL_MM) | (deg > REL_DEG))[0]
    gt_pos = (np.linalg.inv(gt[0])[None] @ gt)[:, :3, 3]
    ref_traj = ref["poses"][:, :3, 3].astype(np.float64)
    return dict(
        config_equal=config_equal, drive_equal=drive_equal,
        mm_median=float(np.median(mm)), mm_max=float(mm.max()),
        deg_median=float(np.median(deg)), deg_max=float(deg.max()),
        first_over=None if not len(over) else int(over[0]) + 1,
        ate_card=float(ate_rmse(eng.trajectory, gt_pos, align=False)),
        ate_ref=float(ate_rmse(ref_traj, gt_pos, align=False)),
        ate_between=float(ate_rmse(eng.trajectory, ref_traj, align=False)),
        inliers_card=[r.n_inliers for r in eng.records], inliers_ref=ref["inliers"].tolist(),
        cursor_card=int(eng.state.map.cursor), cursor_ref=int(ref["cursor"]))


# ---------------------------------------------------------------------------
# Phases 7-8: the device preprocess, the evaluation ops


def walk_phase(cfg, sweeps, dev) -> dict:
    """Phase [7], kernel F over the drive: each frame's range image on the
    card, F against its plain version run on the card (cell-exact) and
    against itself (bit-identical); the fused clouds against the native
    host ingest (`host_cloud`); then F's and the fused ingest's times on
    frame 3."""
    import torch

    from bshot_slam_tpu_torch.kernels import preprocess as KF
    from bshot_slam_tpu_torch.odometry import pipeline
    from bshot_slam_tpu_torch.odometry.engine import host_cloud
    from bshot_slam_tpu_torch.ops import preprocess as pp
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image
    from bshot_slam_tpu_torch.utils import profiling

    pcfg = cfg.preprocess
    differ = not_identical = count_differs = max_err = 0
    max_pt = 0.0
    for sw in sweeps:
        ri = build_range_image(sw, cfg.sensor)
        r, az, v = (torch.as_tensor(x, device=dev)
                    for x in (ri.range_mm, ri.azimuth_rad, ri.vert_rad))
        xyz, p0 = pp.polar_to_xyz(r, az, v), pp.ground_point(az, pcfg)
        got = KF.ground_walk(r, xyz, p0, pcfg)
        want = KF.ground_walk_plain(r, xyz, p0, pcfg)
        differ += int_mismatch(got, want)
        max_err = max(max_err, int((got - want).abs().max()))
        not_identical += int(not torch.equal(got, KF.ground_walk(r, xyz, p0, pcfg)))
        pts, _, nv = pipeline.ingest(r, az, v, None, pcfg, pcfg.max_points)
        host, nv_host = host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad, None, cfg)
        if int(nv) != nv_host:
            count_differs += 1
        elif nv_host:
            max_pt = max(max_pt, float((pts[:nv_host].cpu()
                                        - torch.from_numpy(host[:nv_host])).abs().max()))
    ri = build_range_image(sweeps[3], cfg.sensor)
    r, az, v = (torch.as_tensor(x, device=dev)
                for x in (ri.range_mm, ri.azimuth_rad, ri.vert_rad))
    R, A = r.shape

    def ingest():
        return pipeline.ingest(r, az, v, None, pcfg, pcfg.max_points)

    ingest_device_ms, ingest_launches = profiling.device_profile(ingest)
    row = walk_row(cfg, sweeps[3], dev)
    row["max_abs_err"] = float(max(max_err, row["max_abs_err"]))
    return dict(frames=len(sweeps), cells=R * A * len(sweeps), cells_differ=differ,
                not_identical=not_identical, count_differs=count_differs,
                max_point_mm=max_pt, row=row, ingest_ms=time_ms(ingest),
                ingest_device_ms=ingest_device_ms, ingest_launches=ingest_launches)


def walk_row(cfg, sweep, dev) -> dict:
    """Kernel F's row on one frame's range image: against its plain version
    on the card (cells differing), its times and its bound."""
    import torch

    from bshot_slam_tpu_torch.kernels import preprocess as KF
    from bshot_slam_tpu_torch.ops import preprocess as pp
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image

    pcfg = cfg.preprocess
    ri = build_range_image(sweep, cfg.sensor)
    r, az, v = (torch.as_tensor(x, device=dev)
                for x in (ri.range_mm, ri.azimuth_rad, ri.vert_rad))
    xyz, p0 = pp.polar_to_xyz(r, az, v), pp.ground_point(az, pcfg)
    R, A = r.shape
    got, want = KF.ground_walk(r, xyz, p0, pcfg), KF.ground_walk_plain(r, xyz, p0, pcfg)
    differ = int_mismatch(got, want)
    b_ms, b_by = bound(R * A * 20 + A * 12, scaled(KF.GROUND_WALK_CELL_OPS, R * A))
    return dict(name="ground_walk", shapes=f"range ({R},{A}), xyz ({R},{A},3), p0 ({A},3)",
                source="bshot_slam_tpu_torch/csrc/preprocess.cu",
                replaces="bshot_slam_tpu/ops/preprocess.py:152 (lax.scan; no pallas_call)",
                max_abs_err=float((got - want).abs().max()), int_mismatch=differ,
                float_out_of_tol=0, card_plain_rows_differ=differ,
                **measure(lambda: KF.ground_walk(r, xyz, p0, pcfg),
                          lambda: KF.ground_walk_plain(r, xyz, p0, pcfg)),
                bound_ms=b_ms, bound_by=b_by, library_ms=None)


def fused_phase(cfg, sweeps, sync_eng, dev) -> dict:
    """Phase [7], the engine with the device preprocess on [4]'s frames and
    prefill: synchronous (poses against [4]'s run) and pipelined
    (`fetch_every=8`, records bit-identical to the synchronous ones),
    frames/s of both, the kernels' launches."""
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine

    def fresh(pipelined):
        return fused_engine(cfg, dev, pipelined)

    sync, pipe = fresh(False), fresh(True)
    fps, launches = counted(lambda: drive(sync, sweeps))
    pipe_fps, pipe_launches = counted(lambda: drive(pipe, sweeps))
    got = np.stack([r.pose for r in sync.records])
    want = np.stack([r.pose for r in sync_eng.records])
    return dict(fps=fps, pipe_fps=pipe_fps, launches=launches,
                pipe_launches=pipe_launches,
                equal=records_equal(pipe.records, sync.records),
                redispatched=pipe.n_redispatched,
                max_mm=float(np.abs(got[:, :3, 3] - want[:, :3, 3]).max()),
                max_rot=float(np.abs(got[:, :3, :3] - want[:, :3, :3]).max()),
                tail_inliers=[r.n_inliers for r in sync.records[-8:]],
                sync=sync, pipe=pipe)


def fused_engine(cfg, dev, pipelined, graphs=True):
    """Phase [7]'s fused engine on the prefilled map."""
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine

    eng = SlamEngine(cfg, seed=0, device=dev, host_preprocess=False, pipelined=pipelined,
                     fetch_every=FETCH_EVERY, graphs=graphs)
    eng.state = eng.state._replace(map=prefilled_map(cfg, dev))
    return eng


def spike_phase(cfg, dev, graphs=True) -> dict:
    """Phase [7], a kept-count spike at full width: SPIKE_FRAMES range images
    with SPIKE_BASE kept points and SPIKE at frame SPIKE_AT (walls on the
    upper rings; the other frames pad with self-car returns), through the
    synchronous and the pipelined (`fetch_every=4`) fused engines; the spike
    overflows its predicted bucket, and the frames after it run at a
    predicted bucket above their exact one."""
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from tests.torch_kernel_cases import overflow_sequence

    frames = overflow_sequence(cfg, SPIKE_BASE, SPIKE, SPIKE_FRAMES, SPIKE_AT)
    vert = np.deg2rad(np.sort(np.asarray(cfg.sensor.vertical_angles_deg))).astype(np.float32)
    buckets = []

    def recording(fn, at):  # the bucket each pipelined fused dispatch runs at
        def call(*args):
            buckets.append(args[at])
            return fn(*args)
        return call

    runs, launches = [], {}
    for pipelined in (False, True):
        eng = SlamEngine(cfg, seed=0, device=dev, host_preprocess=False,
                         pipelined=pipelined, fetch_every=4, graphs=graphs)
        eng.graphs.fused = recording(eng.graphs.fused, 5)
        _, launches[pipelined] = counted(
            lambda: [eng.process_range_image(r, az, vert) for r, az in frames]
            + [eng.flush()])
        runs.append(eng)
    return dict(frames=len(frames), equal=records_equal(runs[1].records, runs[0].records),
                redispatched=runs[1].n_redispatched, buckets=buckets,
                launches=launches[True], map_size=runs[0].records[-1].map_size,
                runs=runs)


def eval_phase(cfg, sweeps, dev) -> dict:
    """Phase [8]: two drive frames' clouds from the device preprocess at
    their exact buckets; kernel A at the ISS salient radius against its
    plain version on CPU copies (as phase [3]); `iss_keypoints` on the card
    against the CPU port's; `repeatability` between the frames, card and
    CPU; `voxel_downsample` twice on the card and once on the CPU."""
    import torch

    from bshot_slam_tpu_torch.kernels import neighborhood as K
    from bshot_slam_tpu_torch.odometry import pipeline
    from bshot_slam_tpu_torch.odometry.engine import pick_bucket
    from bshot_slam_tpu_torch.ops import keypoints, voxelgrid
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image

    pcfg, kcfg = cfg.preprocess, cfg.keypoints
    clouds = []
    for sw in sweeps:
        ri = build_range_image(sw, cfg.sensor)
        pts, pmask, nv = pipeline.ingest(
            *(torch.as_tensor(x, device=dev) for x in (ri.range_mm, ri.azimuth_rad,
                                                      ri.vert_rad)),
            None, pcfg, pcfg.max_points)
        b = pick_bucket(int(nv), cfg)
        clouds.append((pts[:b], pmask[:b]))
    pts, mask = clouds[0]
    r = kcfg.iss_salient_radius_mm
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    feat = torch.stack([torch.ones_like(x), x, y, z, x * x, x * y, x * z,
                        y * y, y * z, z * z], dim=-1).contiguous()
    out = K.neighborhood_accumulate(pts, mask, feat, r)
    pts_c, mask_c, feat_c = cpu(pts, mask, feat)
    ref = K.neighborhood_accumulate_plain(pts_c, mask_c, feat_c, r)
    cnt = ref[:, 0]
    scale = cnt[:, None] * feat_c.abs().max(dim=0).values[None, :]
    atol = torch.tensor([0.0, 1e-2, 1e-2, 1e-2] + [100.0] * 6)
    err = (out.cpu() - ref).abs()
    kps, launches = counted(lambda: [keypoints.iss_keypoints(p, m, kcfg) for p, m in clouds])
    kps_cpu = [keypoints.iss_keypoints(*cpu(p, m), kcfg) for p, m in clouds]
    n_card = [int(k.mask.sum()) for k in kps]
    n_cpu = [int(k.mask.sum()) for k in kps_cpu]
    common = [len(np.intersect1d(k.indices[:n].cpu().numpy(), c.indices[:m].numpy()))
              for k, c, n, m in zip(kps, kps_cpu, n_card, n_cpu)]
    rep = float(keypoints.repeatability(kps[1].positions, kps[1].mask, kps[0].positions,
                                        kps[0].mask, kcfg.repeat_radius_mm))
    rep_cpu = float(keypoints.repeatability(kps_cpu[1].positions, kps_cpu[1].mask,
                                            kps_cpu[0].positions, kps_cpu[0].mask,
                                            kcfg.repeat_radius_mm))
    vox = [voxelgrid.voxel_downsample(pts, mask, 200.0) for _ in range(2)]
    vox_cpu = voxelgrid.voxel_downsample(pts_c, mask_c, 200.0)
    return dict(
        shapes=f"points ({pts.shape[0]},3) n_valid {int(mask.sum())}, radius {r} mm",
        count_mismatch=int_mismatch(out[:, 0], cnt),
        float_out_of_tol=int((err > 1e-5 * scale + atol).any(dim=1).sum()),
        in_radius=float(cnt.sum()),
        a_ms=time_ms(lambda: K.neighborhood_accumulate(pts, mask, feat, r)),
        a_plain_ms=time_ms(lambda: K.neighborhood_accumulate_plain(pts, mask, feat, r)),
        iss_ms=time_ms(lambda: keypoints.iss_keypoints(pts, mask, kcfg), repeats=5),
        n_card=n_card, n_cpu=n_cpu, common=common, repeat=rep, repeat_cpu=rep_cpu,
        launches=launches, vox_identical=same_bits(vox[0], vox[1]),
        vox_equal_cpu=all(torch.equal(a.cpu(), b) for a, b in zip(vox[0], vox_cpu)),
        voxels=int(vox[0][1].sum()))


# ---------------------------------------------------------------------------
# Phase 9: the mesh on the card

# (ranks, process-group backend) of phase [9]: ranks share cuda:0, where
# NCCL refuses a duplicate GPU, so more than one rank runs gloo.
MESH_RUNS = ((1, "nccl"), (2, "gloo"), (4, "gloo"))


def record_bytes(eng) -> list:
    """An engine's records as plain tuples, every float by its bits."""
    return [(r.pose.tobytes(), r.n_inliers, r.n_mutual, r.gated, r.map_size,
             np.float64(r.icp_rmse).tobytes(), r.corr_stats.tobytes(), r.n_dropped)
            for r in eng.records]


def ba_problem(seed: int = 9, M: int = 6, L: int = 40):
    """A bundle adjustment of M keyframes on a circle observing L landmarks
    (5 mm noise), from drifted poses and displaced landmarks (numpy)."""
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(M) / M
    gt = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    gt[:, 0, 0], gt[:, 0, 1], gt[:, 1, 0], gt[:, 1, 1] = (
        np.cos(th), -np.sin(th), np.sin(th), np.cos(th))
    gt[:, 0, 3], gt[:, 1, 3] = 8000.0 * (1 - np.cos(th)), 8000.0 * np.sin(th)
    lm = rng.uniform(-15000, 15000, (L, 3)).astype(np.float32)
    lm[:, 2] = rng.uniform(0, 4000, L)
    kf, li = np.repeat(np.arange(M), L), np.tile(np.arange(L), M)
    inv = np.linalg.inv(gt)
    obs = (np.einsum("oij,oj->oi", inv[kf, :3, :3], lm[li]) + inv[kf, :3, 3]
           + rng.normal(0, 5.0, (M * L, 3)))
    noisy = gt.copy()
    for i in range(1, M):  # drift: a small yaw and offset per step, integrated
        a = rng.normal(0, 0.005)
        d = np.eye(4)
        d[:2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        d[:3, 3] = rng.normal(0, 80.0, 3)
        noisy[i] = noisy[i - 1] @ (np.linalg.inv(gt[i - 1]) @ gt[i]) @ d
    return dict(poses=noisy.astype(np.float32),
                landmarks=(lm + rng.normal(0, 150.0, (L, 3))).astype(np.float32),
                obs_kf=kf.astype(np.int32), obs_lm=li.astype(np.int32),
                obs_p=obs.astype(np.float32), obs_mask=np.ones(M * L, bool))


def mesh_rank(rank: int, cfg, sweeps, evict: bool, ba) -> dict:
    """One rank of phase [9]: the engine over the mesh (`make_mesh` of the
    process group) on the 24 frames and prefill, synchronous (kernel
    launches, collectives and time counted) and pipelined (synchronising
    calls between drains counted); with `evict`, [4c]'s eviction drive;
    with `ba`, the sharded bundle adjustment of that problem, three solves
    through the mesh's `Graphs` and three eager.  Where the collectives can
    be captured (NCCL) the engines are graphed, and the synchronous drive
    runs eager, graphed, graphed, eager, and the pipelined one graphed and
    eager; on gloo every engine is eager and each drive runs once."""
    import torch

    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.odometry.graphs import Graphs
    from bshot_slam_tpu_torch.parallel import comm, layout, sharded

    stage = [("start", time.perf_counter())]
    mesh = sharded.make_mesh()
    axes = sharded.mesh_axes(mesh)
    dev = sharded.mesh_device(mesh)
    cap, k = cfg.map.capacity, cfg.keypoints.top_k
    graphed = comm.capturable(dev, axes)

    def fresh(prefill=None, **kw):
        eng = SlamEngine(cfg, seed=0, mesh=mesh, **kw)
        if prefill is None:
            prefill = prefilled_map(cfg, "cpu")
        eng.state = eng.state._replace(map=prefill)
        eng._place_state()
        return eng

    def synchronous(graphs: bool) -> dict:
        eng = fresh(graphs=graphs)
        wrappers = kernel_wrappers()
        for w in wrappers.values():
            w.launches = 0
        comm.reset_counts()
        times, steady = [], []
        for i, sw in enumerate(sweeps):
            n_cap = eng.graphs.captures
            t0 = time.perf_counter()
            eng.process_sweep(sw)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            if i and eng.graphs.captures == n_cap:
                steady.append(times[-1])
        coll = comm.counts()
        return dict(eng=eng, fps=(len(times) - 1) / sum(times[1:]),
                    steady_fps=len(steady) / sum(steady), steady_frames=len(steady),
                    launches={n: w.launches for n, w in wrappers.items()},
                    calls_per_frame=sum(c["calls"] for c in coll.values()) / len(sweeps),
                    bytes_per_frame=sum(c["bytes"] for c in coll.values()) / len(sweeps),
                    sites={n: (c["calls"] / len(sweeps), c["bytes"] / len(sweeps))
                           for n, c in coll.items()})

    sides = ("eager", "graphed", "graphed", "eager") if graphed else ("eager",)
    sync = {"eager": [], "graphed": []}
    for side in sides:
        sync[side].append(synchronous(side == "graphed"))
    stage.append(("synchronous", time.perf_counter()))
    main = sync["graphed" if graphed else "eager"][0]
    eng = main["eng"]
    bucket = frame_cloud(cfg, sweeps[-1])[0].shape[0]
    out = dict(
        mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
        backends={n: comm.Axis.of(mesh, n).backend for n in mesh.mesh_dim_names},
        graphed=not eng.graphs.eager, records=record_bytes(eng),
        fps={side: [r["fps"] for r in rs] for side, rs in sync.items()},
        steady_fps={side: [r["steady_fps"] for r in rs] for side, rs in sync.items()},
        steady_frames=main["steady_frames"],
        launches=main["launches"], map_rows=eng.state.map.positions.shape[0],
        live_rows=int(layout.local_live_rows(eng.state.map.cursor, axes.map)),
        query_rows=layout.data_rows(bucket, axes.data)[0], bucket=bucket,
        **{key: main[key] for key in ("calls_per_frame", "bytes_per_frame", "sites")},
        captures=eng.graphs.captures, capture_s=eng.graphs.capture_s,
        pool_bytes=pool_bytes(eng.graphs) if graphed else None)
    if graphed:
        eager = sync["eager"][0]
        out.update(
            records_eager=record_bytes(eager["eng"]),
            launches_equal=all(r["launches"] == eager["launches"]
                               for rs in sync.values() for r in rs),
            collectives_equal=all(
                (r["calls_per_frame"], r["bytes_per_frame"], r["sites"])
                == (eager["calls_per_frame"], eager["bytes_per_frame"], eager["sites"])
                for rs in sync.values() for r in rs),
            records_all_equal=all(record_bytes(r["eng"]) == out["records"]
                                  for rs in sync.values() for r in rs))
    for rs in sync.values():  # their graphs and pools go before the next drives
        for r in rs:
            r.pop("eng")
    del eng, main
    census = fresh(pipelined=True, fetch_every=FETCH_EVERY)
    calls, sites, captured = sync_census(census, sweeps)
    stage.append(("pipelined", time.perf_counter()))
    between = [n for n, drained in calls[1:] if not drained]
    out.update(pipe_records=record_bytes(census),
               syncs_per_frame=sum(between) / max(1, len(between)),
               sync_sites=dict(sites[1]), census_captured=captured)
    del census
    if graphed:
        pipe_eager = fresh(pipelined=True, fetch_every=FETCH_EVERY, graphs=False)
        drive(pipe_eager, sweeps)
        out["pipe_records_eager"] = record_bytes(pipe_eager)
        del pipe_eager
        stage.append(("pipelined eager", time.perf_counter()))
    if evict:
        full = prefilled_map(cfg, "cpu", n=cap - k - 100, far=(1.9e6, 1.95e6))
        ev = fresh(prefill=full, pipelined=True, fetch_every=FETCH_EVERY)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            drive(ev, sweeps[:8])
        out.update(evict_records=record_bytes(ev), n_evicted=ev.n_evicted,
                   evict_graphed=any(key[0] == "evict" for key in ev.graphs._graphs))
        del ev
        stage.append(("eviction", time.perf_counter()))
    if ba is not None:
        from bshot_slam_tpu_torch.backend.ba import BAProblem
        from tests.torch_kernel_cases import ba_within

        prob = BAProblem(**{n: torch.from_numpy(v).to(dev) for n, v in ba.items()})
        solves = {"graphed": [], "eager": []}
        for side in ("graphed", "eager") * 3:
            g = None if side == "graphed" else Graphs(dev, eager=True)
            solves[side].append(sharded.sharded_ba_solve(
                mesh, prob, gn_iterations=3, cg_iterations=15, graphs=g))
        near = [ba_within(r, solves["eager"]) for r in solves["graphed"]]
        first = solves["graphed"][0]
        out.update(ba={n: v.cpu().numpy() for n, v in first._asdict().items()},
                   ba_graphed=not sharded.ba_graphs(mesh).eager,
                   ba_captures=sharded.ba_graphs(mesh).captures,
                   ba_near=[max(x) for x in zip(*[d for d, _ in near])],
                   ba_within=all(w for _, w in near))
        stage.append(("BA", time.perf_counter()))
    out["stage_s"] = {b[0]: b[1] - a[1] for a, b in zip(stage, stage[1:])}
    out["started"] = time.time()
    return out


def mesh_phase(cfg, sweeps, dev) -> dict:
    """Phase [9]: single-device references with `mesh_runtime_overrides`
    (synchronous on the 24 frames and prefill, [4c]'s eviction drive, the
    dense bundle adjustment); kernels A and B over each data rank's query
    range at the main path's shapes against the launch over every row;
    then `mesh_rank` on 1 (NCCL: graphed and eager), 2 and 4 (gloo: eager)
    ranks sharing cuda:0, the eviction drive and the bundle adjustment at
    1 and 2."""
    import torch

    from bshot_slam_tpu_torch.backend.ba import BAProblem, ba_solve
    from bshot_slam_tpu_torch.kernels import neighborhood as nb
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.ops import keypoints
    from bshot_slam_tpu_torch.parallel import multihost, sharded

    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    one = sharded.mesh_runtime_overrides(cfg, 1)

    def single(prefill, pipelined=False, frames=sweeps):
        eng = SlamEngine(one, seed=0, device=dev, pipelined=pipelined,
                         fetch_every=FETCH_EVERY)
        eng.state = eng.state._replace(map=prefill)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fps = drive(eng, frames)
        return eng, fps

    ref, ref_fps = single(prefilled_map(one, dev))
    cap, k = cfg.map.capacity, cfg.keypoints.top_k
    ref_ev, _ = single(prefilled_map(one, dev, n=cap - k - 100, far=(1.9e6, 1.95e6)),
                       pipelined=True, frames=sweeps[:8])
    ba = ba_problem()
    dense = ba_solve(BAProblem(**{n: torch.from_numpy(v).to(dev) for n, v in ba.items()}),
                     gn_iterations=3, cg_iterations=15)
    dense = {n: v.cpu().numpy() for n, v in dense._asdict().items()}

    points, nv = frame_cloud(cfg, sweeps[3])
    pts = torch.from_numpy(points).to(dev)
    mask = torch.arange(pts.shape[0], device=dev) < nv
    feat = keypoints.moment_features(pts)
    r = cfg.keypoints.radius_mm
    full_a = nb.neighborhood_accumulate(pts, mask, feat, r)
    ctvec = pts - full_a[:, 1:4] / torch.clamp(full_a[:, 0], min=1.0)[:, None]
    full_b = nb.segratio_accumulate(pts, mask, ctvec, r)
    n, ranges, equal = pts.shape[0], [], True
    for parts in (2, 4):
        per = -(-n // (nb.PLAIN_ROWS * parts)) * nb.PLAIN_ROWS
        for q0 in range(0, n, per):
            q1 = min(q0 + per, n)
            a = nb.neighborhood_accumulate(pts, mask, feat, r, rows=(q0, q1))
            b = nb.segratio_accumulate(pts, mask, ctvec[q0:q1].contiguous(), r,
                                       rows=(q0, q1))
            equal &= same_bits((a, b), (full_a[q0:q1], full_b[q0:q1]))
            ranges.append((q0, q1))
    torch.cuda.synchronize()

    runs = {}
    for ranks, backend in MESH_RUNS:
        t0, wall0 = time.perf_counter(), time.time()
        out = multihost.spawn_local(
            mesh_rank, ranks, args=(cfg, sweeps, ranks <= 2,
                                    ba if ranks <= 2 else None),
            backend=backend, device="cuda", timeout=600)
        runs[ranks] = dict(backend=backend, s=time.perf_counter() - t0, out=out,
                           start_s=max(o["started"] - sum(o["stage_s"].values())
                                       for o in out) - wall0)
    return dict(compute_mode=mode, ref=record_bytes(ref), ref_fps=ref_fps,
                ref_ev=record_bytes(ref_ev),
                ref_evicted=ref_ev.n_evicted, dense=dense, range_equal=equal,
                ranges=ranges, bucket=n, runs=runs)


# ---------------------------------------------------------------------------
# Phase 11: the steps replayed from CUDA graphs against the eager steps


def parts_line(parts: dict) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in parts.items())


def mean_parts(passes: list) -> dict:
    """Part -> mean ms a pass over the passes that verified pairs (the
    first pass verifies none)."""
    ps = [p["parts"] for p in passes if p["verified"]] or [p["parts"] for p in passes]
    return {k: sum(p[k] for p in ps) / len(ps) for k in PARTS}


def final_bytes(bk: dict):
    """A backend drive's state after its final pass: records, the
    corrections' summary and the keyframe store, every float by its bits."""
    f = bk["final"]
    return (f["records"], repr(f["correction"]),
            [(k, v.tobytes()) for k, v in sorted(f["keyframes"].items())])


def pool_bytes(graphs) -> int | None:
    """Bytes the card holds in the graphs' shared memory pool (its segments
    stay reserved while the graphs live, so this is the pool's peak), from
    the allocator's snapshot; None where the snapshot does not name pools."""
    import torch

    segs = torch.cuda.memory._snapshot()["segments"]
    if not segs or "segment_pool_id" not in segs[0]:
        return None
    pool = tuple(graphs.pool)
    return sum(sg["total_size"] for sg in segs if tuple(sg["segment_pool_id"]) == pool)


def in_turns(make, frames, warm) -> dict:
    """Eager, graphed, graphed, eager: `make(graphs)` builds a fresh engine
    (`graphs=False`, or `warm`, an earlier graphed engine's `Graphs`, whose
    captures the graphed runs replay), `frames(eng)` drives it (flush
    included).  Frames/s and launches a frame of each run, and each side's
    last engine, which counts its re-runs through the dense step
    (`run_dense_calls`)."""
    import torch

    out = {"eager": [], "graphed": []}
    for side in ("eager", "graphed", "graphed", "eager"):
        eng = make(False if side == "eager" else warm)
        eng.run_dense_calls = 0

        def counting(*a, eng=eng, method=eng._run_dense):
            eng.run_dense_calls += 1
            return method(*a)

        eng._run_dense = counting
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n, launches = counted(lambda: frames(eng))
        torch.cuda.synchronize()
        out[side].append(dict(fps=n / (time.perf_counter() - t0), launches=launches,
                              per_frame=sum(launches.values()) / n))
        out[side + "_eng"] = eng
    out["records_equal"] = record_bytes(out["graphed_eng"]) == record_bytes(out["eager_eng"])
    out["launches_equal"] = all(g["launches"] == e["launches"]
                                for g, e in zip(out["graphed"], out["eager"]))
    return out


def graphs_phase(cfg, sweeps, drive_sweeps, dev, earlier: dict) -> dict:
    """Phase [11]: each engine mode of [4], [4b], [7] and [4d] run eagerly
    (`graphs=False`) and graphed in turns within this call (the graphed runs
    replay the earlier phase's captures); records (loop edges too) must be
    bit-identical; frames/s, launches a frame, captures, their seconds and
    pool bytes of the earlier (first, capturing) run; the backend passes'
    seconds both ways."""
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine

    def host(pipelined):
        def make(graphs):
            eng = SlamEngine(cfg, seed=0, device=dev, pipelined=pipelined,
                             fetch_every=FETCH_EVERY, graphs=graphs)
            eng.state = eng.state._replace(map=prefilled_map(cfg, dev))
            return eng
        return make

    def fused(pipelined):
        return lambda graphs: fused_engine(cfg, dev, pipelined, graphs)

    def over(pipelined):
        def make(graphs):
            c = earlier["overflow_cfg"]
            eng = SlamEngine(c, seed=0, device=dev, pipelined=pipelined,
                             fetch_every=FETCH_EVERY, graphs=graphs)
            eng.state = eng.state._replace(map=prefilled_map(c, dev))
            return eng
        return make

    def frames(subset):
        def run(eng):
            for sw in subset:
                eng.process_sweep(sw)
            eng.flush()
            return len(subset)
        return run

    modes = {
        "sync_24": (host(False), frames(sweeps), earlier["sync"]),
        "pipelined_24": (host(True), frames(sweeps), earlier["pipe"]),
        "overflow_sync_12": (over(False), frames(sweeps[:12]), earlier["overflow"][0]),
        "overflow_pipelined_12": (over(True), frames(sweeps[:12]), earlier["overflow"][1]),
        "fused_sync_24": (fused(False), frames(sweeps), earlier["fused_sync"]),
        "fused_pipelined_24": (fused(True), frames(sweeps), earlier["fused_pipe"]),
    }
    out = {}
    for name, (make, run, first) in modes.items():
        r = in_turns(make, run, first.graphs)
        r.update(earlier_equal=record_bytes(r["graphed_eng"]) == record_bytes(first),
                 captures=first.graphs.captures, capture_s=first.graphs.capture_s,
                 pool_bytes=pool_bytes(first.graphs),
                 redispatched=(r["graphed_eng"].n_redispatched,
                               r["eager_eng"].n_redispatched),
                 eager_dense=r["eager_eng"].run_dense_calls,
                 dense_replays=r["graphed_eng"].run_dense_calls,
                 dense_keys=sorted(k[:2] for k in first.graphs._graphs
                                   if k[0].startswith("dense")))
        out[name] = r
    sp = spike_phase(cfg, dev, graphs=False)
    out["spike"] = dict(equal=all(record_bytes(a) == record_bytes(b) for a, b in
                                  zip(sp["runs"], earlier["spike"]["runs"])),
                        buckets=sp["buckets"], buckets_graphed=earlier["spike"]["buckets"],
                        redispatched=sp["redispatched"])
    bk = earlier["backend"]
    eager = backend_phase(cfg, drive_sweeps, earlier["gt"], dev, None, graphs=False)
    again = backend_phase(cfg, drive_sweeps, earlier["gt"], dev, None, graphs=bk["eng"].graphs)

    def edges(e):
        return [(x.kf_i, x.kf_j, x.n_inliers, np.float64(x.rmse_mm).tobytes(),
                 np.asarray(x.z).tobytes()) for x in e["uninterrupted"]["edges"]]

    out["backend_129"] = dict(
        records_equal=record_bytes(eager["eng"]) == record_bytes(bk["eng"])
        == record_bytes(again["eng"]),
        edges_equal=edges(eager) == edges(bk) == edges(again),
        closures=len(bk["uninterrupted"]["edges"]),
        pass_ms={"graphed (first run)": [p["ms"] for p in bk["passes"]],
                 "eager": [p["ms"] for p in eager["passes"]],
                 "graphed": [p["ms"] for p in again["passes"]]},
        corr_ms={"graphed (first run)": [p["corr_ms"] for p in bk["passes"]],
                 "eager": [p["corr_ms"] for p in eager["passes"]],
                 "graphed": [p["corr_ms"] for p in again["passes"]]},
        parts={"eager": mean_parts(eager["passes"]), "graphed": mean_parts(again["passes"])},
        part_launches={"eager": eager["part_launches"], "graphed": again["part_launches"]},
        final_equal=all(final_bytes(e) == final_bytes(bk) for e in (eager, again)),
        fps={"graphed (first run)": bk["fps"], "eager": eager["fps"], "graphed": again["fps"]},
        launches_equal=eager["launches"] == again["launches"],
        per_frame={"eager": sum(eager["launches"].values()) / len(drive_sweeps),
                   "graphed": sum(again["launches"].values()) / len(drive_sweeps)},
        captures=bk["eng"].graphs.captures, capture_s=bk["eng"].graphs.capture_s,
        pool_bytes=pool_bytes(bk["eng"].graphs),
        pair_graphs=sum(k[0] == "pair" for k in bk["eng"].graphs._graphs),
        programs=sorted({k[0] for k in bk["eng"].graphs._graphs}))
    return out


# ---------------------------------------------------------------------------
# Phases 12-14: the backend at full width, a shared Graphs, the pool


def device_launches(fn) -> int:
    """Device launches `torch.profiler` sees in one fn() on the card."""
    from bshot_slam_tpu_torch.utils import profiling

    return sum(e.count for e in profiling.profiled(fn, fn))


def eager_graphed(eager, graphed) -> dict:
    """One program eager and replayed from its graph (captured first, outside
    the timing) in turns, eager, graphed, graphed, eager, ..., 5 calls
    each, each call fenced by synchronises: median ms of each, every result
    (a tuple of tensors), device launches a call of each, the capture's
    seconds."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graphed()  # the capture
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    out = {"eager": [], "graphed": []}
    for side in ("eager", "graphed", "graphed", "eager") * 2 + ("eager", "graphed"):
        fn = eager if side == "eager" else graphed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out[side].append(((time.perf_counter() - t0) * 1e3, tuple(res)))
    return dict(eager_ms=statistics.median(ms for ms, _ in out["eager"]),
                graphed_ms=statistics.median(ms for ms, _ in out["graphed"]),
                results={k: [r for _, r in v] for k, v in out.items()},
                eager_launches=device_launches(eager),
                graphed_launches=device_launches(graphed), capture_s=capture_s)


def bits_equal(runs: list) -> bool:
    """Every run's tensors equal the first run's, bit for bit."""
    return all(torch_equal(a, b) for r in runs[1:] for a, b in zip(runs[0], r))


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def full_width_phase(cfg, dev, bk_eng, bk_passes: list) -> dict:
    """Phase [12]: the backend's programs at full width, eager against graphed
    (`eager_graphed`): the LM pose graph of FULL_NODES nodes from a seed
    (a chain around a loop and FULL_LOOPS loop edges, padded to a multiple
    of 4), `keyframe_bow` over a full store (max_keyframes rows) filled with
    [4d]'s keyframes over and over, and BA at [10]'s size (64 keyframes,
    4096 landmarks, 32768 observations); and `add_keyframe` on the full
    store, eager and graphed, and `evict_keyframe` eager (it stays eager).
    The pose graph and the BoW must be bit-identical graphed and eager.
    BA's `index_add_` adds floats with atomics: where the eager solves agree
    bit for bit, graphed must equal them; where they do not, each graphed
    solve must lie within `torch_kernel_cases.BA_LIMITS` of its nearest
    eager solve, field by field.  The limits are checked both ways: the
    eager solves' spread must lie within them, and a planted fault (the
    problem with one observation dropped, solved eagerly) must not."""
    import torch

    from bshot_slam_tpu_torch.backend import ba, loop_closure, posegraph
    from bshot_slam_tpu_torch.odometry.graphs import Graphs
    from bshot_slam_tpu_torch.tools.run_ba_bench import problem_arrays
    from bshot_slam_tpu_torch.utils import profiling
    from tests.torch_kernel_cases import (BA_CASE, BA_LIMITS, ba_distance, ba_dropped,
                                          ba_within, pose_graph_case)

    out = {}
    iters = cfg.backend.gn_iterations
    g = posegraph.PoseGraph(**{k: torch.as_tensor(v, device=dev) for k, v in
                               pose_graph_case(FULL_NODES, FULL_LOOPS, 12).items()})
    graphs = Graphs(dev)
    r = eager_graphed(lambda: posegraph.optimize_pose_graph(g, iterations=iters),
                      lambda: graphs.pose_graph(g, iterations=iters))
    res = r.pop("results")
    first = res["eager"][0]
    replay = lambda: graphs.pose_graph(g, iterations=iters)  # noqa: E731
    kernels = profiling.profiled(replay, replay)
    out["posegraph"] = dict(
        r, nodes=FULL_NODES, edges=int(g.edge_i.shape[0]), masked=int((~g.edge_mask).sum()),
        equal=bits_equal(res["eager"] + res["graphed"]), pool_bytes=pool_bytes(graphs),
        cost=(float(first[1]), float(first[2])),
        device_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
        top=[(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in sorted(
            kernels, key=lambda e: e.self_device_time_total, reverse=True)[:5]])
    kf, n = bk_eng.keyframes, bk_eng._kf_count
    rows = torch.arange(kf.descriptors.shape[0], device=dev) % n
    store = kf._replace(descriptors=kf.descriptors[rows].contiguous(),
                        kp_mask=kf.kp_mask[rows].contiguous())
    graphs = Graphs(dev)
    r = eager_graphed(lambda: (loop_closure.keyframe_bow(store),),
                      lambda: (graphs.bow(store),))
    res = r.pop("results")
    out["bow"] = dict(r, rows=int(rows.shape[0]), filled_from=n,
                      equal=bits_equal(res["eager"] + res["graphed"]),
                      pool_bytes=pool_bytes(graphs))
    arrays = problem_arrays(*BA_CASE)
    prob, dropped = (ba.BAProblem(**{k: torch.as_tensor(v, device=dev) for k, v in a.items()})
                     for a in (arrays, ba_dropped(arrays)))
    graphs = Graphs(dev)
    r = eager_graphed(lambda: ba.ba_solve(prob), lambda: graphs.ba(prob))
    res = r.pop("results")
    eager = res["eager"]
    spread = [max(d) for d in zip(*[ba_distance(a, b) for i, a in enumerate(eager)
                                    for b in eager[i + 1:]])]
    graphed = [ba_within(gr, eager) for gr in res["graphed"]]
    fault, fault_within = ba_within(tuple(ba.ba_solve(dropped)), eager)
    deterministic = bits_equal(eager)
    out["ba"] = dict(
        r, eager_runs=len(eager), eager_deterministic=deterministic, spread=spread,
        graphed_to_nearest_eager=[max(x) for x in zip(*[d for d, _ in graphed])],
        fault=fault, limits=BA_LIMITS, limits_sound=not fault_within and all(
            d <= lim for d, lim in zip(spread, BA_LIMITS)),
        ok=(bits_equal(eager[:1] + res["graphed"]) if deterministic else
            all(w for _, w in graphed)),
        cost=(float(eager[0][2]), float(eager[0][3])), pool_bytes=pool_bytes(graphs))
    # Keyframe add eager and graphed, evict eager, on [4d]'s full store
    # (max_keyframes rows).
    from bshot_slam_tpu_torch.backend import keyframes
    from bshot_slam_tpu_torch.odometry.pipeline import FrameFeatures

    feats = FrameFeatures(kf.keypoints[1], torch.zeros_like(kf.kp_mask[1], dtype=torch.float32),
                          kf.descriptors[1], kf.kp_mask[1])
    graphs = Graphs(dev)
    frame = torch.tensor(7, dtype=torch.int32, device=dev)
    for _ in range(2):  # the first call captures, the second replays
        added = [keyframes.add_keyframe(kf, kf.poses[1], feats, frame, kf.obs_lm[1]),
                 graphs.add_keyframe(kf, kf.poses[1], feats, frame, kf.obs_lm[1])]
    out["keyframes"] = dict(
        add_ms=time_ms(lambda: keyframes.add_keyframe(kf, kf.poses[1], feats, frame,
                                                       kf.obs_lm[1])),
        evict_ms=time_ms(lambda: keyframes.evict_keyframe(kf, n // 2)),
        add_graphed_ms=time_ms(lambda: graphs.add_keyframe(kf, kf.poses[1], feats, frame,
                                                           kf.obs_lm[1])),
        equal=bits_equal(added),
        rows=int(kf.poses.shape[0]), adds_per_pass=n / max(1, len(bk_passes)))
    return out


def shared_graphs_phase(cfg, sweeps, dev) -> dict:
    """Phase [13]: two engines whose configurations differ only in the RANSAC
    inlier threshold share one `Graphs`, in turns; each one's records over
    the frames equal its own `graphs=False` run bit for bit (a key without
    the configuration would replay the first engine's threshold); and the
    host cost of hashing the configuration, which each step's key does."""
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.odometry.graphs import Graphs

    other = dataclasses.replace(cfg, match=dataclasses.replace(
        cfg.match, ransac_inlier_th_mm=0.5 * cfg.match.ransac_inlier_th_mm))
    shared = Graphs(dev)
    equal, records = [], []
    for c in (cfg, other):
        runs = []
        for graphs in (shared, False):
            eng = SlamEngine(c, seed=0, device=dev, graphs=graphs)
            eng.state = eng.state._replace(map=prefilled_map(c, dev))
            for sw in sweeps:
                eng.process_sweep(sw)
            runs.append(record_bytes(eng))
        equal.append(runs[0] == runs[1])
        records.append(runs[1])
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        hash(cfg)
    return dict(equal=equal, differ=records[0] != records[1],
                keys=[k[0] for k in shared._graphs],
                configs=len({k[-1] for k in shared._graphs}),
                hash_us=(time.perf_counter() - t0) / n * 1e6)


def state_bytes(graphs) -> int:
    """Bytes of the state buffers a `Graphs` keeps (one set per capacity)."""
    from bshot_slam_tpu_torch.odometry.graphs import leaves

    return sum(t.numel() * t.element_size() for st in graphs._states.values()
               for t in leaves(st))


def at_capacity(cfg, dev, rows: int, n: int):
    """[4]'s far prefill of n landmarks in a map of `rows` rows."""
    m = prefilled_map(cfg, dev, n=n)
    cap = m.positions.shape[0]
    return m._replace(**{f: getattr(m, f)[:rows] for f in m._fields
                         if getattr(m, f).dim() and getattr(m, f).shape[0] == cap})


def pool_phase(cfg, sweeps, drive_sweeps, dev, graphs) -> dict:
    """Phase [14]: the keys a long drive gathers in one engine's `Graphs`,
    added to `graphs` ([4d]'s drive's, which [11] replayed: its steps, loop
    pair, histograms, keyframe add and 8- to 128-node programs).  A graphed
    engine on `graphs` runs every map bucket: for each capacity in turn the
    map is prefilled to 650 rows under it (the frames' inserts may grow
    it), and three frames run at three cloud buckets (a frame's cloud cut
    to CUT_POINTS points, the whole frame, two frames' points together).
    Each capacity's whole-frame cloud is also replayed through the dense
    step's graph (an aborted frame's re-run), and the largest map, at the
    hard capacity, evicts through its graph.
    Then the pose graph at every node bucket (8 to max_keyframes) with each
    loop-edge padding a pass can make (0, 4, 8 or 12 loop edges: at most 8
    proximity and `lc_appearance_top` appearance pairs), the corrections at
    every node bucket with a drive's frame bucket (5 frames a keyframe) on
    the largest map, and BA at [10]'s size (`run_odometry.py --ba`).  Last,
    a backend engine ([4d]'s) on `graphs` drives [4d]'s circle LONG_LAPS
    times, so its keyframe store fills (max_keyframes) and evicts, and its
    map grows to the largest bucket and evicts.  After each, the pool's
    bytes and the state buffers'; the peak is the largest pool seen, and
    must stay under POOL_LIMIT."""
    from bshot_slam_tpu_torch.backend import ba, posegraph
    from bshot_slam_tpu_torch.device import upload
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine, pick_bucket
    from bshot_slam_tpu_torch.tools.run_ba_bench import problem_arrays
    from tests.torch_kernel_cases import BA_CASE, pose_graph_case

    import torch

    eng = SlamEngine(cfg, seed=0, device=dev, graphs=graphs)
    clouds = [frame_cloud(cfg, sw) for sw in sweeps]
    rows = []

    def cloud(points, nv):
        pts = np.zeros((pick_bucket(nv, cfg), 3), np.float32)
        pts[:nv] = points[:nv]
        return pts, nv

    def note(what):
        torch.cuda.synchronize()
        rows.append(dict(what=what, capacity=eng.state.map.positions.shape[0],
                         pool_bytes=pool_bytes(graphs), state_bytes=state_bytes(graphs),
                         graphs=len(graphs._graphs)))

    note("the backend drive")
    f = 0
    for b in sorted(cfg.runtime.map_buckets):
        eng.state = eng.state._replace(map=at_capacity(cfg, dev, b, b - 650))
        (p0, n0), (p1, n1) = clouds[f % len(clouds)], clouds[(f + 1) % len(clouds)]
        both = np.concatenate([p0[:n0], p1[:n1]])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for pts, nv in (cloud(p0, min(n0, CUT_POINTS)), cloud(p0, n0),
                            cloud(both, len(both))):
                eng.process_compact(pts, nv)
                note(f"capacity {b}, bucket {pts.shape[0]}")
            pts, nv = cloud(p0, n0)
            eng._run_dense(upload(pts, dev), None, upload(np.asarray(nv, np.int32), dev),
                           eng._next_draws(), eng._capacity())
            note(f"capacity {b}, bucket {pts.shape[0]}, the dense step")
        f += 2
    if eng._capacity() == cfg.map.capacity:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng._evict(int(eng.state.map.cursor))
        note(f"an eviction at capacity {eng._capacity()}")
    iters, m = cfg.backend.gn_iterations, 8
    while m <= cfg.backend.max_keyframes:
        for loops in (0, 4, 8, 12):
            g = posegraph.PoseGraph(**{k: torch.as_tensor(v, device=dev) for k, v in
                                       pose_graph_case(m, loops, m + loops).items()})
            graphs.pose_graph(g, iterations=iters)
        note(f"pose graph {m} nodes, {m - 1}-{m + 11} edges")
        frames = 1 << (5 * m - 1).bit_length()
        kf_frames = torch.arange(m, dtype=torch.int32, device=dev) * 5
        graphs.corrections(cfg.map, torch.eye(4, device=dev).expand(m, 4, 4).contiguous(),
                           kf_frames, torch.arange(frames, dtype=torch.int32, device=dev),
                           eng.state.map)
        note(f"corrections {m} keyframes, {frames} frames")
        m *= 2
    graphs.ba(ba.BAProblem(**{k: torch.as_tensor(v, device=dev)
                              for k, v in problem_arrays(*BA_CASE).items()}))
    note("BA")
    eng = backend_engine(cfg, dev, graphs)
    eng.state = eng.state._replace(map=prefilled_map(cfg, dev))
    passes, optimize = [], eng.optimize_backend

    def timed_optimize(*a, **k):
        t0 = time.perf_counter()
        out = optimize(*a, **k)
        torch.cuda.synchronize()
        passes.append((eng._kf_count, (time.perf_counter() - t0) * 1e3))
        return out

    eng.optimize_backend = timed_optimize
    frames = LONG_LAPS * len(drive_sweeps)
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for i in range(frames):
            eng.process_sweep(drive_sweeps[i % len(drive_sweeps)])
        eng.flush()
    torch.cuda.synchronize()
    long = dict(frames=frames, s=time.perf_counter() - t0, records=len(eng.records),
                finite=bool(np.isfinite(eng.trajectory).all()), keyframes=eng._kf_count,
                kf_evicted=eng.n_kf_evicted, map_evicted=eng.n_evicted,
                closures=len(eng.loop_edges), map_size=eng.records[-1].map_size,
                full_passes=[ms for n, ms in passes if n >= cfg.backend.max_keyframes // 2],
                passes=len(passes))
    note(f"a {frames}-frame drive ({eng._kf_count} keyframes, {eng.n_kf_evicted} evicted)")
    return dict(rows=rows, peak=max(r["pool_bytes"] for r in rows), long=long,
                states_peak=max(r["state_bytes"] for r in rows),
                programs=collections.Counter(k[0] for k in graphs._graphs),
                reserved=torch.cuda.memory_reserved(dev))


# ---------------------------------------------------------------------------
# Phase 10: the tools on the card

A_TO_E = ("neighborhood_accumulate", "segratio_accumulate", "hamming_nn_bounded",
          "euclid_nn_bounded", "dedup_blocked_bounded")


def tool_runs(work: pathlib.Path):
    """(module under bshot_slam_tpu_torch/tools, arguments, the kernels its
    run must launch) of each tool phase [10] runs."""
    return (
        ("run_golden", ["--out", str(work / "golden_torch.json")], A_TO_E),
        ("run_stage_bench", ["--iters", "5"], A_TO_E),
        ("run_feature_profile", ["--iters", "5"], A_TO_E[:2] + ("shot_neighbors",)),
        ("run_ba_bench", [], ()),
        ("run_reference_stats", ["--out", str(work / "refstats_torch.json"),
                                 "--workdir", str(work / "refstats")],
         A_TO_E + ("ground_walk",)),
    )


def tools_phase(work: pathlib.Path) -> dict:
    """Phase [10]: each tool's `main` in this process on the card, its
    output captured; per tool its exit code, seconds, kernel launches, the
    lines it printed and its JSON line."""
    out = {}
    for name, argv, needs in tool_runs(work):
        mod = importlib.import_module(f"bshot_slam_tpu_torch.tools.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc, launches = counted(lambda: mod.main(argv))
        lines = buf.getvalue().splitlines()
        js = [ln for ln in lines if ln.startswith("{")]
        out[name] = dict(rc=rc, s=time.perf_counter() - t0, launches=launches,
                         idle=[k for k in needs if not launches[k]],
                         lines=[ln for ln in lines if not ln.startswith("{")],
                         line=js[-1] if js else None,
                         result=json.loads(js[-1]) if js else None)
    return out


def report_rows(rows: list, max_neighbors: int) -> list:
    """Print phase [3]'s lines of `rows`; the names of the kernels that
    disagree with their plain versions or themselves, or ran the other
    form than their rows take."""
    failed = []
    for r in rows:
        print(f"[3] {r['name']}: {r['shapes']}; int mismatches vs CPU plain "
              f"{r['int_mismatch']}, float out of tolerance {r['float_out_of_tol']}, "
              f"max abs err {r['max_abs_err']:.6g}, rows differing from the plain "
              f"version on the card {r['card_plain_rows_differ']}"
              + ("" if "deterministic" not in r else
                 f", two runs bit-identical: {r['deterministic']}")
              + f"; kernel {r['ms']:.4f} ms (device only {r['device_ms']:.4f} ms in "
              f"{r['device_launches_per_call']:.0f} launches, host "
              f"{r['host_us_per_call']:.1f} us per call), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); {r['tolerance']}", flush=True)
        for n, b in r.get("by_rows", {}).items():
            if "keypoints" in b:  # H
                about = (f"{b['cloud']}, {b['n_valid']} valid, {b['keypoints']} keypoints; "
                         f"over {max_neighbors} in radius: "
                         f"{b['saturated_pct']:.2f}%, mean {b['mean_in_radius']:.1f}, max "
                         f"{b['max_in_radius']:.0f}): mismatches vs CPU plain "
                         f"{b['int_mismatch']}")
                plain = (f", host {b['host_us_per_call']:.1f} us), plain "
                         f"{b['plain_ms']:.4f} ms")
            else:  # A and B, against the plain version on the card
                about = (f"{b['n_valid']} valid, {b['radius_tests']:.0f} radius tests, "
                         f"{b['in_radius']:.0f} pairs in radius): float out of tolerance "
                         f"{b['float_out_of_tol']}, max abs err {b['max_abs_err']:.6g}")
                plain = ")"
            print(f"[3] {r['name']} at {n} rows ({about}, rows differing from the plain "
                  f"version on the card {b['card_plain_rows_differ']}, two runs "
                  f"bit-identical {b['deterministic']}; kernel {b['ms']:.4f} ms (device "
                  f"{b['device_ms']:.4f} ms in {b['device_launches_per_call']:.0f} "
                  f"launches{plain}, bound {b['bound_ms']:.4f} ms ({b['bound_by']}); "
                  f"kernels {b['kernels']}, the form {n} rows take: {b['wide_form']}",
                  flush=True)
        for what, b in r.get("by_input", {}).items():
            print(f"[3] {r['name']} on the {what}: matrices differing from the plain "
                  f"version on the card {b['card_plain_rows_differ']}, two runs "
                  f"bit-identical {b['deterministic']}; kernel {b['ms']:.4f} ms (device "
                  f"{b['device_ms']:.4f} ms in {b['device_launches_per_call']:.0f} "
                  f"launches, host {b['host_us_per_call']:.1f} us), plain "
                  f"{b['plain_ms']:.4f} ms (device {b['plain_device_ms']:.4f} ms in "
                  f"{b['plain_launches']:.0f} launches), bound {b['bound_ms']:.6f} ms "
                  f"({b['bound_by']})", flush=True)
        if (r["int_mismatch"] or r["float_out_of_tol"]
                or r["card_plain_rows_differ"] or not r.get("deterministic", True)
                or not r.get("wide_form", True)):
            failed.append(r["name"])
    return failed


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
    try:
        import bshot_slam_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e})", file=sys.stderr)
        return 2
    from bshot_slam_tpu_torch import default_config
    from bshot_slam_tpu_torch.device import card_line
    from bshot_slam_tpu_torch.io import native_decoder
    from bshot_slam_tpu_torch.kernels import build_all
    from bshot_slam_tpu_torch.odometry.engine import pick_bucket

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    work = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    card = card_line()
    print(f"[1] card: {card}", flush=True)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:  # g++ beside nvcc
        native = pool.submit(native_decoder.is_available)
        print(f"[1] kernels built in {build_all():.2f} s", flush=True)
        native.result()
    print(f"[1] native host library built: {native_decoder.BUILD_DIR}", flush=True)

    cfg = default_config()
    t0 = time.perf_counter()
    drive_sweeps, drive_gt = render_drive(cfg, N_DRIVE)
    sweeps, gt = drive_sweeps[:N_FRAMES], drive_gt[:N_FRAMES]
    print(f"[2] rendered {len(drive_sweeps)} frames in {time.perf_counter() - t0:.1f} s; "
          f"host preprocess {host_preprocess_ms(cfg, sweeps):.2f} ms/frame", flush=True)
    t0 = time.perf_counter()
    cfg64, points64, nv64 = hdl64e_cloud()
    print(f"[2] HDL-64E frames {SELECT_FRAMES} rendered in {time.perf_counter() - t0:.1f} "
          f"s; the largest keeps {nv64} points", flush=True)
    t0 = time.perf_counter()
    cfg128, points128, nv128 = vls128_cloud(dev)
    print(f"[2] the vls128.replay lap rendered and ingested in "
          f"{time.perf_counter() - t0:.1f} s; the largest keeps {nv128} points", flush=True)

    points, nv = frame_cloud(cfg, sweeps[3])
    assert points.shape[0] == pick_bucket(nv, cfg)
    wide_a, wide_b = check_wide_neighborhood(cfg128, points128, nv128, dev)
    what = f"wide: the VLS-128 cloud of {nv128} kept points at {WIDE_ROWS} rows"
    a_row, b_row = check_neighborhood(cfg, points, nv, dev)
    rows = ([with_rows(a_row, wide_a, what), with_rows(b_row, wide_b, what)]
            + check_mapops(cfg, dev)
            + [check_shot_select(cfg64, [("HDL-64E cloud", points64, nv64, SELECT_ROWS),
                                         ("VLS-128 cloud", points128, nv128, WIDE_ROWS)],
                                 dev),
               check_eig3(cfg, points, nv, cfg64, points64, nv64, dev)])
    torch.cuda.synchronize()
    failed = report_rows(rows, cfg.descriptor.max_neighbors)
    if failed:
        raise SmokeError("kernels disagree with their plain versions, or with "
                         "themselves over two runs, or ran the other form than "
                         f"their rows take: {failed}")
    wide = {r["name"] if n is None else f"{r['name']} at {n} rows":
            b["device_launches_per_call"]
            for r in rows for n, b in [(None, r), *r.get("by_rows", {}).items()]
            if b["device_launches_per_call"] > MAX_DEVICE_LAUNCHES.get(r["name"], 99)}
    if wide:  # a trace can lose records, not add them
        raise SmokeError(f"more device launches per call than allowed: {wide}")

    res, sync_eng = run_engine(cfg, sweeps, gt, dev)
    print(f"[4] engine: {N_FRAMES} frames, {res['fps']:.3f} frames/s after the "
          f"first ({res['first_frame_s']:.2f} s), {res['steady_fps']:.3f} over the "
          f"{res['steady_frames']} later frames that captured no graph, ATE "
          f"{res['ate_mm']:.1f} mm on a "
          f"{res['path_mm']:.0f} mm path, tail inliers {res['tail_inliers']}, "
          f"map {res['map_size']}, launches {res['launches']}; steps replayed from "
          f"{sync_eng.graphs.captures} CUDA graphs captured in "
          f"{sync_eng.graphs.capture_s:.3f} s", flush=True)
    if not res["ate_mm"] < 0.10 * res["path_mm"]:
        raise SmokeError("quality guard: ATE >= 10% of the path")
    if max(res["tail_inliers"]) < cfg.match.gate_min_inliers:
        raise SmokeError("quality guard: too few inliers on the last 8 frames")
    idle = [k for k, n in res["launches"].items() if n == 0]
    if idle:
        raise SmokeError(f"kernels never launched on the main path: {idle}")
    dev_ms, n_kernels, top, own = profile_engine(cfg, sweeps, dev, sync_eng.graphs)
    frame_ms = 1e3 / res["steady_fps"]
    print(f"[4] breakdown: frame {frame_ms:.2f} ms unprofiled (no capture); device kernels "
          f"{dev_ms:.2f} ms/frame in {n_kernels:.0f} launches (busy "
          f"{100 * dev_ms / frame_ms:.1f}%); heaviest: "
          + "; ".join(f"{k} {ms:.3f} ms x{c:.0f}" for k, ms, c in top), flush=True)
    print("[4] the port's kernels per frame: "
          + "; ".join(f"{k} {ms:.4f} ms x{c:.0f}" for k, ms, c in own), flush=True)
    icp = sum(c for k, _, c in own if k == "euclid_kernel")
    if icp > cfg.match.icp_iterations:  # a trace can lose records, not add them
        raise SmokeError(f"kernel D made {icp} device launches per frame, more than "
                         f"one per ICP iteration ({cfg.match.icp_iterations})")
    sel = sum(c for k, _, c in own if k == "shot_select_kernel")
    if sel > 1:
        raise SmokeError(f"kernel H made {sel} selection launches per frame, not one")
    icp = sum(c for k, _, c in own if k == "icp_update_kernel")
    if icp > cfg.match.icp_iterations + 1:
        raise SmokeError(f"kernel G made {icp} device launches per frame, more than "
                         f"one per ICP iteration and its start")
    g, d, it = (res["launches"]["icp_update"], res["launches"]["euclid_nn_bounded"],
                cfg.match.icp_iterations)
    if g != d // it * (it + 1) or g < N_FRAMES * (it + 1):
        raise SmokeError(f"kernel G's wrapper counted {g} launches over {N_FRAMES} "
                         f"frames (D {d}), not the iterations + 1 an ICP")
    eig = sum(c for k, _, c in own if k == "eig3_kernel")
    if eig > 2 or res["launches"]["eigh3"] < 2 * N_FRAMES:
        raise SmokeError(f"kernel I made {eig} device launches per frame (at most 2: "
                         f"normals and LRFs), its wrapper {res['launches']['eigh3']} "
                         f"over {N_FRAMES} frames")

    pipe = pipelined_phase(cfg, sweeps, sync_eng, dev)
    print(f"[4b] pipelined (fetch_every {FETCH_EVERY}): {N_FRAMES} frames, "
          f"{pipe['fps']:.3f} frames/s after the first (synchronous [4]: "
          f"{res['fps']:.3f}); records bit-identical to the synchronous run: "
          f"{pipe['equal']}; launches {pipe['launches']}", flush=True)
    print(f"[4b] synchronising calls: first frame {pipe['first_call_syncs']} "
          f"({pipe['first_sites'] or 'none'}: the cursor bound's first read), "
          f"{pipe['syncs_per_frame']:.3f} per frame over "
          f"the {len(pipe['between'])} frames between drains (by source line: "
          f"{pipe['sites'] or 'none'}), at the drains {pipe['drain_syncs']}", flush=True)
    print(f"[4b] forced window overflow (window_cap {OVERFLOW_WINDOW}): "
          f"{pipe['redispatched']} of {pipe['overflow_frames']} frames aborted and "
          f"re-run; records equal to the synchronous engine's: "
          f"{pipe['overflow_equal']}", flush=True)
    if not (pipe["equal"] and pipe["overflow_equal"]):
        raise SmokeError("pipelined records differ from the synchronous engine's")
    if not pipe["redispatched"]:
        raise SmokeError("the forced window overflow aborted no frame")

    ev = eviction_phase(cfg, drive_sweeps, dev)
    print(f"[4c] eviction: map one frame short of {cfg.map.capacity}; 8 frames "
          f"pipelined evicted {ev['n_evicted']} keypoints graphed (evictions replayed "
          f"from {ev['graphed_keys']}), {ev['eager_evicted']} eager (tail inliers "
          f"{ev['tail_inliers']}); records bit-identical graphed and eager: "
          f"{ev['records_equal']}; evict_keypoints at cursor {ev['cursor']} drops "
          f"{ev['evicted_now']} rows, card equal to CPU copies in every field, eager "
          f"twice and graphed twice: {ev['exact']}; launches {ev['launches']}", flush=True)
    print(f"[4c] {card}: one eviction eager {ev['ms']:.4f} ms, graphed (replayed) "
          f"{ev['graphed_ms']:.4f} ms (CUDA events, median of {REPEATS} each, in turns; "
          f"the CPU {ev['cpu_ms']:.1f} ms)", flush=True)
    if not (ev["n_evicted"] == ev["eager_evicted"] > 0 and ev["exact"]
            and ev["records_equal"] and ev["graphed_keys"]):
        raise SmokeError("eviction did not run or was not replayed, its records differ "
                         "graphed and eager, or the card differs from the CPU")

    ckpt = str(work / "checkpoint")
    bk = backend_phase(cfg, drive_sweeps, drive_gt, dev, ckpt)
    for i, ps in enumerate(bk["passes"]):
        print(f"[4d] backend pass {i}: {ps['keyframes']} keyframes, "
              f"{ps['verified']} pairs verified, {ps['closures']} closures, best "
              f"candidate {ps['best_inliers']} inliers, {ps['ms']:.1f} ms + corrections "
              f"{ps['corr_ms']:.1f} ms; by part (ms) {parts_line(ps['parts'])}; kernel C "
              f"x{ps['launches']['hamming_nn_bounded']}, D "
              f"x{ps['launches']['euclid_nn_bounded']}", flush=True)
    print(f"[4d] device launches by part of one more pass (torch.profiler): "
          f"{bk['part_launches']}", flush=True)
    print(f"[4d] backend drive: {N_DRIVE} frames in {bk['wall_s']:.1f} s "
          f"({bk['fps']:.3f} frames/s with the passes), {bk['keyframes']} keyframes, "
          f"map {bk['map_size']}, evicted {bk['n_evicted']}; ATE {bk['ate_before']:.1f} "
          f"mm before and {bk['ate_after']:.1f} mm after a final "
          f"apply_backend_corrections() ({bk['final_ms']:.1f} ms, "
          f"{bk['correction']}) on a {bk['path_mm']:.0f} mm path; tail inliers "
          f"{bk['tail_inliers']}; launches {bk['launches']}", flush=True)
    if not bk["ate_after"] < 0.10 * bk["path_mm"]:
        raise SmokeError("quality guard (backend drive): ATE >= 10% of the path")
    if max(bk["tail_inliers"]) < cfg.match.gate_min_inliers:
        raise SmokeError("quality guard (backend drive): too few inliers at the end")
    if len(bk["passes"]) < N_DRIVE // BACKEND_EVERY:
        raise SmokeError(f"only {len(bk['passes'])} backend passes ran")
    loop_cd = {k: sum(ps["launches"][k] for ps in bk["passes"])
               for k in ("hamming_nn_bounded", "euclid_nn_bounded")}
    loop = check_loop_kernels(bk["eng"], dev)
    for name, r in loop.items():
        print(f"[4d] {name} at the loop-verification shape: {r['shapes']}; int "
              f"mismatches vs CPU plain {r['int_mismatch']}, rows differing from "
              f"the plain version on the card {r['card_plain_rows_differ']}, two runs "
              f"bit-identical: {r['deterministic']}; kernel {r['ms']:.4f} ms (device "
              f"only {r['device_ms']:.4f} ms in {r['device_launches_per_call']:.0f} "
              f"launches), plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
        if r["int_mismatch"] or r["card_plain_rows_differ"] or not r["deterministic"]:
            raise SmokeError(f"{name} disagrees at the loop-verification shape")
        if r["device_launches_per_call"] > MAX_DEVICE_LAUNCHES.get(name, 1):
            raise SmokeError(f"{name} made {r['device_launches_per_call']} device "
                             "launches per call at the loop-verification shape")
    ing = ingest_phase(cfg, drive_sweeps)
    print(f"[5] host ingest over {ing['frames']} frames: range image "
          f"{ing['range_image_ms']:.2f} ms/frame, then classify + extract: numpy "
          f"(plain) {ing['numpy_ms']:.2f} ms/frame, native {ing['native_ms']:.2f} "
          f"ms/frame; class cells differing {ing['class_cells_differ']}, frames whose "
          f"kept count differs {ing['frames_count_differs']}, largest point "
          f"difference {ing['max_point_mm']:.6f} mm", flush=True)
    if ing["class_cells_differ"] or ing["frames_count_differs"] or ing["max_point_mm"] > 0.05:
        raise SmokeError("native classify + extract differs from the numpy plain version")
    if not ing["native_ms"] < ing["numpy_ms"]:
        raise SmokeError("native host ingest is not faster than numpy")
    pc = pcap_phase(cfg, sweeps, sync_eng, dev, str(work / "drive.pcap"))
    print(f"[5] PCAP round trip: {len(sweeps)} frames encoded and written, "
          f"{pc['frames']} read back by NativeSweepStream and run through the "
          f"engine; largest pose difference from the sweeps path [4]: "
          f"{pc['max_mm']:.3f} mm, {pc['max_rot']:.2e} in rotation; tail inliers "
          f"{pc['tail_inliers']}, map {pc['map_size']}; launches {pc['launches']}",
          flush=True)
    if pc["frames"] < len(sweeps) - 1 or max(pc["tail_inliers"]) < cfg.match.gate_min_inliers:
        raise SmokeError("the PCAP round trip lost frames or matching collapsed")
    print(f"[5] engine records on the native path ([4]): frames {len(sync_eng.records)}, "
          f"inliers {[r.n_inliers for r in sync_eng.records]}, map sizes "
          f"{sync_eng.records[0].map_size}..{sync_eng.records[-1].map_size}", flush=True)

    rs = resume_phase(cfg, drive_sweeps, bk, dev, ckpt)
    print(f"[5b] checkpoint at frame {RESUME_AT} (after backend pass "
          f"{bk['saved']['passes']}, {bk['saved']['pending']} frames in flight, saved "
          f"in {bk['saved']['s']:.2f} s; prior poses {rs['prior']}); resumed engine "
          f"drove {rs['frames']} frames: records bit-identical to the uninterrupted "
          f"run {rs['records_equal']}, keyframe store {rs['keyframes_equal']}, state "
          f"{rs['state_equal']}, loop edges {rs['edges_equal']} ({rs['closures']} "
          f"closures); launches {rs['launches']}", flush=True)
    if bk["saved"]["pending"] or rs["prior"] != RESUME_AT:
        raise SmokeError("the checkpoint was not taken on a drained engine")
    if not (rs["records_equal"] and rs["keyframes_equal"] and rs["state_equal"]
            and rs["edges_equal"]):
        raise SmokeError("the resumed run differs from the uninterrupted run")

    bench = bench_phase(cfg, drive_sweeps, drive_gt, dev)
    print(f"[6] bench_torch: {json.dumps(bench['line'])}", flush=True)
    print(f"[6] bench_torch engine pass: {len(drive_sweeps)} frames, {bench['fps']:.3f} "
          f"frames/s (one warm pass capturing {bench['captures']} graphs in "
          f"{bench['capture_s']:.3f} s, one timed replaying them), final map {bench['map_size']}, "
          f"inliers {bench['inliers']}, redispatched {bench['redispatched']}, ATE "
          f"{bench['ate_mm']:.1f} mm on a {bench['path_mm']:.0f} mm path, tail inliers "
          f"{bench['tail_inliers']}; launches {bench['launches']}", flush=True)
    if not bench["quality_ok"]:
        raise SmokeError("bench_torch's quality guard failed")
    jd = reference_drive(cfg, bench["eng"], drive_gt)
    print(f"[6] card against the JAX package on the CPU (exact top-k, "
          f"{REFERENCE_DRIVE.name}): configuration equal {jd['config_equal']}, drive "
          f"equal {jd['drive_equal']}; relative motion differences per frame: "
          f"translation median {jd['mm_median']:.3f} mm, max {jd['mm_max']:.3f} mm; "
          f"rotation median {jd['deg_median']:.4f} deg, max {jd['deg_max']:.4f} deg; "
          f"first frame over {REL_MM:g} mm or {REL_DEG:g} deg: {jd['first_over']}; ATE "
          f"against ground truth: card {jd['ate_card']:.1f} mm, JAX {jd['ate_ref']:.1f} "
          f"mm; ATE between the two {jd['ate_between']:.1f} mm; map cursor card "
          f"{jd['cursor_card']}, JAX {jd['cursor_ref']}", flush=True)
    print(f"[6] inliers per frame: card {jd['inliers_card']}; JAX {jd['inliers_ref']}",
          flush=True)
    if not (jd["config_equal"] and jd["drive_equal"]):
        raise SmokeError(f"the JAX drive fixture was recorded at another "
                         f"configuration or drive: {REFERENCE_DRIVE}")

    walk = walk_phase(cfg, drive_sweeps, dev)
    wr = walk["row"]
    print(f"[7] kernel F (ground_walk) over {walk['frames']} frames ({walk['cells']} "
          f"cells): class cells differing from the plain version on the card "
          f"{walk['cells_differ']}, frames not bit-identical over two runs "
          f"{walk['not_identical']}; fused clouds against host_cloud: frames whose "
          f"count differs {walk['count_differs']}, largest point difference "
          f"{walk['max_point_mm']:.6f} mm; F at {wr['shapes']}: kernel {wr['ms']:.4f} ms "
          f"(device only {wr['device_ms']:.4f} ms in {wr['device_launches_per_call']:.0f} "
          f"launches, host {wr['host_us_per_call']:.1f} us per call), plain "
          f"{wr['plain_ms']:.4f} ms, bound {wr['bound_ms']:.6f} ms ({wr['bound_by']}); "
          f"the fused ingest (preprocess + extract + count) {walk['ingest_ms']:.4f} ms "
          f"(device only {walk['ingest_device_ms']:.4f} ms in "
          f"{walk['ingest_launches']:.0f} launches) per frame", flush=True)
    if walk["cells_differ"] or walk["not_identical"]:
        raise SmokeError("kernel F differs from its plain version, or from itself")
    if walk["count_differs"] or walk["max_point_mm"] > 0.05:
        raise SmokeError("the fused clouds differ from the host ingest's")
    if (walk["ingest_launches"] > FUSED_INGEST_MAX_LAUNCHES
            or wr["device_launches_per_call"] > MAX_DEVICE_LAUNCHES["ground_walk"]):
        raise SmokeError("the fused ingest makes more device launches than allowed")
    fu = fused_phase(cfg, sweeps, sync_eng, dev)
    print(f"[7] fused engine ({N_FRAMES} frames, prefill): synchronous {fu['fps']:.3f} "
          f"frames/s (host preprocess [4]: {res['fps']:.3f}), pipelined "
          f"{fu['pipe_fps']:.3f} (host preprocess [4b]: {pipe['fps']:.3f}); pipelined "
          f"records bit-identical to the synchronous ones: {fu['equal']} "
          f"({fu['redispatched']} re-run); largest pose difference from [4]: "
          f"{fu['max_mm']:.3f} mm, {fu['max_rot']:.2e} in rotation; tail inliers "
          f"{fu['tail_inliers']}; launches synchronous {fu['launches']}, pipelined "
          f"{fu['pipe_launches']}", flush=True)
    if not fu["equal"]:
        raise SmokeError("pipelined fused records differ from the synchronous ones")
    if fu["max_mm"] > 10.0 or fu["max_rot"] > 1e-3:
        raise SmokeError("the fused engine's poses part from the host-preprocess run")
    sp = spike_phase(cfg, dev)
    print(f"[7] full-width spike ({sp['frames']} frames, {SPIKE_BASE} kept points, "
          f"{SPIKE} at frame {SPIKE_AT}): pipelined fused buckets {sp['buckets']}, "
          f"{sp['redispatched']} frames re-run; records bit-identical to the "
          f"synchronous fused engine: {sp['equal']}; map {sp['map_size']}; launches "
          f"{sp['launches']}", flush=True)
    if not (sp["equal"] and sp["redispatched"]):
        raise SmokeError("the spike did not abort, or its re-run differs")
    evl = eval_phase(cfg, drive_sweeps[:2], dev)
    print(f"[8] kernel A at the ISS salient radius: {evl['shapes']}; count mismatches vs "
          f"CPU plain {evl['count_mismatch']}, float out of tolerance "
          f"{evl['float_out_of_tol']} (phase [3]'s), {evl['in_radius']:.0f} pairs in "
          f"radius; kernel {evl['a_ms']:.4f} ms, plain {evl['a_plain_ms']:.4f} ms; "
          f"iss_keypoints {evl['iss_ms']:.3f} ms on the card; keypoints card "
          f"{evl['n_card']} / CPU {evl['n_cpu']}, in common {evl['common']}; "
          f"repeatability of frame 1 on frame 0: card {evl['repeat']:.4f}, CPU "
          f"{evl['repeat_cpu']:.4f}; voxel_downsample (200 mm): {evl['voxels']} voxels, "
          f"two runs bit-identical {evl['vox_identical']}, equal to the CPU "
          f"{evl['vox_equal_cpu']}; launches {evl['launches']}", flush=True)
    if evl["count_mismatch"] or evl["float_out_of_tol"] or not evl["vox_identical"]:
        raise SmokeError("the evaluation ops disagree on the card")
    if not all(b > 0 and abs(a - b) <= 0.1 * b and c >= 0.75 * b
               for a, b, c in zip(evl["n_card"], evl["n_cpu"], evl["common"])):
        raise SmokeError("ISS keypoints on the card part from the CPU port's")

    ms = mesh_phase(cfg, sweeps, dev)
    print(f"[9] one device with mesh_runtime_overrides (no window compaction), "
          f"synchronous: {ms['ref_fps']:.3f} frames/s after the first (with it, [4]: "
          f"{res['fps']:.3f})", flush=True)
    print(f"[9] compute mode {ms['compute_mode']}; kernels A and B over the query "
          f"ranges {ms['ranges']} of the {ms['bucket']}-row cloud bit-identical to "
          f"the launch over every row: {ms['range_equal']}", flush=True)
    if not ms["range_equal"]:
        raise SmokeError("A or B over a query range differs from the full launch")
    def rounded(runs: dict) -> dict:
        return {k: [round(x, 3) for x in v] for k, v in runs.items() if v}

    mesh_paths = {}
    for ranks, run in ms["runs"].items():
        out, r0 = run["out"], run["out"][0]
        how = (f"graphed: {r0['captures']} captures in {r0['capture_s']:.3f} s, pool "
               f"{r0['pool_bytes']} bytes" if r0["graphed"] else
               "eager: gloo stages every collective through the host with a sync, "
               "which a capture refuses")
        print(f"[9] {ranks} rank(s) on cuda:0 ({run['backend']}; mesh {r0['mesh']}, "
              f"dims {r0['backends']}; {how}; spawn to finish {run['s']:.1f} s, of which "
              f"process start {run['start_s']:.1f} s, then "
              f"{', '.join(f'{n} {t:.1f} s' for n, t in r0['stage_s'].items())}): "
              f"frames/s {rounded(r0['fps'])} after the first frame, "
              f"{rounded(r0['steady_fps'])} over the {r0['steady_frames']} later frames "
              f"that captured nothing (ranks share one card: overhead, not scaling); "
              f"map rows per rank {r0['map_rows']}, live "
              f"rows per rank {[o['live_rows'] for o in out]}; query rows per rank "
              f"{[o['query_rows'] for o in out]} of bucket {r0['bucket']}; launches per "
              f"rank {[o['launches'] for o in out]}; collectives per frame "
              f"{r0['calls_per_frame']:.2f} calls, {r0['bytes_per_frame']:.0f} bytes "
              f"({', '.join(f'{n} {c:.2f}x {b:.0f} B' for n, (c, b) in r0['sites'].items())}); "
              f"pipelined syncs per frame between drains {[o['syncs_per_frame'] for o in out]} "
              f"({r0['sync_sites'] or 'none'}; calls that captured a graph, set aside: "
              f"{r0['census_captured']})", flush=True)
        same = all(o["records"] == ms["ref"] and o["pipe_records"] == ms["ref"]
                   for o in out)
        print(f"[9] {ranks} rank(s): synchronous and pipelined records bit-identical "
              f"to one device with mesh_runtime_overrides ({len(ms['ref'])} frames): "
              f"{same}", flush=True)
        if not same:
            raise SmokeError(f"the mesh's records at {ranks} rank(s) differ from "
                             "one device's")
        idle = [n for o in out for n in A_TO_E if not o["launches"][n]]
        if idle:
            raise SmokeError(f"kernels never launched on the mesh path: {idle}")
        if run["backend"] == "nccl":
            graphed_ok = all(o["graphed"] and o["captures"] > 0 for o in out)
            eager_same = all(o["records_all_equal"] and o["records_eager"] == ms["ref"]
                             and o["pipe_records_eager"] == ms["ref"] for o in out)
            print(f"[9] {ranks} rank(s), {card}: graphed {graphed_ok}; every synchronous "
                  f"run (eager, graphed, graphed, eager) and the pipelined runs graphed "
                  f"and eager bit-identical to one another and to one device: "
                  f"{eager_same}; collective calls and bytes per frame by site equal "
                  f"graphed and eager: {all(o['collectives_equal'] for o in out)}; A-E "
                  f"launches per rank equal graphed and eager: "
                  f"{all(o['launches_equal'] for o in out)}", flush=True)
            equal = all(o["collectives_equal"] and o["launches_equal"] for o in out)
            if not (graphed_ok and eager_same and equal):
                raise SmokeError("the graphed mesh engine is not graphed, or differs from "
                                 "the eager one in records, collectives or launches")
            if any(o["syncs_per_frame"] for o in out):
                raise SmokeError("the pipelined engine syncs between drains on NCCL")
            mesh_paths[f"mesh_{ranks}_ranks_24_graphed"] = r0["launches"]
        else:
            if any(o["graphed"] for o in out):
                raise SmokeError("a gloo mesh on the card was graphed")
            mesh_paths[f"mesh_{ranks}_ranks_24"] = r0["launches"]
        if "n_evicted" in r0:
            ev_same = all(o["evict_records"] == ms["ref_ev"] for o in out)
            print(f"[9] {ranks} rank(s): [4c]'s eviction drive evicted {r0['n_evicted']} "
                  f"(one device {ms['ref_evicted']}), evictions replayed from a graph "
                  f"{r0['evict_graphed']}; records bit-identical: {ev_same}", flush=True)
            if not (ev_same and r0["n_evicted"] == ms["ref_evicted"] > 0
                    and r0["evict_graphed"] == r0["graphed"]):
                raise SmokeError("the sharded eviction differs from one device's")
        if "ba" in r0:
            d = ms["dense"]
            err = [float(np.abs(o["ba"][f] - d[f]).max()) for o in out
                   for f in ("poses", "landmarks")]
            ok = all(o["ba"]["final_cost"] < o["ba"]["initial_cost"]
                     and np.allclose(o["ba"]["poses"], d["poses"], rtol=1e-3, atol=1e-2)
                     and np.allclose(o["ba"]["landmarks"], d["landmarks"], rtol=1e-3,
                                     atol=1.0) for o in out)
            how = (f"replayed from a graph, {r0['ba_captures']} capture" if r0["ba_graphed"]
                   else "eager")
            print(f"[9] {ranks} rank(s): sharded BA ({how}) cost "
                  f"{float(r0['ba']['initial_cost']):.1f} -> "
                  f"{float(r0['ba']['final_cost']):.4f} (dense "
                  f"{float(d['final_cost']):.4f}); largest difference from the dense "
                  f"solve (poses, landmarks) {err[:2]}; within rtol 1e-3 / atol 1e-2 "
                  f"and 1.0: {ok}; three solves each way, each graphed-side solve to its "
                  f"nearest eager one by field {r0['ba_near']}: within BA_LIMITS "
                  f"{all(o['ba_within'] for o in out)}", flush=True)
            if not (ok and all(o["ba_within"] for o in out)
                    and r0["ba_graphed"] == r0["graphed"]):
                raise SmokeError("the sharded bundle adjustment parts from the dense one, "
                                 "or its graphed solves from the eager ones")
    print("[9] graphed NCCL replay at 2-4 ranks needs a card per rank: NCCL refuses "
          "two ranks on one card, and gloo stays eager", flush=True)

    tl = tools_phase(work)
    for name, t in tl.items():
        for ln in t["lines"]:
            print(f"[10] {name}: {ln}", flush=True)
        print(f"[10] {name} (exit {t['rc']}, {t['s']:.1f} s, launches {t['launches']}): "
              f"{t['line']}", flush=True)
    bad = {n: t["idle"] for n, t in tl.items() if t["rc"] != 0 or t["result"] is None
           or t["idle"]}
    if bad:
        raise SmokeError(f"tools failed, printed no JSON line, or never launched "
                         f"their kernels: {bad}")
    g = tl["run_golden"]["result"]
    if not (g["ate_vs_cpu_gold_mm"] < GOLDEN_MM
            and g["ate_vs_ground_truth_mm"] < GOLDEN_PATH_SHARE * g["path_len_mm"]
            and g["min_inliers"] >= g["gate_min_inliers"]):
        raise SmokeError("the golden replay on the card parts from the CPU gold, "
                         "from ground truth, or matches too few inliers")

    gp = graphs_phase(cfg, sweeps, drive_sweeps, dev, dict(
        sync=sync_eng, pipe=pipe["eng"], overflow=pipe["overflow"],
        overflow_cfg=pipe["overflow_cfg"], fused_sync=fu["sync"], fused_pipe=fu["pipe"],
        spike=sp, backend=bk, gt=drive_gt))
    print(f"[11] {card}: each mode eager (graphs=False) and graphed (replaying the "
          f"earlier phase's captures) in turns, eager, graphed, graphed, eager "
          f"(frames/s with the first frame and the flush)", flush=True)
    bad = []
    for name, r in gp.items():
        if name in ("spike", "backend_129"):
            continue
        print(f"[11] {name}: frames/s graphed {[round(x['fps'], 3) for x in r['graphed']]}, "
              f"eager {[round(x['fps'], 3) for x in r['eager']]}; launches a frame "
              f"graphed {r['graphed'][0]['per_frame']:.2f}, eager "
              f"{r['eager'][0]['per_frame']:.2f} (equal per kernel: {r['launches_equal']}); "
              f"records bit-identical graphed vs eager {r['records_equal']}, vs the earlier "
              f"phase's {r['earlier_equal']}; pipelined frames re-run (graphed, eager) "
              f"{r['redispatched']}; re-runs through the dense step in the last "
              f"graphed run {r['dense_replays']}, eager {r['eager_dense']}; the "
              f"earlier run's captures {r['captures']} "
              f"(dense keys {r['dense_keys']}) in {r['capture_s']:.3f} s, pool "
              f"{r['pool_bytes']} bytes", flush=True)
        # Both modes re-run the same frames through the same dense body.
        dense_ok = r["dense_replays"] == r["eager_dense"]
        if name.startswith("overflow"):  # every re-run through the dense graph
            dense_ok = dense_ok and bool(r["dense_keys"]) and r["dense_replays"] > 0 and (
                "pipelined" not in name or r["dense_replays"] == r["redispatched"][0])
        if not (r["records_equal"] and r["earlier_equal"] and r["launches_equal"]
                and dense_ok):
            bad.append(name)
    o_s, o_p = gp["overflow_sync_12"], gp["overflow_pipelined_12"]
    print(f"[11] {card}: the window overflow's re-runs replayed from the dense step's "
          f"graph: launches a frame synchronous "
          f"{o_s['graphed'][0]['per_frame']:.2f}, pipelined "
          f"{o_p['graphed'][0]['per_frame']:.2f}; frames/s synchronous "
          f"{[round(x['fps'], 3) for x in o_s['graphed']]}, pipelined "
          f"{[round(x['fps'], 3) for x in o_p['graphed']]}; dense replays "
          f"{o_s['dense_replays']} and {o_p['dense_replays']} of 12 frames", flush=True)
    spk = gp["spike"]
    print(f"[11] spike: eager buckets {spk['buckets']}, graphed {spk['buckets_graphed']}; "
          f"{spk['redispatched']} frames re-run eagerly; records bit-identical to the "
          f"graphed runs of [7]: {spk['equal']}", flush=True)
    b = gp["backend_129"]
    print(f"[11] backend_129: records bit-identical {b['records_equal']}, loop edges "
          f"bit-identical {b['edges_equal']} ({b['closures']} closures); frames/s with "
          f"the passes {({k: round(v, 3) for k, v in b['fps'].items()})}; pass ms "
          f"{({k: [round(x, 1) for x in v] for k, v in b['pass_ms'].items()})}, then "
          f"corrections {({k: [round(x, 1) for x in v] for k, v in b['corr_ms'].items()})}; "
          f"ms a pass by part, eager {parts_line(b['parts']['eager'])}, graphed "
          f"{parts_line(b['parts']['graphed'])}; device launches by part of one pass, "
          f"eager {b['part_launches']['eager']}, graphed {b['part_launches']['graphed']}; "
          f"the final pass's records, corrections and keyframes bit-identical "
          f"{b['final_equal']}; "
          f"launches a frame eager {b['per_frame']['eager']:.2f}, graphed "
          f"{b['per_frame']['graphed']:.2f} (equal: {b['launches_equal']}); first run's "
          f"captures {b['captures']} ({b['pair_graphs']} loop pair; programs "
          f"{b['programs']}) in "
          f"{b['capture_s']:.3f} s, pool {b['pool_bytes']} bytes", flush=True)
    if not (spk["equal"] and spk["buckets"] == spk["buckets_graphed"]):
        bad.append("spike")
    if not (b["records_equal"] and b["edges_equal"] and b["launches_equal"]
            and b["final_equal"]
            and {"pair", "bow", "posegraph", "corr", "kf_add"} <= set(b["programs"])):
        bad.append("backend_129")
    if bad:
        raise SmokeError(f"graphed runs differ from eager ones: {bad}")

    fw = full_width_phase(cfg, dev, bk["eng"], bk["passes"])
    k = fw.pop("keyframes")
    print(f"[12] {card}: keyframe add {k['add_ms']:.4f} ms eager, "
          f"{k['add_graphed_ms']:.4f} ms graphed (copies in and out included), evict "
          f"{k['evict_ms']:.4f} ms eager (not graphed), on a {k['rows']}-row store (CUDA "
          f"events, median of 25), graphed add bit-identical to eager {k['equal']}; [4d] "
          f"added {k['adds_per_pass']:.1f} keyframes a pass", flush=True)
    if not k["equal"]:
        raise SmokeError("a keyframe add replayed from its graph differs")
    for name, r in fw.items():
        what = {"posegraph": f"{r.get('nodes')} nodes, {r.get('edges')} edges "
                             f"({r.get('masked')} masked), cost {r.get('cost')}",
                "bow": f"{r.get('rows')} rows filled from [4d]'s {r.get('filled_from')} "
                       "keyframes",
                "ba": f"64 keyframes, 4096 landmarks, 32768 observations, cost "
                      f"{r.get('cost')}"}[name]
        print(f"[12] {card}: {name} at full width ({what}): eager {r['eager_ms']:.3f} ms, "
              f"graphed {r['graphed_ms']:.3f} ms (median of 5, in turns); device "
              f"launches a call eager {r['eager_launches']}, graphed "
              f"{r['graphed_launches']}; capture {r['capture_s']:.3f} s; pool "
              f"{r['pool_bytes']} bytes; "
              + (f"graphed bit-identical to eager: {r['equal']}" if name != "ba" else
                 f"{r['eager_runs']} eager runs bit-identical: {r['eager_deterministic']}, "
                 f"their spread by field {r['spread']}, each graphed run to its nearest "
                 f"eager run {r['graphed_to_nearest_eager']}: within the limits "
                 f"{r['limits']} {r['ok']}; one observation dropped (a planted fault) "
                 f"{r['fault']} from them; limits between the two {r['limits_sound']}"),
              flush=True)
    pg = fw["posegraph"]
    print(f"[12] the {FULL_NODES}-node pose graph replayed: {pg['device_ms']:.3f} device-ms "
          f"a solve ({cfg.backend.gn_iterations} LM iterations); heaviest: "
          + "; ".join(f"{k} {ms:.3f} ms x{c}" for k, ms, c in pg["top"]), flush=True)
    if not (fw["posegraph"]["equal"] and fw["bow"]["equal"] and fw["ba"]["ok"]):
        raise SmokeError("a backend program replayed from its graph differs from the "
                         "eager one (BA: beyond its limits)")
    if not fw["ba"]["limits_sound"]:
        raise SmokeError("BA's limits do not lie between the eager solves' spread and "
                         "the planted fault")

    sh = shared_graphs_phase(cfg, sweeps[:8], dev)
    print(f"[13] two configurations (ransac_inlier_th_mm {cfg.match.ransac_inlier_th_mm} "
          f"and half of it) sharing one Graphs over 8 frames: each bit-identical to its "
          f"own graphs=False run {sh['equal']}; their records differ {sh['differ']}; "
          f"graph keys {sh['keys']} over {sh['configs']} configurations; hashing the "
          f"configuration {sh['hash_us']:.2f} us on this host", flush=True)
    if not (all(sh["equal"]) and sh["configs"] == 2):
        raise SmokeError("a Graphs shared by two configurations replays the wrong one")

    pl = pool_phase(cfg, sweeps, drive_sweeps, dev, bk["eng"].graphs)
    for r in pl["rows"]:
        print(f"[14] after {r['what']}: map capacity {r['capacity']}, {r['graphs']} graphs, "
              f"pool {r['pool_bytes']} bytes, state buffers {r['state_bytes']} bytes",
              flush=True)
    print(f"[14] {card}: the pool's peak {pl['peak']} bytes (limit {POOL_LIMIT}) over "
          f"{dict(pl['programs'])} graphs in one Graphs, the state buffers' "
          f"{pl['states_peak']} bytes; the allocator holds {pl['reserved']} bytes in all",
          flush=True)
    lg = pl["long"]
    print(f"[14] {card}: the long drive, {lg['frames']} frames in {lg['s']:.1f} s "
          f"({lg['frames'] / lg['s']:.3f} frames/s with {lg['passes']} passes): "
          f"{lg['records']} records, finite {lg['finite']}; {lg['keyframes']} keyframes, "
          f"{lg['kf_evicted']} evicted; map {lg['map_size']}, {lg['map_evicted']} "
          f"landmarks evicted; {lg['closures']} closures; passes at 256 or more keyframes "
          f"(ms) {[round(x, 1) for x in lg['full_passes']]}", flush=True)
    if not (lg["records"] == lg["frames"] and lg["finite"]
            and lg["keyframes"] == cfg.backend.max_keyframes and lg["kf_evicted"] > 0):
        raise SmokeError("the long drive lost records, went non-finite or never "
                         "filled its keyframe store")
    if pl["peak"] is None or pl["peak"] > POOL_LIMIT:
        raise SmokeError(f"the graphs' pool reached {pl['peak']} bytes, over "
                         f"{POOL_LIMIT} (or unmeasured)")

    paths = {"sync_24": res["launches"], "pipelined_24": pipe["launches"],
             "eviction_8": ev["launches"], "eviction_8_eager": ev["eager_launches"],
             **{f"{name}_dense_replay": gp[name]["graphed"][0]["launches"]
                for name in ("overflow_sync_12", "overflow_pipelined_12")},
             "backend_129": bk["launches"],
             "pcap_native_stream": pc["launches"], "resume_65": rs["launches"],
             "bench_129": bench["launches"], "fused_sync_24": fu["launches"],
             "fused_pipelined_24": fu["pipe_launches"], "fused_spike": sp["launches"],
             "iss_2": evl["launches"], **mesh_paths,
             **{f"tool_{n}": t["launches"] for n, t in tl.items()}}

    def runs(path):  # the kernels a path runs
        if path == "iss_2":
            return ["neighborhood_accumulate"]
        if path.startswith("tool_"):
            return []  # checked above, tool by tool
        return [k for k in kernel_wrappers()
                if k != "ground_walk" or path.startswith("fused")]

    idle = {p: [k for k in runs(p) if not c.get(k)] for p, c in paths.items()}
    idle = {p: ks for p, ks in idle.items() if ks}
    if idle or not all(loop_cd.values()):
        raise SmokeError(f"kernels never launched on a path: {idle}, loop "
                         f"verification {loop_cd}")

    keys = ("name", "source", "replaces", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err", "device_ms",
            "device_launches_per_call", "host_us_per_call")
    kernels = []
    for r in rows + [wr]:
        k = {key: r[key] for key in keys}
        if "by_rows" in r:  # each size's columns (A, B and H's wide form among them)
            k["by_rows"] = r["by_rows"]
        # over the whole engine run of its main path: [4] for A-E, [7]'s
        # synchronous fused run for F
        n = fu["launches"]["ground_walk"] if r is wr else res["launches"][r["name"]]
        k.update(route="cuda", launches=n, frames=N_FRAMES,
                 launches_per_frame=n / N_FRAMES,
                 launches_by_path={p: c.get(r["name"], 0) for p, c in paths.items()})
        if r["name"] in loop:
            lr = loop[r["name"]]
            k["loop_verification"] = dict(
                {key: lr[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "max_abs_err", "device_ms",
                                          "device_launches_per_call")},
                shapes=lr["shapes"], launches=loop_cd[r["name"]],
                passes=len(bk["passes"]))
        kernels.append(k)
    print(f"[15] whole script {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
