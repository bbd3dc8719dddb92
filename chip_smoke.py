#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`bshot_slam_tpu_torch`) on one card.

    python3 chip_smoke.py

Phases, one line each:
  1. the card (nvidia-smi name and power limit) and the kernel build;
  2. the first 24 frames of the benchmark drive (synthetic HDL-32E);
  3. each CUDA kernel A-E at the main path's shapes against its plain
     PyTorch version: integer outputs exactly equal to the plain version
     run on CPU copies of the inputs, float outputs within the stated
     tolerance, no row differing from the plain version run on the card,
     every kernel bit-identical over two runs on the same inputs; kernel and
     plain times on the card (CUDA events, median of 25), the kernel's
     device-only time and device launches per call (`torch.profiler`) and
     the host's time per wrapper call;
  4. `SlamEngine.process_sweep` end to end over the 24 frames, with the
     map prefilled to 65,536 far-away landmarks: frames/s, ATE against
     ground truth, the quality guard (ATE < 10% of path, >= 15 inliers on
     one of the last 8 frames), and every kernel launched on that path;
     then where a frame's time goes: the host preprocess alone, and a
     `torch.profiler` pass over 6 frames of a second engine (device busy
     time per frame, the device kernels that take the most of it);
     the port's own kernels per frame (kernel D: one device launch per
     ICP iteration; B and C: at most two device launches per call, E one);
  4b. the pipelined engine (`pipelined=True, fetch_every=8`) over the same
     24 frames and prefilled map: records bit-identical to phase [4]'s
     synchronous run, frames/s of both, and the synchronising calls per
     frame between drains (`torch.cuda.set_sync_debug_mode("warn")`, by
     source line); then a forced window overflow (`window_cap` 256, below
     the frames' windows) through abort and re-run, whose records must equal
     the synchronous engine's at that setting;
  4c. eviction at full capacity: the map prefilled to within one frame of
     `cfg.map.capacity`, so the pipelined engine evicts (`n_evicted`); then
     `evict_keypoints` on the card against the same call on CPU copies,
     every field exact, and its time on the card;
  4d. the backend at full width over `bench.py`'s whole drive (129 frames,
     64k-landmark prefill, `pipelined=True, enable_backend=True,
     backend_every=32`): keyframes, pairs verified, closures, the best
     candidate's inliers, each pass's time and its kernel C and D launches,
     ATE before and after a final `apply_backend_corrections()`, the
     quality guard; then kernels C and D at the loop-verification shape
     (two of the drive's keyframes, 600 against 600) against their plain
     versions, as in phase [3];
  5. one JSON line of per-kernel results (`launches` counts the main path,
     phase [4]'s engine run of `frames` frames, `launches_per_frame`
     divides it; `launches_by_path` counts each later path alone, from 0;
     C's and D's `loop_verification` the 600 x 600 check), the card line
     again, and the result line {"ok": true, "device": {...}}.

The drive is rendered once, in a pool of worker processes; the script's
wall time is printed before the JSON lines.

Any failed phase exits non-zero.  Without a visible CUDA device, or without
the `bshot_slam_tpu_torch` package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
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

# H100 SXM: 132 SMs at the 1.98 GHz boost clock, 3.35 TB/s of HBM3.  Lanes
# per SM per clock by instruction class (compute capability 9.0): f32 add,
# multiply, FMA and compare 128 (67 TFLOP/s with an FMA as 2 flops); 32-bit
# integer add, compare and logic 64; popc 16.  An SM dispatches at most 128
# lanes per clock over all classes.
H100_LANES_PER_S = 132 * 1.98e9
H100_LANES = {"f32": 128, "int": 64, "popc": 16}
H100_DISPATCH_LANES = 128
H100_BYTES_PER_S = 3.35e12
N_FRAMES = 24
N_DRIVE = 129  # bench.py's drive, one full circle
PREFILL = 65536
FETCH_EVERY = 8
BACKEND_EVERY = 32
OVERFLOW_WINDOW = 256  # phase [4b]'s window_cap, below the frames' windows
REPEATS = 25
# The bound of A and B counts the radius tests that a box prune at this
# grain (query rows x candidate rows) leaves: a property of the cloud, fixed
# here so that a kernel's own tiling cannot move its own bound.
PRUNE_GRAIN = 128


class SmokeError(RuntimeError):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


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


def profiled(warm_up, work):
    """`torch.profiler` events of work() on the card.  warm_up() runs as the
    profiler's warm-up step: the first launches after tracing starts can go
    unrecorded."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        warm_up()
        torch.cuda.synchronize()
        prof.step()
        work()
        torch.cuda.synchronize()
        prof.step()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")]  # the step's own span


def device_profile(fn, calls: int = 20):
    """(device ms per call, device launches per call) of fn(): the summed
    durations and the count of what `torch.profiler` saw run on the card."""
    for _ in range(3):  # a trace that lost records shows in the count: again
        on_card = profiled(fn, lambda: [fn() for _ in range(calls)])
        launches = sum(e.count for e in on_card)
        if launches and launches % calls == 0:
            break
    return sum(e.self_device_time_total for e in on_card) / calls / 1e3, launches / calls


def measure(fn, plain_fn) -> dict:
    """The timing columns of one kernel's row."""
    device_ms, launches = device_profile(fn)
    return dict(ms=time_ms(fn), plain_ms=time_ms(plain_fn), device_ms=device_ms,
                device_launches_per_call=launches, host_us_per_call=host_us(fn))


def same_bits(a, b) -> bool:
    import torch

    return all(torch.equal(x.view(torch.uint8), y.view(torch.uint8))
               for x, y in zip(a, b))


def bound(nbytes: float, ops: dict):
    """Least time in ms for the work and what sets it.  `ops` counts
    instructions (one per lane) by class; the time for them is the longest
    of each class at its own rate and of all of them at the dispatch rate."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = max([n / (H100_LANES[c] * H100_LANES_PER_S) for c, n in ops.items()]
                + [sum(ops.values()) / (H100_DISPATCH_LANES * H100_LANES_PER_S)]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scaled(ops: dict, n: float) -> dict:
    return {c: k * n for c, k in ops.items()}


def radius_tests(points: np.ndarray, mask: np.ndarray, r2: float,
                 tile: int = PRUNE_GRAIN) -> float:
    """Radius tests a box prune at `tile` x `tile` rows leaves kernels A and
    B: pairs of valid rows in the (query block, candidate tile) pairs that
    are not separated (the same test as `separated` in
    csrc/neighborhood.cu, in float64)."""
    n = points.shape[0]
    nb = -(-n // tile)
    lo = np.full((nb, 3), np.inf)
    hi = np.full((nb, 3), -np.inf)
    n2 = np.zeros(nb)
    cnt = np.zeros(nb)
    p = points.astype(np.float64)
    for b in range(nb):
        rows = p[b * tile:(b + 1) * tile][mask[b * tile:(b + 1) * tile]]
        if len(rows):
            lo[b], hi[b] = rows.min(0), rows.max(0)
            n2[b] = (rows * rows).sum(1).max()
            cnt[b] = len(rows)
    gap = np.maximum(lo[:, None] - hi[None], lo[None] - hi[:, None])
    lim = r2 + (n2[:, None] + n2[None] + r2) * 2.0 ** -18
    far = ((gap > 0) & (gap * gap > lim[..., None])).any(-1)
    keep = ~far & (cnt[:, None] > 0) & (cnt[None] > 0)
    return float((cnt[:, None] * cnt[None])[keep].sum())


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


def frame_cloud(cfg, sweep):
    """Host preprocess of one sweep: (points (bucket, 3), n_valid)."""
    from bshot_slam_tpu_torch.odometry.engine import pick_bucket
    from bshot_slam_tpu_torch.ops import preprocess_host as ph
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image

    ri = build_range_image(sweep, cfg.sensor)
    cl, xyz, valid = ph.preprocess_host(ri.range_mm, ri.azimuth_rad,
                                        ri.vert_rad, cfg.preprocess)
    pts, nv = ph.extract_cloud_host(cl, xyz, valid, None,
                                    cfg.preprocess.max_points)
    points = np.zeros((pick_bucket(nv, cfg), 3), np.float32)
    points[:nv] = pts
    return points, nv


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
    tests = radius_tests(points_np, np.arange(N) < nv, r * r)
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
    """Kernels C, D and E at the main path's shapes."""
    import torch

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
    return rows


# ---------------------------------------------------------------------------
# Phase 4: the engine


def run_engine(cfg, sweeps, gt, dev):
    import torch

    from bshot_slam_tpu_torch.kernels import mapops, neighborhood
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.utils.metrics import ate_rmse

    wrappers = {
        "neighborhood_accumulate": neighborhood.neighborhood_accumulate,
        "segratio_accumulate": neighborhood.segratio_accumulate,
        "hamming_nn_bounded": mapops.hamming_nn_bounded,
        "euclid_nn_bounded": mapops.euclid_nn_bounded,
        "dedup_blocked_bounded": mapops.dedup_blocked_bounded,
    }
    eng = SlamEngine(cfg, seed=0, device=dev)
    eng.state = eng.state._replace(map=prefilled_map(cfg, dev))
    for w in wrappers.values():
        w.launches = 0
    times = []
    for sw in sweeps:
        t0 = time.perf_counter()
        eng.process_sweep(sw)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launches = {k: w.launches for k, w in wrappers.items()}
    fps = (len(times) - 1) / sum(times[1:])
    gt_rel = np.linalg.inv(gt[0])[None] @ gt
    gt_pos = gt_rel[:, :3, 3]
    ate = float(ate_rmse(eng.trajectory, gt_pos, align=False))
    path = float(np.linalg.norm(np.diff(gt_pos, axis=0), axis=1).sum())
    tail_inliers = [r.n_inliers for r in eng.records[-8:]]
    return dict(fps=fps, ate_mm=ate, path_mm=path, tail_inliers=tail_inliers,
                launches=launches, map_size=eng.records[-1].map_size,
                first_frame_s=times[0]), eng


def host_preprocess_ms(cfg, sweeps) -> float:
    """Mean host time of range image + classify + extract per frame."""
    t0 = time.perf_counter()
    for sw in sweeps:
        frame_cloud(cfg, sw)
    return (time.perf_counter() - t0) / len(sweeps) * 1e3


# The __global__ functions of csrc/*.cu, as the profiler names them.
PORT_KERNELS = ("pack_cloud_kernel", "accumulate_kernel", "segratio_kernel",
                "hamming_kernel", "euclid_kernel", "dedup_kernel")
# Most device launches a call of a wrapper may make.
MAX_DEVICE_LAUNCHES = {"segratio_accumulate": 2, "hamming_nn_bounded": 2,
                       "dedup_blocked_bounded": 1}


def profile_engine(cfg, sweeps, dev, n: int = 6):
    """Device kernel time per frame, the heaviest device kernels and the
    port's own kernels (ms and launches per frame), over n frames of a
    fresh engine (frames 0 and 1 run before the window)."""
    import torch

    from bshot_slam_tpu_torch.odometry.engine import SlamEngine

    eng = SlamEngine(cfg, seed=0, device=dev)
    eng.state = eng.state._replace(map=prefilled_map(cfg, dev))
    eng.process_sweep(sweeps[0])
    torch.cuda.synchronize()
    kernels = profiled(lambda: eng.process_sweep(sweeps[1]),
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
    from bshot_slam_tpu_torch.kernels import mapops, neighborhood

    return {
        "neighborhood_accumulate": neighborhood.neighborhood_accumulate,
        "segratio_accumulate": neighborhood.segratio_accumulate,
        "hamming_nn_bounded": mapops.hamming_nn_bounded,
        "euclid_nn_bounded": mapops.euclid_nn_bounded,
        "dedup_blocked_bounded": mapops.dedup_blocked_bounded,
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
    and the source lines of the synchronising calls made outside drains."""
    import torch

    calls, sites = [], [collections.Counter(), collections.Counter()]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for i, sw in enumerate(sweeps):
            n_rec = len(eng.records)
            with warnings.catch_warnings(record=True) as ws:
                warnings.simplefilter("always")
                eng.process_sweep(sw)
            syncs = [w for w in ws if "synchroniz" in str(w.message)]
            drained = len(eng.records) != n_rec
            calls.append((len(syncs), drained))
            if not drained:  # [first call, later calls between drains]
                for w in syncs:
                    sites[min(i, 1)][f"{pathlib.Path(w.filename).name}:{w.lineno}"] += 1
        eng.flush()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return calls, sites


def pipelined_phase(cfg, sweeps, sync_eng, dev) -> dict:
    """Phase [4b]."""
    import torch

    from bshot_slam_tpu_torch.odometry.engine import SlamEngine

    def fresh(c=cfg, pipelined=True):
        eng = SlamEngine(c, seed=0, device=dev, pipelined=pipelined,
                         fetch_every=FETCH_EVERY)
        eng.state = eng.state._replace(map=prefilled_map(c, dev))
        return eng

    pipe = fresh()
    fps, launches = counted(lambda: drive(pipe, sweeps))
    census = fresh()
    calls, sites = sync_census(census, sweeps)
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
        redispatched=runs[1].n_redispatched, overflow_frames=len(runs[1].records))


def eviction_phase(cfg, sweeps, dev) -> dict:
    """Phase [4c]: the map starts one frame short of its hard capacity, in
    dense far blocks (so eviction takes them, not the drive's own map)."""
    import torch

    from bshot_slam_tpu_torch.odometry import mapstore
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine

    cap, k = cfg.map.capacity, cfg.keypoints.top_k
    eng = SlamEngine(cfg, seed=0, device=dev, pipelined=True, fetch_every=FETCH_EVERY)
    full = prefilled_map(cfg, dev, n=cap - k - 100, far=(1.9e6, 1.95e6))
    eng.state = eng.state._replace(map=full)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _, launches = counted(lambda: drive(eng, sweeps[:8]))
    n_evict = min(2 * k, cap // 2)
    m = eng.state.map
    want = mapstore.evict_keypoints(mapstore.MapState(*cpu(*m)), n_evict)
    outs = [mapstore.evict_keypoints(m, n_evict) for _ in range(2)]
    exact = all(torch.equal(g.cpu(), w) for out in outs for g, w in zip(out, want))
    return dict(n_evicted=eng.n_evicted, launches=launches, exact=exact,
                cursor=int(m.cursor), evicted_now=int(m.cursor) - int(want.cursor),
                ms=time_ms(lambda: mapstore.evict_keypoints(m, n_evict)),
                cpu_ms=time_ms(lambda: mapstore.evict_keypoints(
                    mapstore.MapState(*cpu(*m)), n_evict), repeats=5),
                tail_inliers=[r.n_inliers for r in eng.records[-4:]])


def backend_phase(cfg, sweeps, gt, dev) -> dict:
    """Phase [4d]: the whole drive with the backend, each pass timed and its
    kernel launches counted."""
    import torch

    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.utils.metrics import ate_rmse

    eng = SlamEngine(cfg, seed=0, device=dev, pipelined=True, fetch_every=FETCH_EVERY,
                     enable_backend=True, backend_every=BACKEND_EVERY)
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
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        t0 = time.perf_counter()
        _, launches = counted(lambda: [eng.process_sweep(sw) for sw in sweeps]
                              + [eng.flush()])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    gt_pos = (np.linalg.inv(gt[0])[None] @ gt)[:, :3, 3]
    path = float(np.linalg.norm(np.diff(gt_pos, axis=0), axis=1).sum())
    ate_before = float(ate_rmse(eng.trajectory, gt_pos, align=False))
    t0 = time.perf_counter()
    eng.optimize_backend()
    corr = eng.apply_backend_corrections()
    torch.cuda.synchronize()
    final_ms = (time.perf_counter() - t0) * 1e3
    ate_after = float(ate_rmse(eng.trajectory, gt_pos, align=False))
    return dict(eng=eng, passes=passes, launches=launches, wall_s=wall,
                fps=len(sweeps) / wall, path_mm=path, ate_before=ate_before,
                ate_after=ate_after, final_ms=final_ms, correction=corr,
                keyframes=eng._kf_count, map_size=eng.records[-1].map_size,
                n_evicted=eng.n_evicted,
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
    from bshot_slam_tpu_torch.kernels import build_all
    from bshot_slam_tpu_torch.odometry.engine import pick_bucket

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"[1] card: {card}", flush=True)
    print(f"[1] kernels built in {build_all():.2f} s", flush=True)

    cfg = default_config()
    t0 = time.perf_counter()
    drive_sweeps, drive_gt = render_drive(cfg, N_DRIVE)
    sweeps, gt = drive_sweeps[:N_FRAMES], drive_gt[:N_FRAMES]
    print(f"[2] rendered {len(drive_sweeps)} frames in {time.perf_counter() - t0:.1f} s; "
          f"host preprocess {host_preprocess_ms(cfg, sweeps):.2f} ms/frame", flush=True)

    points, nv = frame_cloud(cfg, sweeps[3])
    assert points.shape[0] == pick_bucket(nv, cfg)
    rows = check_neighborhood(cfg, points, nv, dev) + check_mapops(cfg, dev)
    torch.cuda.synchronize()
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
        if (r["int_mismatch"] or r["float_out_of_tol"]
                or r["card_plain_rows_differ"] or not r.get("deterministic", True)):
            failed.append(r["name"])
    if failed:
        raise SmokeError("kernels disagree with their plain versions, or with "
                         f"themselves over two runs: {failed}")
    wide = {r["name"]: r["device_launches_per_call"] for r in rows
            if r["device_launches_per_call"] > MAX_DEVICE_LAUNCHES.get(r["name"], 99)}
    if wide:  # a trace can lose records, not add them
        raise SmokeError(f"more device launches per call than allowed: {wide}")

    res, sync_eng = run_engine(cfg, sweeps, gt, dev)
    print(f"[4] engine: {N_FRAMES} frames, {res['fps']:.3f} frames/s after the "
          f"first ({res['first_frame_s']:.2f} s), ATE {res['ate_mm']:.1f} mm on a "
          f"{res['path_mm']:.0f} mm path, tail inliers {res['tail_inliers']}, "
          f"map {res['map_size']}, launches {res['launches']}", flush=True)
    if not res["ate_mm"] < 0.10 * res["path_mm"]:
        raise SmokeError("quality guard: ATE >= 10% of the path")
    if max(res["tail_inliers"]) < cfg.match.gate_min_inliers:
        raise SmokeError("quality guard: too few inliers on the last 8 frames")
    idle = [k for k, n in res["launches"].items() if n == 0]
    if idle:
        raise SmokeError(f"kernels never launched on the main path: {idle}")
    dev_ms, n_kernels, top, own = profile_engine(cfg, sweeps, dev)
    frame_ms = 1e3 / res["fps"]
    print(f"[4] breakdown: frame {frame_ms:.2f} ms unprofiled; device kernels "
          f"{dev_ms:.2f} ms/frame in {n_kernels:.0f} launches (busy "
          f"{100 * dev_ms / frame_ms:.1f}%); heaviest: "
          + "; ".join(f"{k} {ms:.3f} ms x{c:.0f}" for k, ms, c in top), flush=True)
    print("[4] the port's kernels per frame: "
          + "; ".join(f"{k} {ms:.4f} ms x{c:.0f}" for k, ms, c in own), flush=True)
    icp = sum(c for k, _, c in own if k == "euclid_kernel")
    if icp > cfg.match.icp_iterations:  # a trace can lose records, not add them
        raise SmokeError(f"kernel D made {icp} device launches per frame, more than "
                         f"one per ICP iteration ({cfg.match.icp_iterations})")

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
          f"pipelined evicted {ev['n_evicted']} keypoints (tail inliers "
          f"{ev['tail_inliers']}); evict_keypoints at cursor {ev['cursor']} "
          f"drops {ev['evicted_now']} rows, card equal to CPU copies in every "
          f"field, twice: {ev['exact']}; {ev['ms']:.3f} ms on the card (CPU "
          f"{ev['cpu_ms']:.1f} ms); launches {ev['launches']}", flush=True)
    if not ev["n_evicted"] or not ev["exact"]:
        raise SmokeError("eviction did not run, or the card differs from the CPU")

    bk = backend_phase(cfg, drive_sweeps, drive_gt, dev)
    for i, ps in enumerate(bk["passes"]):
        print(f"[4d] backend pass {i}: {ps['keyframes']} keyframes, "
              f"{ps['verified']} pairs verified, {ps['closures']} closures, best "
              f"candidate {ps['best_inliers']} inliers, {ps['ms']:.1f} ms, kernel C "
              f"x{ps['launches']['hamming_nn_bounded']}, D "
              f"x{ps['launches']['euclid_nn_bounded']}", flush=True)
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
    paths = {"sync_24": res["launches"], "pipelined_24": pipe["launches"],
             "eviction_8": ev["launches"], "backend_129": bk["launches"]}
    idle = {p: [k for k, n in c.items() if n == 0] for p, c in paths.items()}
    idle = {p: ks for p, ks in idle.items() if ks}
    if idle or not all(loop_cd.values()):
        raise SmokeError(f"kernels never launched on a path: {idle}, loop "
                         f"verification {loop_cd}")

    keys = ("name", "source", "replaces", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err", "device_ms",
            "device_launches_per_call", "host_us_per_call")
    kernels = []
    for r in rows:
        k = {key: r[key] for key in keys}
        n = res["launches"][r["name"]]  # over the whole engine run
        k.update(route="cuda", launches=n, frames=N_FRAMES,
                 launches_per_frame=n / N_FRAMES,
                 launches_by_path={p: c[r["name"]] for p, c in paths.items()})
        if r["name"] in loop:
            lr = loop[r["name"]]
            k["loop_verification"] = dict(
                {key: lr[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                          "max_abs_err", "device_ms",
                                          "device_launches_per_call")},
                shapes=lr["shapes"], launches=loop_cd[r["name"]],
                passes=len(bk["passes"]))
        kernels.append(k)
    print(f"[5] whole script {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
