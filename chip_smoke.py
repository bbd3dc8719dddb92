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
  5. one JSON line of per-kernel results (`launches` counts the whole
     engine run of `frames` frames, `launches_per_frame` divides it), the
     card line again, and the result line {"ok": true, "device": {...}}.

Any failed phase exits non-zero.  Without a visible CUDA device, or without
the `bshot_slam_tpu_torch` package beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

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
PREFILL = 65536
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


def render_drive(cfg):
    from bshot_slam_tpu_torch.io import synthetic

    return synthetic.render_sequence(
        N_FRAMES, cfg.sensor, step_mm=400.0, noise_mm=20.0, seed=0,
        n_firings=cfg.sensor.n_azimuth, yaw_rate_rad=2 * math.pi / 129,
    )


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


def prefilled_map(cfg, device, n: int = PREFILL):
    """MapState at full capacity with `n` random valid landmarks far outside
    the drive's query window (the benchmark's prefill)."""
    import torch

    from bshot_slam_tpu_torch.odometry import mapstore

    rng = np.random.default_rng(42)
    pos = rng.uniform(1.9e6, 2.1e6, (n, 3)).astype(np.float32)
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

    dev = torch.device("cuda")
    card = card_line()
    print(f"[1] card: {card}", flush=True)
    print(f"[1] kernels built in {build_all():.2f} s", flush=True)

    cfg = default_config()
    t0 = time.perf_counter()
    sweeps, gt = render_drive(cfg)
    print(f"[2] rendered {len(sweeps)} frames in {time.perf_counter() - t0:.1f} s; "
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

    res, _ = run_engine(cfg, sweeps, gt, dev)
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

    keys = ("name", "source", "replaces", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "max_abs_err", "device_ms",
            "device_launches_per_call", "host_us_per_call")
    kernels = []
    for r in rows:
        k = {key: r[key] for key in keys}
        n = res["launches"][r["name"]]  # over the whole engine run
        k.update(route="cuda", launches=n, frames=N_FRAMES,
                 launches_per_frame=n / N_FRAMES)
        kernels.append(k)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
