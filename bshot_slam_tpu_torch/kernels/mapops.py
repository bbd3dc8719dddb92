"""Map-facing bounded nearest-neighbour ops, CUDA kernels C, D and E, and
the ICP update that consumes D, kernel G.

C, `hamming_nn_bounded`, replaces the Pallas kernel
bshot_slam_tpu/kernels/mapops.py:hamming_nn_bounded (two-sided Hamming
nearest neighbours, one launch per frame); D, `euclid_nn_bounded`, replaces
euclid_nn_bounded (ICP correspondences, 10 launches per frame); E,
`dedup_blocked_bounded`, replaces dedup_blocked_bounded (insert dedup, one
launch per frame).

Candidates are front-compacted: rows [0, n_valid) hold the map (or the
compacted window) and, when `tail_start >= 0`, rows [tail_start, end) hold
the previous frame's keypoints; rows in between are dead.  Invalid or dead
pairs count as distance 3e38; a row with no candidate reports (3e38, 0);
ties go to the lowest index.  Descriptors are packed (., 11) int32 words
holding the uint32 bit patterns.

The CUDA side (csrc/mapops.cu).  C is one launch per call that computes
each distance once for both sides: a grid of (split of the live rows, block
of 64 sources), two sources per lane in registers, 32-bit keys
(distance << 20 | index) whose minimum stays in a register per source and
is one warp reduction per row, then per-block keys in scratch and two
last-block merges (per source over the splits, per row over the source
blocks) that write minima and indices directly; it takes fewer than 2^20
rows on either side.  D is one launch per call: a grid of (split of the
live rows, block of 64 queries), two queries per lane in registers,
per-block (distance bits << 32 | index) keys in scratch and the last block
of a query block writing the minimum over the splits.  E is one launch per
call in D's shape: a grid of (split of the live rows, block of 64
newcomers), two newcomers per lane in registers, rows staged with a 32-bit
key of their voxel block and a NaN seg ratio where masked, a fast test per
pair of keys and seg ratios with the exact block compare and the distance
behind it, flag bits ORed per block into scratch and the last block of a
newcomer block writing the (k,) bools.  The wrappers keep C's, D's and E's
scratch per device, stream and shape.  The work per pair of valid live
rows, by instruction class, is in `HAMMING_PAIR_OPS`, `EUCLID_PAIR_OPS`, `DEDUP_PAIR_OPS` and
`DEDUP_SAME_BLOCK_OPS` (csrc/mapops.cu says how they are counted);
`chip_smoke.py` turns them into the bound at the main path's shapes.

G, `icp_update`, replaces no Pallas kernel: it is an ICP iteration's
update after D (`ops/icp.py`), which the plain path runs as ~235 PyTorch
operations (the weighted Kabsch step of `geometry/se3.py`, the identity
fallback, the composition, the rmse and the next iteration's source
points).  One launch per call, one block: the sums in a fixed tree, Horn's
solve in one thread, then every thread moves its rows of the source.  The
pose and the moved source are updated in place (`IcpState`), so an ICP of
n iterations is one G launch to start and n of D and G.  Its work per
source row and per call is in `ICP_ROW_OPS`, `ICP_ROW_BYTES`,
`ICP_CALL_OPS` and `ICP_CALL_BYTES`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bshot_slam_tpu_torch.geometry import se3
from bshot_slam_tpu_torch.kernels import (
    BIG, _build, device_count_arg, on_cpu, pair_d2, ptr, require, scratch,
    stream_arg,
)

N_WORDS = 11
_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F

# Instructions per pair by class: "f32" (add, multiply, FMA, compare),
# "int" (32-bit integer add, compare, logic), "popc".  C's are those of the
# cheapest form known for 11 words: 11 XOR, 7 carry-save adders of 2 logic
# instructions each, 4 popc, 3 weighted adds and one minimum for each side.
HAMMING_PAIR_OPS = {"int": 30, "popc": 4}
EUCLID_PAIR_OPS = {"f32": 8}
DEDUP_PAIR_OPS = {"int": 1, "f32": 1}
DEDUP_SAME_BLOCK_OPS = {"int": 3, "f32": 8}
# Kernel D: queries per block, most rows a block stages, and the blocks it
# aims to have in flight (two on each of the 132 SMs).
EUCLID_QUERIES = 64
EUCLID_ROWS = 2048
EUCLID_BLOCKS = 264
# Kernel C: sources per block, most rows a block stages and the rows either
# side may have (a key holds an index in 20 bits).
HAMMING_SOURCES = 64
HAMMING_ROWS = 512
HAMMING_MAX_ROWS = 1 << 20
# Kernel E: newcomers per block (two per lane) and most rows a block stages.
DEDUP_NEWCOMERS = 64
DEDUP_ROWS = 640
# Kernel G's work by instruction class and its bytes.  Per source row, 52
# f32: the pair test and sums of pass 1 (4), the pair test, weight and
# means' products and adds of pass 2 (15), the pair test, weight, centring
# and 9 FMAs of pass 3 (21), the move under the new pose (12).  Bytes per
# row, each read or written once: source, mask, d2, index, candidate, the
# moved source read and written.  Per call: 17 sums through the block's
# tree (5 adds a lane in each of 1024 + 32 lanes) and the serial part in
# one thread, ~934 (Horn's matrix 45, 30 power iterations of 26, the
# rotation 30, t 12, the composition 64, the rmse 3), whose latency, not
# its count, is what bounds G.
ICP_ROW_OPS = {"f32": 52}
ICP_ROW_BYTES = 12 + 1 + 4 + 4 + 12 + 12 + 12
ICP_CALL_OPS = {"f32": 17 * 5 * (1024 + 32) + 934}
ICP_CALL_BYTES = 16 * 4 * 2 + 8


def popcount_distances(a_words: torch.Tensor, b_words: torch.Tensor) -> torch.Tensor:
    """(Na, W) x (Nb, W) packed words -> (Na, Nb) int32 XOR-popcount."""
    x = (a_words[:, None, :] ^ b_words[None, :, :]).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & _M1)
    x = (x & _M2) + ((x >> 2) & _M2)
    x = (x + (x >> 4)) & _M4
    x = (x * 0x01010101 & 0xFFFFFFFF) >> 24
    return torch.sum(x, dim=-1).to(torch.int32)


def _live_rows(n_rows: int, n_valid, tail_start: int, device) -> torch.Tensor:
    j = torch.arange(n_rows, dtype=torch.int32, device=device)
    live = j < n_valid
    if tail_start >= 0:
        live = live | (j >= tail_start)
    return live


def _min_argmin(d: torch.Tensor, dim: int):
    arg = torch.argmin(d, dim=dim)  # first (lowest-index) minimum
    return torch.gather(d, dim, arg.unsqueeze(dim)).squeeze(dim), arg.to(torch.int32)


def _no_pairs(ka: int, cb: int, device):
    """Kernel C's outputs when a side is empty: every row reports (3e38, 0)."""
    return (torch.full((ka,), BIG, dtype=torch.float32, device=device),
            torch.zeros((ka,), dtype=torch.int32, device=device),
            torch.full((cb,), BIG, dtype=torch.float32, device=device),
            torch.zeros((cb,), dtype=torch.int32, device=device))


def hamming_nn_bounded_plain(a_words, a_mask, b_words, b_mask, n_valid_b,
                             tail_start: int = -1, chunk: int = 2048):
    """Plain PyTorch version of kernel C (XOR-popcount distances)."""
    if a_words.shape[0] == 0 or b_words.shape[0] == 0:
        return _no_pairs(a_words.shape[0], b_words.shape[0], a_words.device)
    ok_b = b_mask & _live_rows(b_words.shape[0], n_valid_b, tail_start,
                               b_words.device)
    parts = []
    for c0 in range(0, b_words.shape[0], chunk):
        ok = a_mask[:, None] & ok_b[None, c0:c0 + chunk]
        if not ok.any():  # dead rows (past the cursor): no distance to take
            parts.append(torch.full(ok.shape, BIG, device=ok.device))
            continue
        d = popcount_distances(a_words, b_words[c0:c0 + chunk]).to(torch.float32)
        parts.append(torch.where(ok, d, BIG))
    d = torch.cat(parts, dim=1)
    a_min, a_arg = _min_argmin(d, 1)
    b_min, b_arg = _min_argmin(d, 0)
    return a_min, a_arg, b_min, b_arg


def hamming_nn_bounded(a_words: torch.Tensor, a_mask: torch.Tensor,
                       b_words: torch.Tensor, b_mask: torch.Tensor, n_valid_b,
                       tail_start: int = -1):
    """Two-sided Hamming nearest neighbours of packed B-SHOTs.

    Returns (a_min (Ka,) f32, a_arg (Ka,) i32, b_min (Cb,), b_arg (Cb,))."""
    if on_cpu(a_words, a_mask, b_words, b_mask):
        return hamming_nn_bounded_plain(a_words, a_mask, b_words, b_mask,
                                        n_valid_b, tail_start)
    ka, cb = a_words.shape[0], b_words.shape[0]
    if max(ka, cb) >= HAMMING_MAX_ROWS:
        raise ValueError(f"kernel C takes fewer than {HAMMING_MAX_ROWS} sources "
                         f"and candidates, got {ka} and {cb}")
    dev = a_words.device
    require(a_words, "a_words", torch.int32, (ka, N_WORDS))
    require(a_mask, "a_mask", torch.bool, (ka,))
    require(b_words, "b_words", torch.int32, (cb, N_WORDS))
    require(b_mask, "b_mask", torch.bool, (cb,))
    if ka == 0 or cb == 0:  # nothing to launch, as in the plain version
        return _no_pairs(ka, cb, dev)
    nv = device_count_arg(n_valid_b, dev)
    a_min = torch.empty((ka,), dtype=torch.float32, device=dev)
    a_arg = torch.empty((ka,), dtype=torch.int32, device=dev)
    b_min = torch.empty((cb,), dtype=torch.float32, device=dev)
    b_arg = torch.empty((cb,), dtype=torch.int32, device=dev)
    stream = stream_arg(dev)
    nsplit, bufs = _hamming_scratch(dev, stream, ka, cb)
    P, I = _build.P, _build.I
    fn = _build.bind("mapops", "bshot_hamming_nn_bounded",
                     [P] * 5 + [I] * 4 + [P] * 9)
    _build.check(fn(ptr(a_words), ptr(a_mask), ptr(b_words), ptr(b_mask),
                    ptr(nv), ka, cb, int(tail_start), nsplit, *bufs,
                    ptr(a_min), ptr(a_arg), ptr(b_min), ptr(b_arg), stream),
                 "hamming_nn_bounded")
    hamming_nn_bounded.launches += 1
    return a_min, a_arg, b_min, b_arg


hamming_nn_bounded.launches = 0


def _hamming_scratch(dev, stream: int, ka: int, cb: int):
    """(nsplit, pointers of kernel C's scratch): the splits' keys per source,
    the source blocks' keys per row, and the arrival counters of the source
    blocks and of the splits (zero between calls)."""
    groups = -(-ka // HAMMING_SOURCES)
    nsplit = -(-cb // HAMMING_ROWS)

    def make():
        i32 = dict(dtype=torch.int32, device=dev)
        bufs = (torch.empty((nsplit, groups * HAMMING_SOURCES), **i32),
                torch.empty((groups, cb), **i32),
                torch.zeros((groups,), **i32), torch.zeros((nsplit,), **i32))
        return bufs, tuple(ptr(b) for b in bufs)

    return nsplit, scratch(dev, stream, ("hamming", ka, cb), make)[1]


def euclid_nn_bounded_plain(q, q_mask, ref, ref_mask, n_valid_ref,
                            tail_start: int = -1):
    """Plain PyTorch version of kernel D."""
    ok_r = ref_mask & _live_rows(ref.shape[0], n_valid_ref, tail_start,
                                 ref.device)
    d2 = torch.where(q_mask[:, None] & ok_r[None, :], pair_d2(q, ref), BIG)
    return _min_argmin(d2, 1)


def euclid_nn_bounded(q: torch.Tensor, q_mask: torch.Tensor, ref: torch.Tensor,
                      ref_mask: torch.Tensor, n_valid_ref,
                      tail_start: int = -1):
    """Per-query nearest candidate: (d2 (Kq,) f32, idx (Kq,) i32)."""
    if on_cpu(q, q_mask, ref, ref_mask):
        return euclid_nn_bounded_plain(q, q_mask, ref, ref_mask, n_valid_ref,
                                       tail_start)
    kq, cr = q.shape[0], ref.shape[0]
    dev = q.device
    require(q, "q", torch.float32, (kq, 3))
    require(q_mask, "q_mask", torch.bool, (kq,))
    require(ref, "ref", torch.float32, (cr, 3))
    require(ref_mask, "ref_mask", torch.bool, (cr,))
    nv = device_count_arg(n_valid_ref, dev)
    dmin = torch.empty((kq,), dtype=torch.float32, device=dev)
    darg = torch.empty((kq,), dtype=torch.int32, device=dev)
    stream = stream_arg(dev)
    nsplit, part, counters = _euclid_scratch(dev, stream, kq, cr)
    P, I = _build.P, _build.I
    fn = _build.bind("mapops", "bshot_euclid_nn_bounded",
                     [P] * 5 + [I] * 4 + [P] * 5)
    _build.check(fn(ptr(q), ptr(q_mask), ptr(ref), ptr(ref_mask), ptr(nv),
                    kq, cr, int(tail_start), nsplit, part, counters,
                    ptr(dmin), ptr(darg), stream),
                 "euclid_nn_bounded")
    euclid_nn_bounded.launches += 1
    return dmin, darg


euclid_nn_bounded.launches = 0


def _euclid_scratch(dev, stream: int, kq: int, cr: int):
    """(nsplit, pointer of the splits' keys, pointer of the query blocks'
    arrival counters) of kernel D; the counters are zero between calls."""
    groups = max(1, -(-kq // EUCLID_QUERIES))
    nsplit = max(1, -(-cr // EUCLID_ROWS),
                 min(-(-EUCLID_BLOCKS // groups), -(-cr // 256)))

    def make():
        bufs = (torch.empty((nsplit, max(kq, 1)), dtype=torch.int64, device=dev),
                torch.zeros((groups,), dtype=torch.int32, device=dev))
        return bufs, tuple(ptr(b) for b in bufs)

    return (nsplit, *scratch(dev, stream, ("euclid", kq, cr), make)[1])


def dedup_blocked_bounded_plain(pos, blk, seg, map_pos, map_blk, map_seg,
                                map_valid, n_valid, dedup_radius: float = 800.0):
    """Plain PyTorch version of kernel E (the reference's dense rule)."""
    ok_m = map_valid & _live_rows(map_pos.shape[0], n_valid, -1, map_pos.device)
    d2 = pair_d2(pos, map_pos)
    same_block = torch.all(blk[:, None, :] == map_blk[None, :, :], dim=-1)
    blocker = (
        ok_m[None, :]
        & same_block
        & (d2 < dedup_radius * dedup_radius)
        & (map_seg[None, :] >= seg[:, None])
    )
    return torch.any(blocker, dim=1)


def dedup_blocked_bounded(pos: torch.Tensor, blk: torch.Tensor,
                          seg: torch.Tensor, map_pos: torch.Tensor,
                          map_blk: torch.Tensor, map_seg: torch.Tensor,
                          map_valid: torch.Tensor, n_valid,
                          dedup_radius: float = 800.0) -> torch.Tensor:
    """(K,) True where a valid map row in [0, n_valid) of the same voxel
    block within dedup_radius has seg_ratio >= the newcomer's."""
    if on_cpu(pos, blk, seg, map_pos, map_blk, map_seg, map_valid):
        return dedup_blocked_bounded_plain(pos, blk, seg, map_pos, map_blk,
                                           map_seg, map_valid, n_valid,
                                           dedup_radius)
    k, c = pos.shape[0], map_pos.shape[0]
    dev = pos.device
    require(pos, "pos", torch.float32, (k, 3))
    require(blk, "blk", torch.int32, (k, 3))
    require(seg, "seg", torch.float32, (k,))
    require(map_pos, "map_pos", torch.float32, (c, 3))
    require(map_blk, "map_blk", torch.int32, (c, 3))
    require(map_seg, "map_seg", torch.float32, (c,))
    require(map_valid, "map_valid", torch.bool, (c,))
    if k == 0 or c == 0:  # nothing to launch, as in the plain version
        return torch.zeros((k,), dtype=torch.bool, device=dev)
    nv = device_count_arg(n_valid, dev)
    out = torch.empty((k,), dtype=torch.bool, device=dev)
    stream = stream_arg(dev)
    nsplit, part, counters = _dedup_scratch(dev, stream, k, c)
    P, I = _build.P, _build.I
    fn = _build.bind("mapops", "bshot_dedup_blocked_bounded",
                     [P] * 8 + [I, I, _build.F, I] + [P] * 4)
    _build.check(fn(ptr(pos), ptr(blk), ptr(seg), ptr(map_pos), ptr(map_blk),
                    ptr(map_seg), ptr(map_valid), ptr(nv), k, c,
                    dedup_radius * dedup_radius, nsplit, part, counters,
                    ptr(out), stream),
                 "dedup_blocked_bounded")
    dedup_blocked_bounded.launches += 1
    return out


dedup_blocked_bounded.launches = 0


def _dedup_scratch(dev, stream: int, k: int, c: int):
    """(nsplit, pointer of the splits' flag words, pointer of the newcomer
    blocks' arrival counters) of kernel E; the counters are zero between
    calls."""
    groups = -(-k // DEDUP_NEWCOMERS)
    nsplit = -(-c // DEDUP_ROWS)

    def make():
        i32 = dict(dtype=torch.int32, device=dev)
        bufs = (torch.empty((groups, nsplit, DEDUP_NEWCOMERS // 32), **i32),
                torch.zeros((groups,), **i32))
        return bufs, tuple(ptr(b) for b in bufs)

    return (nsplit, *scratch(dev, stream, ("dedup", k, c), make)[1])


class IcpState(NamedTuple):
    """An ICP's running state, which kernel G updates in place."""

    transform: torch.Tensor  # (4, 4) f32: the composed steps
    cur: torch.Tensor  # (K, 3) f32: the source points under `transform`
    rmse: torch.Tensor  # () f32: the last update's pair RMSE (0 at the start)
    n_pairs: torch.Tensor  # () int32: the last update's pairs (0 at the start)


def icp_update_plain(T, cur, nn_pos, nn_d2, src_mask, max_corr_dist: float, eye):
    """Plain PyTorch version of kernel G's update, as `ops/icp.py`'s plain
    loop runs it: (transform, rmse, pair count as f32) after one weighted
    Kabsch step of `cur` onto its nearest candidates `nn_pos`."""
    pair_ok = src_mask & (nn_d2 < 1e30) & (
        nn_d2 <= max_corr_dist * max_corr_dist
    )
    w = pair_ok.to(torch.float32)
    T_step = se3.kabsch(cur, nn_pos, w)
    n = torch.sum(w)
    T_step = torch.where(n >= 3, T_step, eye)
    T = se3.compose(T_step, T)
    rmse = torch.sqrt(
        torch.sum(torch.where(pair_ok, nn_d2, 0.0)) / torch.clamp(n, min=1.0)
    )
    return T, rmse, n


def icp_update(src: torch.Tensor, src_mask: torch.Tensor, dst: torch.Tensor,
               nn_d2: torch.Tensor | None = None, nn: torch.Tensor | None = None,
               max_corr_dist: float = 1.0e9,
               state: IcpState | None = None) -> IcpState:
    """Kernel G.  Without `state`: a new ICP state, the identity and the
    source under it.  With it: one iteration's update after kernel D gave
    the nearest candidates (`nn_d2`, `nn`) of `state.cur` among `dst` --
    the Kabsch step of the pairs within `max_corr_dist` (the identity below
    3 pairs) composed onto the transform, the source moved under it, and
    the pairs' rmse and count.  With `nn` None, `dst` holds each source
    row's candidate in its row (K, 3), as a mesh's owner fetch gives them.
    On the card `state` is updated in place and returned; on the CPU a new
    state is returned."""
    if on_cpu(src, src_mask, dst, nn_d2, nn):
        eye = torch.eye(4, dtype=torch.float32, device=src.device)
        if state is None:
            return IcpState(eye, se3.apply(eye, src),
                            torch.zeros((), dtype=torch.float32),
                            torch.zeros((), dtype=torch.int32))
        nn_pos = dst if nn is None else dst[nn.long()]
        T, rmse, n = icp_update_plain(state.transform, state.cur, nn_pos,
                                      nn_d2, src_mask, max_corr_dist, eye)
        return IcpState(T, se3.apply(T, src), rmse, n.to(torch.int32))
    k, dev = src.shape[0], src.device
    require(src, "src", torch.float32, (k, 3))
    init = state is None
    if init:
        state = IcpState(torch.empty((4, 4), dtype=torch.float32, device=dev),
                         torch.empty((k, 3), dtype=torch.float32, device=dev),
                         torch.empty((), dtype=torch.float32, device=dev),
                         torch.empty((), dtype=torch.int32, device=dev))
    else:
        require(src_mask, "src_mask", torch.bool, (k,))
        require(dst, "dst", torch.float32, (k if nn is None else dst.shape[0], 3))
        require(nn_d2, "nn_d2", torch.float32, (k,))
        if nn is not None:
            require(nn, "nn", torch.int32, (k,))
        require(state.transform, "transform", torch.float32, (4, 4))
        require(state.cur, "cur", torch.float32, (k, 3))
        require(state.rmse, "rmse", torch.float32, ())
        require(state.n_pairs, "n_pairs", torch.int32, ())
    P, I = _build.P, _build.I
    fn = _build.bind("mapops", "bshot_icp_update",
                     [P] * 5 + [I, _build.F, I] + [P] * 5)
    _build.check(fn(ptr(src), ptr(src_mask), ptr(dst), ptr(nn_d2), ptr(nn), k,
                    max_corr_dist * max_corr_dist, int(init), ptr(state.transform),
                    ptr(state.cur), ptr(state.rmse), ptr(state.n_pairs),
                    stream_arg(dev)),
                 "icp_update")
    icp_update.launches += 1
    return state


icp_update.launches = 0
