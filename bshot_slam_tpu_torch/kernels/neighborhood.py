"""Radius neighbourhoods: CUDA kernels A, B and H, plain versions.

A, `neighborhood_accumulate`, replaces the Pallas kernel
bshot_slam_tpu/kernels/neighborhood.py:neighborhood_accumulate:

    out[i] = sum_j [d2(p_i, p_j) <= r2_i] mask_i mask_j feat[j]

(the query itself included; masked rows give zeros).  B,
`segratio_accumulate`, replaces segratio_accumulate: per query, over its
in-radius points, the counts of sign(v_i.p_j - v_i.q_i) and the CVS dot sum
(or the CVSN cosine sum when `normalized`).

The CUDA side (csrc/neighborhood.cu) runs one thread per query over
candidate tiles of 128 rows in shared memory; it skips tiles that are empty
or out of reach of the block's query box, with a margin that keeps every
result equal to the unpruned one.  Both kernels are two launches: a
pre-pass packs the cloud once (float4 candidates with masked rows inert,
every tile's box and, for A, feature rows padded to 16-byte loads), then a
grid of (query block, split) blocks walks only the tiles it keeps through a
cp.async ring and the last block of a query block adds the splits' partial
sums in a fixed order, so the result is deterministic (B's two counts stay
exact).  The wrappers keep the scratch (`_accumulate_scratch`: ~0.8 MB of
packed cloud and `nsplit` partial buffers at the main path's 12288 x 10;
`_segratio_scratch`: ~1.8 MB at 12288 rows) per device, stream and shape,
each kernel under a key of its own.  The work, in f32 instructions, is
`RADIUS_TEST_F32` per radius test the skips leave plus, per in-radius pair,
one add per feature column (A) or `SEGRATIO_IN_RADIUS_F32` (B);
`chip_smoke.py` turns these counts into the bound at the main path's shapes.

Both take a range of query rows, `rows=(q0, q1)` (the data axis of a mesh
splits a cloud's queries this way), and return those rows only; every row of
the cloud stays a candidate.  q0 is a multiple of TILE and q1 one too or the
cloud's end, so each query block is the block of the launch over every row,
its kept tiles are dealt over the same SPLITS, and its sums come out bit for
bit the same.

The plain versions mirror the reference's `lax.scan` path tile by tile,
over query blocks of PLAIN_ROWS rows at multiples of PLAIN_ROWS: a block's
sums are the same products in the same order whatever range holds it, at
any number of CPU threads, so a range aligned to PLAIN_ROWS (as a data
axis splits a cloud, `parallel.layout.data_rows`) gives the full call's
rows bit for bit.
Counts are exact between the two: the kernel reproduces the rounding of
`kernels.pair_d2` step for step (see csrc/common.cuh).  Float sums differ
by summation order only.

H, `shot_neighbors`, is SHOT's neighbour selection
(bshot_slam_tpu/ops/shot.py:gather_neighbors; no Pallas kernel): per
keypoint the `max_neighbors` nearest rows within the radius, as the stable
sort of the plain version orders them.  Its rows are the plain version's
bit for bit (the same d2 rounding; integers out).  Two launches, the
cloud's packing and one block a keypoint (csrc/neighborhood.cu says how a
block selects); the scratch (`_select_scratch`: ~2.1 MB at 131072 rows)
is kept per device, stream and shape.

A, B and H take up to `MAX_ROWS` (262144) rows in two forms, which the
library picks by the cloud's row count (a static shape, so one form is
captured in a graph): up to `NARROW_ROWS` (131072, 1024 tiles) the narrow
form, past it the wide one, whose blocks list up to 2048 tiles and whose
H keys hold an 18-bit row.  The wide kernels carry the namespace `wide`
in the profiler's names (`wide::accumulate_kernel`, ...).
"""

from __future__ import annotations

import math

import torch

from bshot_slam_tpu_torch.kernels import (
    _build, fma_dot3, on_cpu, pair_d2, ptr, require, scratch, stream_arg, top_k,
)

MAX_FEAT = 16  # feature columns the CUDA kernel accumulates in registers
MAX_ROWS = 262144  # rows the CUDA kernels take: a wide block lists up to 2048 tiles
NARROW_ROWS = 131072  # rows the narrow form takes (1024 tiles); past it the wide
TILE = 128  # queries per block and candidates per tile of the CUDA kernels
# Kernels A and B deal a query block's kept tiles in turn to SPLITS blocks
# at every cloud size, so a row's sum is the same at any padded size that
# holds the cloud: the pipelined fused engine runs a frame at a predicted
# cloud bucket, the synchronous engine at the exact one, and their records
# agree bit for bit.  At the main path's 12288 rows that is ~768 blocks of
# 4 warps in flight on the 132 SMs.
SPLITS = 8
# Query rows per block of the plain versions (a multiple of TILE): a matrix
# product's rounding may depend on its row count, so a row's sums are the
# same in two calls only if both compute its block alike.
PLAIN_ROWS = 1024
# f32 instructions per pair (csrc/neighborhood.cu says how they are counted)
RADIUS_TEST_F32 = 8
SEGRATIO_IN_RADIUS_F32 = 10
# Most neighbours kernel H returns a keypoint (half the keys a block sorts).
SHOT_MAX_NEIGHBORS = 1024


def query_rows(n: int, rows) -> tuple[int, int]:
    """(q0, q1) of a query range (None: every row), checked as A and B
    take it."""
    q0, q1 = (0, n) if rows is None else (int(rows[0]), int(rows[1]))
    if not (0 <= q0 <= q1 <= n and q0 % TILE == 0 and (q1 % TILE == 0 or q1 == n)):
        raise ValueError(f"query rows ({q0}, {q1}) must lie in [0, {n}], start "
                         f"on a multiple of {TILE} and end on one or at {n}")
    return q0, q1


def kept_tiles(points, mask, radius: float, tile: int = TILE):
    """Host replay of the tile skips of kernels A and B over every query
    row: `block_box` and `separated` of csrc/neighborhood.cu, in float32 as
    the card computes them.  Query block qb walks candidate tile t unless
    either holds no valid row or their boxes lie farther apart than the
    radius (plus the kernels' margin) along some axis.  Returns (keep (nt,
    nt) bool, valid rows per tile (nt,) int64) of the `tile`-row tiles;
    points and mask are host arrays or CPU tensors."""
    p = torch.as_tensor(points, dtype=torch.float32)
    m = torch.as_tensor(mask, dtype=torch.bool)
    n = p.shape[0]
    nt = max(1, -(-n // tile))
    p = torch.cat([p, p.new_zeros((nt * tile - n, 3))]).view(nt, tile, 3)
    m = torch.cat([m, m.new_zeros(nt * tile - n)]).view(nt, tile)
    inf = torch.tensor(float("inf"))
    lo = torch.where(m[..., None], p, inf).amin(1)
    hi = torch.where(m[..., None], p, -inf).amax(1)
    n2 = torch.where(m, fma_dot3(p, p), 0.0).amax(1)
    rows = m.sum(1)
    r2 = torch.tensor(radius * radius, dtype=torch.float32)
    lim = r2 + (n2[:, None] + n2[None, :] + r2) * 2.0 ** -18
    gap = torch.maximum(lo[:, None] - hi[None, :], lo[None, :] - hi[:, None])
    far = ((gap > 0) & (gap * gap > lim[..., None])).any(-1)
    live = rows > 0
    return live[:, None] & live[None, :] & ~far, rows


def _block_d2(points, sq, b0: int, b1: int, t0: int, t1: int):
    """`pair_d2(points[b0:b1], points[t0:t1])` with the squared norms `sq`
    (`fma_dot3` of every row, taken once per call)."""
    cross = points[b0:b1] @ points[t0:t1].T
    return torch.clamp(sq[b0:b1, None] + sq[None, t0:t1] - 2.0 * cross, min=0.0)


def _query_blocks(q0: int, q1: int):
    """The plain versions' query blocks: [q0, q1) cut at the multiples of
    PLAIN_ROWS."""
    cuts = [q0, *range((q0 // PLAIN_ROWS + 1) * PLAIN_ROWS, q1, PLAIN_ROWS), q1]
    return [(a, b) for a, b in zip(cuts, cuts[1:]) if a < b]


def neighborhood_accumulate_plain(points, mask, feat, radius: float,
                                  r2_row=None, tile: int = 4096, rows=None):
    """Plain PyTorch version of kernel A (the reference's scan path)."""
    n = points.shape[0]
    q0, q1 = query_rows(n, rows)
    out = torch.zeros((q1 - q0, feat.shape[1]), dtype=torch.float32,
                      device=points.device)
    sq = fma_dot3(points, points)
    for b0, b1 in _query_blocks(q0, q1):
        qm = mask[b0:b1]
        r2_col = radius * radius if r2_row is None else r2_row[b0:b1, None]
        acc = out[b0 - q0:b1 - q0]
        for t0 in range(0, n, tile):
            rm = mask[t0:t0 + tile]
            d2 = _block_d2(points, sq, b0, b1, t0, t0 + tile)
            within = (d2 <= r2_col) & rm[None, :] & qm[:, None]
            acc = acc + within.to(torch.float32) @ feat[t0:t0 + tile]
        out[b0 - q0:b1 - q0] = acc
    return out


def neighborhood_accumulate(points: torch.Tensor, mask: torch.Tensor,
                            feat: torch.Tensor, radius: float,
                            r2_row: torch.Tensor | None = None,
                            tile: int = 4096, rows=None) -> torch.Tensor:
    """(q1 - q0, F) sums of in-radius features over the query rows
    `rows=(q0, q1)` (default every row); masked rows give zeros.

    `r2_row` (N,) optionally shrinks each query's ball (cap mode;
    <= radius^2), `tile` is the plain version's candidate tile."""
    if on_cpu(points, mask, feat, r2_row):
        return neighborhood_accumulate_plain(points, mask, feat, radius,
                                             r2_row, tile, rows)
    n, nf = feat.shape
    q0, q1 = query_rows(n, rows)
    if not 1 <= nf <= MAX_FEAT:
        raise ValueError(f"kernel A takes 1 to {MAX_FEAT} feature columns")
    if n > MAX_ROWS:
        raise ValueError(f"kernel A takes at most {MAX_ROWS} rows")
    if not math.isfinite(radius):
        raise ValueError("kernel A needs a finite radius")
    require(points, "points", torch.float32, (n, 3))
    require(mask, "mask", torch.bool, (n,))
    require(feat, "feat", torch.float32, (n, nf))
    if r2_row is not None:
        require(r2_row, "r2_row", torch.float32, (n,))
    dev = points.device
    out = torch.empty((q1 - q0, nf), dtype=torch.float32, device=dev)
    if q0 == q1:  # no query row: nothing to launch
        return out
    stream = stream_arg(dev)
    nsplit, bufs = _accumulate_scratch(dev, stream, n, nf)
    P, I = _build.P, _build.I
    fn = _build.bind("neighborhood", "bshot_neighborhood_accumulate",
                     [P] * 10 + [I, I, I, _build.F, I, I, P])
    _build.check(fn(ptr(points), ptr(mask), ptr(feat), ptr(r2_row), ptr(out),
                    *bufs, n, nf, nsplit, radius * radius, q0, q1, stream),
                 "neighborhood_accumulate")
    neighborhood_accumulate.launches += 1
    return out


neighborhood_accumulate.launches = 0


def _tiles_and_splits(n: int):
    """(tiles of TILE rows, blocks that share a query block's kept tiles)."""
    return max(1, -(-n // TILE)), SPLITS


def _accumulate_scratch(dev, stream: int, n: int, nf: int):
    """(nsplit, pointers of kernel A's scratch): the packed candidates,
    padded features, tile boxes, the splits' partial sums and the query
    blocks' arrival counters (zero between calls)."""
    ntiles, nsplit = _tiles_and_splits(n)
    nfp = -(-nf // 4) * 4
    rows = ntiles * TILE

    def make():
        f32 = dict(dtype=torch.float32, device=dev)
        bufs = (torch.empty((rows, 4), **f32), torch.empty((rows, nfp), **f32),
                torch.empty((ntiles, 8), **f32),
                torch.empty((nsplit, rows, nfp), **f32),
                torch.zeros((ntiles,), dtype=torch.int32, device=dev))
        return bufs, tuple(ptr(b) for b in bufs)

    return nsplit, scratch(dev, stream, ("accumulate", n, nf), make)[1]


def segratio_accumulate_plain(points, mask, ctvec, radius: float,
                              normalized: bool = False, r2_row=None,
                              tile: int = 4096, rows=None):
    """Plain PyTorch version of kernel B (the reference's scan path)."""
    n = points.shape[0]
    q0, q1 = query_rows(n, rows)
    out = torch.zeros((q1 - q0, 3), dtype=torch.float32, device=points.device)
    sq = fma_dot3(points, points)
    for b0, b1 in _query_blocks(q0, q1):
        qp, qm, cv = points[b0:b1], mask[b0:b1], ctvec[b0 - q0:b1 - q0]
        r2_col = radius * radius if r2_row is None else r2_row[b0:b1, None]
        vq = fma_dot3(cv, qp)[:, None]
        ct_norm = torch.linalg.norm(cv, dim=-1)
        zeros = torch.zeros((b1 - b0,), dtype=torch.float32, device=points.device)
        pos, neg, ssum = zeros, zeros, zeros
        for t0 in range(0, n, tile):
            rp, rm = points[t0:t0 + tile], mask[t0:t0 + tile]
            d2 = _block_d2(points, sq, b0, b1, t0, t0 + tile)
            within = (d2 <= r2_col) & rm[None, :] & qm[:, None]
            # dot(ctvec_i, p_j - sp_i) = p_j . ctvec_i - sp_i . ctvec_i
            dots = cv @ rp.T - vq
            w = within.to(torch.float32)
            pos = pos + torch.sum(w * (dots > 0), dim=1)
            neg = neg + torch.sum(w * (dots < 0), dim=1)
            if normalized:  # CVSN: dots / (|ctvec| * |p - q|)
                denom = ct_norm[:, None] * torch.sqrt(d2)
                valid = within & (denom > 0)
                terms = torch.where(valid, dots / torch.clamp(denom, min=1e-12), 0.0)
            else:  # CVS
                terms = torch.where(within & (d2 > 0), dots, 0.0)
            ssum = ssum + torch.sum(terms, dim=1)
        out[b0 - q0:b1 - q0] = torch.stack([pos, neg, ssum], dim=-1)
    return out


def segratio_accumulate(points: torch.Tensor, mask: torch.Tensor,
                        ctvec: torch.Tensor, radius: float,
                        normalized: bool = False,
                        r2_row: torch.Tensor | None = None,
                        tile: int = 4096, rows=None) -> torch.Tensor:
    """(q1 - q0, 3): [pos count, neg count, CVS(N) dot sum] per point of
    the query rows `rows=(q0, q1)` (default every row), whose ctvec
    (q1 - q0, 3) holds."""
    if on_cpu(points, mask, ctvec, r2_row):
        return segratio_accumulate_plain(points, mask, ctvec, radius,
                                         normalized, r2_row, tile, rows)
    n = points.shape[0]
    q0, q1 = query_rows(n, rows)
    if n > MAX_ROWS:
        raise ValueError(f"kernel B takes at most {MAX_ROWS} rows")
    if not math.isfinite(radius):
        raise ValueError("kernel B needs a finite radius")
    require(points, "points", torch.float32, (n, 3))
    require(mask, "mask", torch.bool, (n,))
    require(ctvec, "ctvec", torch.float32, (q1 - q0, 3))
    if r2_row is not None:
        require(r2_row, "r2_row", torch.float32, (n,))
    dev = points.device
    out = torch.empty((q1 - q0, 3), dtype=torch.float32, device=dev)
    if q0 == q1:  # no query row: nothing to launch
        return out
    stream = stream_arg(dev)
    nsplit, bufs = _segratio_scratch(dev, stream, n)
    P, I = _build.P, _build.I
    fn = _build.bind("neighborhood", "bshot_segratio_accumulate",
                     [P] * 9 + [I, I, I, _build.F, I, I, P])
    _build.check(fn(ptr(points), ptr(mask), ptr(ctvec), ptr(r2_row), ptr(out),
                    *bufs, n, int(normalized), nsplit, radius * radius, q0, q1,
                    stream),
                 "segratio_accumulate")
    segratio_accumulate.launches += 1
    return out


segratio_accumulate.launches = 0


def _segratio_scratch(dev, stream: int, n: int):
    """(nsplit, pointers of kernel B's scratch): the packed candidates, tile
    boxes, the splits' partial (pos, neg, sum, 0) and the query blocks'
    arrival counters (zero between calls)."""
    ntiles, nsplit = _tiles_and_splits(n)
    rows = ntiles * TILE

    def make():
        f32 = dict(dtype=torch.float32, device=dev)
        bufs = (torch.empty((rows, 4), **f32), torch.empty((ntiles, 8), **f32),
                torch.empty((nsplit, rows, 4), **f32),
                torch.zeros((ntiles,), dtype=torch.int32, device=dev))
        return bufs, tuple(ptr(b) for b in bufs)

    return nsplit, scratch(dev, stream, ("segratio", n), make)[1]


def shot_neighbors_plain(keypoints, kp_mask, points, mask, radius: float,
                         max_neighbors: int):
    """Plain PyTorch version of kernel H: a stable sort of every keypoint's
    scores over the cloud."""
    d2 = pair_d2(keypoints, points)  # (K, N)
    r2 = radius * radius
    ok = mask[None, :] & (d2 <= r2) & (d2 > 0) & kp_mask[:, None]
    score = torch.where(ok, -d2, float("-inf"))
    _, idx = top_k(score, max_neighbors)
    return idx


def shot_neighbors(keypoints: torch.Tensor, kp_mask: torch.Tensor,
                   points: torch.Tensor, mask: torch.Tensor, radius: float,
                   max_neighbors: int) -> torch.Tensor:
    """(K, min(max_neighbors, N)) int64 rows of the cloud per keypoint: its
    rows within the radius (valid, 0 < d2 <= radius^2, the keypoint valid)
    by ascending (d2, row), then the others by ascending row.  A keypoint
    whose `kp_mask` is False gets rows 0, 1, 2, ..."""
    if on_cpu(keypoints, kp_mask, points, mask):
        return shot_neighbors_plain(keypoints, kp_mask, points, mask, radius,
                                    max_neighbors)
    k, n = keypoints.shape[0], points.shape[0]
    if n > MAX_ROWS:
        raise ValueError(f"kernel H takes at most {MAX_ROWS} rows")
    if not 0 <= max_neighbors <= SHOT_MAX_NEIGHBORS:
        raise ValueError(f"kernel H takes 0 to {SHOT_MAX_NEIGHBORS} neighbours")
    if not math.isfinite(radius):
        raise ValueError("kernel H needs a finite radius")
    require(keypoints, "keypoints", torch.float32, (k, 3))
    require(kp_mask, "kp_mask", torch.bool, (k,))
    require(points, "points", torch.float32, (n, 3))
    require(mask, "mask", torch.bool, (n,))
    dev = points.device
    m = min(max_neighbors, n)
    out = torch.empty((k, m), dtype=torch.int64, device=dev)
    if k == 0 or m == 0:  # nothing to select: nothing to launch
        return out
    stream = stream_arg(dev)
    bufs = _select_scratch(dev, stream, n)
    P, I = _build.P, _build.I
    fn = _build.bind("neighborhood", "bshot_shot_neighbors",
                     [P] * 7 + [I, I, I, _build.F, P])
    _build.check(fn(ptr(keypoints), ptr(kp_mask), ptr(points), ptr(mask), ptr(out),
                    *bufs, k, n, m, radius * radius, stream),
                 "shot_neighbors")
    shot_neighbors.launches += 1
    return out


shot_neighbors.launches = 0


def _select_scratch(dev, stream: int, n: int):
    """Pointers of kernel H's scratch: the packed candidates and tile boxes."""
    ntiles, _ = _tiles_and_splits(n)

    def make():
        f32 = dict(dtype=torch.float32, device=dev)
        bufs = (torch.empty((ntiles * TILE, 4), **f32), torch.empty((ntiles, 8), **f32))
        return bufs, tuple(ptr(b) for b in bufs)

    return scratch(dev, stream, ("select", n), make)[1]
