"""Radius-neighbourhood accumulation: CUDA kernels A and B, plain versions.

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

The plain versions mirror the reference's `lax.scan` path tile by tile.
Counts are exact between the two: the kernel reproduces the rounding of
`kernels.pair_d2` step for step (see csrc/common.cuh).  Float sums differ
by summation order only.
"""

from __future__ import annotations

import math

import torch

from bshot_slam_tpu_torch.kernels import (
    _build, fma_dot3, on_cpu, pair_d2, ptr, require, scratch, stream_arg,
)

MAX_FEAT = 16  # feature columns the CUDA kernel accumulates in registers
MAX_ROWS = 131072  # rows the CUDA kernels take: a block lists at most 1024 tiles
TILE = 128  # queries per block and candidates per tile of the CUDA kernels
# Kernels A and B spread a query block's kept tiles over so many blocks that
# about ACCUMULATE_BLOCKS blocks of 4 warps are in flight on the 132 SMs.
ACCUMULATE_BLOCKS = 768
MAX_SPLIT = 16  # ... but no more than this many per query block
# f32 instructions per pair (csrc/neighborhood.cu says how they are counted)
RADIUS_TEST_F32 = 8
SEGRATIO_IN_RADIUS_F32 = 10


def neighborhood_accumulate_plain(points, mask, feat, radius: float,
                                  r2_row=None, tile: int = 4096):
    """Plain PyTorch version of kernel A (the reference's scan path)."""
    n = points.shape[0]
    r2_col = radius * radius if r2_row is None else r2_row[:, None]
    out = torch.zeros((n, feat.shape[1]), dtype=torch.float32,
                      device=points.device)
    for t0 in range(0, n, tile):
        rp, rm = points[t0:t0 + tile], mask[t0:t0 + tile]
        d2 = pair_d2(points, rp)
        within = (d2 <= r2_col) & rm[None, :] & mask[:, None]
        out = out + within.to(torch.float32) @ feat[t0:t0 + tile]
    return out


def neighborhood_accumulate(points: torch.Tensor, mask: torch.Tensor,
                            feat: torch.Tensor, radius: float,
                            r2_row: torch.Tensor | None = None,
                            tile: int = 4096) -> torch.Tensor:
    """(N, F) sums of in-radius features; masked rows give zeros.

    `r2_row` optionally shrinks each query's ball (cap mode; <= radius^2),
    `tile` is the plain version's candidate tile."""
    if on_cpu(points, mask, feat, r2_row):
        return neighborhood_accumulate_plain(points, mask, feat, radius,
                                             r2_row, tile)
    n, nf = feat.shape
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
    out = torch.empty((n, nf), dtype=torch.float32, device=dev)
    stream = stream_arg(dev)
    nsplit, bufs = _accumulate_scratch(dev, stream, n, nf)
    P, I = _build.P, _build.I
    fn = _build.bind("neighborhood", "bshot_neighborhood_accumulate",
                     [P] * 10 + [I, I, I, _build.F, P])
    _build.check(fn(ptr(points), ptr(mask), ptr(feat), ptr(r2_row), ptr(out),
                    *bufs, n, nf, nsplit, radius * radius, stream),
                 "neighborhood_accumulate")
    neighborhood_accumulate.launches += 1
    return out


neighborhood_accumulate.launches = 0


def _tiles_and_splits(n: int):
    """(tiles of TILE rows, blocks that share a query block's kept tiles)."""
    ntiles = max(1, -(-n // TILE))
    return ntiles, min(MAX_SPLIT, max(1, -(-ACCUMULATE_BLOCKS // ntiles)))


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
                              tile: int = 4096):
    """Plain PyTorch version of kernel B (the reference's scan path)."""
    n = points.shape[0]
    r2_col = radius * radius if r2_row is None else r2_row[:, None]
    vq = fma_dot3(ctvec, points)[:, None]
    ct_norm = torch.linalg.norm(ctvec, dim=-1)
    zeros = torch.zeros((n,), dtype=torch.float32, device=points.device)
    pos, neg, ssum = zeros, zeros, zeros
    for t0 in range(0, n, tile):
        rp, rm = points[t0:t0 + tile], mask[t0:t0 + tile]
        d2 = pair_d2(points, rp)
        within = (d2 <= r2_col) & rm[None, :] & mask[:, None]
        # dot(ctvec_i, p_j - sp_i) = p_j . ctvec_i - sp_i . ctvec_i
        dots = ctvec @ rp.T - vq
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
    return torch.stack([pos, neg, ssum], dim=-1)


def segratio_accumulate(points: torch.Tensor, mask: torch.Tensor,
                        ctvec: torch.Tensor, radius: float,
                        normalized: bool = False,
                        r2_row: torch.Tensor | None = None,
                        tile: int = 4096) -> torch.Tensor:
    """(N, 3): [pos count, neg count, CVS(N) dot sum] per point."""
    if on_cpu(points, mask, ctvec, r2_row):
        return segratio_accumulate_plain(points, mask, ctvec, radius,
                                         normalized, r2_row, tile)
    n = points.shape[0]
    if n > MAX_ROWS:
        raise ValueError(f"kernel B takes at most {MAX_ROWS} rows")
    if not math.isfinite(radius):
        raise ValueError("kernel B needs a finite radius")
    require(points, "points", torch.float32, (n, 3))
    require(mask, "mask", torch.bool, (n,))
    require(ctvec, "ctvec", torch.float32, (n, 3))
    if r2_row is not None:
        require(r2_row, "r2_row", torch.float32, (n,))
    dev = points.device
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    stream = stream_arg(dev)
    nsplit, bufs = _segratio_scratch(dev, stream, n)
    P, I = _build.P, _build.I
    fn = _build.bind("neighborhood", "bshot_segratio_accumulate",
                     [P] * 9 + [I, I, I, _build.F, P])
    _build.check(fn(ptr(points), ptr(mask), ptr(ctvec), ptr(r2_row), ptr(out),
                    *bufs, n, int(normalized), nsplit, radius * radius, stream),
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
