"""The plain reference of one odometry frame: features, matching, RANSAC,
the pose gate, ICP, the map insert, and the map eviction.

A frozen copy of the plain PyTorch path of bshot_slam_tpu_torch (the
plain versions of its CUDA kernels A-E and the ops they serve, from
`kernels/`, `ops/`, `odometry/mapstore.py` and `odometry/pipeline.py`),
with what serves the program's speed taken out: the matching, ICP and
dedup scan the whole map (the program gathers the query window into a
compact buffer; both give the same results, as the program's dense
fallback shows), nothing is deferred, captured or sharded, and every
product is an eager PyTorch call.  It imports nothing of the program, so
a later change to the program cannot move it.  Float32 with TF32 off
unless the caller turns TF32 on (the control).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from slambench.reference import eig3, se3

BIG = 3.0e38  # "no candidate" distance
PLAIN_ROWS = 1024  # query rows per block of the plain neighbourhood sums
_M1, _M2, _M4 = 0x55555555, 0x33333333, 0x0F0F0F0F
_NEG_INF = float("-inf")
_EPS = 1e-12
_BIG = 2**30
# B-SHOT subset priority order: singles, pairs (01,12,23,03,13,02), triples, all.
_SUBSETS = (
    (1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1),
    (1, 1, 0, 0), (0, 1, 1, 0), (0, 0, 1, 1), (1, 0, 0, 1),
    (0, 1, 0, 1), (1, 0, 1, 0),
    (1, 1, 1, 0), (0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 0, 1),
    (1, 1, 1, 1),
)


def fma_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a.b over a last axis of 3 as the FMA chain
    fma(a2, b2, fma(a1, b1, a0*b0)), each step rounded once to float32.

    This is how the reference's compiled programs reduce every K=3 product
    (sums of squares included), and what csrc/common.cuh computes; the
    steps run in float64, where each product is exact, and round to
    float32 after each step."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    acc = (a[..., 0] * b[..., 0]).to(torch.float32)
    acc = (a[..., 1] * b[..., 1] + acc).to(torch.float32)
    return (a[..., 2] * b[..., 2] + acc).to(torch.float32)


def pair_d2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared distances (Q, P) by the expansion (|q|^2 + |p|^2) - 2 q.p,
    clamped at 0, rounded as the reference rounds it: FMA-chain norms and
    cross term (a K=3 float32 matmul is one on the CPU), so radius
    memberships agree bit for bit with it and with the kernels."""
    cross = q @ p.T
    return torch.clamp(fma_dot3(q, q)[:, None] + fma_dot3(p, p)[None, :]
                       - 2.0 * cross, min=0.0)


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
                                  r2_row=None, tile: int = 4096):
    """Plain PyTorch version of kernel A (the reference's scan path)."""
    n = points.shape[0]
    q0, q1 = 0, n
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


def segratio_accumulate_plain(points, mask, ctvec, radius: float,
                              normalized: bool = False, r2_row=None,
                              tile: int = 4096, rows=None):
    """Plain PyTorch version of kernel B (the reference's scan path)."""
    n = points.shape[0]
    q0, q1 = 0, n
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


def euclid_nn_bounded_plain(q, q_mask, ref, ref_mask, n_valid_ref,
                            tail_start: int = -1):
    """Plain PyTorch version of kernel D."""
    ok_r = ref_mask & _live_rows(ref.shape[0], n_valid_ref, tail_start,
                                 ref.device)
    d2 = torch.where(q_mask[:, None] & ok_r[None, :], pair_d2(q, ref), BIG)
    return _min_argmin(d2, 1)


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


def top_k(score: torch.Tensor, k: int):
    """Exact top-k over the last axis, ties to the lowest index (as
    `lax.top_k`; `torch.topk` breaks ties otherwise)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _outer_from6(o6: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            torch.stack([o6[:, 0], o6[:, 1], o6[:, 2]], dim=-1),
            torch.stack([o6[:, 1], o6[:, 3], o6[:, 4]], dim=-1),
            torch.stack([o6[:, 2], o6[:, 4], o6[:, 5]], dim=-1),
        ],
        dim=-2,
    )


def moment_features(points: torch.Tensor) -> torch.Tensor:
    """The (N, 10) features whose in-radius sums are the moments: 1, p and
    the 6 products."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    return torch.stack(
        [torch.ones_like(x), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z],
        dim=-1,
    )


def moments_from_sums(acc: torch.Tensor):
    """(count, sum, sum of outer products) from kernel A's sums of
    `moment_features`."""
    return acc[:, 0], acc[:, 1:4], _outer_from6(acc[:, 4:10])


def _finalize_scores(points, mask, cfg, cnt, pos, neg, ssum):
    if cfg.sr_type == "CV":
        mx = torch.maximum(pos, neg)
        score = 1.0 - torch.minimum(pos, neg) / torch.clamp(mx, min=1.0)
        defined = mx > 0
    elif cfg.sr_type in ("CVS", "CVSN"):
        score = torch.abs(ssum) / torch.clamp(cnt, min=1.0)
        defined = cnt > 0
    else:
        raise ValueError(f"unknown sr_type {cfg.sr_type}")
    # The reference skips the origin point and zero-neighbour points.
    at_origin = torch.all(points == 0, dim=-1)
    ok = mask & defined & ~at_origin & (cnt > 0)
    return torch.where(ok, score, _NEG_INF)


class Keypoints(NamedTuple):
    positions: torch.Tensor  # (K, 3)
    scores: torch.Tensor  # (K,)
    mask: torch.Tensor  # (K,) valid flag
    indices: torch.Tensor  # (K,) index into the input cloud


def keypoints_from_scores(points: torch.Tensor, top_scores: torch.Tensor,
                          top_idx: torch.Tensor) -> Keypoints:
    kmask = torch.isfinite(top_scores)
    return Keypoints(
        positions=torch.where(kmask[:, None], points[top_idx], 0.0),
        scores=torch.where(kmask, top_scores, 0.0),
        mask=kmask,
        indices=torch.where(kmask, top_idx, -1),
    )


def normals_from_moments(
    points: torch.Tensor,
    mask: torch.Tensor,
    cnt: torch.Tensor,
    psum: torch.Tensor,
    outer: torch.Tensor,
    min_neighbors: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normals from precomputed neighbourhood moments (shared-sweep path)."""
    safe = torch.clamp(cnt, min=1.0)
    mean = psum / safe[:, None]
    cov = outer / safe[:, None, None] - mean[:, :, None] * mean[:, None, :]
    evals, evecs = eig3.eigh3(cov)  # ascending eigenvalues
    n = evecs[..., 0]  # smallest-eigenvalue direction
    # Flip toward the viewpoint at the origin: need n . (0 - p) > 0.
    flip = torch.sum(n * points, dim=-1) > 0
    n = torch.where(flip[:, None], -n, n)
    lam = torch.clamp(evals, min=0.0)
    denom = lam[:, 0] + lam[:, 1] + lam[:, 2]
    curvature = lam[:, 0] / torch.clamp(denom, min=1e-12)
    valid = mask & (cnt >= min_neighbors)
    n = torch.where(valid[:, None], n, 0.0)
    return n, torch.where(valid, curvature, 0.0), valid


class NeighborGather(NamedTuple):
    rel: torch.Tensor  # (K, M, 3) neighbor - keypoint
    normals: torch.Tensor  # (K, M, 3)
    dist: torch.Tensor  # (K, M)
    nmask: torch.Tensor  # (K, M) within-radius validity


def gather_neighbors(
    keypoints: torch.Tensor,
    kp_mask: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
    normals: torch.Tensor,
    radius: float,
    max_neighbors: int,
) -> NeighborGather:
    """Nearest `max_neighbors` in-radius surface points per keypoint;
    zero-distance duplicates of the keypoint are excluded."""
    d2 = pair_d2(keypoints, points)  # (K, N)
    r2 = radius * radius
    ok = mask[None, :] & (d2 <= r2) & (d2 > 0) & kp_mask[:, None]
    score = torch.where(ok, -d2, float("-inf"))
    _, idx = top_k(score, max_neighbors)
    pnv = torch.cat([points, normals, mask.to(torch.float32)[:, None]], dim=1)
    g = pnv[idx]  # (K, M, 7)
    nb, nn, vbit = g[..., :3], g[..., 3:6], g[..., 6]
    rel = nb - keypoints[:, None, :]
    d2g = fma_dot3(rel, rel)
    nmask = (vbit > 0) & (d2g <= r2) & (d2g > 0) & kp_mask[:, None]
    dist = torch.sqrt(d2g)
    rel = torch.where(nmask[..., None], rel, 0.0)
    nn = torch.where(nmask[..., None], nn, 0.0)
    return NeighborGather(rel=rel, normals=nn,
                          dist=torch.where(nmask, dist, 0.0), nmask=nmask)


def local_reference_frames(g: NeighborGather, radius: float):
    """Disambiguated LRF per keypoint: (frames (K, 3, 3) rows [x, y, z],
    valid (K,))."""
    w = torch.where(g.nmask, radius - g.dist, 0.0)
    wsum = torch.sum(w, dim=1)
    valid = wsum > _EPS
    wn = w / torch.clamp(wsum, min=_EPS)[:, None]
    cov = torch.einsum("km,kmi,kmj->kij", wn, g.rel, g.rel)
    _, evecs = eig3.eigh3(cov)  # ascending
    x_axis = evecs[..., 2]
    z_axis = evecs[..., 0]

    def majority_flip(axis):
        dots = torch.einsum("kmi,ki->km", g.rel, axis)
        npos = torch.sum(torch.where(g.nmask, (dots >= 0).to(torch.float32), 0.0), dim=1)
        nneg = torch.sum(torch.where(g.nmask, (dots < 0).to(torch.float32), 0.0), dim=1)
        return torch.where((nneg > npos)[:, None], -axis, axis)

    x_axis = majority_flip(x_axis)
    z_axis = majority_flip(z_axis)
    y_axis = torch.linalg.cross(z_axis, x_axis)
    frames = torch.stack([x_axis, y_axis, z_axis], dim=-2)  # rows
    return frames, valid


def _soft_bins(coord: torch.Tensor, n_bins: int, circular: bool):
    """Linear soft assignment of a bin coordinate in [0, n_bins): returns
    (bin_lo, bin_hi, w_lo, w_hi); centres at i + 0.5."""
    c = coord - 0.5
    lo = torch.floor(c)
    frac = c - lo
    lo_i = lo.to(torch.int32)
    hi_i = lo_i + 1
    if circular:
        lo_i = torch.remainder(lo_i, n_bins)
        hi_i = torch.remainder(hi_i, n_bins)
    else:
        lo_i = torch.clamp(lo_i, 0, n_bins - 1)
        hi_i = torch.clamp(hi_i, 0, n_bins - 1)
    return lo_i, hi_i, 1.0 - frac, frac


def shot_descriptors(
    keypoints: torch.Tensor,
    kp_mask: torch.Tensor,
    points: torch.Tensor,
    mask: torch.Tensor,
    normals: torch.Tensor,
    cfg,
):
    """SHOT descriptors: (desc (K, 352) f32 L2-normalised, valid (K,))."""
    radius = cfg.shot_radius_mm
    g = gather_neighbors(keypoints, kp_mask, points, mask, normals, radius,
                         cfg.max_neighbors)
    frames, lrf_valid = local_reference_frames(g, radius)

    local = torch.einsum("kai,kmi->kma", frames, g.rel)  # (K, M, 3)
    xl, yl, zl = local[..., 0], local[..., 1], local[..., 2]
    d = g.dist
    nA, nE, nR, nC = (cfg.n_azimuth_bins, cfg.n_elevation_bins,
                      cfg.n_radial_bins, cfg.n_cosine_bins)

    az = torch.atan2(yl, xl)
    az = torch.where(az < 0, az + 2.0 * math.pi, az)
    az_coord = az / (2.0 * math.pi) * nA
    a_lo, a_hi, aw_lo, aw_hi = _soft_bins(az_coord, nA, circular=True)

    el_coord = torch.clamp(zl / max(radius, _EPS) + 1.0, 0.0, 2.0 - 1e-6) / 2.0 * nE
    e_lo, e_hi, ew_lo, ew_hi = _soft_bins(el_coord, nE, circular=False)

    r_coord = torch.clamp(d / radius, 0.0, 1.0 - 1e-6) * nR
    r_lo, r_hi, rw_lo, rw_hi = _soft_bins(r_coord, nR, circular=False)

    cosine = torch.einsum("kmi,ki->km", g.normals, frames[:, 2, :])
    cosine = torch.clamp(cosine, -1.0, 1.0)
    c_coord = (cosine + 1.0) / 2.0 * nC
    c_coord = torch.clamp(c_coord, max=nC - 1e-6)
    c_lo, c_hi, cw_lo, cw_hi = _soft_bins(c_coord, nC, circular=False)

    wgt = g.nmask.to(torch.float32)
    # The 16-corner quadrilinear weight factorises into (spatial trilinear)
    # x (cosine linear): desc[k,v,c] = sum_m vol_w[k,m,v] * cos_w[k,m,c].
    nV = nA * nE * nR
    K, M = g.nmask.shape
    dev = keypoints.device
    v_iota = torch.arange(nV, dtype=torch.int32, device=dev)
    c_iota = torch.arange(nC, dtype=torch.int32, device=dev)
    vol_w = torch.zeros((K, M, nV), dtype=torch.float32, device=dev)
    for a_i, a_w in ((a_lo, aw_lo), (a_hi, aw_hi)):
        for e_i, e_w in ((e_lo, ew_lo), (e_hi, ew_hi)):
            for r_i, r_w in ((r_lo, rw_lo), (r_hi, rw_hi)):
                vol = (a_i * nE + e_i) * nR + r_i  # (K, M)
                w = wgt * a_w * e_w * r_w
                vol_w = vol_w + w[..., None] * (vol[..., None] == v_iota).to(torch.float32)
    cos_w = cw_lo[..., None] * (c_lo[..., None] == c_iota).to(torch.float32)
    cos_w = cos_w + cw_hi[..., None] * (c_hi[..., None] == c_iota).to(torch.float32)
    desc = torch.einsum("kmv,kmc->kvc", vol_w, cos_w).reshape(K, nV * nC)

    norm = torch.linalg.norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(norm, min=_EPS)
    valid = kp_mask & lrf_valid & (norm[:, 0] > _EPS)
    return torch.where(valid[:, None], desc, 0.0), valid


def binarize(shot: torch.Tensor, threshold: float = 0.9) -> torch.Tensor:
    """(..., 352) SHOT floats -> (..., 352) {0,1} uint8 bits."""
    batch = shot.shape[:-1]
    groups = shot.reshape(batch + (88, 4)).to(torch.float32)
    total = torch.sum(groups, dim=-1)
    thr = threshold * total
    subsets = torch.tensor(_SUBSETS, dtype=torch.float32, device=shot.device)
    sums = groups @ subsets.T  # (..., 88, 15)
    cond = sums > thr[..., None]
    cond[..., -1] = True  # the all-ones fallback always fires
    first = torch.argmax(cond.to(torch.uint8), dim=-1)  # first true
    bits = subsets.to(torch.uint8)[first]  # (..., 88, 4)
    all_zero = torch.all(groups == 0, dim=-1)
    bits = torch.where(all_zero[..., None], 0, bits).to(torch.uint8)
    return bits.reshape(batch + (352,))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 352) {0,1} -> (..., 11) int32 words (uint32 bit patterns)."""
    batch = bits.shape[:-1]
    words = bits.reshape(batch + (11, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    w = torch.sum(words << shifts, dim=-1)
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32)


class MutualMatches(NamedTuple):
    src_to_ref: torch.Tensor  # (Na,) best ref index per src
    distances: torch.Tensor  # (Na,) Hamming distance on mutual rows, else 2^30
    mutual: torch.Tensor  # (Na,) True where the pair is a mutual NN


def _mutual(amin, aarg, barg, a_mask) -> MutualMatches:
    ar = torch.arange(aarg.shape[0], dtype=torch.int32, device=aarg.device)
    mutual = (barg[aarg.long()] == ar) & a_mask & (amin < 1e30)
    return MutualMatches(
        src_to_ref=aarg,
        distances=torch.where(mutual, amin, float(_BIG)).to(torch.int32),
        mutual=mutual,
    )


class RansacResult(NamedTuple):
    transform: torch.Tensor  # (4, 4) refit on inliers of the best hypothesis
    inliers: torch.Tensor  # (K,) bool
    n_inliers: torch.Tensor  # () int32


def sample_distinct_triples(u: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """(H, 3) index triples WITHOUT replacement from [0, n_valid), from
    (H, 3) uniform draws u: r0 from [0,n), r1 from [0,n-1) shifted past r0,
    r2 from [0,n-2) shifted past both."""
    n = torch.clamp(n_valid, min=3)
    r0 = (u[:, 0] * n).to(torch.int32)
    r1 = (u[:, 1] * (n - 1)).to(torch.int32)
    r1 = r1 + (r1 >= r0).to(torch.int32)
    r2 = (u[:, 2] * (n - 2)).to(torch.int32)
    lo = torch.minimum(r0, r1)
    hi = torch.maximum(r0, r1)
    r2 = r2 + (r2 >= lo).to(torch.int32)
    r2 = r2 + (r2 >= hi).to(torch.int32)
    return torch.stack([r0, r1, r2], dim=1)


def ransac_rigid(
    draws,
    src: torch.Tensor,
    dst: torch.Tensor,
    cmask: torch.Tensor,
    inlier_threshold: float,
    iterations: int = 2000,
) -> RansacResult:
    """Rigid transform from correspondences with outliers (src[i] matches
    dst[i]; cmask marks real ones).  With < 3 valid correspondences the
    identity transform and an empty inlier set are returned."""
    K = src.shape[0]
    dev = src.device
    n_valid = torch.sum(cmask.to(torch.int32))
    # Dense list of valid indices (then the invalid ones) for sampling.
    order = torch.argsort(torch.where(cmask, 0, 1), stable=True)
    draw = sample_distinct_triples(draws.to(device=dev, dtype=torch.float32), n_valid)
    sample_idx = order[torch.clamp(draw, 0, K - 1).long()]  # (H, 3)

    s = src[sample_idx]  # (H, 3, 3)
    d = dst[sample_idx]
    T_h = se3.kabsch(s, d)  # (H, 4, 4)

    src_h = se3.apply(T_h, src[None, :, :])  # (H, K, 3)
    err = torch.linalg.norm(src_h - dst[None, :, :], dim=-1)
    ok = cmask[None, :] & (err < inlier_threshold)
    # Near-collinear source triples make the Kabsch rotation ill-conditioned;
    # zero their score so a degenerate hypothesis can never win.
    area2 = torch.linalg.norm(
        torch.linalg.cross(s[:, 1] - s[:, 0], s[:, 2] - s[:, 0]), dim=-1
    )
    scores = torch.where(area2 > 1e-6, torch.sum(ok.to(torch.int32), dim=1), 0)
    # The first maximum, taken with index_select: indexing with a 0-d tensor
    # reads it on the host, a synchronisation.
    best = torch.argmax(scores).reshape(1)
    inliers = (ok.index_select(0, best)[0] & (n_valid >= 3)
               & (scores.index_select(0, best)[0] > 0))
    w = inliers.to(torch.float32)
    T = se3.kabsch(src, dst, w)
    T = torch.where(torch.sum(w) >= 3, T, torch.eye(4, dtype=T.dtype, device=dev))
    return RansacResult(transform=T, inliers=inliers,
                        n_inliers=torch.sum(inliers.to(torch.int32)))


class IcpResult(NamedTuple):
    transform: torch.Tensor  # (4, 4): target ~= transform(source)
    rmse: torch.Tensor  # () final inlier RMSE, mm
    n_pairs: torch.Tensor  # () correspondences used in the last iteration


def icp_point_to_point(
    src: torch.Tensor,
    src_mask: torch.Tensor,
    dst: torch.Tensor,
    dst_mask: torch.Tensor,
    iterations: int = 10,
    max_corr_dist: float = 1.0e9,
    n_valid_dst=None,
    tail_start: int = -1,
) -> IcpResult:
    """Align (K, 3) masked source points to (M, 3) masked target points.

    `n_valid_dst` optionally bounds the valid (front-compacted) target rows;
    rows at or past `tail_start` are always searched."""
    if n_valid_dst is None:
        n_valid_dst = dst.shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=src.device)
    T = eye
    rmse = n = None
    for _ in range(iterations):
        cur = se3.apply(T, src)
        nn_d2, nn = euclid_nn_bounded_plain(cur, src_mask, dst, dst_mask,
                                            n_valid_dst, tail_start=tail_start)
        nn_pos = dst[nn.long()]
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
    return IcpResult(transform=T, rmse=rmse, n_pairs=n.to(torch.int32))


class MapState(NamedTuple):
    positions: torch.Tensor  # (C, 3) float32, snapped to cfg.snap_mm
    descriptors: torch.Tensor  # (C, 11) int32 packed B-SHOT (uint32 bits)
    seg_ratios: torch.Tensor  # (C,) float32
    blocks: torch.Tensor  # (C, 3) int32 voxel-block coords
    valid: torch.Tensor  # (C,) bool
    cursor: torch.Tensor  # () int32 next free slot
    frame_born: torch.Tensor  # (C,) int32 inserting frame, -1 for empty rows
    n_dropped: torch.Tensor  # () int32 insertions lost at capacity


def snap_positions(pos: torch.Tensor, snap_mm: float) -> torch.Tensor:
    """Grid snap, truncating toward zero."""
    return torch.trunc(pos / snap_mm) * snap_mm


def block_coords(pos: torch.Tensor, block_mm: float) -> torch.Tensor:
    """Voxel-block integer coords by rounding (half to even)."""
    return torch.round(pos / block_mm).to(torch.int32)


def _set_rows(x: torch.Tensor, tgt: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Copy of x with x[tgt[i]] = rows[i]; targets == len(x) are dropped."""
    ext = torch.cat([x, x[:1]], dim=0)
    return ext.index_copy(0, tgt, rows.to(x.dtype))[: x.shape[0]]


def evict_keypoints(state: MapState, n_evict: int) -> MapState:
    """Evict up to `n_evict` keypoints, lowest-seg-ratio-in-densest-block
    first, then front-compact the survivors so valid rows stay exactly
    [0, cursor).  Evicted rows get `frame_born` -1.

    Ties follow the reference exactly: its lexsort is three stable sorts
    (last key first), its float32 score `occ * 2C + (C - 1 - seg_rank)`
    rounds above 2^24 as it does there, and its top-k takes the lowest
    index among equal scores (a stable descending sort)."""
    C = state.positions.shape[0]
    dev = state.positions.device
    i32 = dict(dtype=torch.int32, device=dev)
    # Per-row block occupancy: sort rows by block, then run lengths.
    blk = torch.where(state.valid[:, None], state.blocks, 2**30)
    order = torch.arange(C, device=dev)
    for k in (2, 1, 0):
        order = order[torch.argsort(blk[order, k], stable=True)]
    sb = blk[order]
    new_run = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                         torch.any(sb[1:] != sb[:-1], dim=1)])
    run_id = torch.cumsum(new_run.to(torch.int32), dim=0) - 1
    run_len = torch.zeros((C,), **i32).index_add_(
        0, run_id, torch.ones((C,), **i32))
    occ = torch.zeros((C,), **i32).index_copy(0, order, run_len[run_id])
    occ = torch.where(state.valid, occ, 0)

    # Eviction score: densest block first, lowest seg_ratio within.
    seg_rank = torch.zeros((C,), **i32).index_copy(
        0, torch.argsort(state.seg_ratios, stable=True),
        torch.arange(C, **i32))
    score = torch.where(
        state.valid,
        occ.to(torch.float32) * (2.0 * C) + (C - 1 - seg_rank).to(torch.float32),
        -1.0,
    )
    evict_idx = torch.sort(score, descending=True, stable=True).indices[:n_evict]
    evict = torch.zeros((C,), dtype=torch.bool, device=dev).index_fill(
        0, evict_idx, True) & state.valid

    # Stable front-compaction of the survivors.
    keep = state.valid & ~evict
    perm = torch.argsort((~keep).to(torch.uint8), stable=True)
    return MapState(
        positions=state.positions[perm],
        descriptors=state.descriptors[perm],
        seg_ratios=state.seg_ratios[perm],
        blocks=state.blocks[perm],
        valid=keep[perm],
        cursor=torch.sum(keep.to(torch.int32)).to(torch.int32),
        frame_born=torch.where(keep, state.frame_born, -1)[perm],
        n_dropped=state.n_dropped,
    )


def query_mask(state: MapState, center: torch.Tensor, range_mm: float,
               cfg) -> torch.Tensor:
    """(C,) mask of keypoints whose block intersects the +-range AABB
    (block granularity, as the reference's window scan)."""
    lo = torch.round((center - range_mm) / cfg.block_size_mm).to(torch.int32)
    hi = torch.round((center + range_mm) / cfg.block_size_mm).to(torch.int32)
    inside = torch.all(
        (state.blocks >= lo[None, :]) & (state.blocks <= hi[None, :]), dim=-1
    )
    return state.valid & inside


class FrameFeatures(NamedTuple):
    keypoints: torch.Tensor  # (K, 3) sensor frame
    scores: torch.Tensor  # (K,) seg ratios
    descriptors: torch.Tensor  # (K, 11) packed B-SHOT, int32
    mask: torch.Tensor  # (K,) keypoint and descriptor valid


class OdometryState(NamedTuple):
    map: MapState
    ref: FrameFeatures  # previous frame's features (sensor frame)
    ref_pose: torch.Tensor  # (4, 4) previous frame's world pose
    frame_idx: torch.Tensor  # () int32




def insert_keypoints(state: MapState, pos, desc, seg, kmask, cfg, frame_idx):
    """Batched equivalent of K sequential `Map::addKeypoint` calls: a new
    keypoint is rejected when an existing same-block keypoint lies within
    the dedup radius with a seg ratio >= its own, or an earlier one of the
    batch does; survivors are appended at the cursor, and those past the
    capacity are dropped and counted."""
    dev = pos.device
    pos = snap_positions(pos, cfg.snap_mm)
    blk = block_coords(pos, cfg.block_size_mm)
    r2 = cfg.dedup_radius_mm * cfg.dedup_radius_mm
    C = state.positions.shape[0]
    rejected_by_map = dedup_blocked_bounded_plain(
        pos, blk, seg, state.positions, state.blocks, state.seg_ratios,
        state.valid, state.cursor, dedup_radius=cfg.dedup_radius_mm)
    d2b = pair_d2(pos, pos)
    same_blk_b = torch.all(blk[:, None, :] == blk[None, :, :], dim=-1)
    K = pos.shape[0]
    earlier = torch.tril(torch.ones((K, K), dtype=torch.bool, device=dev),
                         diagonal=-1)
    blocker_b = (earlier & kmask[None, :] & same_blk_b & (d2b < r2)
                 & (seg[None, :] >= seg[:, None]))
    accept = kmask & ~rejected_by_map & ~torch.any(blocker_b, dim=1)
    offs = torch.cumsum(accept.to(torch.int32), dim=0) - 1
    slot = state.cursor + offs
    ok = accept & (slot < C)
    tgt = torch.where(ok, slot, C).long()
    n_ok = torch.sum(ok.to(torch.int32))
    fidx = torch.as_tensor(frame_idx, dtype=torch.int32, device=dev)
    return MapState(
        positions=_set_rows(state.positions, tgt, pos),
        descriptors=_set_rows(state.descriptors, tgt, desc),
        seg_ratios=_set_rows(state.seg_ratios, tgt, seg),
        blocks=_set_rows(state.blocks, tgt, blk),
        valid=_set_rows(state.valid, tgt, torch.ones_like(accept)),
        cursor=torch.clamp(state.cursor + n_ok, max=C).to(torch.int32),
        frame_born=_set_rows(state.frame_born, tgt, fidx.expand(K)),
        n_dropped=(state.n_dropped + torch.sum(accept.to(torch.int32))
                   - n_ok).to(torch.int32),
    )


def compute_features(points, pmask, cfg) -> FrameFeatures:
    """Seg-ratio keypoints (top_k), surface normals from the same
    neighbourhood moments, SHOT descriptors binarised to B-SHOT."""
    kcfg = cfg.keypoints
    acc = neighborhood_accumulate_plain(points, pmask, moment_features(points),
                                        kcfg.radius_mm)
    ctvec = points - acc[:, 1:4] / torch.clamp(acc[:, 0], min=1.0)[:, None]
    sr = segratio_accumulate_plain(points, pmask, ctvec, kcfg.radius_mm,
                                   normalized=(kcfg.sr_type == "CVSN"))
    cnt, psum, outer = moments_from_sums(acc)
    scores = _finalize_scores(points, pmask, kcfg, cnt, sr[:, 0], sr[:, 1], sr[:, 2])
    top_scores, top_idx = top_k(scores, kcfg.top_k)
    kps = keypoints_from_scores(points, top_scores, top_idx)
    normals, _, _ = normals_from_moments(points, pmask, cnt, psum, outer)
    desc_f, desc_valid = shot_descriptors(kps.positions, kps.mask, points, pmask,
                                          normals, cfg.descriptor)
    words = pack_bits(binarize(desc_f, cfg.descriptor.bshot_threshold))
    return FrameFeatures(keypoints=kps.positions, scores=kps.scores,
                         descriptors=words, mask=kps.mask & desc_valid)


class StepOut(NamedTuple):
    pose: torch.Tensor  # (4, 4)
    n_mutual: torch.Tensor
    n_inliers: torch.Tensor
    gated: torch.Tensor
    map_size: torch.Tensor
    features: FrameFeatures


def odometry_step(state: OdometryState, points, pmask, draws, cfg):
    """One frame: (the state after it, StepOut).  `draws` are the frame's
    (H, 3) uniform RANSAC draws."""
    mcfg = cfg.match
    dev = points.device
    src = compute_features(points, pmask, cfg)
    ref_pose = state.ref_pose
    win = query_mask(state.map, se3.translation(ref_pose), mcfg.map_query_range_mm,
                     cfg.map)
    cand_pos = torch.cat([state.map.positions, se3.apply(ref_pose, state.ref.keypoints)])
    cand_desc = torch.cat([state.map.descriptors, state.ref.descriptors])
    cand_mask = torch.cat([win, state.ref.mask])
    capacity = state.map.positions.shape[0]
    amin, aarg, _, barg = hamming_nn_bounded_plain(
        src.descriptors, src.mask, cand_desc, cand_mask, state.map.cursor,
        tail_start=capacity)
    m = _mutual(amin, aarg, barg, src.mask)
    corr_dst = cand_pos[m.src_to_ref.long()]
    rr = ransac_rigid(draws, src.keypoints, corr_dst, m.mutual,
                      inlier_threshold=mcfg.ransac_inlier_th_mm,
                      iterations=mcfg.ransac_iterations)
    T_j = rr.transform
    T_ij = se3.compose(se3.inverse(ref_pose), T_j)
    gate = ((se3.heading_angle(T_ij) > math.radians(mcfg.gate_heading_deg))
            | (torch.linalg.norm(se3.translation(T_ij)) > mcfg.gate_translation_mm)
            | (rr.n_inliers < mcfg.gate_min_inliers))
    T_est = torch.where(gate, ref_pose, T_j)
    icp = icp_point_to_point(
        se3.apply(T_est, src.keypoints), src.mask, cand_pos, cand_mask,
        iterations=mcfg.icp_iterations, max_corr_dist=mcfg.icp_max_corr_dist_mm,
        n_valid_dst=state.map.cursor, tail_start=capacity)
    T_best = se3.compose(icp.transform, T_est) if mcfg.run_icp else T_j
    is_initial = state.frame_idx == 0
    T_best = torch.where(is_initial, torch.eye(4, dtype=torch.float32, device=dev),
                         T_best)
    gate = gate & ~is_initial
    new_map = insert_keypoints(state.map, se3.apply(T_best, src.keypoints),
                               src.descriptors, src.scores, src.mask, cfg.map,
                               state.frame_idx)
    out = StepOut(pose=T_best, n_mutual=torch.sum(m.mutual.to(torch.int32)),
                  n_inliers=rr.n_inliers, gated=gate,
                  map_size=torch.sum(new_map.valid.to(torch.int32)), features=src)
    return OdometryState(map=new_map, ref=src, ref_pose=T_best,
                         frame_idx=state.frame_idx + 1), out


def make_room(state: OdometryState, cfg) -> OdometryState:
    """The engine's rule before a frame at the map's hard capacity: when the
    frame's inserts could overflow it, evict the weakest keypoints of the
    densest blocks (min(2 top_k, capacity / 2) rows)."""
    cap = state.map.positions.shape[0]
    if int(state.map.cursor) + cfg.keypoints.top_k <= cap:
        return state
    n_evict = min(2 * cfg.keypoints.top_k, cfg.map.capacity // 2)
    return state._replace(map=evict_keypoints(state.map, n_evict))
