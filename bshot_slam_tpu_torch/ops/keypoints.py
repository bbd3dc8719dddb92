"""Segmentation-ratio saliency keypoints.

Port of `bshot_slam_tpu.ops.keypoints`: per-point radius-neighbourhood
moments (kernel A), seg-ratio counts and sums (kernel B) and the top-k
keypoint selection; and for evaluation the ISS detector (kernel A at the
salient radius) and keypoint repeatability.  The reference's formulas:

  CV   = 1 - min(pos, neg)/max(pos, neg)
  CVS  = |sum dot(ctvec, p-sp)| / n
  CVSN = |sum cos angle| / n

with ctvec = sp - centroid(neighbourhood); undefined scores become -inf.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from bshot_slam_tpu_torch.config import KeypointConfig
from bshot_slam_tpu_torch.geometry.eig3 import eigvalsh3
from bshot_slam_tpu_torch.kernels import fma_dot3  # noqa: F401  (re-export)
from bshot_slam_tpu_torch.kernels import pair_d2 as _pair_d2  # noqa: F401
from bshot_slam_tpu_torch.kernels import top_k  # noqa: F401  (re-export)
from bshot_slam_tpu_torch.kernels.neighborhood import (
    neighborhood_accumulate, segratio_accumulate,
)

_NEG_INF = float("-inf")


def capped_r2_rows(points, mask, radius: float, cap: int, tile: int = 4096,
                   refine: int = 2) -> torch.Tensor:
    """Per-point squared radius approximating the reference's `cap`-nearest
    neighbour truncation by shrinking each ball (see the reference)."""
    r2 = radius * radius
    r2_row = torch.full((points.shape[0],), r2, dtype=torch.float32,
                        device=points.device)
    for _ in range(1 + refine):
        cnt, _, _ = neighborhood_moments(points, mask, radius, tile,
                                         r2_row=r2_row)
        r2_row = torch.clamp(
            r2_row * (cap / torch.clamp(cnt, min=1.0)) ** (2.0 / 3.0), max=r2
        )
    return r2_row


def _outer_from6(o6: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            torch.stack([o6[:, 0], o6[:, 1], o6[:, 2]], dim=-1),
            torch.stack([o6[:, 1], o6[:, 3], o6[:, 4]], dim=-1),
            torch.stack([o6[:, 2], o6[:, 4], o6[:, 5]], dim=-1),
        ],
        dim=-2,
    )


def neighborhood_moments(
    points: torch.Tensor,
    mask: torch.Tensor,
    radius: float,
    tile: int = 4096,
    r2_row: torch.Tensor | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point neighbour (count (N,), sum (N, 3), sum of outer products
    (N, 3, 3)) within radius, the query itself included; masked points get
    zeros.  One pass of kernel A over `moment_features`."""
    acc = neighborhood_accumulate(points, mask, moment_features(points), radius,
                                  r2_row=r2_row, tile=tile)
    return moments_from_sums(acc)


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


def seg_ratio_scores(
    points: torch.Tensor,
    mask: torch.Tensor,
    cfg: KeypointConfig,
    tile: int = 4096,
    moments: Tuple[torch.Tensor, torch.Tensor] | None = None,
    r2_row: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-point saliency (N,), -inf where undefined or masked.

    `moments` optionally supplies precomputed (count, sum) at cfg.radius_mm
    so the sweep is shared with normal estimation."""
    if cfg.neighbor_cap_mode and r2_row is None:
        r2_row = capped_r2_rows(points, mask, cfg.radius_mm,
                                cfg.neighbor_cap, tile)
        moments = None  # shared full-radius moments don't apply when capped
    if moments is None:
        cnt, psum, _ = neighborhood_moments(points, mask, cfg.radius_mm,
                                            tile, r2_row=r2_row)
    else:
        cnt, psum = moments
    safe_cnt = torch.clamp(cnt, min=1.0)
    centroid = psum / safe_cnt[:, None]
    ctvec = points - centroid  # sp - ct
    acc = segratio_accumulate(points, mask, ctvec, cfg.radius_mm,
                              normalized=(cfg.sr_type == "CVSN"),
                              r2_row=r2_row, tile=tile)
    return _finalize_scores(points, mask, cfg, cnt, acc[:, 0], acc[:, 1],
                            acc[:, 2])


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


def extract_keypoints(
    points: torch.Tensor,
    mask: torch.Tensor,
    cfg: KeypointConfig,
    tile: int = 4096,
) -> Keypoints:
    """Top-k saliency keypoints."""
    scores = seg_ratio_scores(points, mask, cfg, tile)
    top_scores, top_idx = top_k(scores, cfg.top_k)
    return keypoints_from_scores(points, top_scores, top_idx)


def iss_keypoints(points: torch.Tensor, mask: torch.Tensor, cfg: KeypointConfig,
                  tile: int = 4096, max_out: int = 1024) -> Keypoints:
    """ISS-style detector for repeatability evaluation (reference:
    lidar_odometry.cpp:447-461; PCL ISSKeypoint3D semantics): eigenvalues
    l1 >= l2 >= l3 of each point's neighbourhood scatter within the salient
    radius; keep l2/l1 < g21 and l3/l2 < g32 with l3 > 0 and at least the
    minimum neighbours; then non-max suppression on l3 within the non-max
    radius, and the `max_out` largest, ties to the lowest index.

    Kernel A takes at most `kernels.neighborhood.MAX_ROWS` (131072) rows
    (the reference has no such limit); the clouds here hold at most the
    configuration's `max_points` rows, which is at most `MAX_ROWS`."""
    cnt, psum, outer = neighborhood_moments(points, mask, cfg.iss_salient_radius_mm,
                                            tile)
    safe = torch.clamp(cnt, min=1.0)
    mean = psum / safe[:, None]
    cov = outer / safe[:, None, None] - mean[:, :, None] * mean[:, None, :]
    l3, l2, l1 = eigvalsh3(cov).unbind(-1)  # ascending
    good = (mask & (cnt >= cfg.iss_min_neighbors)
            & (l2 / torch.clamp(l1, min=1e-12) < cfg.iss_gamma_21)
            & (l3 / torch.clamp(l2, min=1e-12) < cfg.iss_gamma_32) & (l3 > 0))
    saliency = torch.where(good, l3, _NEG_INF)
    # Non-max suppression: i stays iff its l3 is the largest within the
    # non-max radius, over tiles of candidates.
    r2 = cfg.iss_nonmax_radius_mm ** 2
    mx = torch.full_like(saliency, _NEG_INF)
    for t0 in range(0, points.shape[0], tile):
        within = (_pair_d2(points, points[t0:t0 + tile]) <= r2) & mask[None, t0:t0 + tile]
        cand = torch.where(within, saliency[None, t0:t0 + tile], _NEG_INF)
        mx = torch.maximum(mx, torch.max(cand, dim=1).values)
    sal = torch.where(good & (saliency >= mx), saliency, _NEG_INF)
    return keypoints_from_scores(points, *top_k(sal, max_out))


def repeatability(src: torch.Tensor, src_mask: torch.Tensor, ref: torch.Tensor,
                  ref_mask: torch.Tensor, hit_radius_mm: float = 30.0) -> torch.Tensor:
    """Fraction of the valid src keypoints (masked, not at the origin) with
    a ref keypoint within the hit radius (reference: lidar_odometry.cpp:
    392-419, sqDistLimit = 30^2); a 0-d float32 tensor."""
    d2 = torch.where(ref_mask[None, :], _pair_d2(src, ref), float("inf"))
    nearest = torch.min(d2, dim=1).values
    valid = src_mask & ~torch.all(src == 0, dim=-1)
    hits = valid & (nearest <= hit_radius_mm * hit_radius_mm)
    return torch.sum(hits) / torch.clamp(torch.sum(valid), min=1)
