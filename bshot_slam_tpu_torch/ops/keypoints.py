"""Segmentation-ratio saliency keypoints.

Port of `bshot_slam_tpu.ops.keypoints` (the main-path part): per-point
radius-neighbourhood moments (kernel A), seg-ratio counts and sums
(kernel B) and the top-k keypoint selection.  The reference's formulas:

  CV   = 1 - min(pos, neg)/max(pos, neg)
  CVS  = |sum dot(ctvec, p-sp)| / n
  CVSN = |sum cos angle| / n

with ctvec = sp - centroid(neighbourhood); undefined scores become -inf.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from bshot_slam_tpu_torch.config import KeypointConfig
from bshot_slam_tpu_torch.kernels import fma_dot3  # noqa: F401  (re-export)
from bshot_slam_tpu_torch.kernels import pair_d2 as _pair_d2  # noqa: F401
from bshot_slam_tpu_torch.kernels.neighborhood import (
    neighborhood_accumulate, segratio_accumulate,
)

_NEG_INF = float("-inf")


def top_k(score: torch.Tensor, k: int):
    """Exact top-k over the last axis, ties to the lowest index (as
    `lax.top_k`; `torch.topk` breaks ties otherwise)."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
    zeros.  One pass of kernel A over 10 features: 1, p, the 6 products."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    feat = torch.stack(
        [torch.ones_like(x), x, y, z, x * x, x * y, x * z, y * y, y * z, z * z],
        dim=-1,
    )
    acc = neighborhood_accumulate(points, mask, feat, radius, r2_row=r2_row,
                                  tile=tile)
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
