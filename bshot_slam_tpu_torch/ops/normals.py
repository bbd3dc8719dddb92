"""Surface normals by masked neighbourhood PCA.

Port of `bshot_slam_tpu.ops.normals`: neighbourhood moments from kernel A,
then the closed-form 3x3 eigendecomposition; the smallest-eigenvalue
direction, flipped toward the sensor at the origin, is the normal.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bshot_slam_tpu_torch.geometry.eig3 import eigh3
from bshot_slam_tpu_torch.ops.keypoints import capped_r2_rows, neighborhood_moments


def surface_normals(
    points: torch.Tensor,
    mask: torch.Tensor,
    radius: float,
    tile: int = 4096,
    min_neighbors: int = 3,
    cap: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-point unit normals (N, 3), curvature (N,) and validity (N,)."""
    r2_row = None
    if cap:
        r2_row = capped_r2_rows(points, mask, radius, cap, tile)
    cnt, psum, outer = neighborhood_moments(points, mask, radius, tile,
                                            r2_row=r2_row)
    return normals_from_moments(points, mask, cnt, psum, outer, min_neighbors)


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
    evals, evecs = eigh3(cov)  # ascending eigenvalues
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
