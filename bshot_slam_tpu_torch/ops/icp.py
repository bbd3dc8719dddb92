"""Masked point-to-point ICP refinement.

Port of `bshot_slam_tpu.ops.icp`: a fixed number of iterations (a Python
loop of `iterations` steps), each a nearest-neighbour search by kernel D
(`kernels.mapops.euclid_nn_bounded`) and a weighted Kabsch step.  Against
targets whose map rows are sharded along a mesh axis, each iteration
combines the ranks' nearest neighbours with one MIN of packed keys and
takes the winners' positions from their owners (`parallel.layout`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bshot_slam_tpu_torch.geometry import se3
from bshot_slam_tpu_torch.kernels.mapops import euclid_nn_bounded
from bshot_slam_tpu_torch.parallel import layout
from bshot_slam_tpu_torch.parallel.comm import Axis


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
    axis: Axis | None = None,
) -> IcpResult:
    """Align (K, 3) masked source points to (M, 3) masked target points.

    `n_valid_dst` optionally bounds the valid (front-compacted) target rows;
    rows at or past `tail_start` are always searched.  With `axis`, rows
    [0, tail_start) are this rank's shard of the map along it."""
    if n_valid_dst is None:
        n_valid_dst = dst.shape[0]
    eye = torch.eye(4, dtype=torch.float32, device=src.device)
    T = eye
    rmse = n = None
    for _ in range(iterations):
        cur = se3.apply(T, src)
        nn_d2, nn = euclid_nn_bounded(cur, src_mask, dst, dst_mask,
                                      n_valid_dst, tail_start=tail_start)
        if axis is None:
            nn_pos = dst[nn.long()]
        else:
            g = layout.global_index(nn, tail_start, axis)
            nn_d2, g = layout.argmin_combine(nn_d2, g, axis, "D: key min")
            nn_pos = layout.fetch_rows(g, dst, tail_start, axis, "D: owner rows")
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
