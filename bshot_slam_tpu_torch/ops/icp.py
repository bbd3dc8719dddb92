"""Masked point-to-point ICP refinement.

Port of `bshot_slam_tpu.ops.icp`: a fixed number of iterations (a Python
loop of `iterations` steps), each a nearest-neighbour search by kernel D
(`kernels.mapops.euclid_nn_bounded`) and a weighted Kabsch step by kernel
G (`kernels.mapops.icp_update`, its plain version on the CPU): one G
launch to start, then one of D and one of G an iteration.  Against
targets whose map rows are sharded along a mesh axis, each iteration
combines the ranks' nearest neighbours with one MIN of packed keys and
takes the winners' positions from their owners (`parallel.layout`), which
G takes as gathered candidates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bshot_slam_tpu_torch.kernels.mapops import euclid_nn_bounded, icp_update
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
    st = icp_update(src, src_mask, dst)
    for _ in range(iterations):
        nn_d2, nn = euclid_nn_bounded(st.cur, src_mask, dst, dst_mask,
                                      n_valid_dst, tail_start=tail_start)
        if axis is None:
            st = icp_update(src, src_mask, dst, nn_d2, nn, max_corr_dist, st)
        else:
            g = layout.global_index(nn, tail_start, axis)
            nn_d2, g = layout.argmin_combine(nn_d2, g, axis, "D: key min")
            nn_pos = layout.fetch_rows(g, dst, tail_start, axis, "D: owner rows")
            st = icp_update(src, src_mask, nn_pos, nn_d2, None, max_corr_dist, st)
    return IcpResult(transform=st.transform, rmse=st.rmse, n_pairs=st.n_pairs)
