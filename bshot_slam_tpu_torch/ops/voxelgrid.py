"""Voxel-grid downsampling (centroid per occupied voxel), fixed-shape.

Port of `bshot_slam_tpu.ops.voxelgrid`: the reference's alternate keypoint
source `bshot::calculate_voxel_grid_keypoints` (reference:
include/bshot_bits.h:97-110, `pcl::VoxelGrid`), which its SLAM loop never
calls but its API exposes.  Voxel coordinates hash into a fixed-capacity
table; each occupied slot's centroid is the mean of its rows.  Distinct
voxels that collide in the hash merge their centroids (a documented
deviation from PCL's exact map, as in the reference).

The sums take each slot's rows in row order, as the reference's scatter-add
does on the CPU: the rows are sorted by slot (stable) and each slot summed
in one segmented pass, on the card too, where float atomics would add in
no fixed order.
"""

from __future__ import annotations

from typing import Tuple

import torch

_P1, _P2, _P3 = 73856093, 19349663, 83492791  # classic spatial-hash primes


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, leaf_mm: float,
                     capacity: int = 16384) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, 3) masked points -> (capacity, 3) voxel centroids + valid mask.
    The int32 hash wraps and `%` is floor-mod, as in the reference; masked
    rows go to slot `capacity`, which is dropped."""
    cell = torch.floor(points / leaf_mm).to(torch.int32)
    h = ((cell[:, 0] * _P1) ^ (cell[:, 1] * _P2) ^ (cell[:, 2] * _P3)) % capacity
    h = torch.where(mask, h, capacity).to(torch.int64)
    order = torch.sort(h, stable=True).indices
    lengths = torch.bincount(h, minlength=capacity + 1)
    psum = torch.segment_reduce(points[order], "sum", lengths=lengths, axis=0,
                                unsafe=True)[:capacity]
    cnt = lengths[:capacity].to(torch.float32)
    valid = cnt > 0
    centroids = torch.where(valid[:, None], psum / torch.clamp(cnt, min=1.0)[:, None],
                            0.0)
    return centroids, valid
