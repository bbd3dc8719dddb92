"""Sweep preprocessing on the device: ground / self-car / occlusion classes.

Port of `bshot_slam_tpu.ops.preprocess` (reference: src/preprocess.cpp), the
ingest of `SlamEngine(host_preprocess=False)`.  A dense (R, A) range image
(rings in ascending vertical angle) becomes points, the bottom-up ground
walk classifies every cell (kernel F, `kernels.preprocess.ground_walk`, on
the card; its plain version on the CPU), the occlusion pass marks the far
side of range jumps along azimuth, and `extract_cloud` front-compacts the
kept points in the reference's column-major order.  Class codes: 0 keep /
1 ground / 2 self-car / 3 occluded.

Every step is a handful of whole-image PyTorch operations (the ground walk
one kernel launch), writing into preallocated outputs where that saves a
copy: the whole ingest of a frame is a few dozen launches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from bshot_slam_tpu_torch.config import CLASS_KEEP, CLASS_OCCLUDED, PreprocessConfig
from bshot_slam_tpu_torch.kernels.preprocess import f32, ground_walk


class PreprocessResult(NamedTuple):
    classes: torch.Tensor  # (R, A) int32 class codes
    xyz: torch.Tensor  # (R, A, 3) float32 sensor-frame coordinates, mm
    valid: torch.Tensor  # (R, A) bool: has a return (range > 0)


def polar_to_xyz(range_mm: torch.Tensor, azimuth_rad: torch.Tensor,
                 vert_rad: torch.Tensor) -> torch.Tensor:
    """(R, A) polar -> (R, A, 3) sensor-frame XYZ (reference:
    preprocess.cpp:50-52): (range cos v) sin az, (range cos v) cos az,
    range sin v."""
    xyz = torch.empty(range_mm.shape + (3,), dtype=torch.float32,
                      device=range_mm.device)
    rc = range_mm * torch.cos(vert_rad)[:, None]
    torch.mul(rc, torch.sin(azimuth_rad), out=xyz[..., 0])
    torch.mul(rc, torch.cos(azimuth_rad), out=xyz[..., 1])
    torch.mul(range_mm, torch.sin(vert_rad)[:, None], out=xyz[..., 2])
    return xyz


def ground_point(azimuth_rad: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """(A, 3) virtual ground point of each column, where the walk starts:
    z = -H under the sensor, at the initial vertical angle (reference:
    preprocess.cpp:80-83), at row 0's azimuth (a firing shares its azimuth
    down the column)."""
    h = np.float32(cfg.sensor_height_mm)
    horiz0 = float(-h / np.tan(np.float32(cfg.vert_init_rad)))
    az0 = azimuth_rad[0]
    p0 = torch.empty((az0.shape[0], 3), dtype=torch.float32, device=az0.device)
    torch.sin(az0, out=p0[:, 0])
    torch.cos(az0, out=p0[:, 1])
    p0[:, :2] *= horiz0
    p0[:, 2] = -float(h)
    return p0


def _ground_scan(range_mm: torch.Tensor, azimuth_rad: torch.Tensor,
                 vert_rad: torch.Tensor, xyz: torch.Tensor,
                 cfg: PreprocessConfig) -> torch.Tensor:
    """The bottom-up ground walk (reference: preprocess.cpp:73-166) from
    each column's `ground_point`: kernel F on the card."""
    return ground_walk(range_mm, xyz, ground_point(azimuth_rad, cfg), cfg)


def _occlusion_pass(range_mm: torch.Tensor, azimuth_rad: torch.Tensor,
                    classes: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """Mark the far side of sharp range jumps along azimuth (reference:
    preprocess.cpp:168-199).  A cell's previous column is the last column
    before it with a return, or column 0 when there is none (the
    reference's isFirst seeding, :175-177); column 0 has no previous column.
    Each jump marks one cell: the current one when the range grew, else the
    previous one."""
    R, A = range_mm.shape
    valid = range_mm > 0
    idx = torch.arange(A, device=range_mm.device).expand(R, A)
    # Last column <= a with a return, else 0: the seeded scan.
    last = torch.cummax(torch.where(valid, idx, 0), dim=1).values
    prev = last[:, :-1]  # the previous column of columns 1..A-1
    ra = torch.stack([range_mm, azimuth_rad])
    d = ra[:, :, 1:] - torch.gather(ra, 2, prev.expand(2, R, A - 1))
    d_abs = torch.abs(d)
    occ = (valid[:, 1:] & (d_abs[0] > f32(cfg.dist_th_mm))
           & (d_abs[1] < f32(cfg.angdiff_th_rad)))
    target = torch.where(d[0] > 0, idx[:, 1:], prev)
    # Integer max: exact in any order of the scatter.
    marks = torch.zeros_like(classes).scatter_reduce(1, target, occ.to(torch.int32),
                                                     "amax")
    # marks (0 or 1) > class exactly where a mark falls on a kept cell
    # (CLASS_KEEP is 0, every other class above 0).
    return torch.where(marks > classes, CLASS_OCCLUDED, classes)


def preprocess(range_mm: torch.Tensor, azimuth_rad: torch.Tensor,
               vert_rad: torch.Tensor, cfg: PreprocessConfig) -> PreprocessResult:
    """Classify every cell of a dense sweep (the reference's
    `Preprocessor::run()` minus IO, preprocess.cpp:218-227)."""
    range_mm = range_mm.to(torch.float32)
    xyz = polar_to_xyz(range_mm, azimuth_rad, vert_rad)
    classes = _ground_scan(range_mm, azimuth_rad, vert_rad, xyz, cfg)
    classes = _occlusion_pass(range_mm, azimuth_rad, classes, cfg)
    return PreprocessResult(classes=classes, xyz=xyz, valid=range_mm > 0)


def extract_cloud(result: PreprocessResult, selected: Optional[torch.Tensor],
                  max_points: int, save_sel: bool = True):
    """Kept points front-compacted into a fixed-size padded cloud (the
    reference's `Preprocessor::writePointCloud`, preprocess.cpp:201-216):
    cells whose class is keep, that have a return and whose select flag is
    `save_sel` (`selected=None`: every cell is selected), in column-major
    order (azimuth, then ring), the first `max_points` of them.  Returns
    (points (max_points, 3), zero past the kept ones; mask (max_points,))."""
    classes_t = result.classes.T  # (A, R): column-major order
    keep = torch.empty(classes_t.shape, dtype=torch.bool, device=classes_t.device)
    torch.eq(classes_t, CLASS_KEEP, out=keep)
    keep &= result.valid.T
    if selected is not None:
        keep &= selected.T == save_sel
    elif not save_sel:
        keep.zero_()
    # Each kept cell's slot in scan order; the other cells, and kept cells
    # past max_points, go to a discarded slot at max_points.
    count = torch.cumsum(keep.view(-1), dim=0)
    slot = torch.where(keep.view(-1), count - 1, max_points).clamp_(max=max_points)
    points = torch.zeros((max_points + 1, 3), dtype=torch.float32,
                         device=keep.device)
    points[slot.view(keep.shape)] = result.xyz.transpose(0, 1)
    mask = torch.arange(max_points, device=keep.device) < count[-1]
    return points[:max_points], mask
