"""Propagating pose-graph corrections into the live SLAM state.

Port of `bshot_slam_tpu.backend.corrections`: the per-keyframe correction
`T_opt @ inv(T_raw)` is interpolated to every frame by twist (se3 log/exp)
interpolation, and map landmarks are re-anchored by their `frame_born`
provenance, so later frames match against the corrected map.
"""

from __future__ import annotations

import torch

from bshot_slam_tpu_torch.config import MapConfig
from bshot_slam_tpu_torch.geometry import se3
from bshot_slam_tpu_torch.ops.keypoints import fma_dot3
from bshot_slam_tpu_torch.odometry.mapstore import (
    MapState, block_coords, snap_positions,
)


def interpolate_corrections(corr_kf: torch.Tensor, kf_frames: torch.Tensor,
                            frames: torch.Tensor) -> torch.Tensor:
    """(F, 4, 4) corrections: exact at keyframes, twist-interpolated between
    them, clamped to the first/last keyframe correction outside the span.
    `kf_frames` (n_kf,) ascending, `frames` (F,)."""
    n_kf = corr_kf.shape[0]
    k = torch.searchsorted(kf_frames, frames, right=True) - 1
    k = torch.clamp(k, 0, n_kf - 1)
    k1 = torch.clamp(k + 1, max=n_kf - 1)
    f0 = kf_frames[k].to(torch.float32)
    f1 = kf_frames[k1].to(torch.float32)
    s = torch.where(f1 > f0, (frames.to(torch.float32) - f0) / (f1 - f0), 0.0)
    s = torch.clamp(s, 0.0, 1.0)
    A, B = corr_kf[k], corr_kf[k1]
    xi = se3.se3_log(se3.compose(B, se3.inverse(A)))  # (F, 6)
    return se3.compose(se3.se3_exp(xi * s[:, None]), A)


def reanchor_map(state: MapState, corr: torch.Tensor, frame0,
                 cfg: MapConfig) -> MapState:
    """Move every landmark by the correction of the frame that inserted it
    (frame_born), re-snapping it to the position grid and recomputing its
    voxel block.  The rotation is the FMA chain the reference's compiled
    program computes: one ulp there can move a snap by a whole grid step."""
    F = corr.shape[0]
    idx = torch.clamp(state.frame_born - frame0, 0, F - 1).long()
    T = corr[idx]  # (C, 4, 4)
    p = fma_dot3(T[:, :3, :3], state.positions[:, None, :]) + T[:, :3, 3]
    p = snap_positions(p, cfg.snap_mm)
    move = state.valid & (state.frame_born >= 0)
    new_pos = torch.where(move[:, None], p, state.positions)
    new_blk = torch.where(move[:, None], block_coords(new_pos, cfg.block_size_mm),
                          state.blocks)
    return state._replace(positions=new_pos, blocks=new_blk)
