"""Keyframe store and selection policy.

Port of `bshot_slam_tpu.backend.keyframes`: fixed-capacity tensors of
keyframe poses and their full feature sets (keypoints + packed B-SHOT
descriptors), appended like the global map.  A frame becomes a keyframe
when it has moved or turned enough since the last keyframe, or every
`keyframe_every` frames, whichever fires first.  The selection and the
eviction slot are decided on the host (numpy), as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from bshot_slam_tpu_torch.config import BackendConfig, SlamConfig
from bshot_slam_tpu_torch.device import resolve_device
from bshot_slam_tpu_torch.odometry.pipeline import FrameFeatures


class KeyframeStore(NamedTuple):
    poses: torch.Tensor  # (Mk, 4, 4)
    keypoints: torch.Tensor  # (Mk, K, 3) sensor frame
    descriptors: torch.Tensor  # (Mk, K, 11) int32 (uint32 bits)
    kp_mask: torch.Tensor  # (Mk, K)
    frame_idx: torch.Tensor  # (Mk,) source frame number
    obs_lm: torch.Tensor  # (Mk, K) int32 map-landmark index, -1 if none
    count: torch.Tensor  # () int32


def init_keyframes(cfg: SlamConfig, device=None) -> KeyframeStore:
    """An empty store; `device=None` means the card (raises without one)."""
    dev = resolve_device(device)
    Mk, K = cfg.backend.max_keyframes, cfg.keypoints.top_k
    return KeyframeStore(
        poses=torch.eye(4, dtype=torch.float32, device=dev).repeat(Mk, 1, 1),
        keypoints=torch.zeros((Mk, K, 3), dtype=torch.float32, device=dev),
        descriptors=torch.zeros((Mk, K, cfg.descriptor.n_words),
                                dtype=torch.int32, device=dev),
        kp_mask=torch.zeros((Mk, K), dtype=torch.bool, device=dev),
        frame_idx=torch.full((Mk,), -1, dtype=torch.int32, device=dev),
        obs_lm=torch.full((Mk, K), -1, dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
    )


def add_keyframe(store: KeyframeStore, pose: torch.Tensor,
                 feats: FrameFeatures, frame_idx, obs_lm: torch.Tensor
                 ) -> KeyframeStore:
    """Append one keyframe.  A full store drops the append (count pinned at
    Mk): callers that must not lose material evict a redundant keyframe
    first (`pick_eviction_slot` + `evict_keyframe`).  The slot is chosen on
    the device: no host sync."""
    Mk = store.poses.shape[0]
    dev = store.poses.device
    slot = torch.clamp(store.count, max=Mk).reshape(1).long()  # Mk: dropped
    fidx = (frame_idx.to(dev) if isinstance(frame_idx, torch.Tensor)
            else torch.full((), int(frame_idx), device=dev))

    def put(x, row):
        ext = torch.cat([x, x[:1]], dim=0)
        return ext.index_copy(0, slot, row.to(x.dtype)[None])[:Mk]

    return KeyframeStore(
        poses=put(store.poses, pose),
        keypoints=put(store.keypoints, feats.keypoints),
        descriptors=put(store.descriptors, feats.descriptors),
        kp_mask=put(store.kp_mask, feats.mask),
        frame_idx=put(store.frame_idx, fidx),
        obs_lm=put(store.obs_lm, obs_lm),
        count=torch.clamp(store.count + 1, max=Mk).to(torch.int32),
    )


def evict_keyframe(store: KeyframeStore, slot) -> KeyframeStore:
    """Remove the keyframe at `slot`, shifting later rows left (temporal
    order, which the pose graph's chain edges and the correction
    interpolator rely on, is kept)."""
    Mk = store.poses.shape[0]
    dev = store.poses.device
    iota = torch.arange(Mk, device=dev)
    idx = torch.where(iota >= slot, torch.clamp(iota + 1, max=Mk - 1), iota)
    return KeyframeStore(*[x[idx] for x in store[:-1]],
                         count=(store.count - 1).to(torch.int32))


def pick_eviction_slot(positions: np.ndarray, count: int) -> int:
    """Host-side choice of the keyframe to evict at saturation: the one whose
    removal leaves the smallest gap between its temporal neighbours.  Slot
    0 (the anchor) and the most recent quarter are protected, so a store of
    fewer than 3 keyframes has no candidate: that raises ValueError (the
    reference returns slot 1, past the end of a one-keyframe store and the
    protected newest of a two-keyframe one)."""
    protect = max(1, count // 4)
    lo, hi = 1, count - protect  # candidate slots in [lo, hi)
    if hi <= lo:
        raise ValueError(f"no keyframe may be evicted from a store of {count}: "
                         "the anchor and the newest quarter are protected")
    p = positions[:count]
    gaps = np.linalg.norm(p[lo + 1:hi + 1] - p[lo - 1:hi - 1], axis=-1)
    return lo + int(np.argmin(gaps))


def should_add_keyframe(last_kf_pose: np.ndarray, pose: np.ndarray,
                        frames_since: int, cfg: BackendConfig) -> bool:
    """Host-side keyframe decision."""
    if frames_since >= cfg.keyframe_every:
        return True
    delta = np.linalg.inv(last_kf_pose) @ pose
    t = np.linalg.norm(delta[:3, 3])
    c = np.clip((np.trace(delta[:3, :3]) - 1) / 2, -1, 1)
    heading = np.degrees(np.arccos(c))
    return bool(t > cfg.keyframe_min_translation_mm
                or heading > cfg.keyframe_min_heading_deg)
