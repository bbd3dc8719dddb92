"""Odometry state and keyframe store to and from plain numpy arrays.

The system has no learned weights: its state is the map, the previous
frame's features and the backend's keyframe store.  `state_to_numpy` /
`state_from_numpy` and `keyframes_to_numpy` / `keyframes_from_numpy` carry
them across as dicts of numpy arrays, with the reference package's field
names and types (descriptors as uint32), so a state built by either
package can start the other.
"""

from __future__ import annotations

import numpy as np
import torch

from bshot_slam_tpu_torch.backend.keyframes import KeyframeStore
from bshot_slam_tpu_torch.device import resolve_device
from bshot_slam_tpu_torch.odometry.mapstore import MapState
from bshot_slam_tpu_torch.odometry.pipeline import FrameFeatures, OdometryState

MAP_FIELDS = MapState._fields  # positions, descriptors, ..., n_dropped
REF_FIELDS = FrameFeatures._fields  # keypoints, scores, descriptors, mask
_DTYPES = {
    "positions": np.float32, "descriptors": np.uint32, "seg_ratios": np.float32,
    "blocks": np.int32, "valid": np.bool_, "cursor": np.int32,
    "frame_born": np.int32, "n_dropped": np.int32, "keypoints": np.float32,
    "scores": np.float32, "mask": np.bool_, "ref_pose": np.float32,
    "frame_idx": np.int32, "poses": np.float32, "kp_mask": np.bool_,
    "obs_lm": np.int32, "count": np.int32,
}
KEYFRAME_FIELDS = KeyframeStore._fields  # poses, keypoints, ..., count


def _to_torch(name: str, x, device) -> torch.Tensor:
    a = np.array(x, dtype=_DTYPES[name], order="C")
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.as_tensor(a, device=device)


def _to_numpy(name: str, t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name == "descriptors" else a


def state_from_numpy(d: dict, device=None) -> OdometryState:
    """Build the port's OdometryState from a dict with keys
    `map.<field>` for every MapState field, `ref.<field>` for every
    FrameFeatures field, `ref_pose` and `frame_idx`.  `device=None` means
    the card (raises without one)."""
    device = resolve_device(device)
    return OdometryState(
        map=MapState(*[_to_torch(f, d[f"map.{f}"], device) for f in MAP_FIELDS]),
        ref=FrameFeatures(*[_to_torch(f, d[f"ref.{f}"], device)
                            for f in REF_FIELDS]),
        ref_pose=_to_torch("ref_pose", d["ref_pose"], device),
        frame_idx=_to_torch("frame_idx", d["frame_idx"], device),
    )


def state_to_numpy(state: OdometryState) -> dict:
    """The reverse of `state_from_numpy`."""
    out = {f"map.{f}": _to_numpy(f, getattr(state.map, f)) for f in MAP_FIELDS}
    out.update({f"ref.{f}": _to_numpy(f, getattr(state.ref, f))
                for f in REF_FIELDS})
    out["ref_pose"] = _to_numpy("ref_pose", state.ref_pose)
    out["frame_idx"] = _to_numpy("frame_idx", state.frame_idx)
    return out


def keyframes_from_numpy(d: dict, device=None) -> KeyframeStore:
    """The port's KeyframeStore from a dict with one key per field
    (`poses`, `keypoints`, `descriptors`, `kp_mask`, `frame_idx`, `obs_lm`,
    `count`).  `device=None` means the card (raises without one)."""
    device = resolve_device(device)
    return KeyframeStore(*[_to_torch(f, d[f], device) for f in KEYFRAME_FIELDS])


def keyframes_to_numpy(store: KeyframeStore) -> dict:
    """The reverse of `keyframes_from_numpy`."""
    return {f: _to_numpy(f, getattr(store, f)) for f in KEYFRAME_FIELDS}
