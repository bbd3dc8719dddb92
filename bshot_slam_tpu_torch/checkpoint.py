"""Checkpoint / resume of full SLAM state.

Port of `bshot_slam_tpu.checkpoint`, in its file formats: the odometry
state (map arrays, previous-frame features, pose, frame index) and the pose
history go to `<path>/slam_state.npz` (format 2; format 1 files, without
`map_frame_born` / `map_n_dropped`, load with frame_born -1 and n_dropped
0), the backend (keyframe store, verified loop edges, keyframe-policy
counters, the engine's random state) to `<path>/backend_state.npz`.  Field
names, dtypes (descriptors as uint32) and versions are the reference's, so
each package reads the other's files.

The random state differs: the reference keeps a JAX PRNG key, which cannot
drive a `torch.Generator`.  The port's backend file adds the generator's
state (`torch_rng_state`, with `torch_rng_device`, the device type it
belongs to) and still writes `rng_key` as `[0, seed]` (uint32), which is
what `jax.random.PRNGKey(seed)` holds: the reference loading a port file
restarts its stream from the engine's seed.  A file the reference wrote has
no generator state; loading it leaves the port's generator as seeded.

On a mesh (`mesh=`), `save_state` gathers the sharded map (a collective:
every rank calls it) and rank 0 writes the file in the same format, and
`load_state` places the map's rows on the ranks; `save_backend` writes from
rank 0 (the backend is every rank's alike).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from bshot_slam_tpu_torch import convert
from bshot_slam_tpu_torch.odometry.mapstore import MapShard
from bshot_slam_tpu_torch.odometry.pipeline import OdometryState
from bshot_slam_tpu_torch.parallel import comm

# v2 adds map_frame_born / map_n_dropped (MapState provenance + saturation
# fields); v1 checkpoints load with frame_born=-1, n_dropped=0 defaults.
_FORMAT_VERSION = 2
_BACKEND_VERSION = 1
# convert's dict keys; the file's names put "_" for "." (map_positions, ...).
_STATE_KEYS = ([f"map.{f}" for f in convert.MAP_FIELDS]
               + [f"ref.{f}" for f in convert.REF_FIELDS] + ["ref_pose", "frame_idx"])


def save_state(path: str, state: OdometryState, poses: np.ndarray,
               mesh=None, map_axis: str = "map") -> None:
    """Write state + (n, 4, 4) pose history to `path`/slam_state.npz; a
    sharded state needs its `mesh` (and `map_axis`)."""
    if isinstance(state.map, MapShard):
        if mesh is None:
            raise ValueError("a sharded state is saved with its mesh")
        from bshot_slam_tpu_torch.parallel import sharded

        state = sharded.gather_state(state, mesh, map_axis)
    if comm.is_writer():
        os.makedirs(path, exist_ok=True)
        d = convert.state_to_numpy(state)
        np.savez_compressed(
            os.path.join(path, "slam_state.npz"),
            version=_FORMAT_VERSION,
            **{k.replace(".", "_"): v for k, v in d.items()},
            poses=np.asarray(poses),
        )
    comm.writer_done("checkpoint written")


def load_state(path: str, device=None, mesh=None,
               map_axis: str = "map") -> Tuple[OdometryState, np.ndarray]:
    """Read back (OdometryState, poses); `device=None` means the card (with
    `mesh`: the rank's device, the map's rows placed along `map_axis`).
    Raises on a version it does not know."""
    if mesh is not None:
        from bshot_slam_tpu_torch.parallel import sharded

        state, poses = load_state(path, device="cpu")
        return sharded.shard_state(state, mesh, map_axis, device), poses
    with np.load(os.path.join(path, "slam_state.npz")) as z:
        version = int(z["version"])
        if version not in (1, 2):
            raise ValueError(f"unsupported checkpoint version {version}")
        d = {k: z[k.replace(".", "_")] for k in _STATE_KEYS
             if k.replace(".", "_") in z}
        if version == 1:
            C = z["map_positions"].shape[0]
            d["map.frame_born"] = np.full((C,), -1, np.int32)
            d["map.n_dropped"] = np.zeros((), np.int32)
        return convert.state_from_numpy(d, device=device), z["poses"]


def save_backend(path: str, engine) -> None:
    """Persist a SlamEngine's KeyframeStore, verified loop edges,
    keyframe-policy counters and random state to `path`/backend_state.npz
    (on a process group, rank 0 writes)."""
    if comm.is_writer():
        _write_backend(path, engine)
    comm.writer_done("checkpoint written")


def _write_backend(path: str, engine) -> None:
    os.makedirs(path, exist_ok=True)
    kf = convert.keyframes_to_numpy(engine.keyframes)
    edges = getattr(engine, "loop_edges", [])
    np.savez_compressed(
        os.path.join(path, "backend_state.npz"),
        version=_BACKEND_VERSION,
        **{f"kf_{k}": v for k, v in kf.items()},
        edge_i=np.asarray([e.kf_i for e in edges], np.int32),
        edge_j=np.asarray([e.kf_j for e in edges], np.int32),
        edge_z=(
            np.stack([e.z for e in edges]).astype(np.float32)
            if edges else np.zeros((0, 4, 4), np.float32)
        ),
        edge_inliers=np.asarray([e.n_inliers for e in edges], np.int32),
        edge_rmse=np.asarray([e.rmse_mm for e in edges], np.float32),
        last_kf_pose=np.asarray(engine._last_kf_pose, np.float32),
        frames_since_kf=np.asarray(
            min(engine._frames_since_kf, 2**31 - 1), np.int32
        ),
        rng_key=np.asarray([0, engine.seed], np.uint32),
        torch_rng_state=engine.generator.get_state().numpy(),
        torch_rng_device=np.asarray(engine.generator.device.type),
    )


def load_backend(path: str, engine) -> bool:
    """Restore the backend state saved by `save_backend` (by either package)
    into `engine`, re-seeding its host mirrors (keyframe count and
    positions, the pipelined cursor bound).  Returns False (engine
    untouched) when no backend file exists."""
    from bshot_slam_tpu_torch.backend.loop_closure import LoopEdge

    fn = os.path.join(path, "backend_state.npz")
    if not os.path.exists(fn):
        return False
    with np.load(fn) as z:
        if int(z["version"]) != _BACKEND_VERSION:
            raise ValueError(
                f"unsupported backend checkpoint version {z['version']}"
            )
        if "torch_rng_state" in z:
            saved_on = str(z["torch_rng_device"])
            if saved_on != engine.generator.device.type:
                raise ValueError(f"the random state was saved by a {saved_on} "
                                 f"engine; this one runs on "
                                 f"{engine.generator.device.type}")
            engine.generator.set_state(torch.from_numpy(z["torch_rng_state"]))
        engine.keyframes = convert.keyframes_from_numpy(
            {k: z[f"kf_{k}"] for k in convert.KEYFRAME_FIELDS},
            device=engine.device)
        engine.loop_edges = [
            LoopEdge(
                kf_i=int(z["edge_i"][k]),
                kf_j=int(z["edge_j"][k]),
                z=z["edge_z"][k],
                n_inliers=int(z["edge_inliers"][k]),
                rmse_mm=float(z["edge_rmse"][k]),
            )
            for k in range(len(z["edge_i"]))
        ]
        engine.optimized_keyframe_poses = None  # they paired with the old rows
        engine._last_kf_pose = z["last_kf_pose"]
        engine._frames_since_kf = int(z["frames_since_kf"])
        engine._kf_count = int(z["kf_count"])
        engine._kf_positions = list(
            z["kf_poses"][: engine._kf_count, :3, 3].astype(np.float32)
        )
    engine._place_state()
    return True
