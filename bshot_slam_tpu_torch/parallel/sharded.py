"""Multi-device execution of the SLAM step on `torch.distributed`.

Port of `bshot_slam_tpu.parallel.sharded`, written the PyTorch way: one
process per rank, a process group, and a `DeviceMesh` with named
dimensions.  Where the reference lets GSPMD insert collectives, the port
calls them itself (`parallel.comm`), and every combine is exact, so a
sharded step gives the single-device step's results bit for bit
(`parallel.layout` says how).  The two axes:

  * ``data`` splits a cloud's query rows: kernels A and B sweep this rank's
    TILE-aligned range of queries against the whole (replicated) cloud, and
    one all-gather assembles the per-row sums; scores, normals, top-k and
    descriptors then run alike on every rank.
  * ``map`` splits the map's rows cyclically (global row g on rank g % R, at
    local row g // R): kernels C, D and E run on this rank's rows, and the
    nearest-neighbour minima, the mutual test and the dedup flags combine
    over the axis.  The cursor, the drop count and the previous frame stay
    replicated; every map capacity must be a multiple of R.

Every rank runs the same host program on the same inputs (SPMD), including
its RANSAC draws from identically seeded generators.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from bshot_slam_tpu_torch.backend.ba import ba_solve
from bshot_slam_tpu_torch.config import SlamConfig
from bshot_slam_tpu_torch.odometry import mapstore, pipeline
from bshot_slam_tpu_torch.odometry.pipeline import FrameFeatures, OdometryState
from bshot_slam_tpu_torch.parallel import comm
from bshot_slam_tpu_torch.parallel.comm import Axis
from bshot_slam_tpu_torch.parallel.layout import local_live_rows  # noqa: F401


class MeshAxes(NamedTuple):
    """The two axes a sharded step runs over."""

    data: Axis
    map: Axis


def make_mesh(ranks: Optional[int] = None,
              axes: Tuple[str, str] = ("data", "map"), device_type=None):
    """2D `DeviceMesh` over the process group's ranks; their number is
    factored as evenly as possible between the two axes, the smaller factor
    first (2 -> (1, 2), 4 -> (2, 2), 8 -> (2, 4)), as the reference does.

    The process group must be up (`multihost.initialize`) and the mesh must
    span it.  Use power-of-two rank counts: map capacities and cloud
    buckets are powers of two times 512, which every such count divides.
    `device_type` defaults to the type of this rank's device
    (`comm.rank_device`)."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if ranks is None else int(ranks)
    if n != dist.get_world_size():
        raise ValueError(f"the mesh must span the process group: {n} ranks "
                         f"asked, {dist.get_world_size()} joined")
    d_data = next(f for f in range(math.isqrt(n), 0, -1) if n % f == 0)
    if device_type is None:
        device_type = comm.rank_device().type
    return init_device_mesh(device_type, (d_data, n // d_data),
                            mesh_dim_names=tuple(axes))


def mesh_axes(mesh, data_axis: str = "data", map_axis: str = "map") -> MeshAxes:
    return MeshAxes(Axis.of(mesh, data_axis), Axis.of(mesh, map_axis))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)



def state_shardings(mesh, map_axis: str = "map") -> OdometryState:
    """Which fields of an OdometryState are split: the name of the mesh
    dimension whose ranks hold its rows cyclically, or None (replicated).
    The map's row arrays are split along `map_axis` ("map" on one host,
    "hosts" on a process-spanning mesh); everything else is replicated."""
    if map_axis not in mesh.mesh_dim_names:
        raise ValueError(f"no {map_axis!r} in the mesh {mesh.mesh_dim_names}")
    rows = {f: map_axis for f in mapstore.ROW_FIELDS}
    return OdometryState(
        map=mapstore.MapState(*[rows.get(f) for f in mapstore.MapState._fields]),
        ref=FrameFeatures(None, None, None, None),
        ref_pose=None, frame_idx=None,
    )


def shard_state(state: OdometryState, mesh, map_axis: str = "map",
                device=None) -> OdometryState:
    """A whole OdometryState (every rank passes the same) placed on this
    rank: its map rows along `map_axis` (a `MapShard`), the rest replicated,
    on the rank's device.  A state already placed is returned as it is."""
    if isinstance(state.map, mapstore.MapShard):
        return state
    dev = mesh_device(mesh) if device is None else torch.device(device)
    return OdometryState(
        map=mapstore.shard_map(state.map, Axis.of(mesh, map_axis), dev),
        ref=FrameFeatures(*[x.to(dev) for x in state.ref]),
        ref_pose=state.ref_pose.to(dev), frame_idx=state.frame_idx.to(dev),
    )


def gather_state(state: OdometryState, mesh, map_axis: str = "map") -> OdometryState:
    """The whole state on every rank (a collective over `map_axis`)."""
    if not isinstance(state.map, mapstore.MapShard):
        return state
    return state._replace(map=mapstore.gather_map(state.map,
                                                  Axis.of(mesh, map_axis)))


def mesh_runtime_overrides(cfg: SlamConfig, n_data: int) -> SlamConfig:
    """The reference's config overrides for mesh execution: window
    compaction off (a sharded map is scanned densely, each rank its own
    rows) and `topk_chunks` a multiple of the data ranks (the port's top-k
    is one exact stage, on which it has no effect)."""
    chunks = n_data * max(1, 8 // n_data)
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, window_compact=False, topk_chunks=chunks))


def sharded_odometry_step(mesh, cfg: SlamConfig, tile: int = 2048,
                          data_axis: str = "data", map_axis: str = "map"
                          ) -> Tuple[Callable, Callable]:
    """Returns (step, shard_state).

    step(state, points, pmask, rng) is `pipeline.odometry_step` over the
    mesh, with `mesh_runtime_overrides`; every rank calls it with the same
    whole cloud and rng.  shard_state places a whole OdometryState on this
    rank.  On a multi-host mesh pass data_axis="devices",
    map_axis="hosts"."""
    axes = mesh_axes(mesh, data_axis, map_axis)
    cfg = mesh_runtime_overrides(cfg, axes.data.size)

    def step(state, points, pmask, rng):
        return pipeline.odometry_step(state, points, pmask, rng, cfg, tile,
                                      axes=axes)

    def place(state):
        return shard_state(state, mesh, map_axis)

    return step, place


def sharded_ba_solve(mesh, prob, gn_iterations: int = 5, cg_iterations: int = 20):
    """Bundle adjustment with the observations split over every rank of the
    mesh: they are zero-mask padded to a multiple of the rank count, each
    rank takes its contiguous block, each per-observation sum is taken
    locally and then one all-reduce SUM over the ranks; poses and landmarks
    stay replicated.  The sums add in another order than on one device, so
    the result agrees with `ba_solve` to rounding, not bit for bit."""
    axis = Axis.world()
    n = axis.size
    if mesh.mesh.numel() != n:
        raise ValueError("the mesh must span the process group")
    O = prob.obs_kf.shape[0]
    per = -(-O // n)
    pad = per * n - O

    def cut(x):
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x[axis.rank * per:(axis.rank + 1) * per]

    local = prob._replace(obs_kf=cut(prob.obs_kf), obs_lm=cut(prob.obs_lm),
                          obs_p=cut(prob.obs_p), obs_mask=cut(prob.obs_mask))

    def total(x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(x, comm.SUM, axis, "BA: sums")

    return ba_solve(local, gn_iterations=gn_iterations,
                    cg_iterations=cg_iterations, reduce=total)
