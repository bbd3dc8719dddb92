"""Multi-process execution: the sharded SLAM step over ranks on many hosts.

Port of `bshot_slam_tpu.parallel.multihost` on `torch.distributed`: one
process per rank joins a process group (`initialize`), a
("hosts", "devices") `DeviceMesh` puts each host's ranks in a row
(`host_mesh`), and the same sharded step as `parallel.sharded` runs with
the map's rows split across hosts and each host's query rows across its
ranks (`multihost_odometry_step`).  `make_global` places identical host
arrays on the ranks.

What crosses the network per frame (the reference's cost model, default
config, K = 600 keypoints): the mutual-NN key minimum and the owners' rows
of the matched candidates (~K * 24 B), each ICP iteration's key minimum and
rows (~K * 20 B, 10 iterations), the dedup flags (~K * 4 B) and the map
size, about 140 KB in all; the query-row gather of the data axis stays
inside a host.

`spawn_local` runs a function on N local ranks (spawned processes) for the
tools, the tests and the smoke run.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import socket
import traceback
from typing import Callable, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bshot_slam_tpu_torch.config import SlamConfig
from bshot_slam_tpu_torch.odometry import mapstore
from bshot_slam_tpu_torch.parallel import comm, layout, sharded
from bshot_slam_tpu_torch.parallel.comm import Axis

HOST_AXES: Tuple[str, str] = ("hosts", "devices")


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: str | None = None, device=None) -> torch.device:
    """Join the process group as rank `process_id` of `num_processes`;
    `coordinator_address` is rank 0's "host:port".  Returns this rank's
    device.

    `device=None` means a card when one is visible (the card of local rank
    `LOCAL_RANK`, default `process_id`, modulo the cards), else the CPU.
    `backend=None` picks "nccl" when every local rank (`LOCAL_WORLD_SIZE`,
    default `num_processes`) has a card of its own and "gloo" on the CPU,
    and raises when ranks would share a card: NCCL refuses that, and the
    caller must name "gloo" for it."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        if device.type != "cuda":
            backend = "gloo"
        elif local <= torch.cuda.device_count():
            backend = "nccl"
        else:
            raise ValueError(
                f"{local} local ranks would share {torch.cuda.device_count()} "
                "card(s), which NCCL refuses: name backend='gloo'")
    address = coordinator_address.removeprefix("tcp://")
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=num_processes, rank=process_id)
    comm.set_rank_device(device)
    return device


def host_mesh(axes: Tuple[str, str] = HOST_AXES, ranks_per_host: int | None = None):
    """("hosts", "devices") mesh: a row per host holding its ranks (one
    process each).  `ranks_per_host` defaults to `LOCAL_WORLD_SIZE`, else 1
    (every process a host of its own)."""
    from torch.distributed.device_mesh import init_device_mesh

    per = ranks_per_host or int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    n = dist.get_world_size()
    if n % per:
        raise ValueError(f"{n} ranks do not fill hosts of {per}")
    return init_device_mesh(comm.rank_device().type, (n // per, per),
                            mesh_dim_names=tuple(axes))


def multihost_odometry_step(mesh, cfg: SlamConfig, tile: int = 2048):
    """The sharded odometry step with map rows across HOSTS and query rows
    across each host's ranks: the same program as the single-host mesh,
    another axis mapping (a CUDA graph on NCCL: `step.graphs`)."""
    return sharded.sharded_odometry_step(mesh, cfg, tile, data_axis="devices",
                                         map_axis="hosts")


def make_global(mesh, spec_tree, host_tree, device=None):
    """This rank's part of identical host arrays (numpy or tensors), placed
    by a spec tree of the same shape (`sharded.state_shardings`, or a
    single spec): a leaf whose spec names a mesh dimension keeps its rows
    r::R along it, a leaf whose spec is None is replicated.  A map with
    split rows comes back a `mapstore.MapShard`."""
    dev = comm.rank_device() if device is None else torch.device(device)

    def walk(spec, host):
        if isinstance(host, tuple) and hasattr(host, "_fields"):
            parts = [walk(s, h) for s, h in zip(spec, host)]
            if isinstance(host, mapstore.MapState) and any(
                    s is not None for s in spec):
                return mapstore.MapShard(*parts)
            return type(host)(*parts)
        t = host if isinstance(host, torch.Tensor) else torch.from_numpy(
            np.array(host))
        if spec is not None:
            t = layout.keep_rows(t, Axis.of(mesh, spec))
        return t.to(dev)

    return walk(spec_tree, host_tree)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, port, backend, device, args, results) -> None:
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        initialize(f"localhost:{port}", n, rank, backend=backend, device=device)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn_local(fn: Callable, n: int, args=(), backend: str | None = None,
                device="cuda", timeout: float = 600.0) -> list:
    """Run `fn(rank, *args)` on n ranks of one process group, each a
    spawned process on this host (a card each, `cuda:rank % cards`, with
    device "cuda"; the CPU with one thread each, with "cpu"), and return
    their results in rank order.  `fn` and its arguments and result must
    pickle.  Raises with the failing rank's traceback if one fails, and
    when they do not all finish within `timeout` seconds (the processes are
    then killed)."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, port, backend, device, args, results))
             for r in range(n)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(n):
            rank, ok, out = results.get(timeout=timeout)
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=60)
    except queue.Empty:
        raise RuntimeError(f"{n - len(got)} of {n} ranks did not finish in "
                           f"{timeout:.0f} s") from None
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(n)]
