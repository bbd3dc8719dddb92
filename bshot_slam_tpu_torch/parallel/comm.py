"""The port's one gateway to `torch.distributed`: mesh axes and collectives.

Every collective of the sharded program goes through `all_reduce`,
`all_gather` or `broadcast` here, on one `Axis` (a dimension of a
`DeviceMesh`, or every rank).  Each call is counted under its call site:
calls, the payload bytes this rank puts in, and the host synchronisations
it cost (`counts()`, `reset_counts()`), which `chip_smoke.py` and
`tools/collective_cost.py` report.

Backends.  With NCCL the CUDA tensors go straight to the collective, which
runs on NCCL's stream behind the current one: no host sync.  With gloo on
CPU tensors the same.  With gloo on CUDA tensors (several ranks sharing one
card, where NCCL refuses the duplicate GPU) each call stages through pinned
host memory: a device-to-host copy that waits for the device (one sync,
counted), the collective on the host copy, and an asynchronous copy back.

The odometry step's collectives are exact: integer reductions, and
gathers that move bits.  A float gather is never built as a SUM of
zero-padded buffers (-0.0 + 0.0 is +0.0).  The one float reduction is the
sharded bundle adjustment's SUM of its normal equations.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.distributed as dist

MIN, MAX, SUM = "min", "max", "sum"

# The device this process computes on, as `multihost.initialize` chose it.
_RANK_DEVICE: list = []


def set_rank_device(device: torch.device) -> None:
    _RANK_DEVICE[:] = [torch.device(device)]


def rank_device() -> torch.device:
    """This rank's device: the one `multihost.initialize` set, else the
    current card, else the CPU."""
    if _RANK_DEVICE:
        return _RANK_DEVICE[0]
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class Axis:
    """One dimension of a mesh as the collectives see it: the process group
    of this rank's peers along it, their number and this rank's index."""

    def __init__(self, name: str, group=None):
        self.name = name
        self.group = group if group is not None else dist.group.WORLD
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.backend = dist.get_backend(self.group)

    @classmethod
    def of(cls, mesh, name: str) -> "Axis":
        """The dimension `name` of a `DeviceMesh`."""
        return cls(name, mesh.get_group(name))

    @classmethod
    def world(cls) -> "Axis":
        """Every rank of the default process group."""
        return cls("world")

    def __repr__(self) -> str:
        return (f"Axis({self.name!r}, rank {self.rank} of {self.size}, "
                f"{self.backend})")


# site -> [calls, payload bytes this rank put in, host syncs for staging]
_COUNTS: Dict[str, List[int]] = {}


def reset_counts() -> None:
    _COUNTS.clear()


def counts() -> Dict[str, dict]:
    """{site: {"calls", "bytes", "syncs"}} since the last reset."""
    return {k: dict(calls=v[0], bytes=v[1], syncs=v[2]) for k, v in _COUNTS.items()}


def _count(site: str, t: torch.Tensor, staged: bool) -> None:
    c = _COUNTS.setdefault(site, [0, 0, 0])
    c[0] += 1
    c[1] += t.numel() * t.element_size()
    c[2] += int(staged)


def _staged(t: torch.Tensor, axis: Axis) -> bool:
    return t.is_cuda and axis.backend == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)  # waits for the device: the staging sync
    return h


def _back(h: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A staged result back on the card, without waiting (the pinned
    buffer's allocator keeps it until the copy has run)."""
    return h.to(device, non_blocking=True)


_REDUCE = {MIN: dist.ReduceOp.MIN, MAX: dist.ReduceOp.MAX, SUM: dist.ReduceOp.SUM}


def all_reduce(t: torch.Tensor, op: str, axis: Axis, site: str) -> torch.Tensor:
    """The elementwise MIN, MAX or SUM of `t` over the axis (a new
    tensor)."""
    staged = _staged(t, axis)
    _count(site, t, staged)
    out = _to_host(t) if staged else t.clone()
    dist.all_reduce(out, op=_REDUCE[op], group=axis.group)
    return _back(out, t.device) if staged else out


def all_gather(t: torch.Tensor, axis: Axis, site: str) -> torch.Tensor:
    """Every rank's `t` along the axis, concatenated on dim 0 in rank order
    (the bits as each rank holds them)."""
    staged = _staged(t, axis)
    _count(site, t, staged)
    src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    if staged:
        src = _to_host(src)
    if src.is_cuda:
        out = src.new_empty((axis.size * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=axis.group)
    else:
        parts = [torch.empty_like(src) for _ in range(axis.size)]
        dist.all_gather(parts, src, group=axis.group)
        out = torch.cat(parts)
    out = _back(out, t.device) if staged else out.to(t.device)
    return out.to(torch.bool) if t.dtype == torch.bool else out


def broadcast(t: torch.Tensor, src: int, axis: Axis, site: str) -> torch.Tensor:
    """Rank `src` (its index along the axis)'s `t` on every rank."""
    staged = _staged(t, axis)
    _count(site, t, staged)
    out = _to_host(t) if staged else t.clone()
    dist.broadcast(out, src=dist.get_global_rank(axis.group, src), group=axis.group)
    return _back(out, t.device) if staged else out


def is_writer() -> bool:
    """Whether this process writes shared outputs: rank 0 of the process
    group, or a process outside any group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def writer_done(site: str) -> None:
    """On a process group, hold every rank until rank 0 has written what it
    writes (an all-reduce of one int, counted under `site`)."""
    if dist.is_initialized():
        all_reduce(torch.zeros((1,), dtype=torch.int32, device=rank_device()),
                   SUM, Axis.world(), site)
