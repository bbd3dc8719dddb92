"""Where rows live on a mesh, and the exact combines of per-rank results.

Map rows are laid out cyclically along the map axis: global row `g` lives
on rank `g % R`, at local row `g // R`.  The map grows by padding each
shard, so growth moves no row between ranks, and the live rows [0, cursor)
split evenly: rank r holds the live local rows [0, ceil((cursor - r) / R)).
A candidate set on a rank is its local map rows followed by a tail of rows
every rank holds (the previous frame's keypoints): local index j < t maps to
global j * R + r, and t + k to R * t + k, which is the single-device index.

Clouds are replicated; the data axis splits a cloud's query rows into
ranges aligned to `kernels.neighborhood.PLAIN_ROWS` (a multiple of the
kernels' TILE, and the plain versions' block), one per rank (`data_rows`),
and `gather_query_rows` puts the per-row results back together.

Every combine is exact, so the sharded program gives the single-device
program's bits: nearest-neighbour minima are one MIN of packed int64 keys
(the distance's float bits, non-negative, above the global index: the
smallest distance wins, ties to the lowest global index, as the
single-device argmin), and a row's values come from its owner by a SUM of
int32 bit patterns in which every other rank puts 0.
"""

from __future__ import annotations

import torch

from bshot_slam_tpu_torch.kernels.neighborhood import PLAIN_ROWS
from bshot_slam_tpu_torch.parallel import comm
from bshot_slam_tpu_torch.parallel.comm import Axis


def local_capacity(capacity: int, axis: Axis) -> int:
    if capacity % axis.size:
        raise ValueError(f"map capacity {capacity} is not a multiple of the "
                         f"{axis.size} ranks of the {axis.name!r} axis")
    return capacity // axis.size


def local_live_rows(cursor: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's live local rows, ceil((cursor - r) / R), as a 0-d int32
    tensor made on the device from the replicated cursor (no host sync)."""
    return torch.clamp(
        torch.div(cursor - axis.rank + axis.size - 1, axis.size,
                  rounding_mode="floor"), min=0).to(torch.int32)


def global_index(local: torch.Tensor, tail_start: int, axis: Axis) -> torch.Tensor:
    """Local candidate indices (map rows, then the tail from `tail_start`)
    as global ones (int64)."""
    local = local.long()
    return torch.where(local < tail_start, local * axis.size + axis.rank,
                       tail_start * axis.size + (local - tail_start))


def argmin_combine(dist: torch.Tensor, index: torch.Tensor, axis: Axis,
                   site: str):
    """Per row, the smallest of the ranks' (distance >= 0, global index)
    pairs, ties to the lowest index: one MIN of packed keys."""
    bits = (dist + 0.0).view(torch.int32).long()  # + 0.0: -0.0 becomes +0.0
    key = comm.all_reduce((bits << 32) | index, comm.MIN, axis, site)
    dmin = (key >> 32).to(torch.int32).view(torch.float32)
    return dmin, key & 0xFFFFFFFF


def owner(index: torch.Tensor, tail_start: int, axis: Axis):
    """(whether this rank owns global map row `index` (tail rows: no),
    its local row, 0 where not owned)."""
    mine = (index < tail_start * axis.size) & (index % axis.size == axis.rank)
    return mine, torch.where(mine, index // axis.size, 0)


def sum_from_owners(values: torch.Tensor, mine: torch.Tensor, axis: Axis,
                    site: str) -> torch.Tensor:
    """(K, W) int32 rows that one rank owns each: the owner's values on
    every rank (the others put 0)."""
    return comm.all_reduce(torch.where(mine[:, None], values, 0), comm.SUM, axis,
                           site)


def fetch_rows(index: torch.Tensor, table: torch.Tensor, tail_start: int,
               axis: Axis, site: str) -> torch.Tensor:
    """Rows `table[index]` of the global candidate set, `table` (t + K, W)
    float32 being this rank's local candidates (map rows, then the tail)."""
    mine, local = owner(index, tail_start, axis)
    got = sum_from_owners(table[local].view(torch.int32), mine, axis, site)
    tail = index >= tail_start * axis.size
    t = torch.clamp(index - tail_start * axis.size + tail_start, tail_start,
                    table.shape[0] - 1)
    return torch.where(tail[:, None], table[t], got.view(torch.float32))


def gather_rows(x: torch.Tensor, axis: Axis, site: str) -> torch.Tensor:
    """The whole (R * c, ...) array from each rank's (c, ...) cyclic shard."""
    full = comm.all_gather(x, axis, site)
    c = x.shape[0]
    return full.reshape((axis.size, c) + tuple(x.shape[1:])).transpose(0, 1) \
        .reshape((axis.size * c,) + tuple(x.shape[1:])).contiguous()


def keep_rows(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's cyclic shard, rows r::R, of a whole array."""
    return x[axis.rank::axis.size].contiguous()


def data_rows(n: int, axis: Axis | None):
    """This rank's query rows (q0, q1) of an n-row cloud, and the padded
    length of every rank's range: ranges of whole PLAIN_ROWS blocks, in
    rank order."""
    if axis is None:
        return (0, n), n
    per = -(-n // (PLAIN_ROWS * axis.size)) * PLAIN_ROWS
    q0 = min(axis.rank * per, n)
    return (q0, min(q0 + per, n)), per


def gather_query_rows(x: torch.Tensor, n: int, per: int, axis: Axis,
                      site: str) -> torch.Tensor:
    """(n, ...) from each rank's results for its `data_rows` range."""
    pad = per - x.shape[0]
    if pad:
        x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
    return comm.all_gather(x, axis, site)[:n]
