"""Device-resident global keypoint map with voxel-block dedup.

Port of `bshot_slam_tpu.odometry.mapstore`.  Fixed-capacity tensors with a
valid mask and an append cursor: valid rows are exactly [0, cursor).  A new
keypoint is rejected when an existing same-block keypoint lies within the
dedup radius and has a seg_ratio >= its own (kernel E against the map, a
lower-triangular test within the batch), then survivors are appended.  At
the hard capacity `evict_keypoints` drops the weakest keypoints of the
densest blocks and front-compacts the survivors.

On a mesh the map is a `MapShard`: this rank's rows of the map, laid out
cyclically along the map axis (`parallel.layout`), with the whole map's
cursor and drop count.  `insert_keypoints` and `map_size` then take the
axis: kernel E flags against the live local rows and one MAX (an OR)
combines the flags, the in-batch dedup, the slots and the cursor are
computed on every rank alike, and each rank writes the accepted rows whose
slot it owns.  Eviction gathers the whole map (`gather_map`), runs as on one
device and keeps this rank's rows (`shard_map`).

Functions return new states and never modify their inputs in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bshot_slam_tpu_torch.config import MapConfig
from bshot_slam_tpu_torch.device import resolve_device
from bshot_slam_tpu_torch.kernels.mapops import dedup_blocked_bounded
from bshot_slam_tpu_torch.ops.keypoints import _pair_d2
from bshot_slam_tpu_torch.parallel import comm, layout


class MapState(NamedTuple):
    positions: torch.Tensor  # (C, 3) float32, snapped to cfg.snap_mm
    descriptors: torch.Tensor  # (C, 11) int32 packed B-SHOT (uint32 bits)
    seg_ratios: torch.Tensor  # (C,) float32
    blocks: torch.Tensor  # (C, 3) int32 voxel-block coords
    valid: torch.Tensor  # (C,) bool
    cursor: torch.Tensor  # () int32 next free slot
    frame_born: torch.Tensor  # (C,) int32 inserting frame, -1 for empty rows
    n_dropped: torch.Tensor  # () int32 insertions lost at capacity


class MapShard(MapState):
    """This rank's rows r::R of a map sharded along a mesh axis of R ranks
    (see the module docstring); `cursor` and `n_dropped` are the whole
    map's."""

    __slots__ = ()


# The fields with a row per map slot (a shard keeps rows r::R of each).
ROW_FIELDS = ("positions", "descriptors", "seg_ratios", "blocks", "valid",
              "frame_born")


def shard_map(state: MapState, axis: comm.Axis, device=None) -> MapShard:
    """This rank's shard of a whole map (every rank passes the same map)."""
    layout.local_capacity(state.positions.shape[0], axis)
    return MapShard(*[
        (layout.keep_rows(x, axis) if f in ROW_FIELDS else x).to(device or x.device)
        for f, x in zip(MapState._fields, state)])


def gather_map(state: MapState, axis: comm.Axis) -> MapState:
    """The whole map, on every rank, from the ranks' shards (a collective:
    every rank of the axis calls it)."""
    return MapState(*[
        layout.gather_rows(x, axis, f"map gather: {f}") if f in ROW_FIELDS else x
        for f, x in zip(MapState._fields, state)])


def init_map(cfg: MapConfig, capacity: int | None = None,
             device=None) -> MapState:
    """An empty map; `device=None` means the card (raises without one)."""
    C = capacity if capacity is not None else cfg.capacity
    device = resolve_device(device)
    return MapState(
        positions=torch.zeros((C, 3), dtype=torch.float32, device=device),
        descriptors=torch.zeros((C, 11), dtype=torch.int32, device=device),
        seg_ratios=torch.zeros((C,), dtype=torch.float32, device=device),
        blocks=torch.zeros((C, 3), dtype=torch.int32, device=device),
        valid=torch.zeros((C,), dtype=torch.bool, device=device),
        cursor=torch.zeros((), dtype=torch.int32, device=device),
        frame_born=torch.full((C,), -1, dtype=torch.int32, device=device),
        n_dropped=torch.zeros((), dtype=torch.int32, device=device),
    )


def grow_map(state: MapState, new_capacity: int) -> MapState:
    """Zero-pad every map array to a larger capacity (a shard's: the new
    capacity over the ranks; the cyclic layout moves no row)."""
    C = state.positions.shape[0]
    if new_capacity <= C:
        return state
    p = new_capacity - C

    def pad(x, fill=0):
        return torch.cat([x, torch.full((p,) + x.shape[1:], fill, dtype=x.dtype,
                                        device=x.device)], dim=0)

    return type(state)(
        positions=pad(state.positions),
        descriptors=pad(state.descriptors),
        seg_ratios=pad(state.seg_ratios),
        blocks=pad(state.blocks),
        valid=pad(state.valid),
        cursor=state.cursor,
        frame_born=pad(state.frame_born, -1),
        n_dropped=state.n_dropped,
    )


def compact_indices(mask: torch.Tensor, W: int) -> torch.Tensor:
    """Indices of the first (ascending) `W` True rows of `mask`, then the
    False rows ascending as padding (callers mask the tail by count)."""
    return torch.argsort((~mask).to(torch.uint8), stable=True)[:W]


def snap_positions(pos: torch.Tensor, snap_mm: float) -> torch.Tensor:
    """Grid snap, truncating toward zero."""
    return torch.trunc(pos / snap_mm) * snap_mm


def block_coords(pos: torch.Tensor, block_mm: float) -> torch.Tensor:
    """Voxel-block integer coords by rounding (half to even)."""
    return torch.round(pos / block_mm).to(torch.int32)


def _dedup_against(pos, blk, seg, m_pos, m_blk, m_seg, m_valid, n_valid,
                   cfg: MapConfig) -> torch.Tensor:
    """(K,) True where an existing same-block candidate within the dedup
    radius has seg_ratio >= the newcomer's (kernel E)."""
    return dedup_blocked_bounded(pos, blk, seg, m_pos, m_blk, m_seg, m_valid,
                                 n_valid, dedup_radius=cfg.dedup_radius_mm)


def _set_rows(x: torch.Tensor, tgt: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """Copy of x with x[tgt[i]] = rows[i]; targets == len(x) are dropped."""
    ext = torch.cat([x, x[:1]], dim=0)
    return ext.index_copy(0, tgt, rows.to(x.dtype))[: x.shape[0]]


def insert_keypoints(
    state: MapState,
    pos: torch.Tensor,  # (K, 3) world-frame keypoint positions
    desc: torch.Tensor,  # (K, 11) packed descriptors
    seg: torch.Tensor,  # (K,)
    kmask: torch.Tensor,  # (K,)
    cfg: MapConfig,
    frame_idx=-1,  # () int32 provenance for frame_born
    window_cap: int | None = None,
    axis: comm.Axis | None = None,
):
    """Batched equivalent of K sequential `Map::addKeypoint` calls.

    Returns (state, fits), `fits` a device bool that is False when the
    dedup window overflowed `window_cap` (the compact window ran anyway: the
    state is then wrong and the caller must discard it).  With `axis` the
    state is a `MapShard` along it (no window)."""
    dev = pos.device
    pos = snap_positions(pos, cfg.snap_mm)
    blk = block_coords(pos, cfg.block_size_mm)
    r2 = cfg.dedup_radius_mm * cfg.dedup_radius_mm

    # Dedup against the map: either every row up to the cursor, or (with
    # `window_cap`) the rows whose block lies in the batch's block box —
    # an exact superset of the possible blockers — compacted to the window.
    C = state.positions.shape[0]
    fits = torch.ones((), dtype=torch.bool, device=dev)
    if axis is not None:
        if window_cap is not None:
            raise ValueError("a sharded map is deduplicated without a window")
        local = _dedup_against(pos, blk, seg, state.positions, state.blocks,
                               state.seg_ratios, state.valid,
                               layout.local_live_rows(state.cursor, axis), cfg)
        rejected_by_map = comm.all_reduce(local.to(torch.int32), comm.MAX, axis,
                                          "E: flag or") > 0
    elif window_cap is not None and C > window_cap:
        W = window_cap
        big = 2**30
        lo = torch.min(torch.where(kmask[:, None], blk, big), dim=0).values
        hi = torch.max(torch.where(kmask[:, None], blk, -big), dim=0).values
        inwin = state.valid & torch.all(
            (state.blocks >= lo[None, :]) & (state.blocks <= hi[None, :]), dim=-1
        )
        n_win = torch.sum(inwin.to(torch.int32))
        fits = n_win <= W
        widx = compact_indices(inwin, W)
        wmask = torch.arange(W, dtype=torch.int32, device=dev) < n_win
        rejected_by_map = _dedup_against(
            pos, blk, seg, state.positions[widx], state.blocks[widx],
            state.seg_ratios[widx], wmask, n_win, cfg,
        )
    else:
        rejected_by_map = _dedup_against(
            pos, blk, seg, state.positions, state.blocks, state.seg_ratios,
            state.valid, state.cursor, cfg,
        )

    # Sequential-shadow dedup within the batch (i sees j < i).
    d2b = _pair_d2(pos, pos)
    same_blk_b = torch.all(blk[:, None, :] == blk[None, :, :], dim=-1)
    K = pos.shape[0]
    earlier = torch.tril(torch.ones((K, K), dtype=torch.bool, device=dev),
                         diagonal=-1)
    blocker_b = (
        earlier
        & kmask[None, :]
        & same_blk_b
        & (d2b < r2)
        & (seg[None, :] >= seg[:, None])
    )
    rejected_in_batch = torch.any(blocker_b, dim=1)
    accept = kmask & ~rejected_by_map & ~rejected_in_batch

    # Cumsum scatter append; rows past the capacity are dropped and counted.
    # A shard writes the rows whose slot it owns.
    R = 1 if axis is None else axis.size
    offs = torch.cumsum(accept.to(torch.int32), dim=0) - 1
    slot = state.cursor + offs
    ok = accept & (slot < C * R)
    if axis is None:
        tgt = torch.where(ok, slot, C).long()
    else:
        mine = ok & (slot % R == axis.rank)
        tgt = torch.where(mine, torch.div(slot, R, rounding_mode="floor"), C).long()
    n_ok = torch.sum(ok.to(torch.int32))
    fidx = torch.as_tensor(frame_idx, dtype=torch.int32, device=dev)
    new_state = type(state)(
        positions=_set_rows(state.positions, tgt, pos),
        descriptors=_set_rows(state.descriptors, tgt, desc),
        seg_ratios=_set_rows(state.seg_ratios, tgt, seg),
        blocks=_set_rows(state.blocks, tgt, blk),
        valid=_set_rows(state.valid, tgt, torch.ones_like(accept)),
        cursor=torch.clamp(state.cursor + n_ok, max=C * R).to(torch.int32),
        frame_born=_set_rows(state.frame_born, tgt, fidx.expand(K)),
        n_dropped=(state.n_dropped + torch.sum(accept.to(torch.int32))
                   - n_ok).to(torch.int32),
    )
    return new_state, fits


def evict_keypoints(state: MapState, n_evict: int,
                    axis: comm.Axis | None = None) -> MapState:
    """Evict up to `n_evict` keypoints, lowest-seg-ratio-in-densest-block
    first, then front-compact the survivors so valid rows stay exactly
    [0, cursor).  Evicted rows get `frame_born` -1.  A `MapShard` along
    `axis` is gathered whole, evicted on every rank alike and sharded again.

    Ties follow the reference exactly: its lexsort is three stable sorts
    (last key first), its float32 score `occ * 2C + (C - 1 - seg_rank)`
    rounds above 2^24 as it does there, and its top-k takes the lowest
    index among equal scores (a stable descending sort)."""
    if axis is not None:
        return shard_map(evict_keypoints(gather_map(state, axis), n_evict), axis)
    C = state.positions.shape[0]
    dev = state.positions.device
    i32 = dict(dtype=torch.int32, device=dev)
    # Per-row block occupancy: sort rows by block, then run lengths.
    blk = torch.where(state.valid[:, None], state.blocks, 2**30)
    order = torch.arange(C, device=dev)
    for k in (2, 1, 0):
        order = order[torch.argsort(blk[order, k], stable=True)]
    sb = blk[order]
    new_run = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                         torch.any(sb[1:] != sb[:-1], dim=1)])
    run_id = torch.cumsum(new_run.to(torch.int32), dim=0) - 1
    run_len = torch.zeros((C,), **i32).index_add_(
        0, run_id, torch.ones((C,), **i32))
    occ = torch.zeros((C,), **i32).index_copy(0, order, run_len[run_id])
    occ = torch.where(state.valid, occ, 0)

    # Eviction score: densest block first, lowest seg_ratio within.
    seg_rank = torch.zeros((C,), **i32).index_copy(
        0, torch.argsort(state.seg_ratios, stable=True),
        torch.arange(C, **i32))
    score = torch.where(
        state.valid,
        occ.to(torch.float32) * (2.0 * C) + (C - 1 - seg_rank).to(torch.float32),
        -1.0,
    )
    evict_idx = torch.sort(score, descending=True, stable=True).indices[:n_evict]
    evict = torch.zeros((C,), dtype=torch.bool, device=dev).index_fill(
        0, evict_idx, True) & state.valid

    # Stable front-compaction of the survivors.
    keep = state.valid & ~evict
    perm = torch.argsort((~keep).to(torch.uint8), stable=True)
    return MapState(
        positions=state.positions[perm],
        descriptors=state.descriptors[perm],
        seg_ratios=state.seg_ratios[perm],
        blocks=state.blocks[perm],
        valid=keep[perm],
        cursor=torch.sum(keep.to(torch.int32)).to(torch.int32),
        frame_born=torch.where(keep, state.frame_born, -1)[perm],
        n_dropped=state.n_dropped,
    )


def query_mask(state: MapState, center: torch.Tensor, range_mm: float,
               cfg: MapConfig) -> torch.Tensor:
    """(C,) mask of keypoints whose block intersects the +-range AABB
    (block granularity, as the reference's window scan)."""
    lo = torch.round((center - range_mm) / cfg.block_size_mm).to(torch.int32)
    hi = torch.round((center + range_mm) / cfg.block_size_mm).to(torch.int32)
    inside = torch.all(
        (state.blocks >= lo[None, :]) & (state.blocks <= hi[None, :]), dim=-1
    )
    return state.valid & inside


def map_size(state: MapState, axis: comm.Axis | None = None) -> torch.Tensor:
    """Number of stored keypoints (of the whole map, with `axis`)."""
    n = torch.sum(state.valid.to(torch.int32))
    return n if axis is None else comm.all_reduce(n, comm.SUM, axis, "map size")
