"""Scan-to-map LiDAR odometry: the per-frame step.

Port of `bshot_slam_tpu.odometry.pipeline` (the host-preprocess path):

    OdometryState = (global map, previous-frame features, pose)
    odometry_step(state, points, mask, rng) -> (state', StepDiagnostics)

Stage order: keypoints + descriptors (one shared-moments sweep, kernels A
and B), map-window matching (kernel C), RANSAC, pose gate, ICP (kernel D,
10 launches), map insert (kernel E), and the packed diagnostics row.

There is one step body, `_odometry_step_impl`, and it never syncs with the
host: it commits or aborts on the device.  Where the reference branches
with `lax.cond` on a window overflow, the body always runs the compact
match and dedup windows, computes on the device whether both fit, and
commits its state only then and only when the caller's `ok` holds;
otherwise `state` passes through unchanged and `committed` is False.  An
aborted frame is re-run with `without_windows(cfg)`, whose dense scans
cannot overflow and give the compact windows' results (both are exact),
with the same RANSAC draws.  `odometry_step_deferred` is that body as the
engine's graphs run it; the fused step (`odometry_step_fused`) puts the
device preprocess of a range image in front of it, and aborts as well when
the kept points overflow the cloud bucket the engine predicted.
`odometry_step` and `odometry_step_compact` keep the reference's names and
outputs: they take the frame's draws once, run the body, and where a
window can overflow read `committed` once and re-run without windows.
`rng` takes the place of the reference's PRNG key: a `torch.Generator`, or
the (H, 3) RANSAC draws.

The steps also run sharded (`axes`, a `parallel.sharded.MeshAxes`): every
rank runs the step on the same inputs, with the map state a
`mapstore.MapShard` along the map axis.  Kernels A and B take the rank's
query rows of the data axis and one all-gather assembles the per-row sums;
C, D and E run on the rank's map rows and their results combine exactly
(`parallel.layout`); everything else runs alike on every rank, so the
records are the single-device step's bit for bit.  A sharded map is
scanned without windows (`parallel.sharded.mesh_runtime_overrides`), so a
mesh step never aborts; the fused step stays single-device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from bshot_slam_tpu_torch.config import SlamConfig
from bshot_slam_tpu_torch.device import resolve_device
from bshot_slam_tpu_torch.geometry import se3
from bshot_slam_tpu_torch.odometry import mapstore
from bshot_slam_tpu_torch.ops import bshot, hamming
from bshot_slam_tpu_torch.ops import preprocess as pp
from bshot_slam_tpu_torch.ops.icp import icp_point_to_point
from bshot_slam_tpu_torch.kernels.neighborhood import (
    neighborhood_accumulate, segratio_accumulate,
)
from bshot_slam_tpu_torch.ops.keypoints import (
    _finalize_scores, extract_keypoints, keypoints_from_scores, moment_features,
    moments_from_sums, top_k,
)
from bshot_slam_tpu_torch.ops.normals import normals_from_moments, surface_normals
from bshot_slam_tpu_torch.ops.ransac import ransac_rigid, uniform_draws
from bshot_slam_tpu_torch.ops.shot import shot_descriptors
from bshot_slam_tpu_torch.parallel import layout

# Packed-diagnostics layout (StepDiagnostics.packed), identical to the
# reference's.
PACKED_LEN = 28  # [pose(16), n_mutual, n_inliers, gated, h_diff, t_diff,
#                  map_size, icp_rmse, corr_stats(3), n_dropped, frame_idx]
IDX_N_MUTUAL = 16
IDX_N_INLIERS = 17
IDX_GATED = 18
IDX_MAP_SIZE = 21
IDX_ICP_RMSE = 22
IDX_CORR_STATS = 23  # ..IDX_CORR_STATS+3
IDX_N_DROPPED = 26
IDX_FRAME = 27
# Tail present when the step receives n_valid:
IDX_N_VALID = 28
IDX_BUCKET = 29
IDX_COMMITTED = 30


class FrameFeatures(NamedTuple):
    keypoints: torch.Tensor  # (K, 3) sensor frame
    scores: torch.Tensor  # (K,) seg ratios
    descriptors: torch.Tensor  # (K, 11) packed B-SHOT, int32
    mask: torch.Tensor  # (K,) keypoint and descriptor valid


class OdometryState(NamedTuple):
    map: mapstore.MapState
    ref: FrameFeatures  # previous frame's features (sensor frame)
    ref_pose: torch.Tensor  # (4, 4) previous frame's world pose
    frame_idx: torch.Tensor  # () int32


class StepDiagnostics(NamedTuple):
    pose: torch.Tensor  # (4, 4) estimated pose of this frame
    n_mutual: torch.Tensor
    n_inliers: torch.Tensor
    gated: torch.Tensor
    heading_diff_rad: torch.Tensor
    translation_diff_mm: torch.Tensor
    map_size: torch.Tensor
    icp_rmse: torch.Tensor
    corr_stats: torch.Tensor  # (3,) [mean, SD, median] inlier distance, mm
    corr_index: torch.Tensor  # (K,) int32 into [map capacity | prev keypoints]
    corr_inlier: torch.Tensor  # (K,) bool
    features: FrameFeatures
    n_dropped: torch.Tensor
    packed: torch.Tensor  # (28,) or (31,) float32, see PACKED_LEN


def init_state(cfg: SlamConfig, device=None) -> OdometryState:
    """The empty odometry state; `device=None` means the card (raises
    without one)."""
    K = cfg.keypoints.top_k
    device = resolve_device(device)
    return OdometryState(
        map=mapstore.init_map(cfg.map, device=device),
        ref=FrameFeatures(
            keypoints=torch.zeros((K, 3), dtype=torch.float32, device=device),
            scores=torch.zeros((K,), dtype=torch.float32, device=device),
            descriptors=torch.zeros((K, cfg.descriptor.n_words),
                                    dtype=torch.int32, device=device),
            mask=torch.zeros((K,), dtype=torch.bool, device=device),
        ),
        ref_pose=torch.eye(4, dtype=torch.float32, device=device),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
    )


def _shared_sweep(points, pmask, kcfg, tile: int, data_axis=None):
    """(count, sum, outer, saliency) of every point from one sweep of
    kernel A at the keypoint radius and one of kernel B.  On a data axis
    each rank sweeps its query rows and one all-gather assembles the
    per-row sums."""
    n = points.shape[0]
    (q0, q1), per = layout.data_rows(n, data_axis)
    acc = neighborhood_accumulate(points, pmask, moment_features(points),
                                  kcfg.radius_mm, tile=tile, rows=(q0, q1))
    ctvec = points[q0:q1] - acc[:, 1:4] / torch.clamp(acc[:, 0], min=1.0)[:, None]
    sr = segratio_accumulate(points, pmask, ctvec, kcfg.radius_mm,
                             normalized=(kcfg.sr_type == "CVSN"), tile=tile,
                             rows=(q0, q1))
    if data_axis is not None:
        rows = layout.gather_query_rows(torch.cat([acc, sr], dim=1), n, per,
                                        data_axis, "A+B: query rows")
        acc, sr = rows[:, :10], rows[:, 10:]
    cnt, psum, outer = moments_from_sums(acc)
    scores = _finalize_scores(points, pmask, kcfg, cnt, sr[:, 0], sr[:, 1], sr[:, 2])
    return cnt, psum, outer, scores


def compute_features(points: torch.Tensor, pmask: torch.Tensor,
                     cfg: SlamConfig, tile: int, data_axis=None) -> FrameFeatures:
    """extractKeypoints + computeDescriptors.  Saliency and normals need
    the same neighbourhood moments at the same radius, so one sweep of
    kernel A feeds both; on a `data_axis` that sweep is split over its ranks
    (the other settings run alike on every rank)."""
    cap_mode = cfg.keypoints.neighbor_cap_mode
    share = (
        cfg.descriptor.use_surface_normals
        and cfg.descriptor.normal_radius_mm == cfg.keypoints.radius_mm
        and not cap_mode
    )
    if share:
        cnt, psum, outer, scores = _shared_sweep(points, pmask, cfg.keypoints,
                                                 tile, data_axis)
        top_scores, top_idx = top_k(scores, cfg.keypoints.top_k)
        kps = keypoints_from_scores(points, top_scores, top_idx)
        normals, _, _ = normals_from_moments(points, pmask, cnt, psum, outer)
    else:
        kps = extract_keypoints(points, pmask, cfg.keypoints, tile)
        if cfg.descriptor.use_surface_normals:
            normals, _, _ = surface_normals(
                points, pmask, cfg.descriptor.normal_radius_mm, tile,
                cap=cfg.keypoints.neighbor_cap if cap_mode else None,
            )
        else:  # reference-mimic mode: zero surface normals
            normals = torch.zeros_like(points)
    desc_f, desc_valid = shot_descriptors(
        kps.positions, kps.mask, points, pmask, normals, cfg.descriptor)
    words = bshot.bshot_from_shot(desc_f, cfg.descriptor)
    return FrameFeatures(keypoints=kps.positions, scores=kps.scores,
                         descriptors=words, mask=kps.mask & desc_valid)


def _match_and_estimate(rng, src: FrameFeatures, state: OdometryState,
                        cfg: SlamConfig, map_axis=None):
    """featureMatching + evaluateEstimation.  Also returns `fits`, a device
    bool that is False when the match window overflowed (the compact window
    ran anyway and the results are to be discarded).  With `map_axis` the
    map is a shard along it."""
    mcfg = cfg.match
    ref_pose = state.ref_pose
    center = se3.translation(ref_pose)
    dev = ref_pose.device

    # Candidates: the map window, then the previous frame's keypoints in
    # the world frame (map wins ties, as in the reference's build order).
    win = mapstore.query_mask(state.map, center, mcfg.map_query_range_mm,
                              cfg.map)
    ref_world = se3.apply(ref_pose, state.ref.keypoints)
    capacity = state.map.positions.shape[0]

    # Window compaction: gather the in-window rows (ascending) into a
    # (window_cap, ...) buffer so matching and ICP scale with the local map;
    # `fits` says whether they all fitted.
    W = cfg.runtime.window_cap
    use_compact = cfg.runtime.window_compact and capacity > W
    if map_axis is not None and cfg.runtime.window_compact:
        raise ValueError("a sharded map is matched without window compaction "
                         "(parallel.sharded.mesh_runtime_overrides)")
    fits = torch.ones((), dtype=torch.bool, device=dev)
    if use_compact:
        n_win = torch.sum(win.to(torch.int32))
        fits = n_win <= W
        widx = mapstore.compact_indices(win, W)
        wmask = torch.arange(W, dtype=torch.int32, device=dev) < n_win
        cand_pos = torch.cat(
            [torch.where(wmask[:, None], state.map.positions[widx], 0.0),
             ref_world], dim=0)
        cand_desc = torch.cat(
            [torch.where(wmask[:, None], state.map.descriptors[widx], 0),
             state.ref.descriptors])
        cand_mask = torch.cat([wmask, state.ref.mask])
        n_live, tail = n_win, W
    else:
        cand_pos = torch.cat([state.map.positions, ref_world], dim=0)
        cand_desc = torch.cat([state.map.descriptors, state.ref.descriptors])
        cand_mask = torch.cat([win, state.ref.mask])
        n_live, tail = state.map.cursor, capacity

    if map_axis is None:
        m = hamming.mutual_nn_bounded(src.descriptors, src.mask, cand_desc,
                                      cand_mask, n_live, tail_start=tail)
        corr_dst = cand_pos[m.src_to_ref.long()]
    else:  # this rank's live map rows; indices come back global
        n_live = layout.local_live_rows(state.map.cursor, map_axis)
        m, corr_dst = hamming.mutual_nn_sharded(
            src.descriptors, src.mask, cand_desc, cand_mask, cand_pos, n_live,
            tail, map_axis)
    s2r = m.src_to_ref.long()
    cmask = m.mutual
    if use_compact:
        # Compact indices back to the full-map index space [0, capacity + K).
        corr_index = torch.where(s2r < W, widx[torch.clamp(s2r, max=W - 1)],
                                 capacity + (s2r - W))
    else:
        corr_index = s2r

    rr = ransac_rigid(rng, src.keypoints, corr_dst, cmask,
                      inlier_threshold=mcfg.ransac_inlier_th_mm,
                      iterations=mcfg.ransac_iterations)
    T_j = rr.transform

    # Pose gate.
    T_ij = se3.compose(se3.inverse(ref_pose), T_j)
    h_diff = se3.heading_angle(T_ij)
    t_diff = torch.linalg.norm(se3.translation(T_ij))
    gate = (
        (h_diff > math.radians(mcfg.gate_heading_deg))
        | (t_diff > mcfg.gate_translation_mm)
        | (rr.n_inliers < mcfg.gate_min_inliers)
    )
    T_est = torch.where(gate, ref_pose, T_j)

    # ICP refinement against the candidate set.  It runs (and its rmse is
    # reported) even with run_icp off, as in the reference.
    src_est = se3.apply(T_est, src.keypoints)
    icp = icp_point_to_point(
        src_est, src.mask, cand_pos, cand_mask,
        iterations=mcfg.icp_iterations, max_corr_dist=mcfg.icp_max_corr_dist_mm,
        n_valid_dst=n_live, tail_start=tail, axis=map_axis,
    )
    T_best = se3.compose(icp.transform, T_est) if mcfg.run_icp else T_j
    n_mutual = torch.sum(cmask.to(torch.int32))

    # Inlier correspondence stats after the final transform; the median is
    # the lower middle element of the sorted inlier distances.
    d = torch.linalg.norm(se3.apply(T_best, src.keypoints) - corr_dst, dim=-1)
    w = rr.inliers
    n_in = torch.sum(w.to(torch.int32))
    safe_n = torch.clamp(n_in, min=1).to(torch.float32)
    c_mean = torch.sum(torch.where(w, d, 0.0)) / safe_n
    c_std = torch.sqrt(torch.sum(torch.where(w, (d - c_mean) ** 2, 0.0)) / safe_n)
    d_sorted = torch.sort(torch.where(w, d, float("inf"))).values
    mid = (torch.clamp(n_in - 1, min=0) // 2).reshape(1).long()
    c_median = d_sorted.index_select(0, mid)[0]
    corr_stats = torch.where(n_in > 0, torch.stack([c_mean, c_std, c_median]),
                             torch.zeros(3, dtype=torch.float32, device=dev))
    return (T_best, rr, corr_index, n_mutual, gate, h_diff, t_diff, icp.rmse,
            corr_stats, fits)


def _odometry_step_impl(state: OdometryState, points: torch.Tensor,
                        pmask: torch.Tensor, rng, cfg: SlamConfig,
                        tile: int = 2048, n_valid=None, ok=None, axes=None):
    """One full SLAM frame, commit-or-abort on the device: it commits only
    when `ok` (a device bool: no earlier in-flight frame aborted; True when
    None) holds and both windows fit, and passes `state` through otherwise.
    Returns (state', committed, diag).  `n_valid` (the cloud count)
    optionally rides in `packed` with the [n_valid, bucket, committed]
    tail.  `axes` (a `parallel.sharded.MeshAxes`) runs it sharded."""
    dev = points.device
    if ok is None:
        ok = torch.ones((), dtype=torch.bool, device=dev)
    data_axis = None if axes is None else axes.data
    map_axis = None if axes is None else axes.map
    src = compute_features(points, pmask, cfg, tile, data_axis)
    (T_best, rr, corr_index, n_mutual, gate, h_diff, t_diff, icp_rmse,
     corr_stats, match_fits) = _match_and_estimate(rng, src, state, cfg, map_axis)

    # INITIAL frame: identity pose, no gating.
    is_initial = state.frame_idx == 0
    eye = torch.eye(4, dtype=torch.float32, device=dev)
    T_best = torch.where(is_initial, eye, T_best)
    gate = gate & ~is_initial

    # updateMap: insert the keypoints transformed by the accepted pose.
    world_kp = se3.apply(T_best, src.keypoints)
    new_map, dedup_fits = mapstore.insert_keypoints(
        state.map, world_kp, src.descriptors, src.scores, src.mask, cfg.map,
        frame_idx=state.frame_idx,
        window_cap=(cfg.runtime.window_cap if cfg.runtime.window_compact
                    else None),
        axis=map_axis,
    )
    committed = ok & match_fits & dedup_fits
    new_state = OdometryState(map=new_map, ref=src, ref_pose=T_best,
                              frame_idx=state.frame_idx + 1)
    new_state = _select(committed, new_state, state)  # abort: all passes through
    msize = mapstore.map_size(new_map, map_axis)
    f32 = torch.float32
    parts = [
        T_best.reshape(16),
        torch.stack([n_mutual.to(f32), rr.n_inliers.to(f32), gate.to(f32),
                     h_diff, t_diff, msize.to(f32), icp_rmse]),
        corr_stats,
        new_map.n_dropped.to(f32)[None],
        state.frame_idx.to(f32)[None],
    ]
    if n_valid is not None:  # made on the device: no host copy
        nv = (n_valid.to(f32).reshape(1) if isinstance(n_valid, torch.Tensor)
              else torch.full((1,), float(n_valid), dtype=f32, device=dev))
        parts += [nv, torch.full((1,), float(points.shape[0]), dtype=f32,
                                 device=dev), committed.to(f32)[None]]
    diag = StepDiagnostics(
        pose=T_best, n_mutual=n_mutual, n_inliers=rr.n_inliers, gated=gate,
        heading_diff_rad=h_diff, translation_diff_mm=t_diff, map_size=msize,
        icp_rmse=icp_rmse, corr_stats=corr_stats,
        corr_index=corr_index.to(torch.int32),
        corr_inlier=rr.inliers & ~is_initial, features=src,
        n_dropped=new_map.n_dropped, packed=torch.cat(parts),
    )
    return new_state, committed, diag


def _select(cond: torch.Tensor, a, b):
    """Field by field `where(cond, a, b)` over nested NamedTuples."""
    if isinstance(a, tuple):
        return type(a)(*[_select(cond, x, y) for x, y in zip(a, b)])
    return torch.where(cond, a, b)


def without_windows(cfg: SlamConfig) -> SlamConfig:
    """The configuration of the step that re-runs an aborted frame: window
    compaction off, so matching, ICP and the dedup scan the whole map.  That
    step cannot abort on a window, and it gives the compact windows'
    results (both are exact).  A sharded map always runs with it."""
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, window_compact=False))


def _step_or_rerun(state, points, pmask, rng, cfg, tile, n_valid, axes):
    """The step body with the frame's draws taken from `rng` once; where a
    window can overflow, `committed` is read on the host (one sync) and an
    aborted frame runs again without windows, with the same draws.
    Returns (state', diag)."""
    draws = uniform_draws(rng, cfg.match.ransac_iterations, points.device)
    new, committed, diag = _odometry_step_impl(state, points, pmask, draws, cfg,
                                               tile, n_valid, axes=axes)
    if (cfg.runtime.window_compact
            and state.map.positions.shape[0] > cfg.runtime.window_cap
            and not bool(committed)):
        new, _, diag = _odometry_step_impl(state, points, pmask, draws,
                                           without_windows(cfg), tile, n_valid,
                                           axes=axes)
    return new, diag


def odometry_step(state: OdometryState, points: torch.Tensor,
                  pmask: torch.Tensor, rng, cfg: SlamConfig, tile: int = 2048,
                  n_valid=None, axes=None):
    """One full SLAM frame: (state', diag).  `n_valid` (the cloud count)
    optionally rides in `packed` with the [n_valid, bucket, committed]
    tail; `axes` (a `parallel.sharded.MeshAxes`) runs it sharded.  A frame
    whose window overflows is run again without windows (see the module
    docstring)."""
    return _step_or_rerun(state, points, pmask, rng, cfg, tile, n_valid, axes)


def odometry_step_compact(state: OdometryState, points: torch.Tensor,
                          n_valid: int, rng, cfg: SlamConfig, tile: int = 2048,
                          axes=None):
    """`odometry_step` over a host-preprocessed compact cloud: points
    (bucket, 3) front-compacted, `n_valid` exact; the validity mask is
    `iota < n_valid`."""
    pmask = torch.arange(points.shape[0], device=points.device) < n_valid
    return _step_or_rerun(state, points, pmask, rng, cfg, tile, n_valid, axes)


def odometry_step_deferred(state: OdometryState, ok: torch.Tensor,
                           points: torch.Tensor, pmask: torch.Tensor | None,
                           n_valid, rng, cfg: SlamConfig, tile: int = 2048,
                           axes=None):
    """The step body as the engine's graphs run it: no host sync.
    `pmask=None` means a front-compacted cloud (`iota < n_valid`).  Commits
    only when `ok` holds and the match and dedup windows fit `window_cap`;
    otherwise `state` passes through unchanged and the packed row's
    committed flag is 0, and the engine re-runs the frame (and every later
    in-flight frame) without windows.  Returns (state', committed, diag)."""
    if pmask is None:
        pmask = torch.arange(points.shape[0], device=points.device) < n_valid
    return _odometry_step_impl(state, points, pmask, rng, cfg, tile,
                               n_valid=n_valid, ok=ok, axes=axes)


def ingest(range_mm: torch.Tensor, azimuth_rad: torch.Tensor,
           vert_rad: torch.Tensor, selected: torch.Tensor | None, pcfg,
           bucket: int):
    """Device preprocess + cloud extraction at `pcfg.max_points` + the slice
    to `bucket` + the kept count (a 0-d int32 tensor), with no host sync
    (the reference's `engine._ingest`).  `selected=None` selects every
    cell.  Returns (points (bucket, 3), pmask (bucket,), n_valid)."""
    res = pp.preprocess(range_mm, azimuth_rad, vert_rad, pcfg)
    points, pmask = pp.extract_cloud(res, selected, pcfg.max_points)
    n_valid = torch.sum(pmask, dtype=torch.int32)
    return points[:bucket], pmask[:bucket], n_valid


def odometry_step_fused(state: OdometryState, ok: torch.Tensor,
                        range_az: torch.Tensor, vert_rad: torch.Tensor,
                        selected: torch.Tensor | None, pcfg, cfg: SlamConfig,
                        bucket: int, rng, tile: int = 2048):
    """The pipelined engine's whole frame from a range image, with no host
    sync: `ingest` (range_az (2, R, A) is [range_mm, azimuth_rad]) at the
    predicted cloud `bucket`, then the deferred step.  It commits only when
    `ok` holds, the kept points fit the bucket (n_valid <= bucket) and the
    match and dedup windows fit; otherwise `state` passes through unchanged
    and the packed row's committed flag is 0, while its tail still carries
    the real n_valid and the bucket.  `rng` is the (H, 3) RANSAC draws.
    Returns (state', committed, diag)."""
    points, pmask, n_valid = ingest(range_az[0], range_az[1], vert_rad,
                                    selected, pcfg, bucket)
    return odometry_step_deferred(state, ok & (n_valid <= bucket), points, pmask,
                                  n_valid, rng, cfg, tile)
