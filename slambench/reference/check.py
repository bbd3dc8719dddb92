"""Whether what the timed path produced is correct: the program's outputs
for a sample of the window's frames against the plain reference.

For each checked frame the reference ingests the frame's sweep itself
(`ingest.py`) and runs the frame's odometry step (`step.py`) with the
frame's RANSAC draws, which it draws again from the run's engine seed on
the same device (each pass of the window starts a fresh engine, so a
frame's draws are those of its place in its pass).  The first
`check_chain` frames of the window run as a chain from the reference's
own start (the prefilled map, built from the benchmark's prefill rows);
each later sampled frame starts from the program's own state before that
frame (a copy taken in the window): a chain longer than a few frames
compares trajectories that have split, since a frame whose RANSAC
hypotheses score alike takes either pose on a last-bit difference, and
every later frame of the chain carries that split.  Numbers compared,
each the largest over the checked frames unless it says otherwise:

- `cloud_gap_pct`: the kept points of the program's ingest against the
  reference's: points of one cloud with no point of the other within
  `CLOUD_MATCH_MM`, as a share of the larger cloud (the program classifies
  in its native library, the reference in numpy: a point on a threshold
  may fall either way);
- `keypoints_gap_pct`: valid keypoints found by one side and not the
  other (no keypoint of the other within `KEYPOINT_MATCH_MM`), as a share
  of the larger set; `descriptor_gap_pct`: differing B-SHOT bits of the
  keypoints both found;
- `inliers_median_gap`: RANSAC inliers, and `pose_median_gap_mm`: the
  frame's pose (RANSAC, the gate, ICP) as the distance between the two
  positions, each the median over the checked frames: a frame whose best
  RANSAC hypotheses score alike, or whose inliers lie at the gate's
  threshold, takes either on a difference in the last bits of its cloud,
  so the largest gap swings from seed to seed; `pose_far_pct`: the
  checked frames whose pose gap exceeds `POSE_FAR_MM`, %, so that a fault
  on fewer than half of the frames, which the median passes, still counts;
- `map_rows_gap`: map rows after the frame's eviction, dedup and insert
  that differ (valid flag, voxel block, or position by more than one
  snap step), and `map_rows_median_gap`, its median over the checked
  frames: a frame whose pose splits inserts its rows a snap step or more
  apart, so the largest follows the pose's tail.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from slambench.reference import config as config_mod
from slambench.reference import ingest, step

KEYPOINT_MATCH_MM = 0.5  # two keypoints are one point of the cloud
CLOUD_MATCH_MM = 1.0  # two kept points are one return (ticks are 2 mm)
POSE_FAR_MM = 2.0  # a frame's pose gap counted by `pose_far_pct`
NUMBERS = ("cloud_gap_pct", "keypoints_gap_pct", "descriptor_gap_pct",
           "inliers_median_gap", "pose_median_gap_mm", "pose_far_pct", "map_rows_gap",
           "map_rows_median_gap")
MEDIANS = {"inliers_median_gap": "inliers_gap", "pose_median_gap_mm": "pose_gap_mm",
           "map_rows_median_gap": "map_rows_gap"}


def to_bfloat16(points: np.ndarray) -> np.ndarray:
    """The cloud as bfloat16 holds it (the control's ingest)."""
    return torch.as_tensor(points).to(torch.bfloat16).to(torch.float32).numpy()


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in float32 products on the card while inside (the control)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def initial_state(cfg, rows: dict, device) -> step.OdometryState:
    """The window's start: the map at full capacity with the prefill rows in
    front, no previous frame, the identity pose."""
    C, K = cfg.map.capacity, cfg.keypoints.top_k
    d = cfg.descriptor
    n_words = (d.n_azimuth_bins * d.n_elevation_bins * d.n_radial_bins
               * d.n_cosine_bins + 31) // 32
    n = rows["positions"].shape[0]
    i32 = dict(dtype=torch.int32, device=device)

    def front(shape, dtype, values):
        x = torch.zeros(shape, dtype=dtype, device=device)
        x[:n] = values
        return x

    m = step.MapState(
        positions=front((C, 3), torch.float32, rows["positions"]),
        descriptors=front((C, n_words), torch.int32, rows["descriptors"]),
        seg_ratios=front((C,), torch.float32, rows["seg_ratios"]),
        blocks=front((C, 3), torch.int32, rows["blocks"]),
        valid=front((C,), torch.bool, True),
        cursor=torch.tensor(n, **i32),
        frame_born=torch.full((C,), -1, **i32),
        n_dropped=torch.zeros((), **i32),
    )
    ref = step.FrameFeatures(
        keypoints=torch.zeros((K, 3), dtype=torch.float32, device=device),
        scores=torch.zeros((K,), dtype=torch.float32, device=device),
        descriptors=torch.zeros((K, n_words), **i32),
        mask=torch.zeros((K,), dtype=torch.bool, device=device))
    return step.OdometryState(map=m, ref=ref,
                              ref_pose=torch.eye(4, dtype=torch.float32, device=device),
                              frame_idx=torch.zeros((), **i32))


def as_reference(state) -> step.OdometryState:
    """The program's state (its NamedTuples hold the same fields in the same
    order) as the reference's."""
    return step.OdometryState(map=step.MapState(*state.map),
                              ref=step.FrameFeatures(*state.ref),
                              ref_pose=state.ref_pose, frame_idx=state.frame_idx)


def draws_for(frames, seed: int, H: int, device) -> dict:
    """The RANSAC draws of each frame: the engine's k-th frame takes the
    k-th (H, 3) uniform draw of a generator on its device seeded with its
    seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out, want = {}, set(frames)
    for k in range(max(frames) + 1):
        d = torch.rand((H, 3), generator=gen, device=device)
        if k in want:
            out[k] = d
    return out


def features_gap(prog: step.FrameFeatures, ref: step.FrameFeatures,
                 match_mm: float) -> tuple:
    """(keypoints found by one side only, % of the larger valid set;
    differing descriptor bits of the keypoints both found, %).  A keypoint
    is found by both where the other side's nearest keypoint lies within
    `match_mm` (the two sides ingest the sweep apart, so a point's
    coordinates may differ in their last bits)."""
    pm, rm = prog.mask, ref.mask
    pk, rk = prog.keypoints[pm].double(), ref.keypoints[rm].double()
    pd, rd = prog.descriptors[pm], ref.descriptors[rm]
    larger = max(pk.shape[0], rk.shape[0], 1)
    if not pk.shape[0] or not rk.shape[0]:
        return 100.0 * (pk.shape[0] != rk.shape[0]), 0.0
    d, j = torch.min(torch.cdist(pk, rk), dim=1)
    hit = d <= match_mm
    kp_gap = 100.0 * (larger - int(torch.sum(hit))) / larger
    if not bool(torch.any(hit)):
        return kp_gap, 100.0
    x = (pd[hit] ^ rd[j[hit]]).cpu().numpy().view(np.uint8)
    return kp_gap, 100.0 * int(np.unpackbits(x).sum()) / (x.size * 8)


def cloud_gap(prog, ref, device, match_mm: float = CLOUD_MATCH_MM,
              chunk: int = 1024) -> float:
    """Points of one cloud ((points, n_valid)) with no point of the other
    within `match_mm`, as % of the larger cloud."""
    if prog is None:
        return 100.0
    a, b = (torch.as_tensor(np.asarray(c[0][:c[1]]), dtype=torch.float64,
                            device=device) for c in (prog, ref))
    if not a.shape[0] or not b.shape[0]:
        return 100.0 * (a.shape[0] != b.shape[0])

    def unmatched(x, y):
        return sum(int(torch.sum(torch.cdist(x[i:i + chunk], y).amin(dim=1) > match_mm))
                   for i in range(0, x.shape[0], chunk))

    return 100.0 * max(unmatched(a, b), unmatched(b, a)) / max(a.shape[0], b.shape[0])


def map_rows_gap(prog: step.MapState, ref: step.MapState, snap_mm: float) -> int:
    pv, rv = prog.valid, ref.valid
    both = pv & rv
    moved = (torch.amax(torch.abs(prog.positions - ref.positions), dim=-1) > snap_mm) | \
        torch.any(prog.blocks != ref.blocks, dim=-1)
    return int(torch.sum((pv != rv) | (both & moved)))


def pose_gap(p: np.ndarray, r: np.ndarray) -> tuple:
    p, r = np.asarray(p, np.float64), np.asarray(r, np.float64)
    dt = float(np.linalg.norm(p[:3, 3] - r[:3, 3]))
    c = (np.trace(p[:3, :3].T @ r[:3, :3]) - 1.0) / 2.0
    return dt, float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def window_rows(state, cfg) -> int:
    """Live map rows in the query window around the state's previous pose."""
    s = as_reference(state)
    win = step.query_mask(s.map, step.se3.translation(s.ref_pose),
                          cfg.match.map_query_range_mm, cfg.map)
    return int(torch.sum(win))


def check(config_json: dict, sweeps, rows: dict, snaps: dict, records: list,
          engine_seed: int, device, limits: dict, pass_frames: int, profiled=(),
          profile_state=None, control: bool = False, log=print) -> dict:
    """The comparison over the checked frames `snaps` ({frame: (program
    state before, program state after, the program's ingest (points,
    n_valid))}) of a window whose passes are `pass_frames` long.  With `control` the program's side is replaced by the
    reference computed with TF32 (the nearest precision below the
    configuration's float32): the cloud in bfloat16, the step's float32
    products in TF32.  Returns {"correct", "numbers": {name: (value,
    limit)} of the numbers the cell's `limits` name, "readings": every
    number, "skipped", "per_frame", "_counts"}."""
    cfg = config_mod.from_json(config_json)
    device = torch.device(device)
    L = len(sweeps)
    frames = sorted(snaps)
    clouds = {}

    def cloud(j):
        if j not in clouds:
            sw = sweeps[j]
            clouds[j] = ingest.host_cloud(sw.azimuth_deg, sw.ring, sw.distance, cfg)
        return clouds[j]

    worst = dict.fromkeys(NUMBERS, 0.0)
    per_frame = []
    draws = draws_for({k % pass_frames for k in frames}, engine_seed,
                      cfg.match.ransac_iterations, device) if frames else {}
    chain_state = initial_state(cfg, rows, device)
    chain_side = chain_state
    skipped = []
    for k in frames:
        before, after, prog_cloud = snaps[k]
        pts, nv = cloud(k % L)
        d = k % pass_frames  # the frame's place in its pass
        chained = k == int(chain_state.frame_idx)
        if not chained and (int(before.frame_idx) != d or int(after.frame_idx) != d + 1):
            skipped.append(k)  # the program re-ran this frame after an overflow
            continue
        start = chain_state if chained else as_reference(before)
        points = torch.as_tensor(pts, device=device)
        pmask = torch.arange(points.shape[0], device=device) < nv
        with tf32(False):
            ref_after, ref_out = step.odometry_step(step.make_room(start, cfg), points,
                                                    pmask, draws[d], cfg)
        if control:
            prog_cloud = (to_bfloat16(pts), nv)
            with tf32(True):
                side_start = chain_side if chained else start
                prog_after, prog_out = step.odometry_step(
                    step.make_room(side_start, cfg),
                    torch.as_tensor(prog_cloud[0], device=device), pmask, draws[d], cfg)
            prog_pose = prog_out.pose.cpu().numpy()
            prog_inliers = int(prog_out.n_inliers)
            chain_side = prog_after
        else:
            prog_after = as_reference(after)
            prog_pose, prog_inliers = records[k].pose, records[k].n_inliers
        if chained:
            chain_state = ref_after
        worst["cloud_gap_pct"] = max(worst["cloud_gap_pct"],
                                     cloud_gap(prog_cloud, (pts, nv), device))
        dt, dr = pose_gap(prog_pose, ref_out.pose.cpu().numpy())
        kp_gap, bit_gap = features_gap(prog_after.ref, ref_after.ref, KEYPOINT_MATCH_MM)
        gaps = {
            "pose_gap_mm": dt, "pose_gap_deg": dr, "keypoints_gap_pct": kp_gap,
            "descriptor_gap_pct": bit_gap,
            "inliers_gap": float(abs(prog_inliers - int(ref_out.n_inliers))),
            "map_rows_gap": float(map_rows_gap(prog_after.map, ref_after.map,
                                               cfg.map.snap_mm)),
        }
        per_frame.append(dict(gaps, frame=k, n_valid=nv, chained=chained,
                              inliers=int(ref_out.n_inliers), gated=bool(ref_out.gated),
                              prog_inliers=prog_inliers))
        for name, v in gaps.items():
            if name in worst:
                worst[name] = max(worst[name], v)
        log(f"# check frame {k}{' (chain)' if chained else ''}: " + ", ".join(
            f"{n} {v:.6g}" for n, v in gaps.items())
            + f", n_valid {nv}, inliers {int(ref_out.n_inliers)}")
    for name, of in MEDIANS.items():
        if per_frame:
            worst[name] = float(np.median([f[of] for f in per_frame]))
    if per_frame:
        worst["pose_far_pct"] = 100.0 * sum(f["pose_gap_mm"] > POSE_FAR_MM
                                            for f in per_frame) / len(per_frame)
    numbers = {n: (worst[n], float(limits[n])) for n in NUMBERS if n in limits}
    correct = all(v <= lim for v, lim in numbers.values()) and len(frames) > len(skipped)
    counts = None
    if profiled:
        counts = {"frames": [], "window_rows": None}
        wrows = window_rows(profile_state, cfg) if profile_state is not None else 0
        counts["window_rows"] = wrows
        pairs = {}
        for k in profiled:
            j = k % L
            pts, nv = cloud(j)
            if j not in pairs:
                p = torch.as_tensor(pts, device=device)
                m = torch.arange(p.shape[0], device=device) < nv
                ones = torch.ones((p.shape[0], 1), dtype=torch.float32, device=device)
                with tf32(False):
                    pairs[j] = float(torch.sum(step.neighborhood_accumulate_plain(
                        p, m, ones, cfg.keypoints.radius_mm)))
            counts["frames"].append(dict(
                points=nv, in_radius=pairs[j], keypoints=cfg.keypoints.top_k,
                window_rows=wrows, icp_iterations=cfg.match.icp_iterations))
    return {"correct": correct, "numbers": numbers, "readings": worst,
            "skipped": skipped, "per_frame": per_frame, "_counts": counts}
