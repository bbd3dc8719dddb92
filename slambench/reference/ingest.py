"""The plain reference of host ingest: a sweep binned into a range image,
classified (ground walk, self-car crop, occlusion) and the kept points
extracted, padded to the smallest cloud bucket holding them.

A frozen copy, in numpy, of bshot_slam_tpu_torch's `ops/rangeimage.py`
(`build_range_image`, the select list left out), `ops/preprocess_host.py`
(the plain version of the native library the program ingests with) and
`odometry/engine.py`'s `pick_bucket`.  It imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

CLASS_KEEP = 0
CLASS_GROUND = 1
CLASS_SELFCAR = 2
CLASS_OCCLUDED = 3


def build_range_image(azimuth_deg, ring, distance, sensor):
    """Bin a LaserSweep into a dense (R, A) range image.

    Returns (range_mm (R, A), azimuth_rad (R, A), vert_rad (R,)) float32.
    On bin collisions the later firing wins, like the reference's map
    overwrite on equal keys.
    """
    R, A = sensor.n_rings, sensor.n_azimuth
    vert_sorted = np.sort(np.asarray(sensor.vertical_angles_deg))
    # ring id (firing order) -> sorted row
    row_of_ring = np.argsort(
        np.argsort(np.asarray(sensor.vertical_angles_deg), kind="stable"),
        kind="stable",
    ).astype(np.int32)

    az_bin_centers = (np.arange(A, dtype=np.float32) + 0.5) * (
        2.0 * np.pi / A
    )
    range_mm = np.zeros((R, A), np.float32)
    azimuth_rad = np.tile(az_bin_centers, (R, 1))

    if len(azimuth_deg):
        rows = row_of_ring[ring]
        cols = np.minimum(
            (azimuth_deg / 360.0 * A).astype(np.int64), A - 1
        ).astype(np.int32)
        # Distance ticks are 2 mm each (reference: src/preprocess.cpp:46).
        dist_mm = distance.astype(np.float32) * sensor.distance_scale_mm
        range_mm[rows, cols] = dist_mm
        azimuth_rad[rows, cols] = np.deg2rad(azimuth_deg).astype(np.float32)

    return (range_mm, azimuth_rad.astype(np.float32),
            np.deg2rad(vert_sorted).astype(np.float32))


_EPS = np.float32(1e-6)


def polar_to_xyz_host(range_mm, azimuth_rad, vert_rad):
    """(R, A) polar -> (R, A, 3) float32 XYZ (reference: preprocess.cpp:50-52)."""
    r = np.asarray(range_mm, np.float32)
    a = np.asarray(azimuth_rad, np.float32)
    v = np.asarray(vert_rad, np.float32)[:, None]
    cos_v = np.cos(v, dtype=np.float32)
    return np.stack(
        [
            r * cos_v * np.sin(a, dtype=np.float32),
            r * cos_v * np.cos(a, dtype=np.float32),
            r * np.sin(v, dtype=np.float32) * np.ones_like(a),
        ],
        axis=-1,
    )


def _ground_walk_host(range_mm, azimuth_rad, vert_rad, xyz,
                      cfg):
    """Bottom-up ground walk (reference: preprocess.cpp:73-166), all azimuth
    columns in parallel, python loop over the 32 rings.  Mirrors
    ops.preprocess._ground_scan rule for rule."""
    R, A = range_mm.shape
    H = np.float32(cfg.sensor_height_mm)
    az0 = azimuth_rad[0].astype(np.float32)
    horiz0 = np.float32(-H / np.tan(np.float32(cfg.vert_init_rad)))
    p0 = np.stack(
        [horiz0 * np.sin(az0), horiz0 * np.cos(az0), np.full(A, -H, np.float32)],
        axis=-1,
    ).astype(np.float32)

    pig = np.ones(A, bool)
    lost = np.zeros(A, bool)
    set_th = np.zeros(A, bool)
    p_prev = p0
    p_th = p0.copy()
    grad_th = np.float32(cfg.grad_th_deg)
    lowpt = np.float32(cfg.lowpt_th_mm)
    height_th = np.float32(cfg.height_th_mm)
    classes = np.empty((R, A), np.int32)

    for i in range(R):
        d = range_mm[i]
        p_curr = xyz[i]
        z = p_curr[:, 2]
        diff = p_curr - p_prev
        nrm = np.sqrt(np.sum(diff * diff, axis=-1, dtype=np.float32))
        grad = np.degrees(
            np.arcsin(np.clip(diff[:, 2] / (nrm + _EPS), -1.0, 1.0))
        ).astype(np.float32)
        norm_prev = np.sqrt(np.sum(p_prev * p_prev, axis=-1, dtype=np.float32))

        # Rule 1: remember a threshold point (preprocess.cpp:99-103).
        cond1 = pig & ((grad > grad_th) | (d == 0) | (d < norm_prev))
        set_th = set_th | cond1
        p_th = np.where(cond1[:, None], p_prev, p_th)

        # Rule 2: ground continuation / lower-ground re-attach (:105-127).
        g_keep = pig & (grad < grad_th) & ~lost
        lower = ~pig & (z < lowpt) & (grad < grad_th)
        cls = np.where(g_keep | lower, CLASS_GROUND, CLASS_KEEP)
        pig = g_keep | lower
        set_th = np.where(lower, False, set_th)

        # Rule 3: lost point (:129-136).
        lost_new = d == 0
        cls = np.where(lost_new, CLASS_GROUND, cls)
        pig = np.where(lost_new, False, pig)

        # Rule 4: range shortened vs previous (:138-141).
        shorten = (d < norm_prev) & (d != 0)
        cls = np.where(shorten, CLASS_KEEP, cls)
        pig = np.where(shorten, False, pig)

        # Rule 5: threshold-point restart (:146-150).
        restart = set_th & ((z - p_th[:, 2]) < height_th) & (z < p_prev[:, 2])
        set_th = np.where(restart, False, set_th)
        cls = np.where(restart, CLASS_GROUND, cls)
        pig = np.where(restart, True, pig)

        # Rule 6: self-car crop box (:155-158).
        x, y = p_curr[:, 0], p_curr[:, 1]
        incar = (
            (x >= cfg.car_x_mm[0]) & (x <= cfg.car_x_mm[1])
            & (y >= cfg.car_y_mm[0]) & (y <= cfg.car_y_mm[1])
            & (z >= cfg.car_z_mm[0]) & (z <= cfg.car_z_mm[1])
        )
        cls = np.where(incar, CLASS_SELFCAR, cls)

        classes[i] = cls
        lost = lost_new
        p_prev = p_curr
    return classes


def _occlusion_host(range_mm, azimuth_rad, classes, cfg):
    """Azimuth range-discontinuity marking (reference: preprocess.cpp:
    168-199), mirroring ops.preprocess._occlusion_pass."""
    R, A = range_mm.shape
    valid = range_mm > 0
    idx = np.broadcast_to(np.arange(A, dtype=np.int64), (R, A))
    seed = valid | (idx == 0)
    vidx = np.where(seed, idx, -1)
    last_incl = np.maximum.accumulate(vidx, axis=1)
    prev_idx = np.concatenate(
        [np.full((R, 1), -1, np.int64), last_incl[:, :-1]], axis=1
    )
    take = np.clip(prev_idx, 0, A - 1)
    rows = np.arange(R)[:, None]
    prev_range = range_mm[rows, take]
    prev_az = azimuth_rad[rows, take]
    active = valid & (prev_idx >= 0)

    d_dist = range_mm - prev_range
    d_hor = azimuth_rad - prev_az
    occ = active & (np.abs(d_dist) > np.float32(cfg.dist_th_mm)) & (
        np.abs(d_hor) < np.float32(cfg.angdiff_th_rad)
    )
    mark_curr = occ & (d_dist > 0)
    mark_prev_flag = occ & (d_dist <= 0)

    prev_marks = np.zeros((R, A), bool)
    rows2 = np.broadcast_to(rows, (R, A))
    # Each prev index is marked by at most one successor (its next valid
    # column), and duplicate True writes are idempotent anyway, so plain
    # boolean scatter is equivalent to the JAX .at[].max (and ~100x faster
    # than np.maximum.at's scalar loop).
    prev_marks[rows2[mark_prev_flag], take[mark_prev_flag]] = True
    marked = mark_curr | prev_marks
    return np.where(marked & (classes == CLASS_KEEP), CLASS_OCCLUDED, classes)


def preprocess_host(range_mm, azimuth_rad, vert_rad, cfg):
    """Full host-side preprocessing.  Returns (classes (R,A) int32,
    xyz (R,A,3) f32, valid (R,A) bool) — same triple as ops.preprocess."""
    r = np.asarray(range_mm, np.float32)
    a = np.asarray(azimuth_rad, np.float32)
    v = np.asarray(vert_rad, np.float32)
    xyz = polar_to_xyz_host(r, a, v)
    classes = _ground_walk_host(r, a, v, xyz, cfg)
    classes = _occlusion_host(r, a, classes, cfg)
    return classes, xyz, r > 0


def extract_cloud_host(classes, xyz, valid, selected, max_points: int,
                       save_sel: bool = True):
    """Gather kept points, azimuth-major order (matching
    ops.preprocess.extract_cloud).  Returns (points (n,3) f32 compacted,
    n_valid) with n_valid = min(kept, max_points); the caller pads to its
    bucket."""
    if selected is None:
        sel_ok = np.ones_like(valid) if save_sel else np.zeros_like(valid)
    else:
        sel_ok = np.asarray(selected, bool) == save_sel
    keep = valid & (classes == CLASS_KEEP) & sel_ok
    flat = np.flatnonzero(keep.T.reshape(-1))[:max_points]
    pts = np.swapaxes(xyz, 0, 1).reshape(-1, 3)[flat]
    return np.ascontiguousarray(pts, dtype=np.float32), len(flat)


def pick_bucket(n_valid: int, cloud_buckets, max_points: int) -> int:
    """Smallest cloud bucket holding n_valid points (capped at max_points)."""
    for b in sorted(cloud_buckets):
        if n_valid <= b <= max_points:
            return b
    return max_points


def host_cloud(azimuth_deg, ring, distance, cfg):
    """One sweep's cloud as the program's ingest gives it: (points (bucket,
    3) float32 front-compacted and zero-padded, n_valid)."""
    r, a, v = build_range_image(azimuth_deg, ring, distance, cfg.sensor)
    classes, xyz, valid = preprocess_host(r, a, v, cfg.preprocess)
    pts, nv = extract_cloud_host(classes, xyz, valid, None, cfg.preprocess.max_points)
    points = np.zeros((pick_bucket(nv, cfg.runtime.cloud_buckets,
                                   cfg.preprocess.max_points), 3), np.float32)
    points[:nv] = pts
    return points, nv
