"""The fixed measure the kernels' roofline share divides by: the H100's
published peaks and the operations and bytes each of the port's CUDA
kernels A-E needs for a frame.

Frozen copies: the peaks of `bshot_slam_tpu_torch/device.py` (`H100`,
`Peaks.bound_ms`), the per-pair instruction counts of
`kernels/neighborhood.py` and `kernels/mapops.py`, and the byte counts
of `chip_smoke.py`'s kernel checks.  The counts are of the work the
frame's inputs need (valid points, pairs within the radius, valid
keypoints, live window rows), worked out by the benchmark's reference
side, not of what a kernel's own pruning leaves: so the share reads the
same work whatever implements it.  Each input byte is read once and each
output byte written once.
"""

from __future__ import annotations

import re

# H100 SXM: 132 SMs at the 1.98 GHz boost clock, 3.35 TB/s of HBM3; lanes
# per SM per clock by instruction class (compute capability 9.0): f32
# 128, 32-bit integer 64, popc 16; at most 128 lanes per clock over all.
SMS = 132
CLOCK_HZ = 1.98e9
LANES = {"f32": 128, "int": 64, "popc": 16}
DISPATCH_LANES = 128
BYTES_PER_S = 3.35e12

# Instructions per unit of work (kernels/neighborhood.py, kernels/mapops.py).
RADIUS_TEST_F32 = 8  # a pair's squared distance and its test
SEGRATIO_IN_RADIUS_F32 = 10  # B's work on a pair within the radius
HAMMING_PAIR_OPS = {"int": 30, "popc": 4}
EUCLID_PAIR_OPS = {"f32": 8}
DEDUP_PAIR_OPS = {"int": 1, "f32": 1}
FEATURES_A = 10  # kernel A's feature columns: 1, x, y, z and six products

# The port's kernels by the names the profiler gives them.
KERNELS = {
    "A": re.compile(r"\b(pack_cloud|accumulate)_kernel\b"),
    "B": re.compile(r"\bsegratio_kernel\b"),
    "C": re.compile(r"\bhamming_kernel\b"),
    "D": re.compile(r"\beuclid_kernel\b"),
    "E": re.compile(r"\bdedup_kernel\b"),
    "F": re.compile(r"\bground_walk_kernel\b"),
}


def kernel_of(name: str):
    """The port's kernel letter a profiled kernel name belongs to, or None.
    `pack_cloud_kernel` serves A and B alike and is counted under A."""
    for letter, pat in KERNELS.items():
        if pat.search(name):
            return letter
    return None


def bound_s(nbytes: float, ops: dict) -> tuple:
    """(least seconds for the work, "bytes" or "operations")."""
    per_s = SMS * CLOCK_HZ
    t_bytes = nbytes / BYTES_PER_S
    t_ops = max([n / (LANES[c] * per_s) for c, n in ops.items()]
                + [sum(ops.values()) / (DISPATCH_LANES * per_s)])
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _scaled(ops: dict, n: float) -> dict:
    return {c: k * n for c, k in ops.items()}


def frame_work(points: int, in_radius: float, keypoints: int,
               window_rows: int, icp_iterations: int) -> dict:
    """{kernel: (bytes, ops)} of one frame's calls of A-E: `points` valid
    cloud rows (the padding to a bucket is not work the frame needs),
    `in_radius` ordered pairs of valid
    points within the keypoint radius (each point with itself included),
    `keypoints` valid keypoints, `window_rows` live map rows in the query
    window (the previous frame's keypoints are added as the tail)."""
    nf = FEATURES_A
    live = window_rows + keypoints
    cands = window_rows + keypoints  # the candidate rows C and D read
    return {
        "A": (points * (12 + 1 + 4 * nf + 4 * nf),
              {"f32": in_radius * (RADIUS_TEST_F32 + nf)}),
        "B": (points * (12 + 1 + 12 + 12),
              {"f32": in_radius * (RADIUS_TEST_F32 + SEGRATIO_IN_RADIUS_F32)}),
        "C": (keypoints * 45 + cands * 45 + (keypoints + cands) * 8,
              _scaled(HAMMING_PAIR_OPS, keypoints * float(live))),
        "D": (icp_iterations * (keypoints * 13 + cands * 13 + keypoints * 8),
              _scaled(EUCLID_PAIR_OPS, icp_iterations * keypoints * float(live))),
        "E": (keypoints * 28 + window_rows * 29 + keypoints,
              _scaled(DEDUP_PAIR_OPS, keypoints * float(window_rows))),
    }


def least_seconds(frames: list) -> dict:
    """Summed over frames (each `frame_work`'s keyword arguments): the least
    seconds of each kernel, and the seconds bound by bytes and by
    operations over all of them."""
    per = {}
    by = {"bytes": 0.0, "operations": 0.0}
    for f in frames:
        for k, (nbytes, ops) in frame_work(**f).items():
            t, what = bound_s(nbytes, ops)
            per[k] = per.get(k, 0.0) + t
            by[what] += t
    return {"per_kernel": per, "by": by}
