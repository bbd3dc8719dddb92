"""The radius-neighbourhood kernels of a profiled slice: kernels A and B
(the saliency's moments and segment ratios) and H (SHOT's neighbour
selection), in both of their forms, and the least time of their work.

The kernels are found by the names the profiler gives them, with or
without the wide form's namespace (`wide::accumulate_kernel<16>`, ...).
A's and B's least times are `yardstick.frame_work`'s.  H's work, counted
here as `yardstick.py` counts A's and B's (the work the frame's inputs
need, not what the kernel's pruning leaves): one radius test
(`yardstick.RADIUS_TEST_F32` f32 instructions) per valid keypoint and
valid cloud row, 16 bytes read a valid row (its packed float4) and 8
bytes written a neighbour row (an int64 index, `max_neighbors` a
keypoint).
"""

from __future__ import annotations

import re

from slambench import yardstick

KERNELS = re.compile(r"\b(pack_cloud|accumulate|segratio|shot_pack|shot_select)_kernel\b")
H_ROW_BYTES = 16  # a valid row's packed (x, y, z, |p|^2), read once
H_OUT_BYTES = 8  # a neighbour row's int64 index, written once


def device_seconds(run):
    """Profiled device seconds of A's, B's and H's kernels, or None where
    the slice holds none."""
    spent = [s for name, s in (run.profile or {}).get("by_kernel", {}).items()
             if KERNELS.search(name)]
    return sum(spent) if spent else None


def ms_per_frame(run):
    s = device_seconds(run)
    if s is None or not run.profile["frames"]:
        return None
    return s / run.profile["frames"] * 1e3


def h_work(points: int, keypoints: int, max_neighbors: int) -> tuple:
    """(bytes, ops) of one call of H."""
    return (points * H_ROW_BYTES + keypoints * max_neighbors * H_OUT_BYTES,
            {"f32": yardstick.RADIUS_TEST_F32 * float(keypoints) * points})


def least_seconds(frames: list, max_neighbors: int) -> float:
    """Summed over the profiled frames (`yardstick.frame_work`'s keyword
    arguments each): the least seconds of A's, B's and H's work."""
    total = 0.0
    for f in frames:
        work = yardstick.frame_work(**f)
        for nbytes, ops in (work["A"], work["B"],
                            h_work(f["points"], f["keypoints"], max_neighbors)):
            total += yardstick.bound_s(nbytes, ops)[0]
    return total


def roofline_pct(run):
    """The least time of A's, B's and H's work over the profiled frames as a
    share of their profiled device time, %."""
    spent = device_seconds(run)
    counts = run.counts
    if not counts or not spent or spent <= 0:
        return None
    m = int(run.cell.config["descriptor"]["max_neighbors"])
    return least_seconds(counts["frames"], m) / spent * 100.0
