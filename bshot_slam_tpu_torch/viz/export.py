"""Headless visualization exports.

The reference renders interactively through OpenCV Viz (reference:
test/odometry_test.cpp:195-345, include/ViewerHandler.h) — unusable on a
headless host.  This module exports the same artifacts for offline
inspection: colored point clouds as PLY (class-colored preprocessing view,
the `pointcloud_preprocessing` palette), keypoint/map clouds, and
trajectory plots as SVG (no matplotlib dependency).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

# Class palette mirroring the reference's preprocessing viewer colors
# (reference: test/pointcloud_preprocessing.cpp render: white keep, green
# ground, blue self-car, red occluded).
CLASS_COLORS = np.array(
    [
        [220, 220, 220],  # 0 keep
        [60, 180, 75],  # 1 ground
        [0, 130, 200],  # 2 self-car
        [230, 25, 75],  # 3 occluded
    ],
    np.uint8,
)


def save_ply(path: str, points: np.ndarray,
             colors: Optional[np.ndarray] = None) -> None:
    """ASCII PLY of (n, 3) points with optional (n, 3) uint8 colors."""
    pts = np.asarray(points, np.float32)
    n = len(pts)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        if colors is None:
            for p in pts:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        else:
            c = np.asarray(colors, np.uint8)
            for p, q in zip(pts, c):
                f.write(f"{p[0]} {p[1]} {p[2]} {q[0]} {q[1]} {q[2]}\n")


def save_classified_cloud(path: str, xyz: np.ndarray, classes: np.ndarray,
                          valid: np.ndarray) -> None:
    """Preprocessing view: every return colored by its class."""
    m = np.asarray(valid).reshape(-1)
    pts = np.asarray(xyz).reshape(-1, 3)[m]
    cls = np.clip(np.asarray(classes).reshape(-1)[m], 0, 3)
    save_ply(path, pts, CLASS_COLORS[cls])


def save_trajectory_svg(
    path: str,
    trajectories: Sequence[np.ndarray],
    labels: Optional[Sequence[str]] = None,
    size: int = 800,
) -> None:
    """Top-down (x, y) SVG plot of one or more (n, 3) trajectories."""
    colors = ["#1f77b4", "#d62728", "#2ca02c", "#9467bd", "#8c564b"]
    trajs = [np.asarray(t, np.float64)[:, :2] for t in trajectories if len(t)]
    if not trajs:
        with open(path, "w") as f:
            f.write("<svg xmlns='http://www.w3.org/2000/svg'/>")
        return
    allp = np.concatenate(trajs)
    lo = allp.min(0)
    hi = allp.max(0)
    span = np.maximum(hi - lo, 1e-9).max()
    pad = 0.05 * span

    def to_px(p):
        q = (p - lo + pad) / (span + 2 * pad) * size
        return q[:, 0], size - q[:, 1]

    parts = [
        f"<svg xmlns='http://www.w3.org/2000/svg' width='{size}' "
        f"height='{size}' viewBox='0 0 {size} {size}'>",
        f"<rect width='{size}' height='{size}' fill='white'/>",
    ]
    for k, t in enumerate(trajs):
        x, y = to_px(t)
        pts = " ".join(f"{a:.1f},{b:.1f}" for a, b in zip(x, y))
        parts.append(
            f"<polyline points='{pts}' fill='none' "
            f"stroke='{colors[k % len(colors)]}' stroke-width='2'/>"
        )
        if labels and k < len(labels):
            parts.append(
                f"<text x='10' y='{20 + 18 * k}' fill='{colors[k % len(colors)]}' "
                f"font-family='monospace' font-size='14'>{labels[k]}</text>"
            )
    parts.append("</svg>")
    with open(path, "w") as f:
        f.write("".join(parts))
