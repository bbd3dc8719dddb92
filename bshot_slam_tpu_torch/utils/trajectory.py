"""Trajectory text IO, byte-compatible with the reference format.

The reference saves/loads trajectories as whitespace-separated x y z lines
(reference: test/odometry_test.cpp:348-361 save, 63-81 load) — its only
persistence mechanism.  Kept here for cross-comparison; full-pose
checkpointing lives in bshot_slam_tpu_torch.checkpoint.
"""

from __future__ import annotations

import numpy as np


def save_xyz(path: str, positions: np.ndarray) -> None:
    """Write (n, 3) positions, one 'x y z' line per frame."""
    with open(path, "w") as f:
        for p in np.asarray(positions):
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def load_xyz(path: str) -> np.ndarray:
    """Read 'x y z' lines -> (n, 3) float64."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 3:
                rows.append([float(parts[0]), float(parts[1]), float(parts[2])])
    return np.asarray(rows, np.float64).reshape(-1, 3)
