"""Dense spherical range-image assembly (host-side numpy).

The reference builds its range image as `std::map<double, std::map<double,
double>>` keyed by exact azimuth/vertical floats (reference:
include/preprocess.h:11-12) — an ordered-tree structure visited ~3x per
point (SURVEY §3.2).  The TPU rebuild uses a dense `(n_rings, n_azimuth)`
tensor: rings are vertical angles sorted ascending (reference sorts at
src/preprocess.cpp:14,31), azimuth columns are fixed-width bins holding the
exact firing azimuth alongside the range so no angular precision is lost.
A cell with range 0.0 is a lost point / empty bin, matching the reference's
`vert.second == 0` convention (reference: src/preprocess.cpp:129).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from bshot_slam_tpu_torch.config import SensorConfig
from bshot_slam_tpu_torch.io.velodyne import LaserSweep


@dataclasses.dataclass
class RangeImage:
    """Device-ready dense sweep tensors (units mm / radians)."""

    range_mm: np.ndarray  # (R, A) float32, 0 = no return
    azimuth_rad: np.ndarray  # (R, A) float32, exact firing azimuth (bin center if empty)
    vert_rad: np.ndarray  # (R,) float32, sorted ascending
    selected: np.ndarray  # (R, A) bool, per-point select-list (default all True)
    timestamp_us: int = 0

    @property
    def n_rings(self) -> int:
        return self.range_mm.shape[0]

    @property
    def n_azimuth(self) -> int:
        return self.range_mm.shape[1]


def sorted_vertical_angles_rad(sensor: SensorConfig) -> np.ndarray:
    return np.deg2rad(np.sort(np.asarray(sensor.vertical_angles_deg))).astype(
        np.float32
    )


def build_range_image(
    sweep: LaserSweep,
    sensor: SensorConfig,
    selected_indices: Optional[np.ndarray] = None,
) -> RangeImage:
    """Bin a LaserSweep into a dense (R, A) range image.

    `selected_indices` are indices into the sweep's firing order, the
    equivalent of the reference's hand-labeled select lists (reference:
    src/preprocess.cpp:58-67).  On bin collisions the later firing wins,
    like the reference's map overwrite on equal keys.
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
    selected = np.ones((R, A), bool)

    if len(sweep):
        rows = row_of_ring[sweep.ring]
        cols = np.minimum(
            (sweep.azimuth_deg / 360.0 * A).astype(np.int64), A - 1
        ).astype(np.int32)
        # Distance ticks are 2 mm each (reference: src/preprocess.cpp:46).
        dist_mm = sweep.distance.astype(np.float32) * sensor.distance_scale_mm
        range_mm[rows, cols] = dist_mm
        azimuth_rad[rows, cols] = np.deg2rad(sweep.azimuth_deg).astype(np.float32)
        if selected_indices is not None:
            sel_flat = np.zeros(len(sweep), bool)
            sel_flat[np.asarray(selected_indices, np.int64)] = True
            selected[rows, cols] = sel_flat

    return RangeImage(
        range_mm=range_mm,
        azimuth_rad=azimuth_rad.astype(np.float32),
        vert_rad=np.deg2rad(vert_sorted).astype(np.float32),
        selected=selected,
        timestamp_us=sweep.timestamp_us,
    )
