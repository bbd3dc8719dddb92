"""Typed configuration for the B-SHOT SLAM engine (PyTorch/CUDA port).

A copy of `bshot_slam_tpu.config`: the port shares the reference package's
configuration tree field for field, so both read the same settings.

Every algorithm constant that is a scattered literal in the reference
(TingKaiChen/B-SHOT-SLAM) is centralized here, with the reference source
location cited so parity can be audited.  All spatial units are millimeters
and all angles are radians unless a field name says otherwise — matching the
reference convention (reference: src/preprocess.cpp:46 `distance*2` mm).

The reference has no config system at all (hard-coded blocks at the top of
each driver, e.g. test/odometry_test.cpp:29-46); this dataclass tree is the
rebuild's single source of truth.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Velodyne sensor geometry (reference: include/VelodyneCapture.h:530-607)."""

    name: str = "HDL-32E"
    n_rings: int = 32
    # Vertical angles in degrees, firing order (reference: VelodyneCapture.h:572).
    # Consumers sort ascending (reference: src/preprocess.cpp:14,31).
    vertical_angles_deg: Tuple[float, ...] = (
        -30.67, -9.3299999, -29.33, -8.0, -28.0, -6.6700001, -26.67,
        -5.3299999, -25.33, -4.0, -24.0, -2.6700001, -22.67, -1.33, -21.33,
        0.0, -20.0, 1.33, -18.67, 2.6700001, -17.33, 4.0, -16.0, 5.3299999,
        -14.67, 6.6700001, -13.33, 8.0, -12.0, 9.3299999, -10.67, 10.67,
    )
    # Raw Velodyne distance ticks are 2 mm each (reference: preprocess.cpp:46,
    # VelodyneCapture.h:511 comment "Distance increament is 2mm").
    distance_scale_mm: float = 2.0
    # Static azimuth binning for the dense (n_rings, n_azimuth) range image.
    # The reference keys a std::map by exact azimuth float (preprocess.h:12);
    # the TPU rebuild quantizes to fixed bins (HDL-32E fires ~2169 az/rev in
    # single-return mode; 2048 lanes align with TPU tiling). 2250 keeps
    # sub-bin collisions rare; we choose a 128-multiple.
    n_azimuth: int = 2176  # 17 * 128

    @property
    def azimuth_bin_rad(self) -> float:
        return 2.0 * math.pi / self.n_azimuth


VLP16_SENSOR = SensorConfig(
    name="VLP-16",
    n_rings=16,
    # reference: VelodyneCapture.h:534
    vertical_angles_deg=(
        -15.0, 1.0, -13.0, 3.0, -11.0, 5.0, -9.0, 7.0, -7.0, 9.0, -5.0, 11.0,
        -3.0, 13.0, -1.0, 15.0,
    ),
    n_azimuth=2176,
)

HDL64E_SENSOR = SensorConfig(
    name="HDL-64E S2",
    n_rings=64,
    # Firing order, the HDL-64E S2 manual's nominal block spacing (no
    # per-unit calibration): the upper block's lasers 0-31 from +2 deg in
    # steps of 1/3 deg, the lower block's 32-63 from -8.83 deg in steps of
    # 1/2 deg, down to -24.33 deg.
    vertical_angles_deg=(
        tuple(2.0 - i / 3.0 for i in range(32))
        + tuple(-8.83 - j / 2.0 for j in range(32))
    ),
    distance_scale_mm=2.0,
    # ~2083 firings a turn at 10 Hz (1.33 M returns/s over 64 lasers):
    # fewer than the bins, so no two firings of a ring share one.
    n_azimuth=2176,
)

# The VLS-128's datasheet gives its envelope: 128 lasers from +15 to -25
# deg, 0.11 deg apart at the finest.  Velodyne publishes the per-laser
# angles (the user manual's laser table, the VLS-128 calibration file of
# ROS's velodyne_pointcloud package), but neither is in this repository,
# so the angles are assumed inside the envelope, in descending order: 32
# from +15 to +3.3 deg, a central band of 64 at the 0.11 deg minimum from
# +3.0 to -3.93 deg, and 32 from -4.3 to -25 deg.
VLS128_SENSOR = SensorConfig(
    name="VLS-128",
    n_rings=128,
    vertical_angles_deg=(
        tuple(15.0 - i * 11.7 / 31.0 for i in range(32))
        + tuple(3.0 - 0.11 * j for j in range(64))
        + tuple(-4.3 - k * 20.7 / 31.0 for k in range(32))
    ),
    distance_scale_mm=2.0,
    # 1800 firings a turn at 10 Hz (0.2 deg apart): fewer than the bins.
    n_azimuth=2176,
)


@dataclasses.dataclass(frozen=True)
class PreprocessConfig:
    """Spherical range-image preprocessing (reference: include/preprocess.h:41-46)."""

    # Virtual initial ground point: vertical angle (rad) and sensor height (mm)
    # (reference: preprocess.cpp:7 vert_init_=-0.6; preprocess.cpp:55,80-84 z=-2450).
    vert_init_rad: float = -0.6
    sensor_height_mm: float = 2450.0
    # Ground gradient threshold in degrees (reference: preprocess.h:42).
    grad_th_deg: float = 45.0
    # "Lower ground" re-attach height (reference: preprocess.h:43, preprocess.cpp:123).
    lowpt_th_mm: float = -2000.0
    # Threshold-point restart height (reference: preprocess.h:44, preprocess.cpp:146).
    height_th_mm: float = 500.0
    # Occlusion range-jump threshold (reference: preprocess.h:45, preprocess.cpp:185).
    dist_th_mm: float = 3000.0
    # Occlusion azimuth-difference bound in radians (reference: preprocess.h:46).
    angdiff_th_rad: float = 1.0 * math.pi / 180.0
    # Self-car crop box, mm (reference: preprocess.cpp:155-157).
    car_x_mm: Tuple[float, float] = (-820.0, 820.0)
    car_y_mm: Tuple[float, float] = (-1800.0, 1300.0)
    car_z_mm: Tuple[float, float] = (-2000.0, 100.0)
    # Max points emitted per frame after filtering (padded static shape).
    max_points: int = 49152  # 384 * 128


# Point classification codes (reference: rmmap semantics, preprocess.cpp:56-158).
CLASS_KEEP = 0
CLASS_GROUND = 1
CLASS_SELFCAR = 2
CLASS_OCCLUDED = 3


@dataclasses.dataclass(frozen=True)
class KeypointConfig:
    """Segmentation-ratio saliency keypoints (reference: src/lidar_odometry.cpp:51-171)."""

    # Neighborhood radius, mm (reference: lidar_odometry.cpp:68).
    radius_mm: float = 3000.0
    # Reference caps the kd-tree radius search at 300 returned neighbors
    # (lidar_odometry.cpp:70, bshot_bits.h:68).  Default TPU mode evaluates
    # the full radius neighborhood (dense masked compute — no kd-tree);
    # neighbor_cap_mode=True enables the parity approximation: each query's
    # ball shrinks to the radius expected to hold `neighbor_cap` points
    # (ops.keypoints.capped_r2_rows), applied to SR scoring and normals.
    neighbor_cap: int = 300
    neighbor_cap_mode: bool = False
    # Keep the top-k highest seg-ratio points (reference: lidar_odometry.cpp:138).
    top_k: int = 600
    # Saliency variant: "CV" | "CVS" | "CVSN" (reference: lidar_odometry.cpp:83-119;
    # default CV per test/odometry_test.cpp:33).
    sr_type: str = "CV"
    # ISS evaluation detector (reference: lidar_odometry.cpp:447-461).
    iss_salient_radius_mm: float = 60.0
    iss_nonmax_radius_mm: float = 40.0
    iss_gamma_21: float = 0.975
    iss_gamma_32: float = 0.975
    iss_min_neighbors: int = 5
    # Repeatability-evaluation hit radius, mm (reference: lidar_odometry.cpp:402).
    repeat_radius_mm: float = 30.0


@dataclasses.dataclass(frozen=True)
class DescriptorConfig:
    """SHOT-352 → B-SHOT binarization (reference: include/bshot_bits.h)."""

    # Normal-estimation radius (reference: lidar_odometry.cpp:174, bshot_bits.h:68).
    normal_radius_mm: float = 3000.0
    # SHOT support radius (reference: lidar_odometry.cpp:175, bshot_bits.h:118).
    shot_radius_mm: float = 3000.0
    # SHOT grid: 8 azimuth x 2 elevation x 2 radial spatial volumes x 11 cosine
    # bins = 352 floats -> 352 bits after B-SHOT binarization (bshot_bits.h:26).
    n_azimuth_bins: int = 8
    n_elevation_bins: int = 2
    n_radial_bins: int = 2
    n_cosine_bins: int = 11
    # B-SHOT subset-sum threshold (reference: bshot_bits.h:171 "0.9 * sum").
    bshot_threshold: float = 0.9
    # Max neighbors gathered per keypoint for LRF/histogram (static shape).
    max_neighbors: int = 384
    # The reference feeds zero normals for SHOT surface points (bshot_bits.h:59
    # resizes cloud1_normals to the full cloud but only writes keypoint rows
    # 43-94, so SHOT's per-neighbor cosine collapses to the middle bin). The
    # rebuild computes true surface normals; set False to mimic the reference.
    use_surface_normals: bool = True

    @property
    def n_bits(self) -> int:
        return (self.n_azimuth_bins * self.n_elevation_bins * self.n_radial_bins
                * self.n_cosine_bins)

    @property
    def n_words(self) -> int:
        return (self.n_bits + 31) // 32  # 11 x uint32


@dataclasses.dataclass(frozen=True)
class MatchConfig:
    """Mutual-NN Hamming matching + RANSAC (reference: lidar_odometry.cpp:186-265)."""

    # Global-map query AABB half-range, mm (reference: lidar_odometry.cpp:198).
    map_query_range_mm: float = 100000.0
    # RANSAC (reference: lidar_odometry.cpp:255-259).
    ransac_iterations: int = 2000
    ransac_inlier_th_mm: float = 1500.0
    # Pose gating (reference: lidar_odometry.cpp:283).
    gate_heading_deg: float = 10.0
    gate_translation_mm: float = 1200.0
    gate_min_inliers: int = 15
    # ICP refinement (reference: lidar_odometry.cpp:293-299; PCL default 10 iters).
    icp_iterations: int = 10
    icp_max_corr_dist_mm: float = 1.0e9  # PCL default: unbounded
    run_icp: bool = True


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Global voxel-block keypoint map (reference: include/mymap.h, src/mymap.cpp)."""

    # Voxel block edge, mm (reference: mymap.h:50 prec=10000).
    block_size_mm: float = 10000.0
    # Insert dedup: reject if an existing same-block keypoint is closer than
    # this AND has >= seg_ratio (reference: mymap.cpp:17-18).
    dedup_radius_mm: float = 800.0
    # Keypoint position grid snap, mm (reference: keypoint.cpp:25).
    snap_mm: float = 10.0
    # Fixed device-array capacity of the global map (padded static shape).
    capacity: int = 131072  # 2**17


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Pose-graph / bundle-adjustment backend (new capability; the reference
    links g2o but never calls it — reference CMakeLists.txt:86, SURVEY §5)."""

    keyframe_every: int = 5
    keyframe_min_translation_mm: float = 2000.0
    keyframe_min_heading_deg: float = 5.0
    max_keyframes: int = 512
    # Loop closure candidate retrieval.
    lc_min_gap: int = 20
    lc_max_dist_mm: float = 15000.0
    lc_min_inliers: int = 25
    # Appearance channel: top pairs by keyframe B-SHOT bag-of-words cosine
    # similarity (drift-immune retrieval; proximity alone cannot fire once
    # drift exceeds lc_max_dist_mm).
    lc_appearance_top: int = 4
    lc_appearance_min_sim: float = 0.35
    # Pose-graph information weighting (residuals live in meters/radians):
    # edge weight = (1000 / sigma_mm)^2.  Odometry edges are locally precise;
    # loop edges take sigma = max(icp_rmse, floor) so a coarse closure can
    # never out-vote the odometry chain it is meant to gently bend.
    odom_edge_sigma_mm: float = 50.0
    lc_sigma_floor_mm: float = 150.0
    # Gauss-Newton / LM.
    gn_iterations: int = 10
    lm_lambda_init: float = 1.0e-4
    lm_lambda_up: float = 10.0
    lm_lambda_down: float = 0.1
    # BA landmark capacity per solve (static shape).
    ba_max_landmarks: int = 16384
    ba_max_obs_per_landmark: int = 8


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Execution-environment knobs (no reference counterpart).

    `point_tile`, `matmul_dtype`, `exact_topk` and `topk_chunks` are read by
    nothing in the port: they stay so that configurations written for the
    reference (and `slambench/configs/`) still load.  The engine's tile is
    its `tile` argument (tests pass `point_tile` there); every matmul on
    coordinates is true float32, and every top-k is one exact selection,
    ties to the lowest index."""

    point_tile: int = 2048
    # Cloud-capacity ladder: the engine front-compacts each frame's kept
    # points and runs the step at the smallest bucket >= n_valid, so the
    # O(N^2) neighborhood sweeps scale with the live cloud instead of
    # max_points.  One captured step per bucket actually used.
    # (24576 matters: urban HDL-32E frames cluster around 15-20k kept
    # points, and 16384->32768 would double the pair space for them;
    # 12288/20480 shave ~25% off the O(N^2) stages for the 9-11k and
    # 15-18k count bands.)
    cloud_buckets: Tuple[int, ...] = (
        8192, 12288, 16384, 20480, 24576, 32768, 49152
    )
    # Pipelined bucket predictor: next bucket holds headroom * last count,
    # floored by a decaying max of recent counts (fast decay tracks scene
    # shrinkage; slow decay damps overflow thrash on volatile scenes).
    bucket_headroom: float = 1.15
    bucket_floor_decay: float = 0.9
    # Map-capacity ladder: the engine starts the global map at the first
    # bucket and zero-pads it (a new captured step) when the cursor
    # approaches capacity, so matching/ICP/dedup track the map that
    # actually exists instead of MapConfig.capacity.
    map_buckets: Tuple[int, ...] = (16384, 32768, 65536, 131072)
    matmul_dtype: str = "bfloat16"
    # Window compaction: once per frame, map rows whose voxel block
    # intersects the query AABB are gathered into a (window_cap, ...)
    # compact candidate buffer, and matching / ICP NN / insert-dedup run
    # over the compact buffer instead of scanning the whole capacity (the
    # reference iterates only window blocks: mymap.cpp:28-74).  Lossless:
    # when a window holds more than window_cap rows the step aborts on the
    # device and the frame re-runs without windows
    # (`odometry.pipeline.without_windows`).  Off when capacity <=
    # window_cap (small maps scan everything anyway).
    window_compact: bool = True
    window_cap: int = 32768
    exact_topk: bool = False
    topk_chunks: int = 1
    # Mesh axis names for the multi-chip path.
    mesh_axes: Tuple[str, ...] = ("data", "map")


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Top-level config bundle."""

    sensor: SensorConfig = dataclasses.field(default_factory=SensorConfig)
    preprocess: PreprocessConfig = dataclasses.field(default_factory=PreprocessConfig)
    keypoints: KeypointConfig = dataclasses.field(default_factory=KeypointConfig)
    descriptor: DescriptorConfig = dataclasses.field(default_factory=DescriptorConfig)
    match: MatchConfig = dataclasses.field(default_factory=MatchConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    backend: BackendConfig = dataclasses.field(default_factory=BackendConfig)
    runtime: RuntimeConfig = dataclasses.field(default_factory=RuntimeConfig)

    def replace(self, **kwargs) -> "SlamConfig":
        return dataclasses.replace(self, **kwargs)


def default_config() -> SlamConfig:
    return SlamConfig()


def hdl64e_config() -> SlamConfig:
    """The KITTI odometry benchmark's sensor (Geiger, Lenz and Urtasun, CVPR
    2012): a Velodyne HDL-64E S2 1.73 m above the road on a VW Passat, with
    `default_config()`'s settings at full width.  Its clouds hold up to
    131072 kept points (the most that kernels A, B and H take in their
    narrow form), so the cloud ladder goes on past 49152 in coarse steps.
    The self-car box is assumed: the Passat's 4.78 x 1.82 m footprint with
    the sensor over its middle."""
    base = SlamConfig()
    return base.replace(
        sensor=HDL64E_SENSOR,
        preprocess=dataclasses.replace(
            base.preprocess, sensor_height_mm=1730.0, max_points=131072,
            car_x_mm=(-910.0, 910.0), car_y_mm=(-2390.0, 2390.0),
            car_z_mm=(-1730.0, 100.0)),
        runtime=dataclasses.replace(
            base.runtime,
            cloud_buckets=base.runtime.cloud_buckets + (65536, 98304, 131072)),
    )


def vls128_config() -> SlamConfig:
    """A Velodyne Alpha Prime (VLS-128) on a car roof at 10 Hz, as the
    Boreas dataset records Toronto (Burnett et al., IJRR 2023), with
    `default_config()`'s settings at full width.  A sweep is 128 x 1800 =
    230400 rays, and `max_points` is all of them, so no frame is cut: the
    cloud ladder goes on past HDL-64E's 131072 in steps of 32768 (163840,
    196608) to 230400, each step a captured step graph and ~20% more rows
    than a dense street's clouds need at the worst.  Past 131072 rows
    kernels A, B and H run their wide form (`kernels/neighborhood.py`,
    `MAX_ROWS` 262144).  Assumed, not from the source: the angle table
    (`VLS128_SENSOR`), a roof mount 2.0 m above the road and a self-car
    box from a sedan's ~4.9 x 1.9 m footprint with the sensor over its
    middle."""
    base = hdl64e_config()
    return base.replace(
        sensor=VLS128_SENSOR,
        preprocess=dataclasses.replace(
            base.preprocess, sensor_height_mm=2000.0, max_points=230400,
            car_x_mm=(-950.0, 950.0), car_y_mm=(-2450.0, 2450.0),
            car_z_mm=(-2000.0, 100.0)),
        runtime=dataclasses.replace(
            base.runtime,
            cloud_buckets=base.runtime.cloud_buckets + (163840, 196608, 230400)),
    )


def tiny_config() -> SlamConfig:
    """Small static shapes for unit tests and the multi-chip dry run."""
    return SlamConfig(
        sensor=SensorConfig(n_azimuth=256),
        preprocess=PreprocessConfig(max_points=2048),
        keypoints=KeypointConfig(top_k=64),
        descriptor=DescriptorConfig(max_neighbors=64),
        match=MatchConfig(ransac_iterations=128),
        map=MapConfig(capacity=4096),
        backend=BackendConfig(max_keyframes=16, ba_max_landmarks=256,
                              gn_iterations=3),
        runtime=RuntimeConfig(point_tile=256),
    )
