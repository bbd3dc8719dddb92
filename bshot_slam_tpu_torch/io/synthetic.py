"""Deterministic synthetic Velodyne scenes for tests and benchmarks.

The reference is only ever exercised against proprietary PCAP logs that are
not in its tree; its "fixtures" are hand-labeled point lists (reference:
test/pointpicking.cpp).  The rebuild instead ray-casts a procedurally
generated urban block (ground plane + axis-aligned buildings + poles) from a
moving sensor, producing raw `LaserSweep`s byte-compatible with the PCAP
decoder output, so every pipeline stage has a ground-truth-posed input.

Geometry conventions match the reference exactly: sensor frame
x = d*cos(v)*sin(a), y = d*cos(v)*cos(a), z = d*sin(v) with azimuth a
clockwise from +y (reference: src/preprocess.cpp:50-52), distances in mm,
sensor mounted `sensor_height_mm` above ground (reference:
src/preprocess.cpp:55,82 virtual ground at z=-2450).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from bshot_slam_tpu_torch.config import PreprocessConfig, SensorConfig
from bshot_slam_tpu_torch.io.velodyne import LaserSweep

MAX_RANGE_MM = 100_000.0


@dataclasses.dataclass(frozen=True)
class Box:
    """Axis-aligned box in world coordinates (mm)."""

    lo: Tuple[float, float, float]
    hi: Tuple[float, float, float]


@dataclasses.dataclass
class Scene:
    boxes: List[Box]
    ground_z: float = 0.0
    # Optional gentle ground undulation: z = ground_z + amp*sin(x/lx)*sin(y/ly)
    ground_amp: float = 0.0
    ground_wavelength: float = 40_000.0


def default_scene(seed: int = 0, n_buildings: int = 14, n_poles: int = 24,
                  extent_mm: float = 60_000.0) -> Scene:
    """A deterministic city-block scene around the trajectory corridor."""
    rng = np.random.default_rng(seed)
    boxes: List[Box] = []
    for _ in range(n_buildings):
        side = rng.integers(0, 2)  # buildings flank a corridor along +y
        w = rng.uniform(4_000, 12_000)
        d = rng.uniform(4_000, 12_000)
        h = rng.uniform(3_000, 15_000)
        # Near facade at >= 6 m from the corridor centerline on either
        # side; the box must extend AWAY from the corridor (a signed x0
        # with +w used to let left-side buildings straddle x=0, putting
        # the sensor inside a box mid-sequence — every ray then hits the
        # interior and preprocessing/odometry degrade into nonsense).
        near = rng.uniform(6_000, extent_mm)
        x_lo, x_hi = (near, near + w) if side else (-near - w, -near)
        y0 = rng.uniform(-extent_mm, extent_mm * 2)
        boxes.append(Box((x_lo, y0, 0.0), (x_hi, y0 + d, h)))
    for _ in range(n_poles):
        x0 = rng.uniform(3_000, 5_500) * (1 if rng.integers(0, 2) else -1)
        y0 = rng.uniform(-extent_mm, extent_mm * 2)
        s = rng.uniform(120, 260)
        h = rng.uniform(2_500, 6_000)
        boxes.append(Box((x0, y0, 0.0), (x0 + s, y0 + s, h)))
    return Scene(boxes=boxes)


def adversarial_scene(seed: int = 0, extent_mm: float = 60_000.0) -> Scene:
    """default_scene hardened for adversarial evaluation (VERDICT r2 item 9):
    undulating ground (exercises the stateful ground-walk thresholds,
    reference preprocess.cpp:73-166), plus low clutter boxes near the
    corridor (curbs, bins, parked cars) that ground removal must NOT eat."""
    rng = np.random.default_rng(seed + 1000)
    scene = default_scene(seed)
    boxes = list(scene.boxes)
    for _ in range(16):
        x0 = rng.uniform(2_500, 5_800) * (1 if rng.integers(0, 2) else -1)
        y0 = rng.uniform(-extent_mm, extent_mm * 2)
        w = rng.uniform(300, 2_200)
        d = rng.uniform(300, 4_000)
        h = rng.uniform(200, 1_500)  # low: the hard case for ground removal
        boxes.append(Box((x0, y0, 0.0), (x0 + w, y0 + d, h)))
    # Periodic NEAR-FIELD clutter (parked cars / bins at 2.6-4.5 m lateral):
    # these become the lowest rings' first returns, where the virtual-seed
    # geometry (vert_init) decides whether the ground walk eats them — the
    # failure mode PCP_SP_initpos_analysis.m measures.
    for k in range(-2, 26):
        side = 1 if k % 2 == 0 else -1
        x0 = side * rng.uniform(2_600, 4_500)
        w = rng.uniform(600, 1_600) * side
        y0 = k * 5_000.0 + rng.uniform(-800, 800)
        h = rng.uniform(800, 1_500)
        lo_x, hi_x = min(x0, x0 + w), max(x0, x0 + w)
        boxes.append(Box((lo_x, y0, 0.0), (hi_x, y0 + rng.uniform(800, 3_000), h)))
    return Scene(boxes=boxes, ground_amp=300.0, ground_wavelength=25_000.0)


# Self-car body rendered in the SENSOR frame (moves with the sensor): the
# reference's crop box is x in [-820,820], y in [-1800,1300], z in
# [-2000,100] (preprocess.cpp:155-157); the rendered body top sits 800 mm
# below the sensor (mast-mounted unit) so only the steepest rings return
# off it in the rear sector, instead of the body shadowing every low ring.
_SELF_CAR_LO = np.array([-820.0, -1800.0, -2000.0])
_SELF_CAR_HI = np.array([820.0, 1300.0, -800.0])


def _ray_ground(origin: np.ndarray, dirs: np.ndarray, scene: Scene) -> np.ndarray:
    """Distance to the ground surface per ray; inf if none. dirs: (..., 3)."""
    dz = dirs[..., 2]
    t = np.where(dz < -1e-9, (scene.ground_z - origin[2]) / np.where(dz < -1e-9, dz, 1.0), np.inf)
    if scene.ground_amp != 0.0:
        # One Newton-ish refinement against the undulating surface.
        for _ in range(2):
            t_safe = np.where(np.isfinite(t), t, 0.0)
            p = origin[None, :] + t_safe[..., None] * dirs
            gz = scene.ground_z + scene.ground_amp * np.sin(
                p[..., 0] / scene.ground_wavelength
            ) * np.sin(p[..., 1] / scene.ground_wavelength)
            dz_safe = np.where(dz < -1e-9, dz, -1.0)
            t = np.where(
                np.isfinite(t) & (dz < -1e-9), (gz - origin[2]) / dz_safe, t
            )
    return np.where(t > 0, t, np.inf)


def _ray_box(origin: np.ndarray, dirs: np.ndarray, box: Box) -> np.ndarray:
    """Slab-method ray/AABB intersection distance; inf if miss."""
    lo = np.asarray(box.lo) - origin
    hi = np.asarray(box.hi) - origin
    inv = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
    t0 = lo * inv
    t1 = hi * inv
    tmin = np.max(np.minimum(t0, t1), axis=-1)
    tmax = np.min(np.maximum(t0, t1), axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(tmin > 0, tmin, tmax)
    return np.where(hit, t, np.inf)


def raycast(
    origin: np.ndarray,
    dirs: np.ndarray,
    scene: Scene,
    max_range: float = MAX_RANGE_MM,
) -> np.ndarray:
    """Min hit distance per ray over ground + all boxes; 0.0 where no return."""
    t = _ray_ground(origin, dirs, scene)
    for box in scene.boxes:
        t = np.minimum(t, _ray_box(origin, dirs, box))
    return np.where(np.isfinite(t) & (t < max_range), t, 0.0)


def render_sweep(
    scene: Scene,
    sensor: SensorConfig,
    pose: np.ndarray,
    pre: PreprocessConfig | None = None,
    noise_mm: float = 0.0,
    seed: int = 0,
    n_firings: int | None = None,
    self_car: bool = False,
) -> LaserSweep:
    """Ray-cast one full rotation from `pose` (4x4 world<-sensor, mm).

    Output distances are raw 2 mm ticks like the hardware (reference:
    VelodyneCapture.h:511-512), so render -> decode -> preprocess exercises
    the same integer quantization as real captures.
    """
    pre = pre or PreprocessConfig()
    if n_firings is None:
        n_firings = sensor.n_azimuth
    az_deg = (np.arange(n_firings) + 0.5) * (360.0 / n_firings)
    vert_deg = np.asarray(sensor.vertical_angles_deg)  # firing order
    az = np.deg2rad(az_deg)[None, :]  # (1, A)
    vert = np.deg2rad(vert_deg)[:, None]  # (R, 1)
    # Sensor-frame ray directions (reference: preprocess.cpp:50-52).
    d_local = np.stack(
        [
            np.cos(vert) * np.sin(az) * np.ones_like(az),
            np.cos(vert) * np.cos(az) * np.ones_like(az),
            np.sin(vert) * np.ones_like(az),
        ],
        axis=-1,
    )  # (R, A, 3)
    R = pose[:3, :3]
    origin = pose[:3, 3]
    d_world = d_local @ R.T
    dist = raycast(origin, d_world, scene)  # (R, A) mm
    if self_car:
        # Intersect in the sensor frame (the body travels with the sensor);
        # nearer car hits shadow the world behind them.
        t_car = _ray_box(
            np.zeros(3), d_local, Box(tuple(_SELF_CAR_LO), tuple(_SELF_CAR_HI))
        )
        t_car = np.where(np.isfinite(t_car), t_car, np.inf)
        dist = np.where(
            t_car < np.where(dist > 0, dist, np.inf), t_car, dist
        )
    if noise_mm > 0:
        rng = np.random.default_rng(seed)
        dist = np.where(
            dist > 0, np.maximum(dist + rng.normal(0, noise_mm, dist.shape), 1.0), 0.0
        )
    ticks = np.round(dist / sensor.distance_scale_mm).astype(np.uint16)
    n_rings, n_az = ticks.shape
    return LaserSweep(
        azimuth_deg=np.repeat(az_deg, n_rings),
        ring=np.tile(np.arange(n_rings, dtype=np.int32), n_az),
        distance=ticks.T.reshape(-1),
        intensity=np.full(n_rings * n_az, 40, np.uint8),
        timestamp_us=seed,
    )


def straight_trajectory(
    n_frames: int,
    step_mm: float = 400.0,
    sensor_height_mm: float = 2450.0,
    yaw_rate_rad: float = 0.0,
) -> np.ndarray:
    """(n, 4, 4) poses driving along +y with optional constant yaw rate."""
    poses = np.zeros((n_frames, 4, 4), np.float64)
    x, y, yaw = 0.0, 0.0, 0.0
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        Rz = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        poses[i, :3, :3] = Rz
        poses[i, :3, 3] = (x, y, sensor_height_mm)
        poses[i, 3, 3] = 1.0
        # Heading is +y in the sensor frame (reference gate heading vector,
        # src/lidar_odometry.cpp:272).
        x += -s * step_mm
        y += c * step_mm
        yaw += yaw_rate_rad
    return poses


def render_sequence(
    n_frames: int,
    sensor: SensorConfig,
    scene: Scene | None = None,
    step_mm: float = 400.0,
    yaw_rate_rad: float = 0.0,
    noise_mm: float = 0.0,
    seed: int = 0,
    n_firings: int | None = None,
    adversarial: bool = False,
) -> Tuple[List[LaserSweep], np.ndarray]:
    """Render a posed sweep sequence; returns (sweeps, gt_poses (n,4,4)).

    `adversarial` swaps in the hardened scene (ground undulation + low
    clutter) and renders self-car returns."""
    if scene is None:
        scene = adversarial_scene(seed) if adversarial else default_scene(seed)
    poses = straight_trajectory(n_frames, step_mm=step_mm,
                                yaw_rate_rad=yaw_rate_rad)
    sweeps = [
        render_sweep(scene, sensor, poses[i], noise_mm=noise_mm, seed=seed + i,
                     n_firings=n_firings, self_car=adversarial)
        for i in range(n_frames)
    ]
    return sweeps, poses
