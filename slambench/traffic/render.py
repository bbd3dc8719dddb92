"""The drive the benchmark replays: a fixed urban scene, a circular
trajectory, and Velodyne sweeps ray-cast from it on the device.

A copy of the port's `io/synthetic.py` (`default_scene`,
`straight_trajectory`, `render_sweep` with the default scene's flat
ground and no self-car), rewritten in plain PyTorch so that a whole lap
of sweeps is cast on the card in a few large calls.  Casting runs in
float64, as the numpy original does, so a noise-free return lands on the
same 2 mm distance tick as `render_sweep`'s but where a product rounds
across a half tick.  The range noise comes from a `torch.Generator`
seeded by the run's seed, not from numpy's generator.

Geometry: sensor frame x = d cos(v) sin(a), y = d cos(v) cos(a),
z = d sin(v), azimuth a clockwise from +y, distances in mm.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MAX_RANGE_MM = 100_000.0
INTENSITY = 40


def scene_boxes(layout_seed: int = 0, n_buildings: int = 14, n_poles: int = 24,
                extent_mm: float = 60_000.0) -> np.ndarray:
    """(n, 2, 3) float64 [lo, hi] corners of the scene's axis-aligned boxes:
    `default_scene(layout_seed)`'s buildings flanking a corridor along +y,
    then its poles, with the same draws in the same order."""
    rng = np.random.default_rng(layout_seed)
    boxes = []
    for _ in range(n_buildings):
        side = rng.integers(0, 2)
        w = rng.uniform(4_000, 12_000)
        d = rng.uniform(4_000, 12_000)
        h = rng.uniform(3_000, 15_000)
        near = rng.uniform(6_000, extent_mm)
        x_lo, x_hi = (near, near + w) if side else (-near - w, -near)
        y0 = rng.uniform(-extent_mm, extent_mm * 2)
        boxes.append(((x_lo, y0, 0.0), (x_hi, y0 + d, h)))
    for _ in range(n_poles):
        x0 = rng.uniform(3_000, 5_500) * (1 if rng.integers(0, 2) else -1)
        y0 = rng.uniform(-extent_mm, extent_mm * 2)
        s = rng.uniform(120, 260)
        h = rng.uniform(2_500, 6_000)
        boxes.append(((x0, y0, 0.0), (x0 + s, y0 + s, h)))
    return np.asarray(boxes, np.float64)


def circle_trajectory(n_frames: int, step_mm: float, yaw_rate_rad: float,
                      sensor_height_mm: float) -> np.ndarray:
    """(n, 4, 4) world-from-sensor poses driving along +y at a constant yaw
    rate (`straight_trajectory`)."""
    poses = np.zeros((n_frames, 4, 4), np.float64)
    x, y, yaw = 0.0, 0.0, 0.0
    for i in range(n_frames):
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i, :3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
        poses[i, :3, 3] = (x, y, sensor_height_mm)
        poses[i, 3, 3] = 1.0
        x += -s * step_mm
        y += c * step_mm
        yaw += yaw_rate_rad
    return poses


def firing_azimuths_deg(n_firings: int) -> np.ndarray:
    return (np.arange(n_firings) + 0.5) * (360.0 / n_firings)


def _box_distance(origin: torch.Tensor, dirs: torch.Tensor, inv: torch.Tensor,
                  lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Slab-method distance to one box per ray, inf on a miss.  origin
    (F, 1, 1, 3), dirs and inv (F, R, A, 3)."""
    t0 = (lo - origin) * inv
    t1 = (hi - origin) * inv
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = torch.where(tmin > 0, tmin, tmax)
    return torch.where(hit, t, torch.full_like(t, math.inf))


def cast(poses: np.ndarray, vertical_angles_deg, n_firings: int, boxes: np.ndarray,
         device, ground_z: float = 0.0) -> torch.Tensor:
    """(F, R, A) float64 distance in mm of each firing's first return over
    the ground plane and every box, 0 where nothing lies within range.
    Rings in firing order, azimuths `firing_azimuths_deg`."""
    f64 = torch.float64
    az = torch.deg2rad(torch.as_tensor(firing_azimuths_deg(n_firings), dtype=f64,
                                       device=device))[None, :]
    vert = torch.deg2rad(torch.as_tensor(np.asarray(vertical_angles_deg, np.float64),
                                         dtype=f64, device=device))[:, None]
    d_local = torch.stack([torch.cos(vert) * torch.sin(az),
                           torch.cos(vert) * torch.cos(az),
                           torch.sin(vert) * torch.ones_like(az)], dim=-1)  # (R, A, 3)
    P = torch.as_tensor(poses, dtype=f64, device=device)
    R, origin = P[:, :3, :3], P[:, None, None, :3, 3]
    dirs = torch.einsum("rak,fjk->fraj", d_local, R)  # d_local @ R.T per frame
    dz = dirs[..., 2]
    down = dz < -1e-9
    t = torch.where(down, (ground_z - origin[..., 2]) / torch.where(down, dz, 1.0),
                    torch.full_like(dz, math.inf))
    t = torch.where(t > 0, t, torch.full_like(t, math.inf))
    inv = 1.0 / torch.where(dirs.abs() < 1e-12, torch.full_like(dirs, 1e-12), dirs)
    bx = torch.as_tensor(boxes, dtype=f64, device=device)
    for lo, hi in zip(bx[:, 0], bx[:, 1]):
        t = torch.minimum(t, _box_distance(origin, dirs, inv, lo, hi))
    return torch.where(torch.isfinite(t) & (t < MAX_RANGE_MM), t, torch.zeros_like(t))


def render_ticks(poses: np.ndarray, vertical_angles_deg, n_firings: int,
                 boxes: np.ndarray, distance_scale_mm: float, noise_mm: float,
                 generator: torch.Generator | None, device,
                 frames_per_call: int = 16) -> np.ndarray:
    """(F, A * R) uint16 raw distance ticks of each sweep in firing order
    (azimuth-major, as a `LaserSweep` holds them), cast on `device` in
    batches of `frames_per_call` frames and copied to the host once.  With
    `noise_mm` each return gets Gaussian range noise drawn from
    `generator`, floored at 1 mm."""
    out = []
    for f0 in range(0, len(poses), frames_per_call):
        d = cast(poses[f0:f0 + frames_per_call], vertical_angles_deg, n_firings,
                 boxes, device)
        if noise_mm > 0:
            noise = torch.randn(d.shape, generator=generator, dtype=d.dtype,
                                device=device)
            d = torch.where(d > 0, torch.clamp(d + noise * noise_mm, min=1.0), d)
        ticks = torch.round(d / distance_scale_mm).to(torch.int32)
        out.append(ticks.transpose(1, 2).reshape(ticks.shape[0], -1))
    return torch.cat(out).cpu().numpy().astype(np.uint16)


def sweep_arrays(n_rings: int, n_firings: int) -> dict:
    """The arrays every sweep of a sensor shares: azimuth in degrees, ring
    index in firing order, intensity."""
    return {
        "azimuth_deg": np.repeat(firing_azimuths_deg(n_firings), n_rings),
        "ring": np.tile(np.arange(n_rings, dtype=np.int32), n_firings),
        "intensity": np.full(n_rings * n_firings, INTENSITY, np.uint8),
    }
