"""The sweep preprocess's ground walk: CUDA kernel F and its plain version.

F, `ground_walk`, has no Pallas counterpart: it is the port's form of the
`lax.scan` over rings in bshot_slam_tpu/ops/preprocess.py:_ground_scan
(reference: src/preprocess.cpp:73-166).  Every azimuth column of an
(R, A) range image is walked bottom-up, ring by ring, from a virtual ground
point `p0` under the sensor, and each cell gets a class code of
`config.py` (keep, ground or self-car; occlusion is a later pass).

The CUDA side (csrc/preprocess.cu) is one launch per call: blocks of 32
columns and 8 warps stage their rings in shared memory with coalesced
loads and compute every cell's gradient and previous-point norm (which
read only loaded points), a ring per warp; then one warp, a thread per
column, walks the rings with the walk's five state variables in
registers.  The plain version steps the rings in a Python loop with every
column in parallel, one PyTorch operation per arithmetic step, so neither
side contracts a product into an FMA; the kernel repeats those steps with
the _rn intrinsics, and the classes agree cell for cell.  The work per
cell, in f32 instructions, is `GROUND_WALK_CELL_OPS`; `chip_smoke.py`
turns it into the bound at the main path's shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from bshot_slam_tpu_torch.config import (
    CLASS_GROUND, CLASS_KEEP, CLASS_SELFCAR, PreprocessConfig,
)
from bshot_slam_tpu_torch.kernels import _build, on_cpu, ptr, require, stream_arg

EPS = 1e-6
RAD2DEG = float(np.float32(180.0 / np.pi))
# f32 instructions per cell (square root, quotient and asin one each): 3
# differences, 5 for each of the two norms, 2 square roots, the epsilon,
# the quotient, 2 for the clamp, asin, the degrees, the height difference
# and 14 compares.
GROUND_WALK_CELL_OPS = {"f32": 36}


def f32(x: float) -> float:
    """x rounded to float32: thresholds compare in the tensors' precision."""
    return float(np.float32(x))


def thresholds(cfg: PreprocessConfig) -> tuple:
    """The walk's thresholds in float32, in the kernel's argument order."""
    return tuple(f32(v) for v in (cfg.grad_th_deg, cfg.lowpt_th_mm,
                                  cfg.height_th_mm, *cfg.car_x_mm,
                                  *cfg.car_y_mm, *cfg.car_z_mm))


def _norm(v: torch.Tensor) -> torch.Tensor:
    """|v| over a last axis of 3 as sqrt((x*x + y*y) + z*z), unfused."""
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    return torch.sqrt(x * x + y * y + z * z)


def ground_walk_plain(range_mm: torch.Tensor, xyz: torch.Tensor,
                      p0: torch.Tensor, cfg: PreprocessConfig) -> torch.Tensor:
    """Plain PyTorch version of kernel F: the rules of the reference's walk
    (preprocess.cpp:99-158) in order, all columns at once, ring by ring."""
    grad_th, lowpt, height_th, x0, x1, y0, y1, z0, z1 = thresholds(cfg)
    R, A = range_mm.shape
    dev = range_mm.device
    pig = torch.ones((A,), dtype=torch.bool, device=dev)
    lost = torch.zeros((A,), dtype=torch.bool, device=dev)
    set_th = torch.zeros((A,), dtype=torch.bool, device=dev)
    p_prev, p_th = p0, p0
    rows = []
    for i in range(R):
        d, p = range_mm[i], xyz[i]
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        diff = p - p_prev
        s = torch.clamp(diff[:, 2] / (_norm(diff) + EPS), -1.0, 1.0)
        grad = torch.asin(s) * RAD2DEG
        norm_prev = _norm(p_prev)

        # Rule 1: remember a threshold point (preprocess.cpp:99-103).
        cond1 = pig & ((grad > grad_th) | (d == 0) | (d < norm_prev))
        set_th = set_th | cond1
        p_th = torch.where(cond1[:, None], p_prev, p_th)
        # Rule 2: ground continuation / lower-ground re-attach (:105-127).
        g_keep = pig & (grad < grad_th) & ~lost
        lower = ~pig & (z < lowpt) & (grad < grad_th)
        pig = g_keep | lower
        cls = torch.where(pig, CLASS_GROUND, CLASS_KEEP)
        set_th = set_th & ~lower
        # Rule 3: lost point (:129-136).
        lost = d == 0
        cls = torch.where(lost, CLASS_GROUND, cls)
        pig = pig & ~lost
        # Rule 4: range shortened against the previous point (:138-141).
        shorten = (d < norm_prev) & ~lost
        cls = torch.where(shorten, CLASS_KEEP, cls)
        pig = pig & ~shorten
        # Rule 5: threshold-point restart (:146-150).
        restart = set_th & ((z - p_th[:, 2]) < height_th) & (z < p_prev[:, 2])
        set_th = set_th & ~restart
        cls = torch.where(restart, CLASS_GROUND, cls)
        pig = pig | restart
        # Rule 6: self-car crop box (:155-158).
        incar = ((x >= x0) & (x <= x1) & (y >= y0) & (y <= y1)
                 & (z >= z0) & (z <= z1))
        rows.append(torch.where(incar, CLASS_SELFCAR, cls))
        p_prev = p
    return torch.stack(rows).to(torch.int32)


def ground_walk(range_mm: torch.Tensor, xyz: torch.Tensor, p0: torch.Tensor,
                cfg: PreprocessConfig) -> torch.Tensor:
    """(R, A) int32 classes of the bottom-up ground walk over range_mm
    (R, A) f32 and its points xyz (R, A, 3) f32, from the virtual ground
    point p0 (A, 3) f32 of each column."""
    if on_cpu(range_mm, xyz, p0):
        return ground_walk_plain(range_mm, xyz, p0, cfg)
    R, A = range_mm.shape
    require(range_mm, "range_mm", torch.float32, (R, A))
    require(xyz, "xyz", torch.float32, (R, A, 3))
    require(p0, "p0", torch.float32, (A, 3))
    out = torch.empty((R, A), dtype=torch.int32, device=range_mm.device)
    P, I, F = _build.P, _build.I, _build.F
    fn = _build.bind("preprocess", "bshot_ground_walk",
                     [P, P, P, I, I] + [F] * 9 + [P, P])
    _build.check(fn(ptr(range_mm), ptr(xyz), ptr(p0), R, A, *thresholds(cfg),
                    ptr(out), stream_arg(range_mm.device)), "ground_walk")
    ground_walk.launches += 1
    return out


ground_walk.launches = 0
