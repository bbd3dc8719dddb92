"""Host-side SLAM engine: sweeps in, poses out.

Port of `bshot_slam_tpu.odometry.engine` (the synchronous host-preprocess
path): each sweep is binned into a range image, classified and extracted on
the host (numpy), padded to the smallest cloud bucket that holds it, and
stepped on the device; the packed diagnostics come back in one transfer.

Runs on the card unless the caller asks for the CPU: `device=None` means
"cuda", and raises when no card is visible.  Not ported yet (they raise
NotImplementedError): the pipelined engine, the fused device preprocess,
the backend, multi-device meshes, correspondence retention, the native C
preprocess, and map eviction at the hard capacity.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterable, List, Optional

import numpy as np
import torch

from bshot_slam_tpu_torch.config import SlamConfig
from bshot_slam_tpu_torch.io.velodyne import LaserSweep
from bshot_slam_tpu_torch.odometry import mapstore, pipeline
from bshot_slam_tpu_torch.ops import preprocess_host as ph
from bshot_slam_tpu_torch.ops.rangeimage import build_range_image


def resolve_device(device=None) -> torch.device:
    """`None` -> the card; raises when CUDA is asked for but not visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def pick_bucket(n_valid: int, cfg: SlamConfig) -> int:
    """Smallest configured cloud bucket holding n_valid points (capped at
    max_points; buckets above the cap are ignored)."""
    cap = cfg.preprocess.max_points
    for b in sorted(cfg.runtime.cloud_buckets):
        if n_valid <= b <= cap:
            return b
    return cap


@dataclasses.dataclass
class FrameRecord:
    pose: np.ndarray  # (4, 4)
    n_inliers: int
    n_mutual: int
    gated: bool
    map_size: int
    icp_rmse: float
    corr_stats: np.ndarray  # (mean, SD, median) inlier distance, mm
    n_dropped: int = 0  # cumulative keypoints lost at the capacity ceiling


class SlamEngine:
    """Streaming scan-to-map odometry over a sweep source.

    `draws`, when given, supplies each frame's (H, 3) uniform RANSAC draws
    in order (tests inject the reference's); otherwise they come from a
    `torch.Generator` on the engine's device seeded with `seed`."""

    def __init__(self, cfg: SlamConfig, seed: int = 0, tile: int = 2048,
                 device=None, draws: Optional[Iterable] = None,
                 enable_backend: bool = False, backend_every: int = 0,
                 pipelined: bool = False, fetch_every: int = 1,
                 host_preprocess: bool = True, keep_corr: bool = False,
                 mesh=None):
        unported = {
            "enable_backend": enable_backend or backend_every,
            "pipelined": pipelined or fetch_every != 1,
            "host_preprocess=False": not host_preprocess,
            "keep_corr": keep_corr,
            "mesh": mesh is not None,
        }
        for name, asked in unported.items():
            if asked:
                raise NotImplementedError(f"SlamEngine({name}) is not ported yet")
        self.cfg = cfg
        self.tile = tile
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._draws = iter(draws) if draws is not None else None
        self.state = pipeline.init_state(cfg, device=self.device)
        # Start the map at the smallest capacity bucket; _maybe_grow_map
        # widens it as the map fills.
        first = min(
            [b for b in cfg.runtime.map_buckets if b <= cfg.map.capacity]
            or [cfg.map.capacity]
        )
        self.state = self.state._replace(
            map=mapstore.init_map(cfg.map, first, device=self.device)
        )
        self.records: List[FrameRecord] = []
        self._warned_drop = False

    def process_sweep(self, sweep: LaserSweep,
                      selected: Optional[np.ndarray] = None) -> FrameRecord:
        ri = build_range_image(sweep, self.cfg.sensor, selected)
        return self.process_range_image(ri.range_mm, ri.azimuth_rad,
                                        ri.vert_rad, ri.selected)

    def process_range_image(self, range_mm: np.ndarray, azimuth_rad: np.ndarray,
                            vert_rad: np.ndarray,
                            selected: Optional[np.ndarray] = None) -> FrameRecord:
        """Host classify + extract (numpy), then one compact device step at
        the smallest bucket holding the kept points."""
        classes, xyz, valid = ph.preprocess_host(range_mm, azimuth_rad, vert_rad,
                                                 self.cfg.preprocess)
        pts, nv = ph.extract_cloud_host(classes, xyz, valid, selected,
                                        self.cfg.preprocess.max_points)
        b = pick_bucket(nv, self.cfg)
        points = np.zeros((b, 3), np.float32)
        points[:nv] = pts
        return self.process_compact(points, nv)

    def _next_rng(self):
        if self._draws is None:
            return self.generator
        return torch.tensor(np.asarray(next(self._draws), np.float32),
                            device=self.device)

    def process_compact(self, points: np.ndarray, n_valid: int) -> FrameRecord:
        """One frame from a host-preprocessed compact cloud: points
        (bucket, 3) front-compacted, n_valid exact."""
        self._maybe_grow_map()
        self.state, diag = pipeline.odometry_step_compact(
            self.state, torch.as_tensor(points, device=self.device),
            int(n_valid), self._next_rng(), self.cfg, self.tile,
        )
        return self._finalize(diag.packed.cpu().numpy())

    def _finalize(self, pk: np.ndarray) -> FrameRecord:
        P = pipeline
        rec = FrameRecord(
            pose=pk[:16].reshape(4, 4).astype(np.float32),
            n_inliers=int(pk[P.IDX_N_INLIERS]),
            n_mutual=int(pk[P.IDX_N_MUTUAL]),
            gated=bool(pk[P.IDX_GATED] > 0),
            map_size=int(pk[P.IDX_MAP_SIZE]),
            icp_rmse=float(pk[P.IDX_ICP_RMSE]),
            corr_stats=pk[P.IDX_CORR_STATS:P.IDX_CORR_STATS + 3].copy(),
            n_dropped=int(pk[P.IDX_N_DROPPED]),
        )
        if rec.n_dropped > 0 and not self._warned_drop:
            self._warned_drop = True
            warnings.warn(
                f"map capacity {self.cfg.map.capacity} saturated at frame "
                f"{len(self.records)}: {rec.n_dropped} keypoint(s) dropped",
                stacklevel=2,
            )
        self.records.append(rec)
        return rec

    def _maybe_grow_map(self) -> None:
        """Pad the map to the next capacity bucket when this frame's insert
        could overflow it."""
        cap = self.state.map.positions.shape[0]
        hard_cap = self.cfg.map.capacity
        need = int(self.state.map.cursor) + self.cfg.keypoints.top_k
        if need <= cap:
            return
        for b in sorted(set(self.cfg.runtime.map_buckets) | {hard_cap}):
            if min(need, hard_cap) <= b <= hard_cap and b > cap:
                self.state = self.state._replace(
                    map=mapstore.grow_map(self.state.map, b)
                )
                return
        if need > hard_cap:
            raise NotImplementedError(
                f"map at hard capacity {hard_cap}: eviction is not ported yet"
            )

    @property
    def trajectory(self) -> np.ndarray:
        """(n, 3) positions."""
        if not self.records:
            return np.zeros((0, 3))
        return np.stack([r.pose[:3, 3] for r in self.records])

    @property
    def poses(self) -> np.ndarray:
        if not self.records:
            return np.zeros((0, 4, 4))
        return np.stack([r.pose for r in self.records])
