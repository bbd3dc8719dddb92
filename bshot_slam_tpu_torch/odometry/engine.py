"""Host-side SLAM engine: sweeps in, poses out.

Port of `bshot_slam_tpu.odometry.engine`.  By default each sweep is
binned into a range image, classified and extracted on the host (the
native C++ library of `io.native_decoder`, as the reference does when its
library is built; `ops.preprocess_host` is its plain version), padded to
the smallest cloud bucket that holds it, and stepped on the device.  With
`host_preprocess=False` the range image goes to the device and is
classified and extracted there (`ops.preprocess`, kernel F's ground walk):
the synchronous engine reads the kept count (one sync per frame) to pick
the exact bucket; the pipelined engine reads it once, on the first frame,
and then predicts each frame's bucket from the counts in the fetched rows
(`runtime.bucket_headroom`, a floor decaying by `bucket_floor_decay`); a
frame whose kept points overflow the predicted bucket aborts on the device
and is re-run at its exact bucket.
The synchronous engine fetches each frame's packed diagnostics at once.
The pipelined engine (`pipelined=True`) dispatches each frame
without a host sync (`pipeline.odometry_step_deferred`) and fetches the
rows of `fetch_every` frames in one device-to-host copy; a frame whose
match or dedup window overflowed aborts on the device, and at the drain it
and every later in-flight frame are re-run in order through the
synchronous step with the clouds and RANSAC draws they were dispatched
with, so the records are the synchronous engine's.  At the map's hard
capacity the weakest keypoints of the densest blocks are evicted.  The
optional backend (`enable_backend`) collects keyframes, and
`optimize_backend` / `apply_backend_corrections` run loop closure, the
pose graph and map re-anchoring (every `backend_every` frames, or when
asked); `build_ba_problem` assembles a bundle adjustment.

Runs on the card unless the caller asks for the CPU: `device=None` means
"cuda", and raises when no card is visible.

With `mesh` (a `DeviceMesh` from `parallel.sharded.make_mesh` or
`parallel.multihost.host_mesh`) the engine runs SPMD: every rank of the
mesh runs this engine over the same input, the map's rows sharded along
`map_axis` (a `mapstore.MapShard` on each rank) and each cloud's query rows
along `data_axis`, with `mesh_runtime_overrides` applied; growth pads each
shard, eviction gathers the map and shards it again, corrections are
row-local, and records, keyframes and the backend are every rank's alike.
The records equal those of one device with the same overrides, bit for
bit.  `device=None` is then the rank's device.  As in the reference, the
pipelined device-preprocess path (`host_preprocess=False,
pipelined=True`) stays single-device.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from bshot_slam_tpu_torch.backend import keyframes as kf_mod
from bshot_slam_tpu_torch.config import SlamConfig
from bshot_slam_tpu_torch.device import resolve_device, upload
from bshot_slam_tpu_torch.io import native_decoder
from bshot_slam_tpu_torch.io.velodyne import LaserSweep
from bshot_slam_tpu_torch.odometry import mapstore, pipeline
from bshot_slam_tpu_torch.ops.rangeimage import RangeImage, build_range_image
from bshot_slam_tpu_torch.parallel import comm, layout


def pick_bucket(n_valid: int, cfg: SlamConfig) -> int:
    """Smallest configured cloud bucket holding n_valid points (capped at
    max_points; buckets above the cap are ignored)."""
    cap = cfg.preprocess.max_points
    for b in sorted(cfg.runtime.cloud_buckets):
        if n_valid <= b <= cap:
            return b
    return cap


def host_cloud(range_mm: np.ndarray, azimuth_rad: np.ndarray,
               vert_rad: np.ndarray, selected: Optional[np.ndarray],
               cfg: SlamConfig):
    """The engine's host ingest of one range image: native classify + compact
    extract, padded with zeros to the smallest bucket holding the kept
    points.  Returns (points (bucket, 3) float32, n_valid)."""
    pts, nv, _ = native_decoder.preprocess_extract_native(
        range_mm, azimuth_rad, vert_rad, cfg.preprocess, selected,
        cfg.preprocess.max_points)
    points = np.zeros((pick_bucket(nv, cfg), 3), np.float32)
    points[:nv] = pts
    return points, nv


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


class _Pending(NamedTuple):
    """One in-flight pipelined frame awaiting its diagnostics drain, with
    what a re-run needs: its cloud (or, for a frame preprocessed on the
    device, its range image) and its RANSAC draws."""

    diag: pipeline.StepDiagnostics  # device tensors (features for keyframes)
    points: Optional[torch.Tensor]  # (bucket, 3) cloud on the device
    pmask: Optional[torch.Tensor]  # None: front-compacted, iota < n_valid
    n_valid: object  # int or () device tensor
    draws: torch.Tensor  # (H, 3) RANSAC draws
    map_cap: int  # map capacity at dispatch (the tail block's offset)
    image: Optional[tuple] = None  # (range_az, vert, sel) on the device


class SlamEngine:
    """Streaming scan-to-map odometry over a sweep source, with an optional
    keyframe / loop-closure / pose-graph backend.

    `draws`, when given, supplies the (H, 3) uniform RANSAC draws of each
    frame and of each verified loop-closure pair, in the order they are
    used (tests inject the reference's); otherwise they come from a
    `torch.Generator` on the engine's device seeded with `seed`.

    `pipelined=True`: `process_*` returns the newest finalized record (None
    until one exists); records lag by up to `fetch_every` frames until the
    next drain; call `flush()` after the last frame.  Keyframing runs at
    drain time from the retained device features, and a periodic backend
    pass drains everything first, so corrections land at the same frame as
    in the synchronous engine."""

    def __init__(self, cfg: SlamConfig, seed: int = 0, tile: int = 2048,
                 device=None, draws: Optional[Iterable] = None,
                 enable_backend: bool = False, backend_every: int = 0,
                 pipelined: bool = False, fetch_every: int = 1,
                 host_preprocess: bool = True, keep_corr: bool = False,
                 mesh=None, data_axis: str = "data", map_axis: str = "map"):
        self.mesh = mesh
        self.axes = None
        self._map_ranks = 1
        if mesh is not None:
            from bshot_slam_tpu_torch.parallel import sharded

            if not host_preprocess and pipelined:
                raise ValueError(
                    "mesh mode requires the host-preprocess ingest "
                    "(host_preprocess=True) in pipelined mode; the fused "
                    "device-preprocess path is single-device-only")
            self.axes = sharded.mesh_axes(mesh, data_axis, map_axis)
            self._map_ranks = self.axes.map.size
            cfg = sharded.mesh_runtime_overrides(cfg, self.axes.data.size)
            if device is None:
                device = sharded.mesh_device(mesh)
        self.map_axis = map_axis
        self.cfg = cfg
        self.host_preprocess = host_preprocess
        self.tile = tile
        self.device = resolve_device(device)
        self.seed = seed
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._draws = iter(draws) if draws is not None else None
        self.state = pipeline.init_state(cfg, device=self.device)
        # Start the map at the smallest capacity bucket; _maybe_grow_map
        # widens it as the map fills.
        first = min(
            [b for b in cfg.runtime.map_buckets if b <= cfg.map.capacity]
            or [cfg.map.capacity]
        )
        self.state = self.state._replace(map=self._new_map(first))
        self.records: List[FrameRecord] = []
        self._warned_drop = False
        self._warned_evict = False
        self.n_evicted = 0  # cumulative keypoints evicted at capacity
        # Pipelined mode.
        self.pipelined = pipelined
        self.fetch_every = max(1, fetch_every)
        self._pending: List[_Pending] = []
        self._fetch = None  # (entries, pinned rows, event) of a started copy
        self._ok = torch.ones((), dtype=torch.bool, device=self.device)
        self._cursor_ub: Optional[int] = None  # host bound on map.cursor
        self._frames_in = 0  # frames dispatched
        self.n_redispatched = 0  # frames re-run after a window or bucket overflow
        # Device preprocess: the vertical angles kept on the device by their
        # bytes, and the pipelined engine's predicted cloud bucket (None
        # until the first frame's count is read) and its decaying floor.
        self._vert_cache: dict = {}
        self._next_bucket: Optional[int] = None
        self._bucket_floor = 0
        # Backend.
        self.enable_backend = enable_backend
        self.backend_every = backend_every
        self.keyframes = kf_mod.init_keyframes(cfg, device=self.device)
        self._last_kf_pose = np.eye(4, dtype=np.float32)
        self._frames_since_kf = 10**9  # force a keyframe on frame 0
        self.optimized_keyframe_poses: Optional[np.ndarray] = None
        self.loop_edges: list = []  # the last pass's verified closures
        self.backend_stats: dict = {}  # the last pass's candidate counts
        # Host mirrors of the keyframe count and positions, so neither the
        # pipelined path nor the eviction slot picker syncs on the store.
        self._kf_count = 0
        self._kf_positions: List[np.ndarray] = []
        self.n_kf_evicted = 0
        self._warned_kf_evict = False
        # keep_corr: each finalized frame's correspondences (world-frame
        # source keypoints, matched candidate indices, inlier flags), as a
        # viewer draws them; costs small device fetches per frame.
        self.keep_corr = keep_corr
        self.last_corr: Optional[dict] = None
        self._prev_kp_world: Optional[np.ndarray] = None

    def _new_map(self, capacity: int) -> mapstore.MapState:
        """An empty map of `capacity` rows (on a mesh, this rank's shard)."""
        if self.axes is None:
            return mapstore.init_map(self.cfg.map, capacity, device=self.device)
        local = layout.local_capacity(capacity, self.axes.map)
        return mapstore.MapShard(*mapstore.init_map(self.cfg.map, local,
                                                    device=self.device))

    def _capacity(self) -> int:
        """The whole map's rows."""
        return self.state.map.positions.shape[0] * self._map_ranks

    def _place_state(self) -> None:
        """Take a state assigned from outside (a resume, a prefilled map):
        on a mesh, a whole state (every rank assigns the same) is sharded
        (a placed one stays as it is); and re-derive what the engine keeps
        on the host about it, the pipelined engine's cursor bound."""
        if self.mesh is not None:
            from bshot_slam_tpu_torch.parallel import sharded

            self.state = sharded.shard_state(self.state, self.mesh,
                                             self.map_axis, self.device)
        self._cursor_ub = int(self.state.map.cursor) if self.pipelined else None

    # -- ingest -------------------------------------------------------------

    def process_sweep(self, sweep: LaserSweep,
                      selected: Optional[np.ndarray] = None):
        ri = build_range_image(sweep, self.cfg.sensor, selected)
        return self.process_range_image(ri.range_mm, ri.azimuth_rad,
                                        ri.vert_rad, ri.selected)

    def process_frame(self, frame):
        """A raw LaserSweep (binned on the host) or an upload-ready
        RangeImage."""
        if isinstance(frame, RangeImage):
            return self.process_range_image(frame.range_mm, frame.azimuth_rad,
                                            frame.vert_rad)
        return self.process_sweep(frame)

    def process_range_image(self, range_mm: np.ndarray, azimuth_rad: np.ndarray,
                            vert_rad: np.ndarray,
                            selected: Optional[np.ndarray] = None):
        """One frame from a range image.  Host preprocess: classify + extract
        on the host (`host_cloud`, native), then one compact device step at
        the smallest bucket holding the kept points.  Device preprocess:
        the image goes to the device; synchronous, the kept count is read to
        slice the cloud to its exact bucket; pipelined, the fused step runs
        at the predicted bucket without a sync."""
        if self.host_preprocess:
            return self.process_compact(*host_cloud(
                range_mm, azimuth_rad, vert_rad, selected, self.cfg))
        range_az = upload(np.stack([np.asarray(range_mm, np.float32),
                                    np.asarray(azimuth_rad, np.float32)]),
                          self.device)
        vert = self._device_vert(vert_rad)
        # An all-True select list selects what None does: skip its upload.
        sel = None
        if selected is not None and not np.all(selected):
            sel = upload(np.asarray(selected, np.bool_), self.device)
        if self.pipelined:
            return self._dispatch_fused((range_az, vert, sel))
        return self.process_cloud(*self._exact_cloud((range_az, vert, sel)))

    def _device_vert(self, vert_rad: np.ndarray) -> torch.Tensor:
        """The (per-sensor constant) vertical angles on the device, uploaded
        once for each distinct value."""
        key = np.asarray(vert_rad, np.float32).tobytes()
        dev = self._vert_cache.get(key)
        if dev is None:
            dev = self._vert_cache[key] = upload(
                np.frombuffer(key, np.float32).copy(), self.device)
        return dev

    def _exact_cloud(self, image):
        """A range image's device cloud at the exact bucket: one sync on the
        kept count.  Returns (points, pmask, n_valid as a 0-d tensor)."""
        range_az, vert, sel = image
        pcfg = self.cfg.preprocess
        points, pmask, n_valid = pipeline.ingest(range_az[0], range_az[1], vert,
                                                 sel, pcfg, pcfg.max_points)
        b = pick_bucket(int(n_valid), self.cfg)
        return points[:b], pmask[:b], n_valid

    def _dispatch_fused(self, image) -> Optional[FrameRecord]:
        """The pipelined device-preprocess frame: one fused deferred step at
        the predicted bucket.  The first frame reads its kept count once to
        start the prediction."""
        if self._next_bucket is None:
            _, _, n_valid = self._exact_cloud(image)
            self._feed_bucket(int(n_valid))
        self._maybe_grow_map()
        cap = self._capacity()
        draws = self._next_draws()
        range_az, vert, sel = image
        self.state, self._ok, diag = pipeline.odometry_step_fused(
            self.state, self._ok, range_az, vert, sel, self.cfg.preprocess,
            self.cfg, self._next_bucket, draws, self.tile)
        return self._enqueue(_Pending(diag, None, None, None, draws, cap, image))

    def _feed_bucket(self, n_valid: int) -> None:
        """Predict the next frame's cloud bucket from this count: headroom
        over it, floored by a decaying maximum of recent counts, so one
        spike does not inflate every later bucket and repeated overflows
        are damped."""
        rt = self.cfg.runtime
        self._bucket_floor = max(n_valid, int(self._bucket_floor * rt.bucket_floor_decay))
        self._next_bucket = pick_bucket(
            max(int(rt.bucket_headroom * n_valid), self._bucket_floor), self.cfg)

    def process_compact(self, points: np.ndarray, n_valid: int):
        """One frame from a host-preprocessed compact cloud: points
        (bucket, 3) front-compacted, n_valid exact."""
        return self._step(upload(np.asarray(points, np.float32), self.device),
                          None, int(n_valid))

    def process_cloud(self, points, pmask, n_valid_dev=None):
        """One frame from a (bucket, 3) cloud and its (bucket,) mask (host
        arrays or tensors); `n_valid_dev`, the count of valid points (an int
        or a 0-d tensor), defaults to the mask's count."""
        points = self._as_device(points, np.float32)
        pmask = self._as_device(pmask, np.bool_)
        if n_valid_dev is None:
            n_valid_dev = torch.sum(pmask.to(torch.int32))
        return self._step(points, pmask, n_valid_dev)

    def _as_device(self, x, dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return upload(np.asarray(x, dtype), self.device)

    def _next_draws(self) -> torch.Tensor:
        """This frame's (H, 3) RANSAC draws: injected, or from the engine's
        generator (the same numbers the synchronous step draws)."""
        H = self.cfg.match.ransac_iterations
        if self._draws is not None:
            return upload(np.asarray(next(self._draws), np.float32), self.device)
        return torch.rand((H, 3), generator=self.generator, device=self.device)

    def _rng_source(self):
        """What the backend's RANSAC draws from: the injected draws'
        iterator, or the generator."""
        return self._draws if self._draws is not None else self.generator

    def _step(self, points: torch.Tensor, pmask: Optional[torch.Tensor], n_valid):
        self._maybe_grow_map()
        cap = self._capacity()
        if self.pipelined:
            draws = self._next_draws()
            self.state, self._ok, diag = pipeline.odometry_step_deferred(
                self.state, self._ok, points, pmask, n_valid, draws, self.cfg,
                self.tile, axes=self.axes)
            return self._enqueue(_Pending(diag, points, pmask, n_valid, draws, cap))
        rng = self.generator if self._draws is None else self._next_draws()
        return self._run_sync(points, pmask, n_valid, rng, cap)

    def _run_sync(self, points, pmask, n_valid, rng, cap: int) -> FrameRecord:
        """The synchronous step (host-side window decisions) and its record."""
        if pmask is None:
            self.state, diag = pipeline.odometry_step_compact(
                self.state, points, n_valid, rng, self.cfg, self.tile,
                axes=self.axes)
        else:
            self.state, diag = pipeline.odometry_step(
                self.state, points, pmask, rng, self.cfg, self.tile,
                n_valid=n_valid, axes=self.axes)
        return self._finalize(diag, diag.packed.cpu().numpy(), cap)

    # -- pipelined mode -----------------------------------------------------

    def _enqueue(self, entry: _Pending) -> Optional[FrameRecord]:
        """Queue a frame for a later batched fetch; returns the newest
        already-finalized record."""
        self._pending.append(entry)
        self._frames_in += 1
        if len(self._pending) == self.fetch_every:
            # The next drain takes exactly these rows: start their copy now
            # so it lands while the host prepares the next frame.
            self._start_fetch(list(self._pending))
        rec = None
        if (self.enable_backend and self.backend_every
                and self._frames_in % self.backend_every == 0):
            # A periodic backend pass: drain everything first so the
            # corrections land at the same frame as in synchronous mode.
            rec = self._drain(keep=0)
        elif len(self._pending) > self.fetch_every:
            rec = self._drain(keep=1)
        if rec is not None:
            return rec
        return self.records[-1] if self.records else None

    def _start_fetch(self, entries: List[_Pending]) -> None:
        """One device-to-host copy of the entries' packed rows, started
        without waiting (pinned memory, non-blocking)."""
        rows = torch.stack([e.diag.packed for e in entries])
        if rows.is_cuda:
            host = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
            host.copy_(rows, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host, event = rows, None
        self._fetch = (entries, host, event)

    def _fetched(self, entries: List[_Pending]) -> np.ndarray:
        """The entries' packed rows on the host: the copy started for them,
        or a new one."""
        f = self._fetch
        if f is None or len(f[0]) != len(entries) or any(
                a is not b for a, b in zip(f[0], entries)):
            self._start_fetch(entries)
            f = self._fetch
        self._fetch = None
        if f[2] is not None:
            f[2].synchronize()
        return f[1].numpy().copy()

    def flush(self) -> Optional[FrameRecord]:
        """Pipelined mode: finalize all in-flight frames (call after the
        last process_* call); returns the final record, or None."""
        return self._drain(keep=0)

    def _drain(self, keep: int) -> Optional[FrameRecord]:
        """Fetch and finalize pending frames down to `keep` in flight,
        oldest first, in one device-to-host copy.  An uncommitted row (a
        window overflow, or an abort cascading from one) sends it and every
        later in-flight frame to `_redispatch`."""
        n = len(self._pending) - keep
        if n <= 0:
            return None
        batch, self._pending = self._pending[:n], self._pending[n:]
        rows = self._fetched(batch)
        rec = None
        for i, (entry, pk) in enumerate(zip(batch, rows)):
            if pk[pipeline.IDX_COMMITTED] == 0.0:
                stalled = batch[i:] + self._pending
                self._pending = []
                self._fetch = None
                return self._redispatch(stalled)
            last = i == len(batch) - 1 and not self._pending
            rec = self._finalize(entry.diag, pk, entry.map_cap, can_backend=last)
        return rec

    def _redispatch(self, stalled: List[_Pending]) -> Optional[FrameRecord]:
        """Re-run the stalled frames in order through the synchronous step
        with the clouds and draws they were dispatched with; a frame
        preprocessed on the device is re-ingested at its exact bucket, as
        the synchronous engine ingests it.  The aborted steps left the state
        untouched and drew nothing more, so this is the run the synchronous
        engine makes."""
        self._ok = torch.ones((), dtype=torch.bool, device=self.device)
        self._cursor_ub = None
        self.n_redispatched += len(stalled)
        rec = None
        for e in stalled:
            self._maybe_grow_map(exact=True)
            if e.image is None:
                points, pmask, n_valid = e.points, e.pmask, e.n_valid
            else:
                points, pmask, n_valid = self._exact_cloud(e.image)
            rec = self._run_sync(points, pmask, n_valid, e.draws,
                                 self._capacity())
        return rec

    # -- records ------------------------------------------------------------

    def _finalize(self, diag, pk: np.ndarray, map_cap: int,
                  can_backend: bool = True) -> FrameRecord:
        P = pipeline
        if self._next_bucket is not None and pk.shape[0] > P.PACKED_LEN:
            self._feed_bucket(int(pk[P.IDX_N_VALID]))  # the pipelined fused path
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
        if self.enable_backend:
            self._maybe_keyframe(diag, rec, abs_frame=int(pk[P.IDX_FRAME]),
                                 map_cap=map_cap)
        if self.keep_corr:
            kp = diag.features.keypoints.cpu().numpy()
            kp_w = kp @ rec.pose[:3, :3].T + rec.pose[:3, 3]
            self.last_corr = {
                "src_world": kp_w,
                "index": diag.corr_index.cpu().numpy(),
                "inlier": (diag.corr_inlier & diag.features.mask).cpu().numpy(),
                "map_cap": map_cap,
                "prev_src_world": self._prev_kp_world,
            }
            self._prev_kp_world = kp_w
        self.records.append(rec)
        if (can_backend and self.enable_backend and self.backend_every
                and len(self.records) % self.backend_every == 0
                and self._kf_count >= 2):
            self.optimize_backend()
            self.apply_backend_corrections()
            rec = self.records[-1]  # its pose may have been corrected
        return rec

    # -- the map ------------------------------------------------------------

    def _maybe_grow_map(self, exact: bool = False) -> None:
        """Pad the map to the next capacity bucket when this frame's insert
        could overflow it; at the hard capacity, evict the weakest keypoints
        of the densest blocks instead.

        Pipelined (unless `exact`), the decision starts from a host-side
        upper bound on the cursor (each step appends at most top_k rows), so
        no frame syncs for it; only when the bound says the map may be full
        does the engine drain every in-flight frame and read the true
        cursor, which makes the decision the synchronous engine's."""
        hard_cap = self.cfg.map.capacity
        inc = self.cfg.keypoints.top_k
        pipelined = self.pipelined and not exact
        if pipelined and (self._cursor_ub is None or self._cursor_ub + inc > min(
                self._capacity(), hard_cap)):
            self._drain(keep=0)  # re-runs of aborted frames may grow the map
            self._cursor_ub = int(self.state.map.cursor)
        cap = self._capacity()
        cursor = self._cursor_ub if pipelined else int(self.state.map.cursor)
        need = cursor + inc
        if need > cap:
            for b in sorted(set(self.cfg.runtime.map_buckets) | {hard_cap}):
                if min(need, hard_cap) <= b <= hard_cap and b > cap:
                    rows = b if self.axes is None else layout.local_capacity(
                        b, self.axes.map)
                    self.state = self.state._replace(
                        map=mapstore.grow_map(self.state.map, rows))
                    break
            else:
                if need > hard_cap:
                    cursor = self._evict(cursor)
        if pipelined:
            self._cursor_ub = cursor + inc

    def _evict(self, cursor: int) -> int:
        """Make room for one frame at the hard capacity (a fixed n_evict);
        returns the new cursor."""
        n_evict = min(2 * self.cfg.keypoints.top_k, self.cfg.map.capacity // 2)
        self.state = self.state._replace(map=mapstore.evict_keypoints(
            self.state.map, n_evict, None if self.axes is None else self.axes.map))
        after = int(self.state.map.cursor)
        evicted = cursor - after
        self.n_evicted += evicted
        if evicted and not self._warned_evict:
            self._warned_evict = True
            warnings.warn(
                f"map at hard capacity {self.cfg.map.capacity}: evicting the "
                f"weakest keypoints of the densest blocks ({evicted} this frame)",
                stacklevel=3,
            )
        return after

    # -- backend ------------------------------------------------------------

    def _maybe_keyframe(self, diag, rec: FrameRecord, abs_frame: int,
                        map_cap: int) -> None:
        if not kf_mod.should_add_keyframe(self._last_kf_pose, rec.pose,
                                          self._frames_since_kf,
                                          self.cfg.backend):
            self._frames_since_kf += 1
            return
        # Saturation: evict the most redundant keyframe (anchor and the
        # newest quarter protected) instead of dropping new material.
        Mk = self.cfg.backend.max_keyframes
        if self._kf_count >= Mk:
            slot = kf_mod.pick_eviction_slot(np.asarray(self._kf_positions),
                                             self._kf_count)
            self.keyframes = kf_mod.evict_keyframe(self.keyframes, slot)
            del self._kf_positions[slot]
            self._kf_count -= 1
            self.n_kf_evicted += 1
            if not self._warned_kf_evict:
                self._warned_kf_evict = True
                warnings.warn(
                    f"keyframe store saturated at {Mk}: evicting the most "
                    "redundant keyframe per new add (raise "
                    "BackendConfig.max_keyframes for long sequences)",
                    stacklevel=3,
                )
        # Landmark observations: inlier matches into the map as it was at
        # step time (indices past map_cap matched the previous frame).
        obs_lm = torch.where(diag.corr_inlier & (diag.corr_index < map_cap),
                             diag.corr_index, -1)
        self.keyframes = kf_mod.add_keyframe(
            self.keyframes, upload(rec.pose, self.device), diag.features,
            abs_frame, obs_lm)
        self._kf_count += 1
        self._kf_positions.append(np.asarray(rec.pose[:3, 3]))
        self._last_kf_pose = rec.pose
        self._frames_since_kf = 1

    def optimize_backend(self, max_candidates: int = 8):
        """Loop-closure detection + pose-graph optimisation over the
        keyframes.  Returns (optimised keyframe poses (n, 4, 4), loop edges)
        and keeps the poses in `optimized_keyframe_poses`."""
        from bshot_slam_tpu_torch.backend import loop_closure, posegraph

        if self.pipelined:
            self._drain(keep=0)
        n = self._kf_count
        if n < 2:
            return self.keyframes.poses[:n].cpu().numpy(), []
        stats: dict = {}
        edges = loop_closure.find_loop_closures(
            self.keyframes, self.cfg, self._rng_source(), max_candidates, n=n,
            stats=stats)
        self.loop_edges = edges
        self.backend_stats = dict(stats, closures=len(edges), keyframes=n)
        # Nodes padded to a power-of-two bucket (repeating the last pose:
        # the implied identity chain edges are inert) and loop edges to a
        # multiple of 4 (masked), as the reference pads them.
        kf = self.keyframes.poses[:n]
        bucket = 8
        while bucket < n:
            bucket *= 2
        bucket = min(bucket, max(self.cfg.backend.max_keyframes, n))
        if bucket > n:
            kf = torch.cat([kf, kf[-1:].expand(bucket - n, 4, 4)])
        bcfg = self.cfg.backend
        g = posegraph.odometry_edges(kf, weight=(1000.0 / bcfg.odom_edge_sigma_mm) ** 2)
        if edges:
            e_pad = (-len(edges)) % 4
            ez = np.stack([e.z for e in edges] + [np.eye(4, dtype=np.float32)] * e_pad)
            ew = [(1000.0 / max(e.rmse_mm, bcfg.lc_sigma_floor_mm)) ** 2
                  for e in edges] + [0.0] * e_pad
            g = posegraph.add_edges(
                g, torch.tensor([e.kf_i for e in edges] + [0] * e_pad),
                torch.tensor([e.kf_j for e in edges] + [0] * e_pad),
                torch.from_numpy(ez.astype(np.float32)),
                torch.tensor(ew, dtype=torch.float32))
            mask = g.edge_mask.clone()
            mask[len(mask) - e_pad:] = False
            g = g._replace(edge_mask=mask)
        res = posegraph.optimize_pose_graph(g, iterations=bcfg.gn_iterations)
        self.optimized_keyframe_poses = res.poses[:n].cpu().numpy()
        return self.optimized_keyframe_poses, edges

    def apply_backend_corrections(self) -> dict:
        """Propagate the optimised keyframe poses into the recorded
        trajectory, the live reference pose and the global map: per-keyframe
        corrections `T_opt @ inv(T_raw)` are twist-interpolated to every
        frame, and landmarks move by the correction of the frame that
        inserted them, so later frames match against the corrected map."""
        from bshot_slam_tpu_torch.backend import corrections as corr_mod

        if self.pipelined:
            self._drain(keep=0)
        if self.optimized_keyframe_poses is None:
            self.optimize_backend()
        n_kf = self._kf_count
        if n_kf < 2 or not self.records:
            return {"max_correction_mm": 0.0, "n_landmarks_moved": 0}
        kf_opt = self.optimized_keyframe_poses.astype(np.float32)
        kf_raw = self.keyframes.poses[:n_kf].cpu().numpy()
        corr_kf = kf_opt @ np.linalg.inv(kf_raw)
        # Corrections for every frame since the run began: after a resume the
        # records hold only the frames since, but landmarks born before it
        # move by their own frame's correction, as in the uninterrupted run
        # (the reference clamps them to the first record's).
        n_frames = int(self.state.frame_idx)
        frame0 = n_frames - len(self.records)  # the first record's frame
        kf_frames = self.keyframes.frame_idx[:n_kf].cpu().numpy()
        dev = self.device
        corr_t = corr_mod.interpolate_corrections(
            torch.from_numpy(corr_kf.astype(np.float32)).to(dev),
            torch.from_numpy(kf_frames.astype(np.int32)).to(dev),
            torch.arange(n_frames, dtype=torch.int32, device=dev))
        corr = corr_t.cpu().numpy()[frame0:]
        for f, r in enumerate(self.records):
            r.pose = (corr[f] @ r.pose).astype(np.float32)
        ref_pose = (corr[-1] @ self.state.ref_pose.cpu().numpy()).astype(np.float32)
        self.state = self.state._replace(
            map=corr_mod.reanchor_map(self.state.map, corr_t, 0, self.cfg.map),
            ref_pose=torch.from_numpy(ref_pose).to(dev),
        )
        # The store's poses become the optimised ones so the next graph
        # build does not correct twice; the host mirror follows.
        poses = self.keyframes.poses.clone()
        poses[:n_kf] = torch.from_numpy(kf_opt).to(dev)
        self.keyframes = self.keyframes._replace(poses=poses)
        self._kf_positions[:n_kf] = list(kf_opt[:, :3, 3])
        self._last_kf_pose = (corr_kf[-1] @ self._last_kf_pose).astype(np.float32)
        self.optimized_keyframe_poses = None  # consumed
        m = self.state.map
        n_moved = torch.sum((m.valid & (m.frame_born >= 0)).to(torch.int32))
        if self.axes is not None:
            n_moved = comm.all_reduce(n_moved, comm.SUM, self.axes.map,
                                      "landmarks moved")
        n_moved = int(n_moved)
        return {"max_correction_mm": float(np.max(np.linalg.norm(corr[:, :3, 3],
                                                                 axis=-1))),
                "n_landmarks_moved": n_moved}

    def build_ba_problem(self):
        """A bundle-adjustment problem from the keyframes' landmark
        observations (map landmarks matched as RANSAC inliers)."""
        from bshot_slam_tpu_torch.backend.ba import BAProblem

        if self.pipelined:
            self._drain(keep=0)
        n = self._kf_count
        obs_lm = self.keyframes.obs_lm[:n].cpu().numpy()  # (n, K)
        kp = self.keyframes.keypoints[:n].cpu().numpy()  # (n, K, 3)
        kf_idx, kp_idx = np.nonzero(obs_lm >= 0)
        lm_raw = obs_lm[kf_idx, kp_idx]
        uniq, compact = np.unique(lm_raw, return_inverse=True)
        L = min(len(uniq), self.cfg.backend.ba_max_landmarks)
        keep = compact < L
        kf_idx, kp_idx, compact = kf_idx[keep], kp_idx[keep], compact[keep]
        positions = self.state.map.positions
        if self.axes is not None:
            positions = layout.gather_rows(positions, self.axes.map,
                                           "BA: map positions")
        landmarks = positions.cpu().numpy()[uniq[:L]]
        dev = self.device
        return BAProblem(
            poses=self.keyframes.poses[:n].clone(),
            landmarks=torch.from_numpy(landmarks.astype(np.float32)).to(dev),
            obs_kf=torch.from_numpy(kf_idx.astype(np.int32)).to(dev),
            obs_lm=torch.from_numpy(compact.astype(np.int32)).to(dev),
            obs_p=torch.from_numpy(kp[kf_idx, kp_idx].astype(np.float32)).to(dev),
            obs_mask=torch.ones(len(kf_idx), dtype=torch.bool, device=dev),
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
