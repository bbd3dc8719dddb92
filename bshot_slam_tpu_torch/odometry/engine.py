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

Every frame runs the one commit-or-abort step
(`pipeline.odometry_step_deferred`, or `odometry_step_fused` for a range
image on the device): it never syncs with the host, and when its match or
dedup window overflowed it passes the state through and reports the frame
uncommitted in its packed row.  The synchronous engine reads each frame's
row at once; the pipelined engine (`pipelined=True`) dispatches each frame
without a host sync and fetches the rows of `fetch_every` frames in one
device-to-host copy.  An uncommitted frame, and in the pipelined engine
every later in-flight frame, is re-run in order through the step without
windows (`Graphs.step(dense=True)`, `_run_dense`: lossless, it cannot
abort) with the cloud and RANSAC draws it was dispatched with, as the
reference's program falls back to the dense scan inside itself; so both
engines give the same records.  At the map's hard capacity the weakest
keypoints of the densest blocks are evicted.  The optional backend
(`enable_backend`) collects keyframes, and `optimize_backend` /
`apply_backend_corrections` run loop closure, the pose graph and map
re-anchoring (every `backend_every` frames, or when asked);
`build_ba_problem` assembles a bundle adjustment.

Runs on the card unless the caller asks for the CPU: `device=None` means
"cuda", and raises when no card is visible.

The steps, the map eviction and the backend's pair verification, keyframe
histograms, pose-graph solve, corrections and keyframe adds all run
through the engine's `odometry.graphs.Graphs`, and the engine calls the
same methods whatever the mode.  With `graphs=True` (the default) each is
replayed on the card from a CUDA graph captured once per static shape (the
cloud bucket, or the predicted bucket of the fused step, and the map
capacity), as the reference dispatches one `jax.jit` program per frame,
with the state updated in place as the reference donates it; on the CPU
the same body runs eagerly on the same buffers.  A keyframe eviction, rare
and no faster replayed, stays eager.  `graphs=False` gives an eager
`Graphs`, which calls each body directly: the counterpart of
`jax.disable_jit`, a comparison that runs exactly the bodies a graphed
engine replays.

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
pipelined=True`) stays single-device.  A mesh engine is graphed like one
device's (each key adds the axes) where its collectives can be captured:
every axis NCCL on the card, or the CPU (`comm.capturable`).  Gloo on
the card stages each collective through the host with a sync, which a
capture refuses, so there the engine's `Graphs` is eager.  A mesh runs
without windows, so its steps never abort.
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Iterable, List, NamedTuple, Optional

import numpy as np
import torch

from bshot_slam_tpu_torch.backend import keyframes as kf_mod
from bshot_slam_tpu_torch.config import CLASS_KEEP, SlamConfig
from bshot_slam_tpu_torch.device import resolve_device, upload
from bshot_slam_tpu_torch.io import native_decoder
from bshot_slam_tpu_torch.io.native_decoder import build_range_image
from bshot_slam_tpu_torch.io.velodyne import LaserSweep
from bshot_slam_tpu_torch.odometry import graphs as graphs_mod
from bshot_slam_tpu_torch.odometry import mapstore, pipeline
from bshot_slam_tpu_torch.ops.rangeimage import RangeImage
from bshot_slam_tpu_torch.parallel import comm, layout
from bshot_slam_tpu_torch.utils import profiling

_REC = profiling.RECORDER
_SERIALS = itertools.count()  # each engine's serial, the first part of its frames' ids


def pick_bucket(n_valid: int, cfg: SlamConfig) -> int:
    """Smallest configured cloud bucket holding n_valid points (capped at
    max_points; buckets above the cap are ignored)."""
    cap = cfg.preprocess.max_points
    for b in sorted(cfg.runtime.cloud_buckets):
        if n_valid <= b <= cap:
            return b
    return cap


def kept_rows(classes: np.ndarray, range_mm: np.ndarray,
              selected: Optional[np.ndarray]) -> int:
    """Cells of a classified range image that extraction keeps, before any
    cap: valid, class keep and selected."""
    keep = (np.asarray(classes) == CLASS_KEEP) & (np.asarray(range_mm) > 0)
    if selected is not None:
        keep &= np.asarray(selected, bool)
    return int(np.count_nonzero(keep))


def host_cloud(range_mm: np.ndarray, azimuth_rad: np.ndarray,
               vert_rad: np.ndarray, selected: Optional[np.ndarray],
               cfg: SlamConfig):
    """The engine's host ingest of one range image: native classify + compact
    extract, padded with zeros to the smallest bucket holding the kept
    points.  Returns (points (bucket, 3) float32, n_valid).  Kept points
    past `max_points` are dropped; while the recorder is on, each call
    counts `cloud.rows` (n_valid), `cloud.bucket_rows` (the bucket) and
    `cloud.truncated_rows` (the kept points dropped)."""
    cap = cfg.preprocess.max_points
    pts, nv, classes = native_decoder.preprocess_extract_native(
        range_mm, azimuth_rad, vert_rad, cfg.preprocess, selected, cap)
    points = np.zeros((pick_bucket(nv, cfg), 3), np.float32)
    points[:nv] = pts
    if _REC.on:
        _REC.count("cloud.rows", nv)
        _REC.count("cloud.bucket_rows", points.shape[0])
        # Below the cap nothing was dropped: the full count only at it.
        _REC.count("cloud.truncated_rows",
                   kept_rows(classes, range_mm, selected) - nv if nv == cap else 0)
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
    frame: Optional[tuple] = None  # its id in the recorder's spans (None: not recording)


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
    in the synchronous engine.

    `graphs=False` runs the steps and the backend's programs eagerly,
    through an eager `Graphs` (see the module docstring); records are the
    same bit for bit.  `graphs` may also be the `Graphs` of an earlier
    engine on the same device, which this engine then takes over (its
    captures are reused where the configuration and shapes are the same, as
    the reference's compiled programs outlive an engine): the two must not
    step in turns; a mesh engine makes its own.  On a mesh whose
    collectives cannot be captured (gloo on the card) `graphs.eager` is
    True whatever `graphs` asks.

    With `enable_backend` the keyframe store holds at least 3 keyframes
    (`BackendConfig.max_keyframes`): a saturated store evicts one that is
    neither the anchor nor in the newest quarter, and a smaller store has
    none, so the engine refuses it.

    While `utils.profiling.RECORDER` is on, the engine records itself.
    Each frame's id is (the engine's `serial`, its dispatch index), and
    its spans carry it: the root `slam.frame` (the outermost `process_*`
    call), `slam.ingest` (`slam.range_image`, `slam.extract`),
    `slam.dispatch` (the map check, the uploads in `slam.upload`, the
    draws and the step, `slam.replay` inside `Graphs`), and, where the
    frame's row is read, `slam.drain` (`slam.fetch_wait`,
    `slam.finalize` with the id of the frame finalized) and
    `slam.redispatch`.  The device marks `frame_start` (before the
    frame's upload), `step_start` (after its uploads and draws) and
    `replay_end` (after its step) bracket each dispatch on the device;
    they are read after the drain's wait for its copy, so recording adds
    no synchronise.  `host_syncs.<site>` counts each place
    the engine waits for the device: `fetch`, `packed`, `cursor`,
    `n_valid`."""

    def __init__(self, cfg: SlamConfig, seed: int = 0, tile: int = 2048,
                 device=None, draws: Optional[Iterable] = None,
                 enable_backend: bool = False, backend_every: int = 0,
                 pipelined: bool = False, fetch_every: int = 1,
                 host_preprocess: bool = True, keep_corr: bool = False,
                 mesh=None, data_axis: str = "data", map_axis: str = "map",
                 graphs=True):
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
        # The graphs of the steps and backend programs, and the steps'
        # in-place state buffers (eager: every program run directly).
        if isinstance(graphs, graphs_mod.Graphs):
            if mesh is not None or graphs.device != graphs_mod.normal_device(self.device):
                raise ValueError("graphs of another device, or with a mesh")
            self.graphs = graphs
        else:
            self.graphs = graphs_mod.Graphs(self.device, eager=not graphs or (
                mesh is not None and not comm.capturable(self.device, self.axes)))
        self._warned_drop = False
        self._warned_evict = False
        self.n_evicted = 0  # cumulative keypoints evicted at capacity
        # Pipelined mode.
        self.pipelined = pipelined
        self.fetch_every = max(1, fetch_every)
        self.serial = next(_SERIALS)
        self._fid: Optional[tuple] = None  # the recorded frame's id
        _REC.reserve(3 * (self.fetch_every + 1))  # three marks a frame in flight
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
        if enable_backend and cfg.backend.max_keyframes < 3:
            raise ValueError(
                f"enable_backend needs max_keyframes >= 3 (got "
                f"{cfg.backend.max_keyframes}): a saturated store evicts a "
                "keyframe other than the anchor (slot 0) and the newest "
                "quarter, and a smaller store has none")
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
        self._cursor_ub = self._read_cursor() if self.pipelined else None

    def _read_cursor(self) -> int:
        """The map's cursor on the host: a wait for the device."""
        _REC.count("host_syncs.cursor")
        return int(self.state.map.cursor)

    # -- ingest -------------------------------------------------------------

    def _frame(self):
        """`slam.frame`, the root span of the frame this outermost
        `process_*` call begins (a nested call opens none), under the
        frame's id: (the engine's serial, its dispatch index)."""
        if not _REC.on or _REC.is_open("slam.frame"):
            return profiling.NOOP
        self._fid = (self.serial, self._frames_in)
        return _REC.span("slam.frame", self._fid)

    def process_sweep(self, sweep: LaserSweep,
                      selected: Optional[np.ndarray] = None):
        with self._frame():
            with _REC.span("slam.ingest"):
                with _REC.span("slam.range_image"):
                    ri = build_range_image(sweep, self.cfg.sensor, selected)
                ingested = self._ingest(ri.range_mm, ri.azimuth_rad, ri.vert_rad,
                                        ri.selected)
            return self._dispatch(ingested)

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
        with self._frame():
            with _REC.span("slam.ingest"):
                ingested = self._ingest(range_mm, azimuth_rad, vert_rad, selected)
            return self._dispatch(ingested)

    def _ingest(self, range_mm, azimuth_rad, vert_rad, selected):
        """A range image's ingest (`slam.extract`): host preprocess, the
        compact cloud (points, n_valid) from `host_cloud`; device
        preprocess, the image on the device and, synchronous, its cloud at
        the exact bucket (`_exact_cloud`)."""
        with _REC.span("slam.extract"):
            if self.host_preprocess:
                return host_cloud(range_mm, azimuth_rad, vert_rad, selected, self.cfg)
            range_az = upload(np.stack([np.asarray(range_mm, np.float32),
                                        np.asarray(azimuth_rad, np.float32)]),
                              self.device)
            vert = self._device_vert(vert_rad)
            # An all-True select list selects what None does: skip its upload.
            sel = None
            if selected is not None and not np.all(selected):
                sel = upload(np.asarray(selected, np.bool_), self.device)
            if self.pipelined:
                return range_az, vert, sel
            return self._exact_cloud((range_az, vert, sel))

    def _dispatch(self, ingested):
        """The step of what `_ingest` returned."""
        if self.host_preprocess:
            return self.process_compact(*ingested)
        if self.pipelined:
            return self._dispatch_fused(ingested)
        return self._step(*ingested)

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
        _REC.count("host_syncs.n_valid")
        b = pick_bucket(int(n_valid), self.cfg)
        return points[:b], pmask[:b], n_valid

    def _dispatch_fused(self, image) -> Optional[FrameRecord]:
        """The pipelined device-preprocess frame: one fused deferred step at
        the predicted bucket.  The first frame reads its kept count once to
        start the prediction."""
        fid = self._fid
        with _REC.span("slam.dispatch"):
            if self._next_bucket is None:
                _, _, n_valid = self._exact_cloud(image)
                self._feed_bucket(int(n_valid))
            self._maybe_grow_map()
            cap = self._capacity()
            _REC.device_mark("frame_start", fid)
            draws = self._next_draws()
            _REC.device_mark("step_start", fid)
            self._frames_in += 1
            self.state, self._ok, diag = self.graphs.fused(
                self.cfg, self.tile, self.state, self._ok, image, self._next_bucket,
                draws, self._keep)
            _REC.device_mark("replay_end", fid)
        return self._enqueue(_Pending(diag, None, None, None, draws, cap, image, fid))

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
        (bucket, 3) front-compacted, n_valid exact (sent to the device
        with the points, as a 0-d int32 tensor: no host sync, and a graph
        reads it from its buffer rather than baking it in)."""
        with self._frame():
            return self._step(np.asarray(points, np.float32), None,
                              np.asarray(n_valid, np.int32))

    def process_cloud(self, points, pmask, n_valid_dev=None):
        """One frame from a (bucket, 3) cloud and its (bucket,) mask (host
        arrays or tensors); `n_valid_dev`, the count of valid points (an int
        or a 0-d tensor), defaults to the mask's count."""
        with self._frame():
            return self._step(points, pmask, n_valid_dev)

    def _as_device(self, x, dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x.to(self.device)
        return upload(np.asarray(x, dtype), self.device)

    def _on_device(self, points, pmask, n_valid):
        """A cloud (host arrays or tensors) on the engine's device: points,
        the mask or None, and n_valid as a 0-d tensor (None: the mask's
        count)."""
        points = self._as_device(points, np.float32)
        if pmask is not None:
            pmask = self._as_device(pmask, np.bool_)
        if n_valid is None:
            n_valid = torch.sum(pmask, dtype=torch.int32)
        elif not isinstance(n_valid, torch.Tensor):
            n_valid = upload(np.asarray(n_valid, np.int32), self.device)
        return points, pmask, n_valid

    def _next_draws(self) -> torch.Tensor:
        """This frame's (H, 3) RANSAC draws: injected, or from the engine's
        generator (the same numbers `pipeline.odometry_step` draws)."""
        H = self.cfg.match.ransac_iterations
        if self._draws is not None:
            return upload(np.asarray(next(self._draws), np.float32), self.device)
        return torch.rand((H, 3), generator=self.generator, device=self.device)

    @property
    def _keep(self) -> bool:
        """Whether a step's features and correspondences outlive it."""
        return self.enable_backend or self.keep_corr

    def _rng_source(self):
        """What the backend's RANSAC draws from: the injected draws'
        iterator, or the generator."""
        return self._draws if self._draws is not None else self.generator

    def _step(self, points, pmask: Optional[torch.Tensor], n_valid):
        """One frame's step from its cloud (see `_on_device`): the dispatch
        (the map check, the uploads, the draws and the step), then,
        pipelined, its place in the queue; synchronous, its packed row and
        record, or, when a window overflowed (the state passed through),
        the dense re-run with the same draws."""
        fid = self._fid
        with _REC.span("slam.dispatch"):
            self._maybe_grow_map()
            cap = self._capacity()
            _REC.device_mark("frame_start", fid)
            with _REC.span("slam.upload"):
                points, pmask, n_valid = self._on_device(points, pmask, n_valid)
            self._frames_in += 1
            draws = self._next_draws()
            _REC.device_mark("step_start", fid)
            self.state, self._ok, diag = self.graphs.step(
                self.cfg, self.tile, self.state, self._ok, points, pmask, n_valid,
                draws, self._keep, axes=self.axes)
            _REC.device_mark("replay_end", fid)
        if self.pipelined:
            return self._enqueue(_Pending(diag, points, pmask, n_valid, draws, cap,
                                          frame=fid))
        pk = self._read_packed(diag)
        if pk[pipeline.IDX_COMMITTED] == 0.0:
            return self._run_dense(points, pmask, n_valid, draws, cap, fid)
        return self._finalize(diag, pk, cap, frame=fid)

    def _read_packed(self, diag) -> np.ndarray:
        """A synchronous step's packed row on the host: a wait for the
        device (`slam.fetch_wait`)."""
        with _REC.span("slam.fetch_wait"):
            _REC.count("host_syncs.packed")
            pk = diag.packed.cpu().numpy()
        _REC.read_marks()
        return pk

    def _run_dense(self, points, pmask, n_valid, draws, cap: int,
                   frame=None) -> FrameRecord:
        """The re-run of a frame that aborted: the step without windows
        (`Graphs.step(dense=True)`, which cannot abort) with the frame's
        draws, and its record."""
        self.state, self._ok, diag = self.graphs.step(
            self.cfg, self.tile, self.state,
            torch.ones((), dtype=torch.bool, device=self.device), points, pmask,
            n_valid, draws, self._keep, axes=self.axes, dense=True)
        return self._finalize(diag, self._read_packed(diag), cap, frame=frame)

    # -- pipelined mode -----------------------------------------------------

    def _enqueue(self, entry: _Pending) -> Optional[FrameRecord]:
        """Queue a frame for a later batched fetch; returns the newest
        already-finalized record."""
        self._pending.append(entry)
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
        with _REC.span("slam.fetch_wait"):
            _REC.count("host_syncs.fetch")
            if f[2] is not None:
                f[2].synchronize()
        _REC.read_marks()  # the device has passed every mark before the copy
        return f[1].numpy().copy()

    def flush(self) -> Optional[FrameRecord]:
        """Pipelined mode: finalize all in-flight frames (call after the
        last process_* call); returns the final record, or None.  Nothing
        is in flight after it, so the recorder retakes its clock's
        anchor."""
        rec = self._drain(keep=0)
        _REC.reanchor()
        return rec

    def _drain(self, keep: int) -> Optional[FrameRecord]:
        """Fetch and finalize pending frames down to `keep` in flight,
        oldest first, in one device-to-host copy.  An uncommitted row (a
        window overflow, or an abort cascading from one) sends it and every
        later in-flight frame to `_redispatch`."""
        n = len(self._pending) - keep
        if n <= 0:
            return None
        batch, self._pending = self._pending[:n], self._pending[n:]
        with _REC.span("slam.drain", batch[-1].frame):
            rows = self._fetched(batch)
            rec = None
            for i, (entry, pk) in enumerate(zip(batch, rows)):
                if pk[pipeline.IDX_COMMITTED] == 0.0:
                    stalled = batch[i:] + self._pending
                    self._pending = []
                    self._fetch = None
                    return self._redispatch(stalled)
                last = i == len(batch) - 1 and not self._pending
                rec = self._finalize(entry.diag, pk, entry.map_cap, can_backend=last,
                                     frame=entry.frame)
        return rec

    def _redispatch(self, stalled: List[_Pending]) -> Optional[FrameRecord]:
        """Re-run the stalled frames in order with the clouds and draws they
        were dispatched with, each through the dense step (`_run_dense`: the
        first overflowed, and a later one may).  A frame preprocessed on the
        device is re-ingested at its exact bucket, as the synchronous engine
        ingests it.  The aborted steps left the state untouched and drew
        nothing more, and the dense scan gives the compact window's results,
        so these are the synchronous engine's records."""
        self._ok = torch.ones((), dtype=torch.bool, device=self.device)
        self._cursor_ub = None
        self.n_redispatched += len(stalled)
        rec = None
        with _REC.span("slam.redispatch"):
            for e in stalled:
                self._maybe_grow_map(exact=True)
                if e.image is None:
                    points, pmask, n_valid = e.points, e.pmask, e.n_valid
                else:
                    points, pmask, n_valid = self._exact_cloud(e.image)
                rec = self._run_dense(points, pmask, n_valid, e.draws, self._capacity(),
                                      e.frame)
        return rec

    # -- records ------------------------------------------------------------

    def _finalize(self, diag, pk: np.ndarray, map_cap: int,
                  can_backend: bool = True, frame=None) -> FrameRecord:
        """The record of a frame's packed row (`slam.finalize` under the
        frame's id), its keyframe and its periodic backend pass."""
        with _REC.span("slam.finalize", frame):
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
            self._cursor_ub = self._read_cursor()
        cap = self._capacity()
        cursor = self._cursor_ub if pipelined else self._read_cursor()
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
        self.state = self.graphs.evict(self.state, n_evict,
                                       None if self.axes is None else self.axes.map)
        after = self._read_cursor()
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
            # The rows above the slot moved down one: so do the edges'
            # indices; an edge to the evicted keyframe goes with it.
            self.loop_edges = [
                e._replace(kf_i=e.kf_i - (e.kf_i > slot), kf_j=e.kf_j - (e.kf_j > slot))
                for e in self.loop_edges if slot not in (e.kf_i, e.kf_j)]
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
        self.keyframes = self.graphs.add_keyframe(
            self.keyframes, upload(rec.pose, self.device), diag.features,
            upload(np.asarray(abs_frame, np.int32), self.device), obs_lm)
        self._kf_count += 1
        # Optimised poses pair with the rows they were optimised from: this
        # add (and an eviction before it) changed the rows, so they go.
        self.optimized_keyframe_poses = None
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
            stats=stats, graphs=self.graphs)
        self.loop_edges = edges
        self.backend_stats = dict(stats, closures=len(edges), keyframes=n)
        g = self._pose_graph(n, edges)
        res = self.graphs.pose_graph(g, iterations=self.cfg.backend.gn_iterations)
        self.optimized_keyframe_poses = res.poses[:n].cpu().numpy()
        return self.optimized_keyframe_poses, edges

    def _pose_graph(self, n: int, edges: list):
        """The pose graph of the first n keyframes and the loop edges: nodes
        padded to a power-of-two bucket (repeating the last pose: the
        implied identity chain edges are inert) and loop edges to a multiple
        of 4 (masked), as the reference pads them, so the solve's shapes
        repeat from pass to pass."""
        from bshot_slam_tpu_torch.backend import posegraph

        kf = self.keyframes.poses[:n]
        bucket = self._node_bucket(n)
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
        return g

    def _node_bucket(self, n: int) -> int:
        """The pose graph's node count for n keyframes: a power of two from 8,
        at most the store's size."""
        bucket = 8
        while bucket < n:
            bucket *= 2
        return min(bucket, max(self.cfg.backend.max_keyframes, n))

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
        # Keyframes padded to the pose graph's node bucket (repeating the
        # last keyframe's correction and frame) and frames to a power of two
        # (repeating the last), graphed or not, so the program's shapes
        # repeat from pass to pass: searchsorted lands on the repeated tail
        # and the clamps pick the unpadded rows' values, and no landmark is
        # born at a padded frame, so the padding changes no result.
        n_pad = self._node_bucket(n_kf) - n_kf
        f_pad = (1 << max(0, n_frames - 1).bit_length()) - n_frames
        dev = self.device
        args = (torch.from_numpy(np.concatenate(
                    [corr_kf, np.repeat(corr_kf[-1:], n_pad, 0)]).astype(np.float32)).to(dev),
                torch.from_numpy(np.concatenate(
                    [kf_frames, np.repeat(kf_frames[-1:], n_pad)]).astype(np.int32)).to(dev),
                torch.from_numpy(np.concatenate(
                    [np.arange(n_frames), np.full(f_pad, n_frames - 1)]).astype(np.int32)).to(dev))
        corr_t, moved = self.graphs.corrections(self.cfg.map, *args, self.state.map)
        corr = corr_t.cpu().numpy()[frame0:n_frames]
        for f, r in enumerate(self.records):
            r.pose = (corr[f] @ r.pose).astype(np.float32)
        ref_pose = (corr[-1] @ self.state.ref_pose.cpu().numpy()).astype(np.float32)
        self.state = self.state._replace(map=moved, ref_pose=torch.from_numpy(ref_pose).to(dev))
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
