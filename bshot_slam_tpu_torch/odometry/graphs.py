"""The engine's per-frame steps and its backend's programs as CUDA graphs.

The port's counterpart of the JAX package's `jax.jit` boundaries: the
reference compiles `odometry_step_compact` / `odometry_step_fused` (one
program each, `donate_argnames=("state",)`, `cfg` static) and the
backend's `_verify_pair`, `keyframe_bow`, `optimize_pose_graph`,
`ba_solve`, `interpolate_corrections`, `reanchor_map` and `add_keyframe`
once per static shape and dispatches each as one call.
Here each body is captured once per key as a CUDA graph
(`torch.cuda.CUDAGraph`) and replayed: the same kernels in the same order
on the same buffers, so every result is bit for bit the eager run's.

| body | key | static inputs |
|---|---|---|
| `pipeline.odometry_step_deferred`, pmask None | ("compact", bucket, capacity, tile, [axes], cfg) | points, n_valid (0-d int32), draws |
| the same with a pmask | ("masked", bucket, capacity, tile, [axes], cfg) | points, pmask, n_valid, draws |
| the same with `pipeline.without_windows(cfg)` (an aborted frame's re-run) | ("dense" or "dense_masked", bucket, capacity, tile, [axes], cfg') | as "compact" / "masked" |
| `pipeline.odometry_step_fused` | ("fused", bucket, capacity, selected is None, tile, cfg) | range_az, vert, selected, draws |
| `mapstore.evict_keypoints` | ("evict", capacity, n_evict, [axis]) | none: the state buffers' map |
| `loop_closure._verify_pair` | ("pair", K, inlier_th, iterations, icp_iterations) | both keyframes' kp, words, masks; draws |
| `loop_closure.bow_rows` over the whole store | ("bow", Mk, K) | descriptors, kp_mask |
| `posegraph.optimize_pose_graph` | ("posegraph", M, E, iterations, lm_lambda, anchor_weight) | the `PoseGraph` fields |
| `ba.ba_solve` (`reduce` the all-reduce SUM over [axis]) | ("ba", M, L, O, gn, cg, lm_lambda, anchor_weight, [axis]) | the `BAProblem` fields (this rank's observations) |
| `corrections.interpolate_corrections` + `reanchor_map` (frame0 0) | ("corr", keyframes, frames, capacity, cfg.map) | corr_kf, kf_frames, frames; the map's positions, blocks, valid, frame_born |
| `keyframes.add_keyframe` | ("kf_add", Mk, K) | the store, pose, features, frame (0-d), obs_lm |

[axes] and [axis] are there only on a mesh: each axis's `comm.Axis.key`
(name, size, this rank, backend, process group), so two meshes never share
a capture.  cfg' is `pipeline.without_windows(cfg)`: the dense scans,
which cannot overflow and give the compact windows' results (both are
exact).

The reference also compiles its sharded step and sharded BA
(`parallel/sharded.py`, one program each with shardings) and keeps the
window fallback and the map eviction inside its programs; here the mesh
steps, the sharded BA, the dense re-run and the eviction are keys of the
same set.  Every step is the one commit-or-abort body
(`pipeline._odometry_step_impl`): the engine reads the commit flag from the
packed row and re-runs an aborted frame through the dense key.

A key names every Python value its body closes over: a value outside the
key would be frozen at capture, so a `Graphs` shared by engines of two
configurations captures a step for each (the frozen, hashable `SlamConfig`
is in the step keys, as the reference's `cfg` is a static argument).
Every call copies its inputs into the key's static buffers (so the
caller's tensors stay its own, as a re-run needs them) and copies the
outputs it returns out of the graphs' memory pool, which all graphs
share: the next replay of any graph may overwrite them.

State is updated in place, as the reference donates it: for each map
capacity the set owns one `OdometryState` of buffers, which the steps
read and, at their end, overwrite with the committed or passed-through
state; the commit flag goes into one shared `ok` buffer, which the next
step reads.  A state assigned from outside (a prefill, a resume, growth,
eviction, corrections, a re-run) is copied into the buffers before the
step; `step` returns the buffers themselves.

On the card the first use of a key runs the body eagerly on the capture
stream, as that call's result (so every kernel's scratch, cached count
tensor and library is made outside the capture, and no frame runs twice),
then captures it; every later use replays it.  A capture that meets a host
synchronisation raises; nothing falls back to the eager step.  Kernel
wrappers count the launches of their Python calls, and `parallel.comm`
its collectives, neither of which a replay makes, so each graph records
the count deltas of its capture and adds them on every replay: the counts
stay those of the eager run.  On the CPU the same body runs eagerly on the
same static buffers (no graph), so the CPU tests cover the buffer
plumbing.

Collectives are captured on NCCL: each group's communicator is made by the
warm-up run (the first collective of the group), and a collective joins
NCCL's stream to the capturing one and back.  Gloo on CUDA tensors stages
every collective through the host with a sync, which a capture refuses, so
a mesh of such axes gets an eager set (`comm.capturable`).

`Graphs(device, eager=True)` runs every body directly on the caller's
tensors, with no buffers and no capture, and returns the body's own
outputs: the engine (`graphs=False`, or a mesh whose collectives cannot be
captured), the sharded step and `find_loop_closures` call the same methods
either way, so no caller chooses between a program and its graph.
"""

from __future__ import annotations

import gc
import time
from typing import Callable, NamedTuple, Optional

import torch

from bshot_slam_tpu_torch.backend import ba, corrections, keyframes, posegraph
from bshot_slam_tpu_torch.backend.loop_closure import _verify_pair, bow_rows
from bshot_slam_tpu_torch.kernels import eig3, mapops, neighborhood, preprocess
from bshot_slam_tpu_torch.odometry import mapstore, pipeline
from bshot_slam_tpu_torch.parallel import comm
from bshot_slam_tpu_torch.utils import profiling

_REC = profiling.RECORDER

# The kernel wrappers whose `launches` a replay advances.
WRAPPERS = (neighborhood.neighborhood_accumulate, neighborhood.segratio_accumulate,
            neighborhood.shot_neighbors, mapops.hamming_nn_bounded,
            mapops.euclid_nn_bounded, mapops.dedup_blocked_bounded,
            preprocess.ground_walk, mapops.icp_update, eig3.eigh3)

_STREAMS: dict = {}


def normal_device(device) -> torch.device:
    """`device` with the current card's index where a CUDA one has none."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    """One side stream per device for every warm-up and capture: the
    kernels keep their scratch per stream, so all graphs share one set."""
    s = _STREAMS.get(device.index)
    if s is None:
        s = _STREAMS[device.index] = torch.cuda.Stream(device)
    return s


def leaves(tree) -> list:
    """The tensors of nested NamedTuples, in field order."""
    if isinstance(tree, tuple):
        return [t for x in tree for t in leaves(x)]
    return [tree]


def clone_tree(tree):
    """New buffers of the same structure, holding `tree`'s values."""
    if isinstance(tree, tuple):
        return type(tree)(*[clone_tree(x) for x in tree])
    return tree.clone()


def _axes_key(axes) -> tuple:
    """The key part of a mesh's axes (`comm.Axis`es): () off a mesh."""
    return () if axes is None else (tuple(a.key for a in axes),)


class _Graph(NamedTuple):
    static: tuple  # the body's inputs (None where the key has none)
    outputs: object  # what the body returned, in the pool on the card
    graph: Optional[torch.cuda.CUDAGraph]  # None on the CPU
    launches: tuple  # each WRAPPERS launch count one run adds
    collectives: dict  # the `comm` counts one run adds, by site


class Graphs:
    """Captured bodies by key, their static inputs, the shared pool and the
    state buffers of one engine (or of one `find_loop_closures` call).
    `captures` and `capture_s` count the captures made and their seconds
    (warm-up included).  With `eager` every body runs directly on the
    caller's tensors (no buffers, no capture, no pool).  While
    `utils.profiling.RECORDER` is on, each capture is a `slam.capture`
    span (attribute `key`, warm-up included) and every other run a
    `slam.replay` span (the copy-in and the replay's launch; on the CPU
    and eager, the body)."""

    def __init__(self, device, eager: bool = False):
        self.device = normal_device(device)
        self.eager = eager
        self.cuda = self.device.type == "cuda" and not eager
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        self._graphs: dict = {}
        self._states: dict = {}
        self.ok = torch.ones((), dtype=torch.bool, device=self.device)
        self.captures = 0
        self.capture_s = 0.0

    # -- the generic runner ---------------------------------------------------

    def run(self, key, body: Callable, args: tuple):
        """`body(*static)` for this key, its static inputs holding `args`:
        replayed on the card (captured on first use), eagerly on the CPU.
        `body` returns (outputs, writes); each (buffer, value) of `writes`
        is copied into the buffer at the body's end.  Returns the outputs,
        which the next call may overwrite.  Eager: `body(*args)` itself."""
        if self.eager:
            with _REC.span("slam.replay"):
                return _apply(body(*args))
        g = self._graphs.get(key)
        if g is None:
            static = tuple(None if a is None else a.clone() for a in args)
            if self.cuda:
                outputs, g = self._capture(key, static, body)
                self._graphs[key] = g
                return outputs
            g = self._graphs[key] = _Graph(static, None, None, (), {})
            args = static
        with _REC.span("slam.replay"):
            self._copy_in(key, g.static, args)
            if g.graph is None:
                return _apply(body(*g.static))
            g.graph.replay()
        for w, n in zip(WRAPPERS, g.launches):
            w.launches += n
        comm.add_counts(g.collectives)
        return g.outputs

    @staticmethod
    def _copy_in(key, static: tuple, args: tuple) -> None:
        for s, a in zip(static, args):
            if (s is None) != (a is None) or (a is not None and (
                    a.shape != s.shape or a.dtype != s.dtype or a.device != s.device)):
                raise ValueError(f"graph {key}: an input does not match its "
                                 "static buffer's presence, shape, dtype or device")
            if a is not None and a is not s:
                s.copy_(a)

    def _capture(self, key, static: tuple, body: Callable):
        """(this call's outputs, run eagerly on the capture stream, and the
        captured graph of the body)."""
        with _REC.span("slam.capture", key=key):
            t0 = time.perf_counter()
            stream = _capture_stream(self.device)
            current = torch.cuda.current_stream(self.device)
            stream.wait_stream(current)
            with torch.cuda.stream(stream):  # makes scratch, cached counts, libraries
                outputs = _apply(body(*static))
            current.wait_stream(stream)
            before, counted = [w.launches for w in WRAPPERS], comm.snapshot()
            graph = torch.cuda.CUDAGraph()
            # No cyclic collection during the capture: it could free an
            # unreachable CUDA graph (an engine left in a reference cycle),
            # whose destroy a capture does not permit, and the capture fails.
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self.pool, stream=stream):
                    captured = _apply(body(*static))
            finally:  # a capture launches nothing and makes no collective
                if collecting:
                    gc.enable()
                launches = tuple(w.launches - b for w, b in zip(WRAPPERS, before))
                for w, b in zip(WRAPPERS, before):
                    w.launches = b
                collectives = comm.counts_since(counted)
            self.captures += 1
            self.capture_s += time.perf_counter() - t0
            return outputs, _Graph(static, captured, graph, launches, collectives)

    # -- state buffers ----------------------------------------------------------

    def state_buffers(self, state: pipeline.OdometryState) -> pipeline.OdometryState:
        """This set's buffers for the state's map capacity, holding the
        state: made on first use, copied into when `state` is not them."""
        cap = state.map.positions.shape[0]
        bufs = self._states.get(cap)
        if bufs is None:
            bufs = self._states[cap] = clone_tree(state)
        elif state is not bufs:
            for b, s in zip(leaves(bufs), leaves(state)):
                if b is not s:
                    b.copy_(s)
        return bufs

    def _ok_buffer(self, ok: torch.Tensor) -> torch.Tensor:
        if ok is not self.ok:
            self.ok.copy_(ok)
        return self.ok

    # -- the engine's steps -----------------------------------------------------

    def _step(self, key: tuple, state, ok, body: Callable, args: tuple, keep):
        """`body(state, ok, *args)` -> (state', committed, diag) through the
        graph of `key`, the state and the commit flag written into their
        buffers; returns (the state buffers, the ok buffer, the diagnostics
        copied out as `_copied(diag, keep)`).  Eager: the body's own
        (state', committed, diag)."""
        if self.eager:
            with _REC.span("slam.replay"):
                return body(state, ok, *args)
        bufs, okb = self.state_buffers(state), self._ok_buffer(ok)

        def on_buffers(*static):
            new, committed, diag = body(bufs, okb, *static)
            return diag, list(zip(leaves(bufs), leaves(new))) + [(okb, committed)]

        diag = self.run(key, on_buffers, args)
        return bufs, okb, _copied(diag, keep)

    def step(self, cfg, tile: int, state, ok, points, pmask, n_valid, draws,
             keep, axes=None, dense: bool = False):
        """`pipeline.odometry_step_deferred(state, ok, points, pmask,
        n_valid, draws, cfg, tile, axes)` through its graph; n_valid is a
        0-d tensor, `axes` a mesh's `MeshAxes` (the state then holds a
        `MapShard`).  With `dense` the step runs with
        `pipeline.without_windows(cfg)`: it cannot abort on a window, and it
        is the re-run of a frame that did.  Returns (the state buffers, the
        ok buffer, diagnostics copied out: `packed`; with `keep` also
        `features`, `corr_index` and `corr_inlier`, the other fields None;
        with keep "all" every field).  Eager: the step's own outputs."""
        if dense:
            cfg = pipeline.without_windows(cfg)
            kind = "dense" if pmask is None else "dense_masked"
        else:
            kind = "compact" if pmask is None else "masked"

        def body(state, ok, points, pmask, n_valid, draws):
            return pipeline.odometry_step_deferred(state, ok, points, pmask, n_valid,
                                                   draws, cfg, tile, axes=axes)

        key = (kind, points.shape[0], state.map.positions.shape[0], tile) + _axes_key(
            axes) + (cfg,)
        return self._step(key, state, ok, body, (
            points, pmask, n_valid.to(torch.int32).reshape(()), draws), keep)

    def fused(self, cfg, tile: int, state, ok, image: tuple, bucket: int, draws,
              keep: bool):
        """`pipeline.odometry_step_fused` of `image` (range_az, vert,
        selected or None) at `bucket` through its graph; returns as
        `step`."""

        def body(state, ok, range_az, vert, sel, draws):
            return pipeline.odometry_step_fused(state, ok, range_az, vert, sel,
                                                cfg.preprocess, cfg, bucket, draws, tile)

        range_az, vert, sel = image
        key = ("fused", bucket, state.map.positions.shape[0], sel is None, tile, cfg)
        return self._step(key, state, ok, body, (range_az, vert, sel, draws), keep)

    def evict(self, state, n_evict: int, axis=None):
        """`mapstore.evict_keypoints(state.map, n_evict, axis)` through its
        graph, written into the state buffers in place (the reference
        donates the state); returns the buffers.  Eager: a new state."""
        if self.eager:
            return state._replace(map=mapstore.evict_keypoints(state.map, n_evict, axis))
        bufs = self.state_buffers(state)

        def body():
            m = mapstore.evict_keypoints(bufs.map, n_evict, axis)
            return None, list(zip(leaves(bufs.map), leaves(m)))

        key = ("evict", bufs.map.positions.shape[0], n_evict) + _axes_key(
            None if axis is None else (axis,))
        self.run(key, body, ())
        return bufs

    # -- the backend ------------------------------------------------------------

    def verify_pair(self, draws, kp_a, desc_a, mask_a, kp_b, desc_b, mask_b,
                    inlier_th: float, iterations: int, icp_iterations: int = 10):
        """`loop_closure._verify_pair` with the (H, 3) draws through its
        graph; returns (T, n_inliers, icp rmse) copied out."""

        def body(draws, kp_a, desc_a, mask_a, kp_b, desc_b, mask_b):
            return _verify_pair(draws, kp_a, desc_a, mask_a, kp_b, desc_b, mask_b,
                                inlier_th, iterations, icp_iterations), []

        key = ("pair", kp_a.shape[0], inlier_th, iterations, icp_iterations)
        out = self.run(key, body, (draws, kp_a, desc_a, mask_a, kp_b, desc_b, mask_b))
        return tuple(t.clone() for t in out)

    def bow(self, store) -> torch.Tensor:
        """`loop_closure.keyframe_bow(store)`, the (Mk, 352) histograms of
        every row of the store, through its graph; copied out."""
        key = ("bow",) + tuple(store.kp_mask.shape)
        out = self.run(key, lambda d, m: (bow_rows(d, m), []),
                       (store.descriptors, store.kp_mask))
        return out.clone()

    def pose_graph(self, g: posegraph.PoseGraph, iterations: int = 10,
                   lm_lambda: float = 1.0e-4, anchor_weight: float = 1.0e6
                   ) -> posegraph.PoseGraphResult:
        """`posegraph.optimize_pose_graph` through its graph; copied out."""

        def body(*fields):
            return posegraph.optimize_pose_graph(
                posegraph.PoseGraph(*fields), iterations, lm_lambda, anchor_weight), []

        key = ("posegraph", g.poses0.shape[0], g.edge_i.shape[0], iterations,
               lm_lambda, anchor_weight)
        return posegraph.PoseGraphResult(*(t.clone() for t in self.run(key, body, tuple(g))))

    def ba(self, prob: ba.BAProblem, gn_iterations: int = 5, cg_iterations: int = 20,
           lm_lambda: float = 1.0e-4, anchor_weight: float = 1.0e6,
           axis=None) -> ba.BAResult:
        """`ba.ba_solve` through its graph; copied out.  With `axis` (a
        `comm.Axis`) `prob` holds this rank's observations and every
        per-observation sum is finished by one all-reduce SUM over the
        axis (`parallel.sharded.sharded_ba_solve`); else `reduce=None`."""

        def total(x: torch.Tensor) -> torch.Tensor:
            return comm.all_reduce(x, comm.SUM, axis, "BA: sums")

        def body(*fields):
            return ba.ba_solve(ba.BAProblem(*fields), gn_iterations, cg_iterations,
                               lm_lambda, anchor_weight,
                               reduce=None if axis is None else total), []

        key = ("ba", prob.poses.shape[0], prob.landmarks.shape[0], prob.obs_kf.shape[0],
               gn_iterations, cg_iterations, lm_lambda, anchor_weight) + _axes_key(
                   None if axis is None else (axis,))
        return ba.BAResult(*(t.clone() for t in self.run(key, body, tuple(prob))))

    def corrections(self, map_cfg, corr_kf, kf_frames, frames, m):
        """`corrections.interpolate_corrections(corr_kf, kf_frames, frames)`
        and `reanchor_map(m, that, 0, map_cfg)` through their graph.
        Returns (the (F, 4, 4) corrections, `m` re-anchored), copied out."""

        def body(corr_kf, kf_frames, frames, positions, blocks, valid, frame_born):
            corr = corrections.interpolate_corrections(corr_kf, kf_frames, frames)
            read = dict(dict.fromkeys(mapstore.MapState._fields), positions=positions,
                        blocks=blocks, valid=valid, frame_born=frame_born)
            moved = corrections.reanchor_map(mapstore.MapState(**read), corr, 0, map_cfg)
            return (corr, moved.positions, moved.blocks), []

        key = ("corr", corr_kf.shape[0], frames.shape[0], m.positions.shape[0], map_cfg)
        corr, positions, blocks = (t.clone() for t in self.run(
            key, body, (corr_kf, kf_frames, frames, m.positions, m.blocks, m.valid,
                        m.frame_born)))
        return corr, m._replace(positions=positions, blocks=blocks)

    def add_keyframe(self, store, pose, feats, frame_idx, obs_lm):
        """`keyframes.add_keyframe` with a 0-d `frame_idx` through its graph;
        the new store copied out."""

        def body(*args):
            n = len(keyframes.KeyframeStore._fields)
            return keyframes.add_keyframe(
                keyframes.KeyframeStore(*args[:n]), args[n],
                pipeline.FrameFeatures(*args[n + 1:n + 5]), args[n + 5], args[n + 6]), []

        key = ("kf_add",) + tuple(store.kp_mask.shape)
        out = self.run(key, body, tuple(store) + (pose,) + tuple(feats) + (frame_idx, obs_lm))
        return keyframes.KeyframeStore(*(t.clone() for t in out))


def _apply(result):
    """The outputs of a body's (outputs, writes), each write copied into its
    buffer."""
    outputs, writes = result
    for buf, value in writes:
        buf.copy_(value)
    return outputs


def _copied(diag: pipeline.StepDiagnostics, keep) -> pipeline.StepDiagnostics:
    """The diagnostics the caller reads (see `Graphs.step`), copied out of
    the pool; None in every other field, so nothing reads a buffer a later
    replay rewrites."""
    if keep == "all":
        return clone_tree(diag)
    out = dict.fromkeys(pipeline.StepDiagnostics._fields)
    out["packed"] = diag.packed.clone()
    if keep:
        out.update(features=clone_tree(diag.features), corr_index=diag.corr_index.clone(),
                   corr_inlier=diag.corr_inlier.clone())
    return pipeline.StepDiagnostics(**out)
