"""What each rank of the port's sharded CPU tests runs (torch and numpy only).

`tests/test_torch_sharded.py` and `tests/test_torch_multihost.py` start
ranks with `bshot_slam_tpu_torch.parallel.multihost.spawn_local` (gloo, one
CPU thread each) and hand them `run_cases`; this module imports no JAX, so
a spawned rank stays light.  One rank (a different one for each
reference, so they run side by side) also runs the single-device port on the
same inputs in its own process, at the same thread count as the ranks.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from bshot_slam_tpu_torch import config as tc

TILE = 256


def step_inputs(cfg, seed: int = 0):
    """The reference's test cloud (tests/test_sharded.py:_inputs)."""
    rng = np.random.default_rng(seed)
    P = cfg.preprocess.max_points
    n = P // 2
    pts = np.zeros((P, 3), np.float32)
    pts[:n] = rng.uniform(-20000, 20000, (n, 3))
    pmask = np.zeros(P, bool)
    pmask[:n] = True
    return pts, pmask


def engine_cfg(capacity: int = 256):
    """tests/test_engine_sharded.py's config: a capacity low enough that a
    short drive grows through the map ladder and evicts."""
    return tc.SlamConfig(
        sensor=tc.SensorConfig(n_azimuth=256),
        preprocess=tc.PreprocessConfig(max_points=2048),
        keypoints=tc.KeypointConfig(top_k=64),
        descriptor=tc.DescriptorConfig(max_neighbors=64),
        match=tc.MatchConfig(ransac_iterations=128),
        map=tc.MapConfig(capacity=capacity),
        backend=tc.BackendConfig(max_keyframes=16, keyframe_every=2),
        runtime=tc.RuntimeConfig(point_tile=256, cloud_buckets=(1024, 2048),
                                 map_buckets=(128, 256, 512, 1024)),
    )


def records(eng) -> list:
    """An engine's records as plain tuples (bytes for the arrays)."""
    return [(r.pose.tobytes(), r.n_inliers, r.n_mutual, r.gated, r.map_size,
             r.icp_rmse, r.corr_stats.tobytes(), r.n_dropped) for r in eng.records]


def _maps(m) -> dict:
    return {f: getattr(m, f).numpy().copy() for f in m._fields}


def _bits(tree) -> list:
    from bshot_slam_tpu_torch.odometry.graphs import leaves

    return [t.numpy().tobytes() for t in leaves(tree)]


def _axes_of(graphs) -> dict:
    """{key kind: the (name, size, rank, backend) of each axis in the key}
    of a `Graphs`' step and eviction keys."""
    out = {}
    for k in graphs._graphs:
        if k[0] in ("compact", "masked", "dense", "dense_masked", "evict"):
            out[k[0]] = [a[:4] for a in (k[3] if k[0] == "evict" else k[4])]
    return out


def case_step(mesh, single: bool) -> dict:
    """Two sharded steps on the reference's cloud (the second matches the
    first): packed rows, this rank's map rows and the gathered map, and
    whether each step left the state it was given as it was (the step
    replays through its `Graphs`, whose buffers it copies out of); with
    `single`, the same on one device with the mesh overrides."""
    from bshot_slam_tpu_torch.odometry import pipeline
    from bshot_slam_tpu_torch.parallel import sharded

    cfg = tc.tiny_config()
    step, place = sharded.sharded_odometry_step(mesh, cfg, tile=TILE)
    pts, pmask = (torch.from_numpy(a) for a in step_inputs(cfg))
    state = place(pipeline.init_state(cfg, device="cpu"))
    packed, kept = [], []
    for f in range(2):
        given = _bits(state)
        new, diag = step(state, pts, pmask, torch.Generator().manual_seed(f))
        kept.append(_bits(state) == given and _bits(new) != given)
        state = new
        packed.append(diag.packed.numpy().copy())
    out = dict(packed=packed, local=_maps(state.map),
               whole=_maps(sharded.gather_state(state, mesh).map),
               kind=type(state.map).__name__, kept=kept, graphed=not step.graphs.eager,
               axes=_axes_of(step.graphs))
    if single:
        c1 = sharded.mesh_runtime_overrides(cfg, 1)
        s1 = pipeline.init_state(c1, device="cpu")
        out["single_packed"] = []
        for f in range(2):
            s1, d1 = pipeline.odometry_step(s1, pts, pmask,
                                            torch.Generator().manual_seed(f), c1, TILE)
            out["single_packed"].append(d1.packed.numpy().copy())
        out["single_map"] = _maps(s1.map)
    return out


def case_injected(mesh, feats: dict, draws: np.ndarray, seed: int) -> dict:
    """One sharded step from the empty state with the reference's features
    and RANSAC draws injected: the packed row and the gathered map."""
    from bshot_slam_tpu_torch.odometry import pipeline
    from bshot_slam_tpu_torch.parallel import sharded

    cfg = tc.tiny_config()
    step, place = sharded.sharded_odometry_step(mesh, cfg, tile=TILE)
    f = pipeline.FrameFeatures(**{k: torch.from_numpy(v) for k, v in feats.items()})
    saved = pipeline.compute_features
    pipeline.compute_features = lambda *a, **k: f
    try:
        pts, pmask = (torch.from_numpy(a) for a in step_inputs(cfg, seed))
        state, diag = step(place(pipeline.init_state(cfg, device="cpu")), pts, pmask,
                           torch.from_numpy(draws))
    finally:
        pipeline.compute_features = saved
    return dict(packed=diag.packed.numpy().copy(),
                whole=_maps(sharded.gather_state(state, mesh).map))


def _drive(eng, sweeps):
    for sw in sweeps:
        eng.process_sweep(sw)
    if eng.pipelined:
        eng.flush()
    return eng


def case_engine(mesh, single: bool, straight: bool, ckpt_dir: str, n: int = 10,
                n_a: int = 4) -> dict:
    """The engine sharded through growth, eviction and the backend (a pass
    every 8 frames), synchronous and pipelined, through its graphs (on the
    CPU their bodies on the static buffers) and eagerly (`graphs=False`),
    with the collectives each synchronous drive counted and the axes in
    its graphs' keys; and a checkpoint after n_a frames (to `ckpt_dir`)
    resumed by a fresh sharded engine, graphed and eager.  With `single`,
    the first on one device; with `straight`, the uninterrupted run the
    resumed one continues, on one device."""
    from bshot_slam_tpu_torch import checkpoint as ckpt
    from bshot_slam_tpu_torch.io import synthetic
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.parallel import comm, sharded

    warnings.simplefilter("ignore")
    cfg = engine_cfg()
    sweeps, _ = synthetic.render_sequence(
        n, cfg.sensor, step_mm=350.0, noise_mm=10.0, seed=13,
        n_firings=cfg.sensor.n_azimuth, yaw_rate_rad=2 * np.pi / (3 * n))
    kw = dict(seed=0, tile=TILE, enable_backend=True, backend_every=8)
    out = dict(counts={})
    for graphs in (True, False):
        comm.reset_counts()
        sync = _drive(SlamEngine(cfg, mesh=mesh, graphs=graphs, **kw), sweeps)
        out["counts"][graphs] = comm.counts()
        pipe = _drive(SlamEngine(cfg, mesh=mesh, pipelined=True, fetch_every=3,
                                 graphs=graphs, **kw), sweeps)
        tag = "" if graphs else "_eager"
        out.update({"sync" + tag: records(sync), "pipe" + tag: records(pipe),
                    "evicted" + tag: sync.n_evicted, "eager" + tag: sync.graphs.eager})
        if graphs:
            out.update(kf=sync._kf_count, rows=sync.state.map.positions.shape[0],
                       capacity=sync._capacity(), kind=type(sync.state.map).__name__,
                       axes=_axes_of(sync.graphs), pipe_axes=_axes_of(pipe.graphs))

    cfg2 = engine_cfg(capacity=1024)
    kw2 = dict(seed=0, tile=TILE, enable_backend=True)
    first = _drive(SlamEngine(cfg2, mesh=mesh, **kw2), sweeps[:n_a])
    ckpt.save_state(ckpt_dir, first.state, first.poses, mesh=mesh)
    ckpt.save_backend(ckpt_dir, first)
    for graphs in (True, False):
        resumed = SlamEngine(cfg2, mesh=mesh, graphs=graphs, **kw2)
        resumed.state, _ = ckpt.load_state(ckpt_dir, mesh=mesh)
        resumed._place_state()
        ckpt.load_backend(ckpt_dir, resumed)
        out["resumed" + ("" if graphs else "_eager")] = records(_drive(resumed,
                                                                      sweeps[n_a:]))
    out["resumed_kind"] = type(resumed.state.map).__name__
    if single:
        one = _drive(SlamEngine(sharded.mesh_runtime_overrides(cfg, 1),
                                device="cpu", **kw), sweeps)
        out.update(single=records(one), single_evicted=one.n_evicted,
                   single_kf=one._kf_count)
    if straight:
        whole = _drive(SlamEngine(sharded.mesh_runtime_overrides(cfg2, 1),
                                  device="cpu", **kw2), sweeps)
        out["straight"] = records(whole)[n_a:]
    return out


def case_device_preprocess(mesh, single: bool, n: int = 3) -> dict:
    """The synchronous engine with the device preprocess
    (`host_preprocess=False`) over the mesh; with `single`, on one device."""
    from bshot_slam_tpu_torch.io import synthetic
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.parallel import sharded

    warnings.simplefilter("ignore")
    cfg = tc.tiny_config()
    sweeps, _ = synthetic.render_sequence(n, cfg.sensor, step_mm=350.0,
                                          noise_mm=10.0, seed=5,
                                          n_firings=cfg.sensor.n_azimuth)
    out = dict(mesh=records(_drive(SlamEngine(cfg, seed=0, tile=TILE, mesh=mesh,
                                              host_preprocess=False), sweeps)))
    if single:
        one = SlamEngine(sharded.mesh_runtime_overrides(cfg, 1), seed=0, tile=TILE,
                         device="cpu", host_preprocess=False)
        out["single"] = records(_drive(one, sweeps))
    return out


def case_ba(mesh, prob: dict, single: bool) -> dict:
    """The sharded bundle adjustment of a numpy problem through the mesh's
    `Graphs` (on the CPU its body on the static buffers), and eagerly
    (`eager`); with `single`, the dense solve too."""
    from bshot_slam_tpu_torch.backend.ba import BAProblem, ba_solve
    from bshot_slam_tpu_torch.odometry.graphs import Graphs
    from bshot_slam_tpu_torch.parallel import sharded

    p = BAProblem(**{k: torch.from_numpy(v) for k, v in prob.items()})
    res = sharded.sharded_ba_solve(mesh, p, gn_iterations=3, cg_iterations=15)
    out = {k: v.numpy().copy() for k, v in res._asdict().items()}
    eager = sharded.sharded_ba_solve(mesh, p, gn_iterations=3, cg_iterations=15,
                                     graphs=Graphs("cpu", eager=True))
    out["eager"] = {k: v.numpy().copy() for k, v in eager._asdict().items()}
    graphs = sharded.ba_graphs(mesh)
    out["keys"] = [k[:8] + tuple([a[:4] for a in ax] for ax in k[8:])
                   for k in graphs._graphs]
    out["graphed"] = not graphs.eager
    if single:
        dense = ba_solve(p, gn_iterations=3, cg_iterations=15)
        out["dense"] = {k: v.numpy().copy() for k, v in dense._asdict().items()}
    return out


def case_comm(mesh) -> dict:
    """Each collective of `parallel.comm` on small tensors of known values."""
    from bshot_slam_tpu_torch.parallel import comm

    ax = comm.Axis.world()
    r = ax.rank
    comm.reset_counts()
    x = torch.tensor([r, -r, 10 * r], dtype=torch.int64)
    return dict(
        rank=r, size=ax.size,
        min=comm.all_reduce(x, comm.MIN, ax, "t").tolist(),
        max=comm.all_reduce(x, comm.MAX, ax, "t").tolist(),
        sum=comm.all_reduce(x, comm.SUM, ax, "t").tolist(),
        gather=comm.all_gather(torch.tensor([[-0.0, float(r)]]), ax, "g").numpy(),
        gather_bool=comm.all_gather(torch.tensor([r % 2 == 0]), ax, "g").tolist(),
        bcast=comm.broadcast(torch.tensor([r + 7]), 1 % ax.size, ax, "b").tolist(),
        counts=comm.counts(),
        backends={n: comm.Axis.of(mesh, n).backend for n in mesh.mesh_dim_names},
    )


def run_cases(rank: int, cases: dict) -> dict:
    """Rank `rank`'s results of the named cases over a `make_mesh` mesh;
    `cases` maps a case name to its keyword arguments, where `single` (and
    `straight`) name the rank that runs that single-device reference."""
    from bshot_slam_tpu_torch.parallel import sharded

    mesh = sharded.make_mesh()
    fns = dict(step=case_step, injected=case_injected, engine=case_engine,
               ba=case_ba, comm=case_comm, device_preprocess=case_device_preprocess)
    out = dict(mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)))
    for name, kw in cases.items():
        kw = {k: (v == rank if k in ("single", "straight") else v)
              for k, v in kw.items()}
        out[name] = fns[name](mesh, **kw)
    return out
