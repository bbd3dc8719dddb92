"""The steps and the pair verification through `odometry.graphs`, on the CPU.

On the CPU a `Graphs` runs each body eagerly on its static buffers (on the
card it replays the body's CUDA graph: `tests/test_torch_cuda.py`), so these
tests hold the buffer plumbing: inputs copied in, the state updated in place
in one buffer set per map capacity, outputs copied out.

(a) Bit for bit: the graphed deferred step (compact and masked) against
    `pipeline.odometry_step_deferred` on its own state, frame by frame over
    six frames: committed frames; a frame entered with ok False (aborted:
    every state field passes through); a growth of the map to the next
    capacity (a second buffer set); a state assigned from outside (a
    numpy round trip, as a resume assigns one).  Every field of the state,
    the commit flag and the packed row are equal each frame; each frame's
    features and correspondences, retained, still equal its own frame's
    after the later frames ran (as the pipelined engine reads them at
    drain time, up to `fetch_every` frames later).
(b) The engine through its graphs (synchronous and pipelined, host and
    device preprocess) against the JAX package's `SlamEngine` on the same
    five frames with the reference's RANSAC draws injected, at
    tests/test_torch_engine.py's and tests/test_torch_fused.py's tolerances
    (counts within 5, poses within 2 mm and 1e-4 rad; the feature stage's
    eigen-solves round differently), and bit for bit against the same
    engine with `graphs=False`.
(c) A window overflow through the graphs: the synchronous engine's
    replayed step aborts and the frame re-runs through the dense step's
    graph, the pipelined engine drains and re-runs every stalled frame
    through it; `graphs=False` re-runs the same frames through the same
    dense body, eagerly; records bit for bit as with `graphs=False`.  A map eviction through its
    graph (the state buffers' map evicted in place) gives the eager
    engine's records, and the eager `evict_keypoints`' map, bit for bit.
(d) `_verify_pair` through one graph for two keyframe pairs against the
    JAX package's `_verify_pair` (inliers equal, pose within 1 mm and 1e-4,
    rmse within 1 mm, as tests/test_torch_backend.py holds it) and bit for
    bit against the eager call; `find_loop_closures` through graphs
    against `graphs=False`, with a generator's draws (drawn before each
    pair) and with injected ones.
(e) The pipelined engine with the backend through its graphs (the pairs,
    the keyframe histograms, the pose graph, the corrections and the
    keyframe adds) against `graphs=False`: records, keyframe store and loop
    edges bit for bit.
(f) A call whose input does not match its key's static buffer raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bshot_slam_tpu.config as jc
import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu.backend import loop_closure as jlc
from bshot_slam_tpu.odometry import pipeline as jpipe
from bshot_slam_tpu.odometry.engine import SlamEngine as JaxEngine
from bshot_slam_tpu_torch import convert
from bshot_slam_tpu_torch.backend import keyframes as tkf
from bshot_slam_tpu_torch.backend import loop_closure as tlc
from bshot_slam_tpu_torch.io import synthetic
from bshot_slam_tpu_torch.odometry import mapstore as tmap
from bshot_slam_tpu_torch.odometry import pipeline as tpipe
from bshot_slam_tpu_torch.odometry.engine import SlamEngine, host_cloud
from bshot_slam_tpu_torch.odometry.graphs import Graphs, leaves
from bshot_slam_tpu_torch.ops.rangeimage import build_range_image
from tests.test_torch_engine_modes import _prefilled, _same_records, _windowed
from tests.torch_kernel_cases import keyframe_pair

N_FRAMES = 5
TILE = tc.tiny_config().runtime.point_tile


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other engine test files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.reshape(-1).numpy().view(np.uint8), b.reshape(-1).numpy().view(np.uint8))


def _same_tree(a, b) -> bool:
    return all(_same_bits(x, y) for x, y in zip(leaves(a), leaves(b)))


@pytest.fixture(scope="module")
def sweeps():
    cfg = tc.tiny_config()
    sw, _ = synthetic.render_sequence(6, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                      seed=11, n_firings=cfg.sensor.n_azimuth)
    return sw


# ---------------------------------------------------------------------------
# (a) the body on its buffers against the deferred step


@pytest.mark.parametrize("masked", [False, True])
def test_graph_body_matches_deferred_step(sweeps, masked):
    """Bit for bit, frame by frame (see (a) above)."""
    cfg = tc.tiny_config()
    H = cfg.match.ransac_iterations
    ref = tpipe.init_state(cfg, device="cpu")
    ref = ref._replace(map=tmap.init_map(cfg.map, 2048, device="cpu"))
    mine, graphs = ref, Graphs("cpu")
    yes, no = torch.ones((), dtype=torch.bool), torch.zeros((), dtype=torch.bool)
    kept, before_abort = [], None
    for i, sw in enumerate(sweeps):
        ri = build_range_image(sw, cfg.sensor)
        pts, nv = host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad, ri.selected, cfg)
        points, n_valid = torch.from_numpy(pts), torch.tensor(nv, dtype=torch.int32)
        pmask = torch.arange(points.shape[0]) < nv if masked else None
        draws = torch.from_numpy(np.random.default_rng(100 + i).random((H, 3))
                                 .astype(np.float32))
        if i == 3:  # growth: the next capacity, a new buffer set
            ref = ref._replace(map=tmap.grow_map(ref.map, 4096))
            mine = mine._replace(map=tmap.grow_map(mine.map, 4096))
        if i == 4:  # a state assigned from outside, as a resume assigns one
            mine = convert.state_from_numpy(convert.state_to_numpy(ref), device="cpu")
        ok = no if i == 2 else yes
        if i == 2:
            before_abort = [t.clone() for t in leaves(ref)]
        ref, ref_ok, ref_diag = tpipe.odometry_step_deferred(
            ref, ok, points, pmask, n_valid, draws, cfg, TILE)
        mine, mine_ok, diag = graphs.step(cfg, TILE, mine, ok, points, pmask, n_valid,
                                          draws, keep=True)
        assert mine is graphs._states[mine.map.positions.shape[0]]  # in place
        assert mine_ok is graphs.ok
        assert _same_tree(mine, ref), f"frame {i}"
        assert _same_bits(mine_ok, ref_ok) and _same_bits(diag.packed, ref_diag.packed)
        assert diag.pose is None  # only what the engine reads is copied out
        if i == 2:  # aborted: every field passed through
            assert all(_same_bits(a, b) for a, b in zip(before_abort, leaves(mine)))
        kept.append((diag, ref_diag))
    assert float(kept[2][1].packed[tpipe.IDX_COMMITTED]) == 0.0  # the abort
    assert float(kept[3][1].packed[tpipe.IDX_COMMITTED]) == 1.0
    assert max(int(d.packed[tpipe.IDX_N_INLIERS]) for d, _ in kept) >= 4
    for i, (diag, want) in enumerate(kept):  # retained past the later frames
        assert _same_tree(diag.features, want.features), f"frame {i}"
        assert _same_bits(diag.corr_index, want.corr_index)
        assert _same_bits(diag.corr_inlier, want.corr_inlier)
    assert sorted(graphs._states) == [2048, 4096] and len(graphs._graphs) == 2



# ---------------------------------------------------------------------------
# (b) the engine through its graphs against the JAX package


@pytest.fixture(scope="module")
def reference_runs(sweeps):
    """The JAX package's synchronous engine over the first N_FRAMES sweeps,
    host and device preprocess, recording each step's RANSAC draws."""
    jcfg = jc.tiny_config()
    H = jcfg.match.ransac_iterations
    out = {}
    for host, name in ((True, "odometry_step_compact"), (False, "odometry_step")):
        draws, step = [], getattr(jpipe, name)

        def recording(state, points, mask_or_nv, key, *args, step=step, draws=draws,
                      **kw):
            draws.append(np.asarray(jax.random.uniform(key, (H, 3))))
            return step(state, points, mask_or_nv, key, *args, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jpipe, name, recording)
            je = JaxEngine(jcfg, seed=0, tile=TILE, host_preprocess=host)
            for sw in sweeps[:N_FRAMES]:
                je.process_sweep(sw)
        out[host] = (je, draws)
    return out


@pytest.mark.parametrize("host_preprocess", [True, False], ids=["host", "fused"])
@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_graphed_engine_matches_reference(sweeps, reference_runs, host_preprocess,
                                          pipelined):
    je, draws = reference_runs[host_preprocess]
    runs = []
    for graphs in (True, False):
        eng = SlamEngine(tc.tiny_config(), seed=0, tile=TILE, device="cpu",
                         draws=draws, host_preprocess=host_preprocess,
                         pipelined=pipelined, fetch_every=2, graphs=graphs)
        for sw in sweeps[:N_FRAMES]:
            eng.process_sweep(sw)
        eng.flush()
        runs.append(eng)
    graphed, eager = runs
    _same_records(graphed.records, eager.records)  # bit for bit
    kind = "fused" if pipelined and not host_preprocess else (
        "compact" if host_preprocess else "masked")
    assert [k[0] for k in graphed.graphs._graphs] == [kind]
    if kind == "compact":  # the count rides in a 0-d int32 buffer
        n_valid = next(iter(graphed.graphs._graphs.values())).static[2]
        assert n_valid.dtype == torch.int32 and n_valid.shape == ()
    assert len(graphed.records) == len(je.records) == N_FRAMES
    for a, b in zip(je.records, graphed.records):
        assert abs(a.n_mutual - b.n_mutual) <= 5
        assert abs(a.n_inliers - b.n_inliers) <= 5
        assert abs(a.map_size - b.map_size) <= 5
        assert a.gated == b.gated
        assert np.abs(a.pose[:3, 3] - b.pose[:3, 3]).max() <= 2.0
        assert np.abs(a.pose[:3, :3] - b.pose[:3, :3]).max() <= 1e-4
    assert max(r.n_inliers for r in graphed.records) >= 4  # matching engages


# ---------------------------------------------------------------------------
# (c) a window overflow through the graphs


def _counting(eng, name: str) -> list:
    """Calls of the engine's method `name`, counted from now."""
    calls, method = [], getattr(eng, name)
    setattr(eng, name, lambda *a: (calls.append(1), method(*a))[1])
    return calls


@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "pipelined"])
def test_graphed_window_overflow(pipelined):
    cfg = _windowed(tc)
    sw, _ = synthetic.render_sequence(6, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                      seed=0, n_firings=cfg.sensor.n_azimuth)
    runs = []
    for graphs in (True, False):
        eng = SlamEngine(cfg, seed=0, device="cpu", tile=TILE, pipelined=pipelined,
                         fetch_every=3, graphs=graphs)
        d = convert.state_to_numpy(eng.state)
        eng.state = convert.state_from_numpy(
            _prefilled(d, np.random.default_rng(3), 200, 300, cfg), device="cpu")
        dense = _counting(eng, "_run_dense")
        for s in sw:
            eng.process_sweep(s)
        eng.flush()
        runs.append((eng, len(dense)))
    (graphed, g_dense), (eager, e_dense) = runs
    _same_records(graphed.records, eager.records)
    assert g_dense == e_dense  # both modes re-run the same frames, dense
    assert "dense" in {k[0] for k in graphed.graphs._graphs}
    if pipelined:  # every stalled frame re-ran through the dense step
        assert g_dense == graphed.n_redispatched == eager.n_redispatched > 0
    else:  # the aborted frames only: the others fit their windows
        assert 0 < g_dense < len(sw)


def test_graphed_eviction_matches_eager():
    """A map eviction through its graph: the engine's records bit for bit
    the eager engine's (synchronous and pipelined); the state buffers'
    map evicted in place bit for bit as `evict_keypoints`' new map."""
    cfg = tc.tiny_config()
    cap, k = cfg.map.capacity, cfg.keypoints.top_k
    sw, _ = synthetic.render_sequence(3, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                      seed=2, n_firings=cfg.sensor.n_azimuth)
    for pipelined in (False, True):
        runs = []
        for graphs in (True, False):
            eng = SlamEngine(cfg, seed=0, device="cpu", tile=TILE, graphs=graphs,
                             pipelined=pipelined, fetch_every=2)
            d = convert.state_to_numpy(eng.state)
            full = _prefilled(d, np.random.default_rng(4), 0, cap - k - 40, cfg,
                              far=(1.9e6, 1.92e6))
            eng.state = convert.state_from_numpy(full, device="cpu")
            with pytest.warns(UserWarning, match="evicting"):
                for s in sw:
                    eng.process_sweep(s)
                eng.flush()
            runs.append(eng)
        graphed, eager = runs
        _same_records(graphed.records, eager.records)
        assert graphed.n_evicted == eager.n_evicted > 0
        assert graphed.state is graphed.graphs._states[cap]
        assert [key[:3] for key in graphed.graphs._graphs if key[0] == "evict"] == [
            ("evict", cap, 2 * k)]
    graphs = Graphs("cpu")
    state = convert.state_from_numpy(full, device="cpu")
    want = tmap.evict_keypoints(state.map, 2 * k)
    got = graphs.evict(state, 2 * k)
    assert got is graphs._states[cap] and _same_tree(got.map, want)
    assert int(want.cursor) == int(state.map.cursor) - 2 * k


# ---------------------------------------------------------------------------
# (d) the loop pair


def test_graphed_verify_pair_matches_reference():
    cfg = jc.default_config().match
    graphs = Graphs("cpu")
    for seed in (1, 2):  # the second pair through the first pair's graph
        args = keyframe_pair(seed)
        key = jax.random.PRNGKey(seed)
        T_w, n_w, rmse_w = jlc._verify_pair(
            key, *[jnp.asarray(a) for a in args], cfg.ransac_inlier_th_mm, 512,
            cfg.icp_iterations)
        draws = torch.tensor(np.asarray(jax.random.uniform(key, (512, 3))))
        targs = [torch.tensor(a.view(np.int32) if a.dtype == np.uint32 else a)
                 for a in args]
        got = graphs.verify_pair(draws, *targs, cfg.ransac_inlier_th_mm, 512,
                                 cfg.icp_iterations)
        eager = tlc._verify_pair(draws, *targs, cfg.ransac_inlier_th_mm, 512,
                                 cfg.icp_iterations)
        assert all(_same_bits(g, e) for g, e in zip(got, eager))
        T_g, n_g, rmse_g = got
        assert int(n_g) == int(n_w) >= 300
        assert np.abs(T_g.numpy()[:3, 3] - np.asarray(T_w)[:3, 3]).max() <= 1.0
        assert np.abs(T_g.numpy()[:3, :3] - np.asarray(T_w)[:3, :3]).max() <= 1e-4
        assert abs(float(rmse_g) - float(rmse_w)) <= 1.0
    assert len(graphs._graphs) == 1


def _store(cfg):
    """Six keyframes alternating between two overlapping keypoint sets,
    3 m apart along x (as tests/test_torch_backend.py builds its store)."""
    K = cfg.keypoints.top_k
    store = tkf.init_keyframes(cfg, device="cpu")
    for k in range(6):
        args = keyframe_pair(40 + k % 2, K)
        kp, desc, mask = (args[0], args[1], args[2]) if k % 3 else args[3:]
        pose = torch.eye(4)
        pose[0, 3] = 3000.0 * k
        feats = tpipe.FrameFeatures(torch.tensor(kp), torch.zeros(K),
                                    torch.tensor(desc.view(np.int32)), torch.tensor(mask))
        store = tkf.add_keyframe(store, pose, feats, k, torch.full((K,), -1, dtype=torch.int32))
    return store


@pytest.mark.parametrize("rng", ["generator", "injected"])
def test_find_loop_closures_graphed_matches_eager(rng):
    cfg = tc.tiny_config()
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, lc_min_gap=2, lc_max_dist_mm=30000.0, lc_min_inliers=10))
    store = _store(cfg)
    H = cfg.match.ransac_iterations
    out = []
    for graphs in (True, False):
        if rng == "generator":
            source = torch.Generator().manual_seed(5)
        else:
            source = iter([np.random.default_rng(i).random((H, 3)) for i in range(64)])
        stats = {}
        out.append((tlc.find_loop_closures(store, cfg, source, 4, stats=stats,
                                           graphs=graphs), stats))
    (got, s_got), (want, s_want) = out
    assert s_got == s_want and s_got["verified"] >= 3 and len(want) >= 1
    assert [(e.kf_i, e.kf_j, e.n_inliers, e.rmse_mm, e.z.tobytes()) for e in got] == \
        [(e.kf_i, e.kf_j, e.n_inliers, e.rmse_mm, e.z.tobytes()) for e in want]


# ---------------------------------------------------------------------------
# (e) the backend engine, (f) a mismatched input


def test_graphed_backend_engine_matches_eager():
    n = 8
    cfg = tc.tiny_config()
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, keyframe_every=1, lc_min_gap=3, lc_max_dist_mm=8000.0,
        lc_min_inliers=8))
    sw, _ = synthetic.render_sequence(n, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                      seed=4, yaw_rate_rad=2 * np.pi / n,
                                      n_firings=cfg.sensor.n_azimuth)
    runs = []
    for graphs in (True, False):
        eng = SlamEngine(cfg, seed=0, tile=TILE, device="cpu", enable_backend=True,
                         backend_every=4, pipelined=True, fetch_every=3,
                         keep_corr=True, graphs=graphs)
        for s in sw:
            eng.process_sweep(s)
        eng.flush()
        runs.append(eng)
    graphed, eager = runs
    _same_records(graphed.records, eager.records)
    a, b = (convert.keyframes_to_numpy(e.keyframes) for e in runs)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert [(e.kf_i, e.kf_j, e.n_inliers, e.z.tobytes()) for e in graphed.loop_edges] == \
        [(e.kf_i, e.kf_j, e.n_inliers, e.z.tobytes()) for e in eager.loop_edges]
    for k in ("src_world", "index", "inlier"):
        np.testing.assert_array_equal(graphed.last_corr[k], eager.last_corr[k])
    assert eager.backend_stats["verified"] > 0
    assert {"pair", "bow", "posegraph", "corr", "kf_add"} <= {
        k[0] for k in graphed.graphs._graphs}


def test_mismatched_input_raises():
    graphs = Graphs("cpu")

    def body(x):
        return x * 2, []

    graphs.run("double", body, (torch.ones(4),))
    with pytest.raises(ValueError):
        graphs.run("double", body, (torch.ones(5),))
    with pytest.raises(ValueError):
        graphs.run("double", body, (torch.ones(4, dtype=torch.float64),))
