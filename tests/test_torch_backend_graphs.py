"""The backend's programs through `odometry.graphs`, and four repairs of the
engine's backend, on the CPU.

On the CPU a `Graphs` runs each body eagerly on its static buffers (on the
card it replays the body's CUDA graph: `tests/test_torch_cuda.py`), so these
tests hold the plumbing: keys, inputs copied in, outputs copied out.

(a) `Graphs.pose_graph`, `.bow`, `.ba`, `.corrections` and `.add_keyframe`
    against their eager bodies, bit for bit, inputs made from a seed with
    numpy: the pose graph at 8 and 16 nodes with and
    without padded (masked) loop edges, two graphs through one key; the
    keyframe histograms of a whole store, whose first n rows equal the
    n-row call bit for bit on the CPU (each row's reductions keep their
    shape); BA on tests/test_backend.py's problem; `Graphs(eager=True)`
    runs each body directly, keeping nothing; the corrections padded
    as the engine pads them (keyframes to a node bucket, frames to a power
    of two, repeating the last row) against the unpadded calls bit for bit
    and against the JAX package at tests/test_torch_backend.py's
    tolerances.
(b) `optimize_pose_graph` on a padded graph against the JAX package's, at
    tests/test_torch_backend.py's tolerance (poses within 1 mm and 1e-4 rad).
(c) The repairs (each fails on the parent commit):
    - A `Graphs` shared by engines of two configurations that differ only
      in `ransac_inlier_th_mm` keys a step for each (the reference compiles
      with `cfg` static; a key without it would replay the first engine's
      thresholds on the card).
    - `pick_eviction_slot` raises where no slot is a candidate (counts 1
      and 2) and picks a slot outside the protected anchor and newest
      quarter for counts 3-16; the engine refuses a backend with
      `max_keyframes` below 3.
    - A keyframe eviction remaps the loop edges: those left point at the
      same keyframes (by frame number), those of the evicted one go; a
      checkpoint saved after it restores the same edges.
    - `optimize_backend()`, a keyframe added, `apply_backend_corrections()`
      equals the run that adds the keyframe first (the stale poses are
      dropped, the corrections re-optimise).
"""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bshot_slam_tpu_torch.config as tc
import bshot_slam_tpu.config as jc
from bshot_slam_tpu.backend import corrections as jcorr
from bshot_slam_tpu.backend import posegraph as jpg
from bshot_slam_tpu.odometry import mapstore as jmap
from bshot_slam_tpu_torch import checkpoint, convert
from bshot_slam_tpu_torch.backend import ba as tba
from bshot_slam_tpu_torch.backend import corrections as tcorr
from bshot_slam_tpu_torch.backend import keyframes as tkf
from bshot_slam_tpu_torch.backend import loop_closure as tlc
from bshot_slam_tpu_torch.backend import posegraph as tpg
from bshot_slam_tpu_torch.backend.loop_closure import LoopEdge
from bshot_slam_tpu_torch.io import synthetic
from bshot_slam_tpu_torch.odometry import mapstore as tmap
from bshot_slam_tpu_torch.odometry import pipeline as tpipe
from bshot_slam_tpu_torch.odometry.engine import FrameRecord, SlamEngine
from bshot_slam_tpu_torch.odometry.graphs import Graphs
from tests.test_backend import _ba_problem
from tests.test_torch_backend import _corrections, _graphs, _pose_close, _t
from tests.test_torch_engine_modes import _same_records
from tests.torch_kernel_cases import evict_case, keyframe_pair, pose_graph_case

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


def _pose_graph(M, n_loops, seed):
    return tpg.PoseGraph(**{k: torch.from_numpy(v) for k, v in
                            pose_graph_case(M, n_loops, seed).items()})


# ---------------------------------------------------------------------------
# (a) the graphed bodies against the eager calls


@pytest.mark.parametrize("M,n_loops", [(8, 0), (8, 3), (16, 0), (16, 5)])
def test_graphed_pose_graph_matches_eager(M, n_loops):
    graphs = Graphs("cpu")
    for seed in (1, 2):  # the second graph through the first one's key
        g = _pose_graph(M, n_loops, seed)
        got = graphs.pose_graph(g, iterations=6)
        want = tpg.optimize_pose_graph(g, iterations=6)
        assert all(_same_bits(a, b) for a, b in zip(got, want)), seed
        assert float(want.final_cost) <= float(want.initial_cost)
    assert list(graphs._graphs) == [("posegraph", M, M - 1 + n_loops + (-n_loops) % 4,
                                     6, 1.0e-4, 1.0e6)]
    if n_loops:  # the padded edges are masked
        assert int(g.edge_mask.sum()) == M - 1 + n_loops < g.edge_mask.shape[0]


def _store(cfg, n, seed=3):
    """A store of n keyframes with random words and masks (empty rows after)."""
    rng = np.random.default_rng(seed)
    K = cfg.keypoints.top_k
    store = tkf.init_keyframes(cfg, device="cpu")
    for k in range(n):
        feats = tpipe.FrameFeatures(
            torch.from_numpy(rng.normal(0, 5000, (K, 3)).astype(np.float32)), torch.zeros(K),
            torch.from_numpy(rng.integers(-2**31, 2**31, (K, 11)).astype(np.int32)),
            torch.from_numpy(rng.random(K) < 0.8))
        store = tkf.add_keyframe(store, torch.eye(4), feats, k,
                                 torch.full((K,), -1, dtype=torch.int32))
    return store


def test_graphed_bow_matches_eager():
    cfg = tc.tiny_config()
    n = 11
    store = _store(cfg, n)
    graphs = Graphs("cpu")
    got = graphs.bow(store)
    want = tlc.keyframe_bow(store)
    assert got.shape == (cfg.backend.max_keyframes, 352) and _same_bits(got, want)
    assert _same_bits(want[:n], tlc.keyframe_bow(store, n))  # rows < n as before
    assert float(want[n:].abs().max()) == 0.0  # empty rows give zeros
    store = _store(cfg, 5, seed=4)  # a second store through the same key
    assert _same_bits(graphs.bow(store), tlc.keyframe_bow(store))
    assert list(graphs._graphs) == [("bow", cfg.backend.max_keyframes, cfg.keypoints.top_k)]


def test_bow_rows_keep_their_bits_across_chunks():
    """Rows of a store longer than one chunk (64 rows) equal the n-row call
    for n inside the first chunk, at a chunk's end and past it."""
    cfg = tc.tiny_config()
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend,
                                                               max_keyframes=80))
    store = _store(cfg, 70)
    whole = tlc.keyframe_bow(store)
    for n in (1, 63, 64, 65, 70):
        assert _same_bits(whole[:n], tlc.keyframe_bow(store, n)), n


def test_graphed_ba_matches_eager():
    prob, _, _ = _ba_problem(np.random.default_rng(77), M=6, L=40)
    prob = tba.BAProblem(*[torch.from_numpy(np.array(x)) for x in prob])
    graphs = Graphs("cpu")
    got = graphs.ba(prob, gn_iterations=4, cg_iterations=10)
    want = tba.ba_solve(prob, gn_iterations=4, cg_iterations=10)
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert float(want.final_cost) < float(want.initial_cost)
    assert list(graphs._graphs) == [("ba", 6, 40, 240, 4, 10, 1.0e-4, 1.0e6)]


def test_eager_graphs_run_the_bodies_directly():
    """`Graphs(eager=True)`, what a `graphs=False` engine and
    `find_loop_closures` call: each program on the caller's tensors, equal
    to the plain call bit for bit, with no key, buffer or capture kept."""
    cfg = tc.tiny_config()
    graphs = Graphs("cpu", eager=True)
    g = _pose_graph(8, 3, 1)
    assert all(_same_bits(a, b) for a, b in zip(
        graphs.pose_graph(g, iterations=6), tpg.optimize_pose_graph(g, iterations=6)))
    store = _store(cfg, 5)
    assert _same_bits(graphs.bow(store), tlc.keyframe_bow(store))
    prob, _, _ = _ba_problem(np.random.default_rng(77), M=6, L=40)
    prob = tba.BAProblem(*[torch.from_numpy(np.array(x)) for x in prob])
    assert all(_same_bits(a, b) for a, b in zip(
        graphs.ba(prob, gn_iterations=2, cg_iterations=5),
        tba.ba_solve(prob, gn_iterations=2, cg_iterations=5)))
    assert not graphs._graphs and not graphs._states and graphs.captures == 0
    assert graphs.pool is None


def _pad(x, n):
    """x with its last row repeated to n rows."""
    return np.concatenate([x, np.repeat(x[-1:], n - len(x), axis=0)])


def test_padded_corrections_match_unpadded_and_reference():
    """The engine's padding (keyframes to a node bucket and frames to a power
    of two, each repeating its last row) changes no correction and no
    re-anchored landmark: bit for bit against the unpadded calls, and at
    tests/test_torch_backend.py's tolerance against the JAX package (its
    inputs); `Graphs.corrections` equals the eager calls bit for bit."""
    rng = np.random.default_rng(8)
    corr_kf = _corrections(rng, 6)
    kf_frames = np.array([2, 5, 6, 11, 17, 30], np.int32)
    frames = np.arange(-3, 36, dtype=np.int32)
    F = len(frames)
    want = np.asarray(jcorr.interpolate_corrections(
        jnp.asarray(corr_kf), jnp.asarray(kf_frames), jnp.asarray(frames)))
    plain = tcorr.interpolate_corrections(_t(corr_kf), _t(kf_frames), _t(frames))
    padded = tcorr.interpolate_corrections(_t(_pad(corr_kf, 8)), _t(_pad(kf_frames, 8)),
                                           _t(_pad(frames, 64)))
    assert _same_bits(padded[:F], plain) and padded.shape[0] == 64
    got = padded[:F].numpy()
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=1e-5)
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3],
                               atol=1e-5 * np.abs(want[:, :3, 3]).max())
    # Re-anchoring through the padded corrections, the engine's frames from 0.
    tcfg = tc.default_config()
    d, _ = evict_case("ties")
    frames = np.arange(20, dtype=np.int32)
    d["frame_born"] = np.where(d["valid"], rng.integers(-1, 20, d["valid"].shape[0]),
                               -1).astype(np.int32)
    m = tmap.MapState(*[_t(d[f]) for f in tmap.MapState._fields])
    corr_kf, kf_frames = _corrections(rng, 4, rot=0.05, t=2000.0), np.array([0, 4, 9, 15])
    args = (_t(corr_kf), _t(kf_frames.astype(np.int32)), _t(frames))
    pargs = (_t(_pad(corr_kf, 8)), _t(_pad(kf_frames, 8).astype(np.int32)), _t(_pad(frames, 32)))
    plain = tcorr.reanchor_map(m, tcorr.interpolate_corrections(*args), 0, tcfg.map)
    padded_corr = tcorr.interpolate_corrections(*pargs)
    padded = tcorr.reanchor_map(m, padded_corr, 0, tcfg.map)
    jm = jmap.MapState(*[jnp.asarray(d[f]) for f in jmap.MapState._fields])
    jwant = jcorr.reanchor_map(jm, jcorr.interpolate_corrections(
        *[jnp.asarray(np.asarray(a)) for a in args]), jnp.asarray(0, jnp.int32), jc.default_config().map)
    for f in ("positions", "blocks"):
        assert _same_bits(getattr(padded, f), getattr(plain, f))
        np.testing.assert_array_equal(getattr(padded, f).numpy(), np.asarray(getattr(jwant, f)))
    assert (padded.positions.numpy() != d["positions"]).any(1).sum() > 1000
    corr, moved = Graphs("cpu").corrections(tcfg.map, *pargs, m)
    assert _same_bits(corr, padded_corr)
    assert _same_bits(moved.positions, padded.positions)
    assert _same_bits(moved.blocks, padded.blocks)


def test_graphed_keyframe_add_matches_eager():
    cfg = tc.tiny_config()
    store = _store(cfg, 6)
    graphs = Graphs("cpu")
    K = cfg.keypoints.top_k
    rng = np.random.default_rng(6)
    for f in (6, 7):  # the second add through the first's key
        feats = tpipe.FrameFeatures(
            torch.from_numpy(rng.normal(0, 5000, (K, 3)).astype(np.float32)), torch.zeros(K),
            torch.from_numpy(rng.integers(-2**31, 2**31, (K, 11)).astype(np.int32)),
            torch.from_numpy(rng.random(K) < 0.8))
        pose = torch.from_numpy(rng.normal(0, 1, (4, 4)).astype(np.float32))
        obs = torch.from_numpy(rng.integers(-1, 100, K).astype(np.int32))
        want = tkf.add_keyframe(store, pose, feats, f, obs)
        got = graphs.add_keyframe(store, pose, feats, torch.tensor(f, dtype=torch.int32), obs)
        assert all(_same_bits(a, b) for a, b in zip(got, want))
        store = want
    assert [k[0] for k in graphs._graphs] == ["kf_add"]


# ---------------------------------------------------------------------------
# (b) the padded graph against the JAX package


def test_padded_pose_graph_close_to_reference():
    """tests/test_torch_backend.py's loop graph (24 nodes) padded as the
    engine pads one: nodes to 32 repeating the last pose, 3 loop edges and
    one masked identity edge.  The same arrays go to both packages."""
    poses, pairs, z, iters = _graphs()["loop"]
    poses = np.concatenate([poses, np.repeat(poses[-1:], 8, axis=0)])
    i, j = np.arange(31), np.arange(1, 32)
    rel = np.linalg.inv(poses[i]) @ poses[j]
    arrays = dict(
        poses0=poses,
        edge_i=np.concatenate([i, [p[0] for p in pairs[:3]], [0]]),
        edge_j=np.concatenate([j, [p[1] for p in pairs[:3]], [0]]),
        edge_z=np.concatenate([rel, z[:3], np.eye(4)[None]]).astype(np.float32),
        edge_weight=np.asarray([1.0] * 31 + [20.0] * 3 + [0.0], np.float32),
        edge_mask=np.arange(35) < 34)
    want = jpg.optimize_pose_graph(jpg.PoseGraph(**{
        k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
        for k, v in arrays.items()}), iterations=iters)
    got = tpg.optimize_pose_graph(tpg.PoseGraph(**{
        k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}), iterations=iters)
    _pose_close(got.poses.numpy(), np.asarray(want.poses))
    np.testing.assert_allclose(float(got.initial_cost), float(want.initial_cost),
                               rtol=1e-4)
    assert float(got.final_cost) < 0.1 * float(got.initial_cost)


# ---------------------------------------------------------------------------
# (c) the repairs


def _sweeps(n, seed=4):
    cfg = tc.tiny_config()
    sw, _ = synthetic.render_sequence(n, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                      seed=seed, yaw_rate_rad=2 * np.pi / 8,
                                      n_firings=cfg.sensor.n_azimuth)
    return sw


@pytest.mark.parametrize("host_preprocess,pipelined", [(True, False), (False, True)],
                         ids=["compact", "fused"])
def test_graph_keys_name_the_config(host_preprocess, pipelined):
    """Two configurations that differ only in the RANSAC inlier threshold
    make two keys in one shared `Graphs`, and each engine's records equal
    its own `graphs=False` run."""
    base = tc.tiny_config()
    other = dataclasses.replace(base, match=dataclasses.replace(
        base.match, ransac_inlier_th_mm=0.5 * base.match.ransac_inlier_th_mm))
    sw = _sweeps(2)
    shared = Graphs("cpu")
    for cfg in (base, other):
        runs = []
        for graphs in (shared, False):
            eng = SlamEngine(cfg, seed=0, tile=TILE, device="cpu", graphs=graphs,
                             host_preprocess=host_preprocess, pipelined=pipelined)
            for s in sw:
                eng.process_sweep(s)
            eng.flush()
            runs.append(eng)
        _same_records(runs[0].records, runs[1].records)
    assert [k[-1] for k in shared._graphs] == [base, other]


def test_eviction_slot_needs_a_candidate():
    pos = np.random.default_rng(5).uniform(-5e4, 5e4, (16, 3))
    for count in (1, 2):
        with pytest.raises(ValueError):
            tkf.pick_eviction_slot(pos, count)
    for count in range(3, 17):
        assert 1 <= tkf.pick_eviction_slot(pos, count) < count - max(1, count // 4)
    cfg = tc.tiny_config()
    small = dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend,
                                                                 max_keyframes=2))
    with pytest.raises(ValueError, match="max_keyframes"):
        SlamEngine(small, device="cpu", enable_backend=True)
    SlamEngine(small, device="cpu")  # without the backend the store is unused


def _add_keyframe(eng, x, frame, seed=40):
    """One keyframe at x (frame `frame`) through the engine's keyframe policy
    (`keyframe_every=1` adds every frame)."""
    K = eng.cfg.keypoints.top_k
    kp, desc, mask = keyframe_pair(seed, K)[:3]
    feats = tpipe.FrameFeatures(torch.tensor(kp), torch.zeros(K),
                                torch.tensor(desc.view(np.int32)), torch.tensor(mask))
    diag = tpipe.StepDiagnostics(**dict(
        dict.fromkeys(tpipe.StepDiagnostics._fields), features=feats,
        corr_index=torch.zeros(K, dtype=torch.int32),
        corr_inlier=torch.zeros(K, dtype=torch.bool)))
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = x
    eng._maybe_keyframe(diag, FrameRecord(pose, 0, 0, False, 0, 0.0, np.zeros(3)), frame,
                        eng.state.map.positions.shape[0])


def test_keyframe_eviction_remaps_loop_edges(tmp_path):
    cfg = tc.tiny_config()
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, max_keyframes=8, keyframe_every=1))
    # Keyframe 3 sits between 2 and 4: the smallest gap, so it is evicted.
    xs = [0.0, 3000.0, 6000.0, 6100.0, 6200.0, 9000.0, 12000.0, 15000.0]
    eng = SlamEngine(cfg, device="cpu", enable_backend=True)
    for f, x in enumerate(xs):
        _add_keyframe(eng, x, f)
    frames = lambda e: e.keyframes.frame_idx.numpy()  # noqa: E731
    eng.loop_edges = [LoopEdge(i, j, np.full((4, 4), i * 10 + j, np.float32), 30 + i, 1.0)
                      for i, j in ((7, 0), (5, 3), (6, 1), (3, 1), (4, 2), (7, 5))]
    before = {(frames(eng)[e.kf_i], frames(eng)[e.kf_j]): e for e in eng.loop_edges}
    _add_keyframe(eng, 18000.0, 8, seed=41)
    assert eng.n_kf_evicted == 1 and 3 not in frames(eng)[:eng._kf_count]
    after = {(frames(eng)[e.kf_i], frames(eng)[e.kf_j]): e for e in eng.loop_edges}
    assert sorted(after) == sorted(k for k in before if 3 not in k)
    for k, e in after.items():  # the same measurement, at the new indices
        assert np.array_equal(e.z, before[k].z) and e.n_inliers == before[k].n_inliers
    checkpoint.save_backend(str(tmp_path), eng)
    resumed = SlamEngine(cfg, device="cpu", enable_backend=True)
    assert checkpoint.load_backend(str(tmp_path), resumed)
    assert [(e.kf_i, e.kf_j, e.n_inliers, e.z.tobytes()) for e in resumed.loop_edges] == \
        [(e.kf_i, e.kf_j, e.n_inliers, e.z.tobytes()) for e in eng.loop_edges]
    np.testing.assert_array_equal(frames(resumed), frames(eng))


def test_corrections_after_a_keyframe_reoptimise():
    """optimize_backend(), one more keyframe, apply_backend_corrections():
    the same records, map and store as the engine that adds the keyframe
    first and then applies (the poses optimised before the add would pair
    with the wrong rows)."""
    cfg = tc.tiny_config()
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, keyframe_every=1, lc_min_gap=3, lc_max_dist_mm=8000.0,
        lc_min_inliers=8))
    sw = _sweeps(6)
    draws = np.random.default_rng(9).random((cfg.match.ransac_iterations, 3))
    runs = []
    for early in (True, False):
        # One set of draws repeated: the early pass draws as many as it likes.
        eng = SlamEngine(cfg, seed=0, tile=TILE, device="cpu", enable_backend=True,
                         draws=itertools.repeat(draws))
        for s in sw[:-1]:
            eng.process_sweep(s)
        if early:
            eng.optimize_backend()
        n = eng._kf_count
        eng.process_sweep(sw[-1])
        assert eng._kf_count == n + 1
        corr = eng.apply_backend_corrections()
        runs.append((eng, corr))
    (a, ca), (b, cb) = runs
    assert ca == cb and ca["max_correction_mm"] > 0.0
    _same_records(a.records, b.records)
    for x, y in ((convert.state_to_numpy(a.state), convert.state_to_numpy(b.state)),
                 (convert.keyframes_to_numpy(a.keyframes),
                  convert.keyframes_to_numpy(b.keyframes))):
        for f in x:
            np.testing.assert_array_equal(x[f], y[f], err_msg=f)
