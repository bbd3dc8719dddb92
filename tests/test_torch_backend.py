"""Port parity: the backend modules and map eviction on the CPU.

Each case feeds the same seeded inputs to the reference (`bshot_slam_tpu`,
JAX on the CPU) and to the port (`bshot_slam_tpu_torch`, plain PyTorch on
the CPU).  Tolerances, each measured before it was set:
- `evict_keypoints`: every field exact, the permutation included (each
  valid row's `frame_born` is its row number, so it shows where rows went).
  Cases: ties in the score (few blocks, few seg-ratio levels), a full
  131072-row map whose float32 scores pass 2^24 and round into ties,
  `n_evict` above the valid rows, an empty map.
- Keyframes (add, a full store dropping the append, evict, the eviction
  slot picker where a slot is a candidate): exact.
- `interpolate_corrections`: rotations within 1e-5, translations within
  1e-5 of the largest (measured: 6.0e-8; 7.2e-4 mm on translations up to
  694 mm, 1.0e-6 of it); `reanchor_map` given the same corrections:
  positions and blocks exact.
- `optimize_pose_graph` on the graphs of tests/test_backend.py: poses
  within 1 mm and 1e-4 rad of the reference (measured 0.0078 mm and
  6.6e-7), the cost decreasing.
- `_verify_pair` (600 keypoints a side, as the engine's) with the
  reference's RANSAC draws: inliers exact, the transform within 1 mm and
  1e-4 rad (measured 0.0004 mm, 1.9e-8), ICP rmse within 1 mm (measured
  0.008 mm); `find_loop_closures` over a reference store carried across:
  the same edges and inliers, measurements within 1 mm.
- `ba_solve` on tests/test_backend.py's problems: initial and final cost
  within 1e-3 relative (measured 1.4e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bshot_slam_tpu.config as jc
import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu.backend import ba as jba
from bshot_slam_tpu.backend import corrections as jcorr
from bshot_slam_tpu.backend import keyframes as jkf
from bshot_slam_tpu.backend import loop_closure as jlc
from bshot_slam_tpu.backend import posegraph as jpg
from bshot_slam_tpu.odometry import mapstore as jmap
from bshot_slam_tpu.odometry import pipeline as jpipe
from bshot_slam_tpu_torch.backend import ba as tba
from bshot_slam_tpu_torch.backend import corrections as tcorr
from bshot_slam_tpu_torch.backend import keyframes as tkf
from bshot_slam_tpu_torch.backend import loop_closure as tlc
from bshot_slam_tpu_torch.backend import posegraph as tpg
from bshot_slam_tpu_torch.convert import keyframes_from_numpy, keyframes_to_numpy
from bshot_slam_tpu_torch.odometry import mapstore as tmap
from bshot_slam_tpu_torch.odometry import pipeline as tpipe
from tests.test_backend import _ba_problem, _circle_poses, _drifted
from tests.torch_kernel_cases import EVICT_CASES, evict_case, keyframe_pair


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: under the suite's parallel
    workers, multithreaded small CPU ops oversubscribe the cores (the same
    tests measured 20-50x slower there than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    a = np.asarray(x)
    return torch.tensor(a.view(np.int32) if a.dtype == np.uint32 else a)


def _n(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


# ---------------------------------------------------------------------------
# Eviction


@pytest.mark.parametrize("case", sorted(EVICT_CASES))
def test_evict_keypoints_exact(case):
    d, n_evict = evict_case(case)
    n_valid = int(d["cursor"])
    want = jmap.evict_keypoints(jmap.MapState(*[jnp.asarray(d[f]) for f in
                                                jmap.MapState._fields]), n_evict)
    got = tmap.evict_keypoints(tmap.MapState(*[_t(d[f]) for f in
                                               tmap.MapState._fields]), n_evict)
    for f in tmap.MapState._fields:
        w, g = np.asarray(getattr(want, f)), _n(getattr(got, f))
        if f == "descriptors":
            g = g.view(np.uint32)
        np.testing.assert_array_equal(g, w, err_msg=f"{case}: {f}")
    assert int(got.cursor) == max(0, n_valid - n_evict)


# ---------------------------------------------------------------------------
# Keyframes


def _features(rng, K):
    return (rng.uniform(-2e4, 2e4, (K, 3)).astype(np.float32),
            rng.uniform(0, 1, K).astype(np.float32),
            rng.integers(0, 2**32, (K, 11), dtype=np.uint64).astype(np.uint32),
            rng.random(K) > 0.2)


def test_keyframes_exact():
    jcfg, tcfg = jc.tiny_config(), tc.tiny_config()
    Mk, K = tcfg.backend.max_keyframes, tcfg.keypoints.top_k
    rng = np.random.default_rng(5)
    js, ts = jkf.init_keyframes(jcfg), tkf.init_keyframes(tcfg, device="cpu")

    def same(tag):
        got = keyframes_to_numpy(ts)
        for f in tkf.KeyframeStore._fields:
            np.testing.assert_array_equal(got[f], np.asarray(getattr(js, f)),
                                          err_msg=f"{tag}: {f}")

    same("init")
    ops = [("add", i) for i in range(Mk + 2)] + [("evict", 3), ("evict", 0),
                                                 ("add", 40), ("evict", Mk - 2)]
    for op, arg in ops:
        if op == "add":
            kp, sc, desc, mask = _features(rng, K)
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = rng.uniform(-1e4, 1e4, 3)
            obs = np.where(rng.random(K) > 0.5, rng.integers(0, 4096, K), -1).astype(np.int32)
            js = jkf.add_keyframe(js, jnp.asarray(pose), jpipe.FrameFeatures(
                jnp.asarray(kp), jnp.asarray(sc), jnp.asarray(desc), jnp.asarray(mask)),
                jnp.asarray(arg, jnp.int32), jnp.asarray(obs))
            ts = tkf.add_keyframe(ts, _t(pose), tpipe.FrameFeatures(
                _t(kp), _t(sc), _t(desc), _t(mask)), arg, _t(obs))
        else:
            js = jkf.evict_keyframe(js, jnp.asarray(arg, jnp.int32))
            ts = tkf.evict_keyframe(ts, arg)
        same(f"{op} {arg}")
    assert int(ts.count) == Mk - 2  # full after Mk adds; two drops; 3 evictions, 1 add
    # The host-side policy, on random positions and every count that has a
    # candidate slot (below 3 the reference returns slot 1, which is past
    # the store or protected; the port raises).
    pos = rng.uniform(-5e4, 5e4, (40, 3))
    for count in range(3, 41):
        assert tkf.pick_eviction_slot(pos, count) == jkf.pick_eviction_slot(pos, count)
    for count in (1, 2):
        with pytest.raises(ValueError):
            tkf.pick_eviction_slot(pos, count)
    a = np.eye(4)
    for t_mm, since in [(100.0, 1), (2500.0, 1), (0.0, 7)]:
        b = np.eye(4)
        b[:3, 3] = [t_mm, 0, 0]
        assert (tkf.should_add_keyframe(a, b, since, tcfg.backend)
                == jkf.should_add_keyframe(a, b, since, jcfg.backend))


def test_keyframes_round_trip():
    d = keyframes_to_numpy(tkf.init_keyframes(tc.tiny_config(), device="cpu"))
    back = keyframes_to_numpy(keyframes_from_numpy(d, device="cpu"))
    for f in d:
        np.testing.assert_array_equal(back[f], d[f])
    assert d["descriptors"].dtype == np.uint32


# ---------------------------------------------------------------------------
# Corrections


def _corrections(rng, n, rot=0.02, t=300.0):
    xi = np.concatenate([rng.normal(0, t, (n, 3)), rng.normal(0, rot, (n, 3))], 1)
    return np.asarray(jax.vmap(lambda x: jcorr.se3.se3_exp(x))(jnp.asarray(xi, jnp.float32)))


def test_interpolate_corrections_close():
    rng = np.random.default_rng(8)
    corr_kf = _corrections(rng, 6)
    kf_frames = np.array([2, 5, 6, 11, 17, 30], np.int32)
    frames = np.arange(-3, 36, dtype=np.int32)
    want = np.asarray(jcorr.interpolate_corrections(
        jnp.asarray(corr_kf), jnp.asarray(kf_frames), jnp.asarray(frames)))
    got = tcorr.interpolate_corrections(_t(corr_kf), _t(kf_frames), _t(frames)).numpy()
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=1e-5)
    t_scale = np.abs(want[:, :3, 3]).max()
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=1e-5 * t_scale)
    np.testing.assert_array_equal(got[:, 3], want[:, 3])


def test_reanchor_map_exact():
    jcfg, tcfg = jc.default_config(), tc.default_config()
    rng = np.random.default_rng(9)
    F = 20
    d, _ = evict_case("ties")
    C = d["valid"].shape[0]
    d["frame_born"] = np.where(d["valid"], rng.integers(-1, F + 3, C), -1).astype(np.int32)
    corr = np.asarray(jcorr.interpolate_corrections(
        jnp.asarray(_corrections(rng, 4, rot=0.05, t=2000.0)),
        jnp.asarray(np.array([0, 4, 9, 15], np.int32)),
        jnp.arange(F, dtype=jnp.int32)))
    frame0 = 2
    want = jcorr.reanchor_map(jmap.MapState(*[jnp.asarray(d[f]) for f in
                                              jmap.MapState._fields]),
                              jnp.asarray(corr), jnp.asarray(frame0, jnp.int32), jcfg.map)
    got = tcorr.reanchor_map(tmap.MapState(*[_t(d[f]) for f in tmap.MapState._fields]),
                             _t(corr), frame0, tcfg.map)
    np.testing.assert_array_equal(got.positions.numpy(), np.asarray(want.positions))
    np.testing.assert_array_equal(got.blocks.numpy(), np.asarray(want.blocks))
    moved = (got.positions.numpy() != d["positions"]).any(1)
    assert moved.sum() > 1000


# ---------------------------------------------------------------------------
# Pose graph


def _graphs():
    rng = np.random.default_rng(1234)
    n = 24
    gt = _circle_poses(n)
    noisy = _drifted(gt, rng)
    pairs = [(n - 1, 0), (12, 0), (18, 6), (20, 2)]
    z = np.stack([np.linalg.inv(gt[i]) @ gt[j] for i, j in pairs]).astype(np.float32)
    loop = (noisy, pairs, z, 15)
    chain = (_circle_poses(10), [], None, 5)
    return {"loop": loop, "chain": chain}


def _pose_close(got, want, mm=1.0, rad=1e-4):
    assert np.abs(got[..., :3, 3] - want[..., :3, 3]).max() <= mm
    assert np.abs(got[..., :3, :3] - want[..., :3, :3]).max() <= rad


@pytest.mark.parametrize("name", ["loop", "chain"])
def test_optimize_pose_graph_close(name):
    poses, pairs, z, iters = _graphs()[name]
    jg = jpg.odometry_edges(jnp.asarray(poses))
    tg = tpg.odometry_edges(_t(poses))
    if pairs:
        i, j = [p[0] for p in pairs], [p[1] for p in pairs]
        w = np.full(len(pairs), 20.0, np.float32)
        jg = jpg.add_edges(jg, jnp.asarray(i), jnp.asarray(j), jnp.asarray(z), jnp.asarray(w))
        tg = tpg.add_edges(tg, torch.tensor(i), torch.tensor(j), _t(z), _t(w))
    want = jpg.optimize_pose_graph(jg, iterations=iters)
    got = tpg.optimize_pose_graph(tg, iterations=iters)
    _pose_close(got.poses.numpy(), np.asarray(want.poses))
    # (the consistent chain's cost is rounding noise, ~1e-11)
    np.testing.assert_allclose(float(got.initial_cost), float(want.initial_cost),
                               rtol=1e-4, atol=1e-9)
    assert float(got.final_cost) <= float(got.initial_cost)
    if pairs:
        assert float(got.final_cost) < 0.1 * float(got.initial_cost)


# ---------------------------------------------------------------------------
# Loop-closure verification


@pytest.mark.parametrize("seed", [1, 2])
def test_verify_pair_close(seed):
    cfg = jc.default_config().match
    args = keyframe_pair(seed)
    key = jax.random.PRNGKey(seed)
    T_w, n_w, rmse_w = jlc._verify_pair(
        key, *[jnp.asarray(a) for a in args], cfg.ransac_inlier_th_mm,
        512, cfg.icp_iterations)
    draws = torch.tensor(np.asarray(jax.random.uniform(key, (512, 3))))
    T_g, n_g, rmse_g = tlc._verify_pair(
        draws, *[_t(a) for a in args], cfg.ransac_inlier_th_mm, 512,
        cfg.icp_iterations)
    assert int(n_g) == int(n_w) >= 300
    _pose_close(T_g.numpy(), np.asarray(T_w))
    assert abs(float(rmse_g) - float(rmse_w)) <= 1.0


def test_find_loop_closures_matches_reference():
    """The host candidate loop over a reference store carried across, with
    the reference's per-pair draws injected: the same pairs verified, the
    same inliers, measurements within 1 mm."""
    jcfg, tcfg = jc.tiny_config(), tc.tiny_config()
    bk = dict(lc_min_gap=2, lc_max_dist_mm=30000.0, lc_min_inliers=10)
    jcfg = dataclasses.replace(jcfg, backend=dataclasses.replace(jcfg.backend, **bk),
                               match=dataclasses.replace(jcfg.match, ransac_iterations=128))
    tcfg = dataclasses.replace(tcfg, backend=dataclasses.replace(tcfg.backend, **bk))
    K = jcfg.keypoints.top_k
    store = jkf.init_keyframes(jcfg)
    for k in range(6):
        args = keyframe_pair(40 + k % 2, K)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [3000.0 * k, 0, 0]
        kp, desc, mask = (args[0], args[1], args[2]) if k % 3 else args[3:]
        store = jkf.add_keyframe(store, jnp.asarray(pose), jpipe.FrameFeatures(
            jnp.asarray(kp), jnp.zeros(K), jnp.asarray(desc), jnp.asarray(mask)),
            jnp.asarray(k), jnp.full((K,), -1, jnp.int32))
    recorded = []
    real = jlc._verify_pair

    def recording(key, *a, **kw):
        recorded.append(np.asarray(jax.random.uniform(key, (jcfg.match.ransac_iterations, 3))))
        return real(key, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlc, "_verify_pair", recording)
        want = jlc.find_loop_closures(store, jcfg, jax.random.PRNGKey(3), 4)
    tstore = keyframes_from_numpy({f: np.asarray(getattr(store, f))
                                   for f in tkf.KeyframeStore._fields}, device="cpu")
    stats = {}
    got = tlc.find_loop_closures(tstore, tcfg, iter(recorded), 4, stats=stats)
    assert stats["verified"] == len(recorded) >= 3
    assert len(want) >= 1
    assert [(e.kf_i, e.kf_j, e.n_inliers) for e in got] == \
        [(e.kf_i, e.kf_j, e.n_inliers) for e in want]
    for a, b in zip(got, want):
        _pose_close(a.z, b.z)


# ---------------------------------------------------------------------------
# Bundle adjustment


@pytest.mark.parametrize("masked", [False, True])
def test_ba_solve_close(masked):
    prob, _, _ = _ba_problem(np.random.default_rng(77), M=6 if not masked else 4,
                             L=40 if not masked else 10)
    if masked:  # half the observations poisoned and masked out
        bad = np.zeros(prob.obs_p.shape[0], bool)
        bad[::2] = True
        prob = prob._replace(obs_p=jnp.asarray(np.asarray(prob.obs_p) + 1e6 * bad[:, None]),
                             obs_mask=jnp.asarray(~bad))
    gn, cg = (8, 30) if not masked else (4, 20)
    want = jba.ba_solve(prob, gn_iterations=gn, cg_iterations=cg)
    got = tba.ba_solve(tba.BAProblem(*[_t(x) for x in prob]), gn_iterations=gn,
                       cg_iterations=cg)
    np.testing.assert_allclose(float(got.initial_cost), float(want.initial_cost), rtol=1e-3)
    np.testing.assert_allclose(float(got.final_cost), float(want.final_cost), rtol=1e-3)
    assert float(got.final_cost) <= float(got.initial_cost)
    assert np.isfinite(got.poses.numpy()).all()
