"""The port's engine modes on the CPU: pipelined, eviction, backend.

(a) The pipelined engine (`fetch_every` 1 and 3) gives records bit-identical
    to the port's synchronous engine, lagged until `flush()`.
(b) With the backend (keyframe every frame, a pass every 4 frames, 8
    frames on a yaw circle), pipelined and synchronous runs give identical
    records, keyframe stores and loop edges: the pass drains the pipeline
    first, so corrections land at the same frame.
    (a), (b) and (e) run the tiny config: the port's plain CPU step at the
    small config costs ~8 s a frame on one thread.
(c) A forced window overflow (a 256-row window over a prefilled map): the
    pipelined step aborts on the device, the drain re-runs the frame and the
    frames after it, and the records equal the synchronous engine's (which
    re-runs the aborted frame alone through the dense step).
(d) The port against the reference engine with the backend, per step:
    before each sweep the port's engine takes the reference engine's state,
    keyframe store, host mirrors and records (`convert`), and that frame's
    reference features and RANSAC draws (the step's, then each verified
    pair's).  The map starts within two frames of its capacity, so both
    engines evict; the keyframe store saturates, so both evict keyframes;
    the passes at frames 3 and 6 verify closures, optimise the pose graph
    and re-anchor the map.  Held: integer fields, the keyframe store's
    integer fields and the loop edges exact (by their keyframes' frame
    numbers: where a keyframe eviction shifts the rows, the reference keeps
    each edge's old row numbers and the port remaps them, dropping the
    evicted keyframe's edges); poses (every record, after
    the corrections too) and keyframe poses within 2 mm and 1e-4 rad;
    landmark positions within one 10 mm snap.  Measured: 1.43 mm on the
    step after the first correction, <= 0.08 mm elsewhere; loop
    measurements within 0.1 mm.  The 1.43 mm is one ICP correspondence
    that a tie in squared distance sends to another candidate (the next
    test shows where and why).
(e) `keep_corr`, `process_frame` and `process_cloud` (also by the
    reference's keyword `n_valid_dev`) in both modes.
(f) The state constructors default to the card: without one they raise.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bshot_slam_tpu.config as jc
import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu.backend import loop_closure as jlc
from bshot_slam_tpu.io import synthetic
from bshot_slam_tpu.odometry import pipeline as jpipe
from bshot_slam_tpu.odometry.engine import SlamEngine as JaxEngine
from bshot_slam_tpu_torch import convert
from bshot_slam_tpu_torch.backend import keyframes as tkf
from bshot_slam_tpu_torch.odometry import mapstore as tmap
from bshot_slam_tpu_torch.odometry import pipeline as tpipe
from bshot_slam_tpu_torch.odometry.engine import SlamEngine, host_cloud
from bshot_slam_tpu_torch.ops.rangeimage import build_range_image
from tests.test_torch_engine import _state_dict, _torch_features, small_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module: under the suite's parallel
    workers, multithreaded small CPU ops oversubscribe the cores (the same
    tests measured 20-50x slower there than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_records(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(x.pose, y.pose, err_msg=f"frame {i}")
        assert (x.n_inliers, x.n_mutual, x.gated, x.map_size, x.n_dropped,
                x.icp_rmse) == (y.n_inliers, y.n_mutual, y.gated, y.map_size,
                                y.n_dropped, y.icp_rmse), f"frame {i}"
        np.testing.assert_array_equal(x.corr_stats, y.corr_stats)


TILE = tc.tiny_config().runtime.point_tile


@pytest.fixture(scope="module")
def drive():
    cfg = tc.tiny_config()
    sweeps, _ = synthetic.render_sequence(5, cfg.sensor, step_mm=300.0,
                                          noise_mm=10.0, seed=11,
                                          n_firings=cfg.sensor.n_azimuth)
    sync = SlamEngine(cfg, seed=0, tile=TILE, device="cpu", keep_corr=True)
    for sw in sweeps:
        sync.process_sweep(sw)
    return sweeps, sync


@pytest.mark.parametrize("fetch_every", [1, 3])
def test_pipelined_matches_sync(drive, fetch_every):
    sweeps, sync = drive
    pipe = SlamEngine(tc.tiny_config(), seed=0, tile=TILE, device="cpu",
                      pipelined=True, fetch_every=fetch_every, keep_corr=True)
    rets = [pipe.process_sweep(sw) for sw in sweeps]
    assert rets[0] is None  # nothing finalized yet
    assert all(r is not None for r in rets[fetch_every:])
    last = pipe.flush()
    assert last is not None and pipe.flush() is None
    _same_records(pipe.records, sync.records)
    assert max(r.n_inliers for r in sync.records) >= 10  # matching engages
    assert pipe.n_redispatched == 0
    for k in ("src_world", "index", "inlier", "prev_src_world"):
        np.testing.assert_array_equal(pipe.last_corr[k], sync.last_corr[k])


def test_process_frame_and_cloud(drive):
    sweeps, sync = drive
    cfg = tc.tiny_config()
    for pipelined in (False, True):
        eng = SlamEngine(cfg, seed=0, tile=TILE, device="cpu", pipelined=pipelined)
        ri = build_range_image(sweeps[0], cfg.sensor)
        eng.process_frame(ri)
        eng.process_frame(sweeps[1])
        ri = build_range_image(sweeps[2], cfg.sensor)
        pts, nv = host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad,
                             ri.selected, cfg)
        n = cfg.preprocess.max_points
        P = np.zeros((n, 3), np.float32)
        P[:nv] = pts[:nv]
        eng.process_cloud(P, np.arange(n) < nv)
        eng.flush()
        _same_records(eng.records, sync.records[:3])


@pytest.mark.parametrize("pipelined", [False, True])
def test_process_cloud_n_valid_dev(drive, pipelined):
    """`process_cloud(points, pmask, n_valid_dev=...)`: the reference's
    keyword, with the count as a 0-d tensor as the reference passes it."""
    sweeps, sync = drive
    cfg = tc.tiny_config()
    eng = SlamEngine(cfg, seed=0, tile=TILE, device="cpu", pipelined=pipelined)
    for sw in sweeps[:3]:
        eng.process_sweep(sw)
    ri = build_range_image(sweeps[3], cfg.sensor)
    pts, nv = host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad, ri.selected, cfg)
    eng.process_cloud(pts, np.arange(pts.shape[0]) < nv,
                      n_valid_dev=torch.tensor(nv, dtype=torch.int32))
    eng.flush()
    _same_records(eng.records, sync.records[:4])


def _backend_cfg(m, **kw):
    cfg = small_cfg(m)
    return dataclasses.replace(cfg, backend=dataclasses.replace(cfg.backend, **kw))


def test_pipelined_backend_matches_sync():
    n = 8
    cfg = tc.tiny_config()
    cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
        cfg.backend, keyframe_every=1, lc_min_gap=3, lc_max_dist_mm=8000.0,
        lc_min_inliers=8))
    sweeps, _ = synthetic.render_sequence(n, cfg.sensor, step_mm=300.0,
                                          noise_mm=10.0, seed=4,
                                          yaw_rate_rad=2 * np.pi / n,
                                          n_firings=cfg.sensor.n_azimuth)
    runs = []
    for pipelined in (False, True):
        eng = SlamEngine(cfg, seed=0, tile=TILE, device="cpu",
                         enable_backend=True, backend_every=4,
                         pipelined=pipelined, fetch_every=3)
        for sw in sweeps:
            eng.process_sweep(sw)
        eng.flush()
        runs.append(eng)
    sync, pipe = runs
    _same_records(pipe.records, sync.records)
    assert pipe._kf_count == sync._kf_count == n
    a, b = convert.keyframes_to_numpy(pipe.keyframes), convert.keyframes_to_numpy(sync.keyframes)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert [(e.kf_i, e.kf_j, e.n_inliers) for e in pipe.loop_edges] == \
        [(e.kf_i, e.kf_j, e.n_inliers) for e in sync.loop_edges]
    assert sync.backend_stats["verified"] > 0


def _windowed(m):
    cfg = m.tiny_config()
    return dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime,
                                                                window_cap=256))


def _prefilled(d, rng, n_near, n_far, cfg, far=(1.9e6, 2.1e6)):
    """`d` with n_near landmarks near the origin (inside the query window)
    and n_far far outside it appended, random descriptors."""
    d = {k: np.array(v) for k, v in d.items()}
    c = int(d["map.cursor"])
    pos = np.concatenate([rng.uniform(-20000, 20000, (n_near, 3)),
                          rng.uniform(*far, (n_far, 3))]).astype(np.float32)
    rng.shuffle(pos)
    pos = np.trunc(pos / cfg.map.snap_mm) * cfg.map.snap_mm
    n = n_near + n_far
    rows = slice(c, c + n)
    d["map.positions"][rows] = pos
    d["map.descriptors"][rows] = rng.integers(0, 2**32, (n, 11), dtype=np.uint64)
    d["map.seg_ratios"][rows] = rng.uniform(0, 1, n)
    d["map.blocks"][rows] = np.round(pos / cfg.map.block_size_mm)
    d["map.valid"][rows] = True
    d["map.frame_born"][rows] = 0
    d["map.cursor"] = np.int32(c + n)
    return d


def test_window_overflow_aborts_and_reruns():
    cfg = _windowed(tc)
    sweeps, _ = synthetic.render_sequence(6, cfg.sensor, step_mm=300.0,
                                          noise_mm=10.0, seed=0,
                                          n_firings=cfg.sensor.n_azimuth)
    runs = []
    for pipelined in (False, True):
        eng = SlamEngine(cfg, seed=0, device="cpu", tile=cfg.runtime.point_tile,
                         pipelined=pipelined, fetch_every=3)
        d = convert.state_to_numpy(eng.state)
        eng.state = convert.state_from_numpy(
            _prefilled(d, np.random.default_rng(3), 200, 300, cfg), device="cpu")
        for sw in sweeps:
            eng.process_sweep(sw)
        eng.flush()
        runs.append(eng)
    sync, pipe = runs
    assert pipe.n_redispatched > 0  # a window overflowed and was re-run
    _same_records(pipe.records, sync.records)


@pytest.fixture(scope="module")
def per_step():
    """The reference engine's run with the backend, recording before each
    sweep its state, keyframe store, mirrors and records, and during it the
    features and every RANSAC draw; then the port's engine run per step
    from those."""
    kw = dict(keyframe_every=1, lc_min_gap=2, lc_max_dist_mm=8000.0,
              max_keyframes=4)
    jcfg, tcfg = _backend_cfg(jc, **kw), _backend_cfg(tc, **kw)
    sweeps, _ = synthetic.render_sequence(6, jcfg.sensor, step_mm=300.0,
                                          noise_mm=10.0, seed=11,
                                          n_firings=jcfg.sensor.n_azimuth)
    draws, feats, steps = [], [], []
    step = jpipe.odometry_step_compact
    verify = jlc._verify_pair
    H = jcfg.match.ransac_iterations

    def recording_step(state, points, n_valid, key, *args, **kwargs):
        draws[-1].append(np.asarray(jax.random.uniform(key, (H, 3))))
        steps.append((_state_dict(state), np.asarray(key)))  # before donation
        state, diag = step(state, points, n_valid, key, *args, **kwargs)
        feats.append(_torch_features(diag.features))
        return state, diag

    def recording_verify(key, *args, **kwargs):
        draws[-1].append(np.asarray(jax.random.uniform(key, (H, 3))))
        return verify(key, *args, **kwargs)

    je = JaxEngine(jcfg, seed=0, tile=1024, enable_backend=True, backend_every=3)
    d = _state_dict(je.state)
    d = _prefilled(d, np.random.default_rng(5), 0, 7900, jcfg, far=(1.9e6, 1.92e6))
    je.state = je.state._replace(map=je.state.map._replace(
        **{f: jax.numpy.asarray(d[f"map.{f}"]) for f in je.state.map._fields}))
    mirrors = ("_kf_count", "_kf_positions", "_last_kf_pose", "_frames_since_kf",
               "n_kf_evicted", "n_evicted", "loop_edges")
    before, after = [], []

    def snapshot():
        kf = {f: np.array(getattr(je.keyframes, f)) for f in je.keyframes._fields}
        return (_state_dict(je.state), kf,
                {m: copy.deepcopy(getattr(je, m)) for m in mirrors},
                copy.deepcopy(je.records))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpipe, "odometry_step_compact", recording_step)
        mp.setattr(jlc, "_verify_pair", recording_verify)
        for sw in sweeps:
            before.append(snapshot())
            draws.append([])
            je.process_sweep(sw)
            after.append(snapshot())

    got = []
    by_frame = _edges_by_frame(after)
    with pytest.MonkeyPatch.context() as mp:
        frame = iter(feats)
        mp.setattr(tpipe, "compute_features", lambda *a, **k: next(frame))
        for i, sw in enumerate(sweeps):
            st, kf, mir, recs = before[i]
            te = SlamEngine(tcfg, seed=0, tile=1024, device="cpu",
                            draws=draws[i], enable_backend=True, backend_every=3)
            te.state = convert.state_from_numpy(st, device="cpu")
            te.keyframes = convert.keyframes_from_numpy(kf, device="cpu")
            for m, v in copy.deepcopy(mir).items():
                setattr(te, m, v)
            if i:  # the edges at the rows of this store (see _edges_by_frame)
                row = {f: r for r, f in enumerate(kf["frame_idx"][:mir["_kf_count"]].tolist())}
                te.loop_edges = [e._replace(kf_i=row[fi], kf_j=row[fj])
                                 for fi, fj, e in by_frame[i - 1]]
            te.records = copy.deepcopy(recs)
            te.process_sweep(sw)
            got.append((convert.state_to_numpy(te.state),
                        convert.keyframes_to_numpy(te.keyframes),
                        {m: getattr(te, m) for m in mirrors}, te.records))
    return after, got, draws, (steps, feats)


def _edges_by_frame(after):
    """The reference's loop edges after each step, by the frame numbers of
    their keyframes: (frame of kf_i, frame of kf_j, edge).  A pass (at
    records 3 and 6) finds them on that step's store; a keyframe evicted
    later takes its edges with it.  (The reference keeps an edge's row
    numbers when a keyframe eviction shifts the rows, so they point at other
    keyframes; the port remaps them and drops the evicted one's.)"""
    out, edges = [], []
    for i, (_, kf, mir, _) in enumerate(after):
        frames = kf["frame_idx"]
        if (i + 1) % 3 == 0:
            edges = [(int(frames[e.kf_i]), int(frames[e.kf_j]), e) for e in mir["loop_edges"]]
        live = set(frames[:mir["_kf_count"]].tolist())
        edges = [x for x in edges if x[0] in live and x[1] in live]
        out.append(edges)
    return out


def _pose_close(a, b, mm=1.0, rad=1e-4):
    assert np.abs(a[..., :3, 3] - b[..., :3, 3]).max() <= mm
    assert np.abs(a[..., :3, :3] - b[..., :3, :3]).max() <= rad


def test_engine_with_backend_matches_reference_per_step(per_step):
    after, got, draws, _ = per_step
    assert after[-1][2]["n_evicted"] > 0  # the map hit its capacity
    assert after[-1][2]["n_kf_evicted"] > 0  # the keyframe store saturated
    assert any(len(d) > 1 for d in draws)  # a pass verified pairs
    assert after[-1][2]["loop_edges"]  # closures verified
    by_frame = _edges_by_frame(after)
    assert any(len(e) < len(a[2]["loop_edges"]) for e, a in zip(by_frame, after))  # dropped
    for i, (want, have) in enumerate(zip(after, got)):
        (wst, wkf, wmir, wrecs), (gst, gkf, gmir, grecs) = want, have
        assert gmir["n_evicted"] == wmir["n_evicted"], f"frame {i}"
        assert (gmir["_kf_count"], gmir["n_kf_evicted"], gmir["_frames_since_kf"]) == \
            (wmir["_kf_count"], wmir["n_kf_evicted"], wmir["_frames_since_kf"])
        assert len(grecs) == len(wrecs) == i + 1
        for a, b in zip(grecs, wrecs):
            assert (a.n_inliers, a.n_mutual, a.gated, a.map_size, a.n_dropped) == \
                (b.n_inliers, b.n_mutual, b.gated, b.map_size, b.n_dropped), f"frame {i}"
            _pose_close(a.pose, b.pose, mm=2.0)
        for f in ("count", "frame_idx", "obs_lm", "kp_mask", "descriptors", "keypoints"):
            np.testing.assert_array_equal(gkf[f], wkf[f], err_msg=f"frame {i} {f}")
        _pose_close(gkf["poses"], wkf["poses"], mm=2.0)
        frames = gkf["frame_idx"]
        assert [(frames[e.kf_i], frames[e.kf_j], e.n_inliers) for e in gmir["loop_edges"]] == \
            [(fi, fj, e.n_inliers) for fi, fj, e in by_frame[i]], f"frame {i}"
        for f in ("cursor", "valid", "frame_born", "descriptors", "seg_ratios"):
            np.testing.assert_array_equal(gst[f"map.{f}"], wst[f"map.{f}"],
                                          err_msg=f"frame {i} {f}")
        np.testing.assert_allclose(gst["map.positions"], wst["map.positions"],
                                   atol=10.0)
        _pose_close(gst["ref_pose"], wst["ref_pose"], mm=2.0)


@functools.partial(jax.jit, static_argnames=("iterations",))
def _ref_icp_iterations(src, src_mask, dst, dst_mask, iterations, max_corr_dist):
    """The reference's ICP loop (`bshot_slam_tpu.ops.icp`, its CPU path),
    returning each iteration's input points, nearest neighbours, pair mask
    and Kabsch step."""
    from bshot_slam_tpu.geometry import se3 as jse3
    from bshot_slam_tpu.ops.keypoints import _pair_d2

    def body(T, _):
        cur = jse3.apply(T, src)
        d2 = jnp.where(dst_mask[None, :], _pair_d2(cur, dst), jnp.inf)
        nn, nn_d2 = jnp.argmin(d2, axis=1), jnp.min(d2, axis=1)
        ok = src_mask & jnp.isfinite(nn_d2) & (nn_d2 <= max_corr_dist * max_corr_dist)
        w = ok.astype(jnp.float32)
        step = jse3.kabsch(cur, dst[nn], w)
        step = jnp.where(jnp.sum(w) >= 3, step, jnp.eye(4, dtype=T.dtype))
        return jse3.compose(step, T), (cur, nn, ok, step)

    T, per_it = jax.lax.scan(body, jnp.eye(4, dtype=jnp.float32), None, length=iterations)
    return T, per_it


def test_backend_step_difference_is_rounding_at_a_near_tie(per_step):
    """Where the per-step poses part (PERF.md §7), for the frame whose pose
    differs most from the reference's, from the reference's input state,
    features and key: matching is exact; RANSAC keeps the same inliers and
    its refit differs only by float rounding (<= 0.001 mm; measured 0.00067:
    Kabsch's weighted sums, which the reference's compiled program reduces
    in an order of its own); ICP from the reference's RANSAC pose agrees up
    to that rounding (Kabsch steps within 0.005 mm on the same inputs,
    points within 0.05 mm) until an iteration where a nearest neighbour
    changes, and each change is a tie in the squared distance as both
    sides round it (expanded, |q|^2 + |p|^2 - 2 q.p, within 4 ulps at the
    reference's points), which the port's points, moved by the rounding,
    break the other way; given the reference's points, the port's nearest
    neighbours are the reference's.  Measured: frame 3 (the step after the
    first correction), ICP iteration 2, row 6: the map landmark 7522 and
    the previous frame's keypoint 8200 both at 82944.0 mm^2 at the
    reference's points (the landmark wins the tie), 83200.0 against 82944.0
    at the port's, which moved by <= 0.008 mm; that one correspondence moves
    the step by 1.04 mm and the frame's pose by 1.43 mm."""
    from bshot_slam_tpu.geometry import se3 as jse3
    from bshot_slam_tpu.odometry import mapstore as jmap
    from bshot_slam_tpu.ops import hamming as jham
    from bshot_slam_tpu.ops import icp as jicp
    from bshot_slam_tpu.ops import ransac as jran
    from bshot_slam_tpu_torch.geometry import se3 as tse3
    from bshot_slam_tpu_torch.kernels import pair_d2
    from bshot_slam_tpu_torch.kernels.mapops import euclid_nn_bounded
    from bshot_slam_tpu_torch.ops import hamming as tham
    from bshot_slam_tpu_torch.ops import ransac as tran

    after, got, _, (steps, feats) = per_step
    diffs = [np.abs(g[3][-1].pose[:3, 3] - a[3][-1].pose[:3, 3]).max()
             for a, g in zip(after, got)]
    k = int(np.argmax(diffs))
    cfg = _backend_cfg(tc, keyframe_every=1, lc_min_gap=2, lc_max_dist_mm=8000.0,
                       max_keyframes=4)
    mc = cfg.match
    sd, key = steps[k]
    src = feats[k]
    kp, words, mask = src.keypoints, src.descriptors, src.mask
    st = convert.state_from_numpy(sd, device="cpu")
    C = st.map.positions.shape[0]
    assert C <= cfg.runtime.window_cap  # the dense candidate set, both sides

    # Matching: the map window then the previous frame's keypoints.
    center = tse3.translation(st.ref_pose)
    win = tmap.query_mask(st.map, center, mc.map_query_range_mm, cfg.map)
    cand_pos = torch.cat([st.map.positions, tse3.apply(st.ref_pose, st.ref.keypoints)])
    cand_mask = torch.cat([win, st.ref.mask])
    m = tham.mutual_nn_bounded(words, mask, torch.cat([st.map.descriptors,
                                                       st.ref.descriptors]),
                               cand_mask, st.map.cursor, tail_start=C)
    jwin = jmap.query_mask(jmap.MapState(*[jnp.asarray(sd[f"map.{f}"])
                                           for f in jmap.MapState._fields]),
                           jnp.asarray(center.numpy()), mc.map_query_range_mm, cfg.map)
    jm = jham.mutual_nn_bounded(
        jnp.asarray(words.numpy().view(np.uint32)), jnp.asarray(mask.numpy()),
        jnp.asarray(np.concatenate([sd["map.descriptors"], sd["ref.descriptors"]])),
        jnp.concatenate([jwin, jnp.asarray(sd["ref.mask"])]),
        jnp.asarray(sd["map.cursor"]), tail_start=C)
    np.testing.assert_array_equal(win.numpy(), np.asarray(jwin))
    np.testing.assert_array_equal(m.src_to_ref.numpy(), np.asarray(jm.src_to_ref))
    np.testing.assert_array_equal(m.mutual.numpy(), np.asarray(jm.mutual))
    corr_dst, cmask = cand_pos[m.src_to_ref.long()], m.mutual

    # RANSAC on the same correspondences and draws.
    H = mc.ransac_iterations
    rr = tran.ransac_rigid(torch.from_numpy(np.asarray(jax.random.uniform(key, (H, 3)))),
                           kp, corr_dst, cmask, mc.ransac_inlier_th_mm, H)
    jrr = jran.ransac_rigid(jnp.asarray(key), jnp.asarray(kp.numpy()),
                            jnp.asarray(corr_dst.numpy()), jnp.asarray(cmask.numpy()),
                            inlier_threshold=mc.ransac_inlier_th_mm, iterations=H)
    np.testing.assert_array_equal(rr.inliers.numpy(), np.asarray(jrr.inliers))
    _pose_close(rr.transform.numpy(), np.asarray(jrr.transform), mm=1e-3, rad=1e-6)

    # ICP from the reference's RANSAC pose, iteration by iteration.
    src_est = jse3.apply(jrr.transform, jnp.asarray(kp.numpy()))
    jT, (jcur, jnn, jok, jstep) = _ref_icp_iterations(
        src_est, jnp.asarray(mask.numpy()), jnp.asarray(cand_pos.numpy()),
        jnp.asarray(cand_mask.numpy()), mc.icp_iterations, mc.icp_max_corr_dist_mm)
    ref_icp = jicp.icp_point_to_point(
        src_est, jnp.asarray(mask.numpy()), jnp.asarray(cand_pos.numpy()),
        jnp.asarray(cand_mask.numpy()), iterations=mc.icp_iterations,
        max_corr_dist=mc.icp_max_corr_dist_mm, n_valid_dst=jnp.asarray(sd["map.cursor"]),
        tail_start=C)
    np.testing.assert_array_equal(np.asarray(jT), np.asarray(ref_icp.transform))
    jcur, jnn, jok, jstep = map(np.asarray, (jcur, jnn, jok, jstep))
    T = torch.eye(4)
    flipped = False
    for i in range(mc.icp_iterations):
        cur = tse3.apply(T, torch.from_numpy(np.asarray(src_est)))
        nd2, nn = euclid_nn_bounded(cur, mask, cand_pos, cand_mask, st.map.cursor,
                                    tail_start=C)
        ok = mask & (nd2 < 1e30) & (nd2 <= mc.icp_max_corr_dist_mm ** 2)
        # From the reference's points the port finds the reference's neighbours.
        ref_cur = torch.from_numpy(jcur[i])
        _, nn_on_ref = euclid_nn_bounded(ref_cur, mask, cand_pos, cand_mask,
                                         st.map.cursor, tail_start=C)
        np.testing.assert_array_equal(nn_on_ref.numpy(), jnn[i])
        rows = np.nonzero(nn.numpy() != jnn[i])[0]
        if not flipped:
            assert np.abs(cur.numpy() - jcur[i]).max() < 0.05, f"iteration {i}"
            step = tse3.kabsch(ref_cur, cand_pos[torch.from_numpy(jnn[i]).long()],
                               torch.from_numpy(jok[i]).float())
            _pose_close(step.numpy(), jstep[i], mm=0.005, rad=1e-6)
        if len(rows) and not flipped:
            # Squared distances as both sides round them (the whole-row
            # call, as inside the nearest-neighbour search).
            flipped = True
            d_ref = pair_d2(ref_cur, cand_pos).numpy()[rows]
            d_port = pair_d2(cur, cand_pos).numpy()[rows]
            a, b = jnn[i][rows], nn.numpy()[rows]
            r = np.arange(len(rows))
            ulp = np.spacing(d_ref[r, a])
            assert (np.abs(d_ref[r, b] - d_ref[r, a]) <= 4 * ulp).all()
            assert (d_port[r, b] <= d_port[r, a]).all()
        T = tse3.compose(tse3.kabsch(cur, cand_pos[nn.long()], ok.float()), T)
    # A pose difference above a millimetre comes only through such a change.
    assert flipped or diffs[k] < 1.0


def test_constructors_default_to_the_card(monkeypatch):
    cfg = tc.tiny_config()
    d = convert.state_to_numpy(tpipe.init_state(cfg, device="cpu"))
    k = convert.keyframes_to_numpy(tkf.init_keyframes(cfg, device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tpipe.init_state(cfg), lambda: tmap.init_map(cfg.map),
                 lambda: convert.state_from_numpy(d),
                 lambda: tkf.init_keyframes(cfg),
                 lambda: convert.keyframes_from_numpy(k)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
