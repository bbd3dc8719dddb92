"""Port parity: the odometry step after the feature stage.

Both packages start from one shared state (carried across with
`bshot_slam_tpu_torch.convert`) and step through six synthetic frames with
`odometry_step_compact`.  The port receives each frame's reference features
and RANSAC draws, so everything after the feature stage — window
compaction, mutual-NN matching (kernel C), RANSAC, the pose gate, ICP
(kernel D), the map insert (kernel E) and the packed row — is held to the
reference.  (The feature stage agrees only statistically: see
tests/test_torch_features.py.)

Per step (the port restarts every frame from the reference's state):
integer fields exactly equal, poses within 1 mm and 1e-4 rad, the new map
rows equal (positions within one 10 mm snap).  Chained (each package keeps
its own state): the reference's compiled program rounds its float32 sums
in another order, so poses differ by ~0.05-0.5 mm; a keypoint whose world
position lies that close to a 10 mm snap boundary lands one cell over and
can flip a dedup decision, after which the maps differ by a row.  Measured:
map sizes within 1, match and inlier counts within 1, poses within 0.52 mm.
Held: counts within 2, poses within 2 mm and 1e-4 rad.

Cases: a small config where matching engages (RANSAC inliers well above
the gate), and a tiny config with a 256-row window over a prefilled map,
which takes the compact path and then its dense overflow fallback.  A
third case of `test_step_exact` holds the port against itself: with 300
landmarks in every frame's window each frame's compact step aborts and
re-runs without windows, and `odometry_step_compact` given a seeded
`torch.Generator` gives, bit for bit, what it gives given that
generator's (H, 3) draws, and advances the generator by exactly that one
draw.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bshot_slam_tpu import config as jc
from bshot_slam_tpu.io import synthetic as jsyn
from bshot_slam_tpu.odometry import pipeline as jpipe
from bshot_slam_tpu_torch import config as tc
from bshot_slam_tpu_torch.convert import state_from_numpy, state_to_numpy
from bshot_slam_tpu_torch.odometry import pipeline as tpipe
from bshot_slam_tpu_torch.odometry.engine import pick_bucket
from bshot_slam_tpu_torch.ops import preprocess_host as ph
from bshot_slam_tpu_torch.ops.rangeimage import build_range_image

INT_FIELDS = [tpipe.IDX_N_MUTUAL, tpipe.IDX_N_INLIERS, tpipe.IDX_GATED,
              tpipe.IDX_MAP_SIZE, tpipe.IDX_N_DROPPED, tpipe.IDX_FRAME,
              tpipe.IDX_N_VALID, tpipe.IDX_BUCKET, tpipe.IDX_COMMITTED]


def small_cfg(m):
    return m.SlamConfig(
        sensor=m.SensorConfig(n_azimuth=512),
        preprocess=m.PreprocessConfig(max_points=8192),
        keypoints=m.KeypointConfig(top_k=192),
        descriptor=m.DescriptorConfig(max_neighbors=96),
        match=m.MatchConfig(ransac_iterations=512),
        map=m.MapConfig(capacity=8192),
    )


def windowed_tiny(m):
    cfg = m.tiny_config()
    return dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, window_cap=256))


def jax_state_dict(st) -> dict:
    d = {f"map.{f}": np.asarray(getattr(st.map, f)) for f in st.map._fields}
    d.update({f"ref.{f}": np.asarray(getattr(st.ref, f)) for f in st.ref._fields})
    d["ref_pose"] = np.asarray(st.ref_pose)
    d["frame_idx"] = np.asarray(st.frame_idx)
    return d


def prefill(d: dict, rng, n_near: int, n_far: int, cfg) -> dict:
    """Append landmarks near the origin (inside the query window) and far
    outside it, with random descriptors."""
    pos = np.concatenate([rng.uniform(-20000, 20000, (n_near, 3)),
                          rng.uniform(1.9e6, 2.1e6, (n_far, 3))]).astype(np.float32)
    rng.shuffle(pos)
    pos = np.trunc(pos / cfg.map.snap_mm) * cfg.map.snap_mm
    n = n_near + n_far
    d = {k: np.array(v) for k, v in d.items()}
    d["map.positions"][:n] = pos
    d["map.descriptors"][:n] = rng.integers(0, 2**32, (n, 11), dtype=np.uint64)
    d["map.seg_ratios"][:n] = rng.uniform(0, 1, n)
    d["map.blocks"][:n] = np.round(pos / cfg.map.block_size_mm)
    d["map.valid"][:n] = True
    d["map.frame_born"][:n] = 0
    d["map.cursor"] = np.int32(n)
    return d


def clouds(cfg, n_frames, seed):
    sweeps, _ = jsyn.render_sequence(n_frames, cfg.sensor, step_mm=300.0,
                                     noise_mm=10.0, seed=seed,
                                     n_firings=cfg.sensor.n_azimuth)
    out = []
    for sw in sweeps:
        ri = build_range_image(sw, cfg.sensor)
        cl, xyz, valid = ph.preprocess_host(ri.range_mm, ri.azimuth_rad,
                                            ri.vert_rad, cfg.preprocess)
        pts, nv = ph.extract_cloud_host(cl, xyz, valid, None,
                                        cfg.preprocess.max_points)
        P = np.zeros((pick_bucket(nv, cfg), 3), np.float32)
        P[:nv] = pts
        out.append((P, nv))
    return out


def generator_step(before, P, nv, tcfg, tile, seed):
    """The port's step from `before` given a `torch.Generator` seeded with
    `seed` and given that generator's (H, 3) draws: both (packed, state),
    the step bodies the generator call ran, and whether it left the
    generator exactly one draw on."""
    gen, drawn = (torch.Generator().manual_seed(seed) for _ in range(2))
    u = torch.rand((tcfg.match.ransac_iterations, 3), generator=drawn)
    body, bodies = tpipe._odometry_step_impl, []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpipe, "_odometry_step_impl",
                   lambda *a, **k: (bodies.append(1), body(*a, **k))[1])
        got = tpipe.odometry_step_compact(state_from_numpy(before, device="cpu"),
                                          torch.tensor(P), nv, gen, tcfg, tile)
    want = tpipe.odometry_step_compact(state_from_numpy(before, device="cpu"),
                                       torch.tensor(P), nv, u, tcfg, tile)
    return ([(d.packed.numpy(), state_to_numpy(st)) for st, d in (want, got)],
            len(bodies), torch.equal(gen.get_state(), drawn.get_state()))


def run_both(case, monkeypatch_features):
    if case == "small":
        jcfg, tcfg, seed, n_near = small_cfg(jc), small_cfg(tc), 11, 0
    else:  # a 256-row window; "generator" puts 300 rows in every frame's
        jcfg, tcfg, seed = windowed_tiny(jc), windowed_tiny(tc), 0
        n_near = 200 if case == "windowed" else 300
    tile = 1024 if case == "small" else tcfg.runtime.point_tile
    d0 = jax_state_dict(jpipe.init_state(jcfg))
    if n_near:
        d0 = prefill(d0, np.random.default_rng(3), n_near, 300, jcfg)
    jstate = jpipe.OdometryState(
        map=jpipe.mapstore.MapState(*[jnp.asarray(d0[f"map.{f}"]) for f in
                                      jpipe.mapstore.MapState._fields]),
        ref=jpipe.FrameFeatures(*[jnp.asarray(d0[f"ref.{f}"]) for f in
                                  jpipe.FrameFeatures._fields]),
        ref_pose=jnp.asarray(d0["ref_pose"]), frame_idx=jnp.asarray(d0["frame_idx"]),
    )
    chained = state_from_numpy(d0, device="cpu")
    key = jax.random.PRNGKey(0)
    steps, chain = [], []
    for P, nv in clouds(jcfg, 6, seed):
        before = jax_state_dict(jstate)
        key, sub = jax.random.split(key)
        u = np.asarray(jax.random.uniform(sub, (jcfg.match.ransac_iterations, 3)))
        jstate, jdiag = jpipe.odometry_step_compact(
            jstate, jnp.asarray(P), np.int32(nv), sub, jcfg, tile)
        f = jdiag.features
        monkeypatch_features(tpipe.FrameFeatures(
            keypoints=torch.tensor(np.asarray(f.keypoints)),
            scores=torch.tensor(np.asarray(f.scores)),
            descriptors=torch.tensor(np.asarray(f.descriptors).view(np.int32)),
            mask=torch.tensor(np.asarray(f.mask)),
        ))
        if case == "generator":
            ((want, wmap), (got, gmap)), bodies, one_draw = generator_step(
                before, P, nv, tcfg, tile, len(steps))
            steps.append((want, got, wmap, gmap))
            chain.append((bodies, one_draw))
            continue
        want = np.asarray(jdiag.packed)
        stepped, diag = tpipe.odometry_step_compact(
            state_from_numpy(before, device="cpu"), torch.tensor(P), nv,
            torch.tensor(u), tcfg, tile)
        steps.append((want, diag.packed.numpy(), jax_state_dict(jstate),
                      state_to_numpy(stepped)))
        chained, diag = tpipe.odometry_step_compact(
            chained, torch.tensor(P), nv, torch.tensor(u), tcfg, tile)
        chain.append((want, diag.packed.numpy()))
    return steps, chain


@pytest.fixture(scope="module")
def stepped(request):
    feats = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(tpipe, "compute_features", lambda *a, **k: feats["f"])
    try:
        return request.param, *run_both(request.param,
                                        lambda f: feats.__setitem__("f", f))
    finally:
        mp.undo()


def _pose_close(want, got, mm):
    Tw, Tg = want[:16].reshape(4, 4), got[:16].reshape(4, 4)
    assert np.abs(Tg[:3, 3] - Tw[:3, 3]).max() <= mm
    assert np.abs(Tg[:3, :3] - Tw[:3, :3]).max() <= 1e-4


@pytest.mark.parametrize("stepped", ["small", "windowed", "generator"], indirect=True)
def test_step_exact(stepped):
    case, steps, chain = stepped
    for i, (want, got, wmap, gmap) in enumerate(steps):
        assert got.shape == want.shape == (31,)
        np.testing.assert_array_equal(got[INT_FIELDS], want[INT_FIELDS],
                                      err_msg=f"frame {i}")
        _pose_close(want, got, 1.0)
        np.testing.assert_allclose(got[19:21], want[19:21], rtol=1e-3, atol=1e-3)
        # icp_rmse and the inlier distance stats (mm): within the pose tolerance
        np.testing.assert_allclose(got[22:26], want[22:26], rtol=1e-3, atol=1.0)
        for f in ("cursor", "valid", "descriptors", "seg_ratios", "frame_born",
                  "n_dropped"):
            np.testing.assert_array_equal(gmap[f"map.{f}"], wmap[f"map.{f}"],
                                          err_msg=f"frame {i} {f}")
        np.testing.assert_allclose(gmap["map.positions"], wmap["map.positions"],
                                   atol=10.0)
    if case == "small":  # matching engages: the gate passes on real inliers
        assert min(s[0][tpipe.IDX_N_INLIERS] for s in steps[1:]) >= 15
        assert not any(s[0][tpipe.IDX_GATED] for s in steps)
    if case == "generator":  # bit for bit; an abort and a re-run; one draw
        for i, (want, got, wmap, gmap) in enumerate(steps):
            np.testing.assert_array_equal(got, want, err_msg=f"frame {i}")
            for f in wmap:
                np.testing.assert_array_equal(gmap[f], wmap[f], err_msg=f"frame {i} {f}")
        assert chain == [(2, True)] * len(steps)


@pytest.mark.parametrize("stepped", ["small", "windowed"], indirect=True)
def test_chained_close(stepped):
    _, _, chain = stepped
    for want, got in chain:
        np.testing.assert_allclose(got[INT_FIELDS], want[INT_FIELDS], atol=2)
        _pose_close(want, got, 2.0)
