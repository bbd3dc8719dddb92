"""Port parity at the edges: kernels A to E and G (plain versions) vs the reference.

Every case of `tests/torch_kernel_cases.py` goes through the port's
`neighborhood_accumulate` / `segratio_accumulate` / `hamming_nn_bounded` /
`euclid_nn_bounded` / `dedup_blocked_bounded` on CPU tensors (the plain PyTorch versions, which the
CUDA kernels must reproduce on the card: `tests/test_torch_cuda.py` runs
the same cases there) and through the reference: its Pallas kernels in
interpret mode, and for A's moment features and B's scores also its
`lax.scan` path.  Counts, sign counts, minima, argmins, d2 and dedup flags
are exact;
G's cases run through the port's ICP loop (`icp_point_to_point`'s, with
G's plain version on the CPU) against the reference's, iteration by
iteration: pair counts exact, rotations within 1e-5, translations and
points within 0.01 mm, rmse within 1e-5 relative (Kabsch's sums in another
order), until a correspondence flips, and a flip only at a tie of the
expanded d2, the final poses then within a stated gap; where nothing
flips, also against the reference's own `icp_point_to_point`;
A's sums agree to 1e-5 * count * max|feat|, B's CVS sum to 1e-5 * count *
|ctvec| * r + 1e-2 and its CVSN sum of cosines to 1e-5 * count + 1e-3
(summation order only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bshot_slam_tpu.config import KeypointConfig
from bshot_slam_tpu.kernels import mapops as jm
from bshot_slam_tpu.kernels import neighborhood as jk
from bshot_slam_tpu.ops import icp as jicp
from bshot_slam_tpu.ops import keypoints as jkp
from bshot_slam_tpu.ops.bshot import unpack_bits as j_unpack
from bshot_slam_tpu_torch.config import KeypointConfig as TKeypointConfig
from bshot_slam_tpu_torch.kernels import mapops as tm
from bshot_slam_tpu_torch.kernels import neighborhood as tk
from bshot_slam_tpu_torch.ops import icp as ticp
from bshot_slam_tpu_torch.ops import keypoints as tkp
from tests.torch_kernel_cases import (
    A_CASES, B_CASES, C_CASES, D_CASES, DEDUP_RADIUS, E_ARGS, E_CASES, G_CASES,
    accumulate_case, dedup_case, euclid_case, hamming_case, icp_case, icp_trace,
    icp_traces_agree, live_rows, segratio_case,
)

BIG = np.float32(3.0e38)


def _t(x):
    return None if x is None else torch.tensor(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


def _sum_tolerance(c, counts):
    live = c["feat"][c["mask"]]
    top = np.abs(live).max(axis=0) if len(live) else np.zeros(c["feat"].shape[1])
    return 1e-5 * counts[:, None] * top[None, :]


@pytest.mark.parametrize("name", A_CASES)
def test_accumulate_case(name):
    c = accumulate_case(name)
    n, nf = c["feat"].shape
    got = tk.neighborhood_accumulate(_t(c["points"]), _t(c["mask"]), _t(c["feat"]),
                                     c["radius"], r2_row=_t(c["r2_row"]),
                                     tile=256).numpy()
    assert got.shape == (n, nf) and not got[~c["mask"]].any()
    # Counts (and the moment sums) against the scan path: exact memberships.
    cnt, psum, _ = jkp.neighborhood_moments(_j(c["points"]), _j(c["mask"]),
                                            c["radius"], tile=256,
                                            r2_row=_j(c["r2_row"]))
    cnt = np.asarray(cnt)
    ones = np.ones((n, 1), np.float32)
    got_cnt = tk.neighborhood_accumulate(_t(c["points"]), _t(c["mask"]), _t(ones),
                                         c["radius"], r2_row=_t(c["r2_row"]),
                                         tile=256).numpy()[:, 0]
    np.testing.assert_array_equal(got_cnt, cnt)
    if name == "one_valid":
        assert cnt.sum() == 1
    if name == "shell":
        on_shell = cnt[:40] - 1  # of each base point's six partners
        assert on_shell.max() <= 6 and 0 < on_shell.sum() < 240  # some in, some out
    # The sums against the Pallas kernel in interpret mode.
    feat128 = np.zeros((n, 128), np.float32)
    feat128[:, :nf] = c["feat"]
    pal = np.asarray(jk.neighborhood_accumulate(
        _j(c["points"]), _j(c["mask"]), _j(feat128), c["radius"], interpret=True,
        r2_row=_j(c["r2_row"])))[:, :nf]
    if name == "far_clusters":
        # The Pallas kernel prunes tile pairs at the bare radius, so a pair
        # within f32 slop of the shell may differ there; the scan path above
        # is the exact one, and the moment sums are held to it.
        np.testing.assert_array_equal(got[:, 0], cnt)
        np.testing.assert_allclose(got[:, 1:4], np.asarray(psum), rtol=0,
                                   atol=float(_sum_tolerance(c, cnt)[:, 1:4].max()))
        return
    tol = _sum_tolerance(c, cnt)
    assert (np.abs(got - pal) <= tol).all()
    if not name.startswith("nf"):  # moment features: column 0 is the count
        np.testing.assert_array_equal(got[:, 0], cnt)


@pytest.mark.parametrize("name", B_CASES)
def test_segratio_case(name):
    c = segratio_case(name)
    pts, mask, r, norm = c["points"], c["mask"], c["radius"], c["normalized"]
    cnt, psum, _ = jkp.neighborhood_moments(_j(pts), _j(mask), r, tile=256,
                                            r2_row=_j(c["r2_row"]))
    ctvec = c["ctvec"]
    if ctvec is None:
        ctvec = np.asarray(_j(pts) - psum / jnp.maximum(cnt, 1.0)[:, None])
    cnt = np.asarray(cnt)
    got = tk.segratio_accumulate(_t(pts), _t(mask), _t(ctvec), r, normalized=norm,
                                 r2_row=_t(c["r2_row"]), tile=256).numpy()
    assert got.shape == (len(mask), 3) and not got[~mask].any()
    assert (got[:, 0] + got[:, 1] <= cnt).all()
    if name in ("all_masked", "n1"):
        assert not got.any()  # a lone point: d2 = 0 and dots = 0
    if name == "dots_zero":  # pairs within a plane carry neither sign
        assert (got[:, 0] + got[:, 1] < cnt)[mask].all() and got[:, :2].any()
    if name.startswith("coincident"):
        assert np.isfinite(got).all() and (cnt[mask] >= 2).all()
    # CVS sums dots of size <= |ctvec| * r; CVSN sums cosines.
    tol = (1e-5 * cnt + 1e-3 if norm
           else 1e-5 * cnt * np.linalg.norm(ctvec, axis=-1) * r + 1e-2)
    if name != "far_clusters":
        # The Pallas kernel in interpret mode (it prunes tile pairs at the
        # bare radius, so far_clusters is held to the scan path alone).
        pal = np.asarray(jk.segratio_accumulate(
            _j(pts), _j(mask), _j(ctvec), r, normalized=norm, interpret=True,
            r2_row=_j(c["r2_row"])))
        np.testing.assert_array_equal(got[:, :2], pal[:, :2])
        assert (np.abs(got[:, 2] - pal[:, 2]) <= tol).all()
    if c["ctvec"] is not None:
        return
    # The scan path computes the same ctvec from the same moments: CV scores
    # are ratios of exact counts, CVS / CVSN scores sums over the count.
    for sr_type in ("CV", "CVSN" if norm else "CVS"):
        want = np.asarray(jkp.seg_ratio_scores(
            _j(pts), _j(mask), KeypointConfig(sr_type=sr_type, radius_mm=r),
            tile=256, moments=(_j(cnt), psum), r2_row=_j(c["r2_row"])))
        scores = tkp.seg_ratio_scores(
            _t(pts), _t(mask), TKeypointConfig(sr_type=sr_type, radius_mm=r),
            tile=256, moments=(_t(cnt), _t(np.asarray(psum))),
            r2_row=_t(c["r2_row"])).numpy()
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(scores), fin)
        if sr_type == "CV":
            np.testing.assert_array_equal(scores[fin], want[fin])
        else:
            lim = tol / np.maximum(cnt, 1)
            assert (np.abs(scores[fin] - want[fin]) <= lim[fin]).all()


def _tw(words):
    return torch.tensor(words.view(np.int32))


def _hamming_brute(c):
    """Two-sided nearest neighbours by numpy: the definition."""
    a, b = c["a_words"], c["b_words"]
    ok_b = c["b_mask"] & live_rows(len(b), c["n_valid"], c["tail_start"])
    d = np.empty((len(a), len(b)), np.float32)
    for i, row in enumerate(a):
        d[i] = np.unpackbits((row[None] ^ b).view(np.uint8), axis=1).sum(1)
    d[~(c["a_mask"][:, None] & ok_b[None])] = BIG
    aarg, barg = d.argmin(1), d.argmin(0)
    return (d[np.arange(len(a)), aarg], aarg.astype(np.int32),
            d[barg, np.arange(len(b))], barg.astype(np.int32))


@pytest.mark.parametrize("name", C_CASES)
def test_hamming_case(name):
    c = hamming_case(name)
    nv, tail = c["n_valid"], c["tail_start"]
    got = [x.numpy() for x in tm.hamming_nn_bounded(
        _tw(c["a_words"]), _t(c["a_mask"]), _tw(c["b_words"]), _t(c["b_mask"]),
        nv, tail_start=tail)]
    # The reference decides liveness by tile, the port by row: they are the
    # same function once the mask is cleared on dead rows.
    live = live_rows(len(c["b_mask"]), nv, tail)
    if name == "dense":  # slow in interpret mode: held to the definition
        want = _hamming_brute(c)
    else:
        want = [np.asarray(x) for x in jm.hamming_nn_bounded(
            j_unpack(_j(c["a_words"])).astype(jnp.float32), _j(c["a_mask"]),
            _j(c["b_words"]), _j(c["b_mask"] & live), jnp.int32(nv),
            tail_start=tail, interpret=True)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    amin, aarg, bmin, barg = got
    ok_b = c["b_mask"] & live
    no_a = ~c["a_mask"] | ~ok_b.any()
    no_b = ~ok_b | ~c["a_mask"].any()
    assert (amin[no_a] == BIG).all() and (aarg[no_a] == 0).all()
    assert (bmin[no_b] == BIG).all() and (barg[no_b] == 0).all()
    assert (amin[~no_a] <= 352).all() and (bmin[~no_b] <= 352).all()
    if name in ("nv0", "a_all_masked", "b_all_masked"):
        assert no_a.all() and no_b.all()
    if name == "live_by_index":
        assert aarg[0] != nv + 5  # the dead exact match
    if name == "dup_candidates":
        np.testing.assert_array_equal(aarg[:8], 5 + 17 * np.arange(8))
        assert (amin[:8] == 0).all()
    if name == "dup_sources":
        np.testing.assert_array_equal(barg[[40, 900, 2048 + 3]], 5)
        np.testing.assert_array_equal(aarg[[5, 9, 20, 36]], 40)
    if name == "dense":
        assert aarg[1] == 65000 and amin[1] == 0


@pytest.mark.parametrize("ka,cb", [(0, 700), (5, 0), (0, 0)])
def test_hamming_empty_side(ka, cb):
    """No sources or no candidates: every row reports (3e38, 0), from the
    wrapper and from the plain version alike."""
    args = (torch.zeros((ka, 11), dtype=torch.int32), torch.ones(ka, dtype=torch.bool),
            torch.zeros((cb, 11), dtype=torch.int32), torch.ones(cb, dtype=torch.bool))
    for fn in (tm.hamming_nn_bounded, tm.hamming_nn_bounded_plain):
        amin, aarg, bmin, barg = fn(*args, cb, tail_start=-1)
        assert amin.shape == aarg.shape == (ka,) and bmin.shape == barg.shape == (cb,)
        assert amin.dtype == bmin.dtype == torch.float32
        assert aarg.dtype == barg.dtype == torch.int32
        assert (amin == BIG).all() and (bmin == BIG).all()
        assert (aarg == 0).all() and (barg == 0).all()


@pytest.mark.parametrize("name", D_CASES)
def test_euclid_case(name):
    c = euclid_case(name)
    d2, idx = tm.euclid_nn_bounded(_t(c["q"]), _t(c["q_mask"]), _t(c["ref"]),
                                   _t(c["ref_mask"]), c["n_valid"],
                                   tail_start=c["tail_start"])
    d2, idx = d2.numpy(), idx.numpy()
    # The reference decides liveness by tile, the port by row: they are the
    # same function once the mask is cleared on dead rows.
    rows = np.arange(c["ref"].shape[0])
    live = rows < c["n_valid"]
    if c["tail_start"] >= 0:
        live |= rows >= c["tail_start"]
    wd2, widx = jm.euclid_nn_bounded(
        _j(c["q"]), _j(c["q_mask"]), _j(c["ref"]), _j(c["ref_mask"] & live),
        jnp.int32(c["n_valid"]), tail_start=c["tail_start"], interpret=True)
    np.testing.assert_array_equal(idx, np.asarray(widx))
    np.testing.assert_array_equal(d2, np.asarray(wd2))
    none = ~c["q_mask"] | ~(c["ref_mask"] & live).any()
    assert (d2[none] == BIG).all() and (idx[none] == 0).all()
    assert (d2[~none] < BIG).all()
    if name in ("nv0", "all_masked"):
        assert none.all()
    if name == "duplicates":
        np.testing.assert_array_equal(idx[:8], 5 + 17 * np.arange(8))


@pytest.mark.parametrize("name", E_CASES)
def test_dedup_case(name):
    c = dedup_case(name)
    nv = c["n_valid"]
    got = tm.dedup_blocked_bounded(*[_t(c[a]) for a in E_ARGS], nv,
                                   DEDUP_RADIUS).numpy()
    assert got.dtype == np.bool_ and got.shape == c["pos"].shape[:1]
    # The reference decides liveness by tile, the port by row: they are the
    # same function once the valid flag is cleared on rows past n_valid.
    live = c["map_valid"] & live_rows(len(c["map_valid"]), nv, -1)
    if len(live):  # with no map rows the reference's grid is empty
        want = np.asarray(jm.dedup_blocked_bounded(
            *[_j(c[a]) for a in E_ARGS[:6]], _j(live), jnp.int32(nv),
            dedup_radius=DEDUP_RADIUS, interpret=True))
        np.testing.assert_array_equal(got, want)
    if c["expect"] is not None:
        np.testing.assert_array_equal(got, c["expect"])
    if name == "dense":
        assert got.mean() > 0.9
    if name == "valid_past_nv":  # the rows past the cursor would block
        every = tm.dedup_blocked_bounded(*[_t(c[a]) for a in E_ARGS],
                                         len(live), DEDUP_RADIUS).numpy()
        assert every.all() and not got.all()


@pytest.mark.parametrize("k,c", [(0, 700), (5, 0), (0, 0)])
def test_dedup_empty_side(k, c):
    """No newcomers or no map rows: (k,) False, from the wrapper and from
    the plain version alike."""
    args = (torch.zeros((k, 3)), torch.zeros((k, 3), dtype=torch.int32), torch.zeros(k),
            torch.zeros((c, 3)), torch.zeros((c, 3), dtype=torch.int32), torch.ones(c),
            torch.ones(c, dtype=torch.bool))
    for fn in (tm.dedup_blocked_bounded, tm.dedup_blocked_bounded_plain):
        got = fn(*args, c, DEDUP_RADIUS)
        assert got.dtype == torch.bool and got.shape == (k,) and not got.any()



@functools.partial(jax.jit, static_argnames=("max_corr_dist",))
def _ref_icp_body(T, src, src_mask, dst, dst_mask, max_corr_dist):
    """One iteration of the reference's ICP (`bshot_slam_tpu.ops.icp`'s
    dense body), compiled as the reference compiles it: (T', cur, nn, n,
    rmse)."""
    from bshot_slam_tpu.geometry import se3 as jse3

    cur = jse3.apply(T, src)
    d2 = jnp.where(dst_mask[None, :], jkp._pair_d2(cur, dst), jnp.inf)
    nn, nn_d2 = jnp.argmin(d2, axis=1), jnp.min(d2, axis=1)
    ok = src_mask & jnp.isfinite(nn_d2) & (nn_d2 <= max_corr_dist * max_corr_dist)
    w = ok.astype(jnp.float32)
    n = jnp.sum(w)
    step = jnp.where(n >= 3, jse3.kabsch(cur, dst[nn], w), jnp.eye(4, dtype=T.dtype))
    rmse = jnp.sqrt(jnp.sum(jnp.where(ok, nn_d2, 0.0)) / jnp.maximum(n, 1.0))
    return jse3.compose(step, T), cur, nn, n, rmse


def _ref_icp_trace(c):
    """The reference's ICP loop, recording each iteration."""
    args = [_j(c[k]) for k in ("src", "src_mask", "dst", "dst_mask")]
    T, out = jnp.eye(4, dtype=jnp.float32), []
    for _ in range(10):
        T, cur, nn, n, rmse = _ref_icp_body(T, *args, c["max_corr_dist"])
        out.append(tuple(np.asarray(x) for x in (cur, nn, T, n, rmse)))
    return out


@pytest.mark.parametrize("name", G_CASES)
def test_icp_case(name):
    """The port's ICP on the CPU (G's plain version) against the
    reference's, iteration by iteration from the same inputs (dead target
    rows masked, so the dense search sees the live rows): within the
    tolerances until a correspondence flips, and a flip only at a tie of
    the expanded d2 (`icp_traces_agree`).  The recorded loop gives
    `icp_point_to_point`'s result bit for bit; where nothing flips, that
    result also agrees with the reference's own `icp_point_to_point`
    (pairs exact, rotation 1e-5, translation 0.01 mm, rmse 1e-3 relative:
    its `lax.scan` compiles the iterations together)."""
    c = icp_case(name)
    port = icp_trace(c, "cpu", False)
    got = ticp.icp_point_to_point(*[_t(c[k]) for k in ("src", "src_mask", "dst",
                                                       "dst_mask")],
                                  10, c["max_corr_dist"], c["n_valid"], c["tail_start"])
    T, n, rmse = port[-1][2:]
    assert np.array_equal(got.transform.numpy(), T)
    assert (float(got.rmse), int(got.n_pairs)) == (rmse, n)
    flip, _ = icp_traces_agree(port, _ref_icp_trace(c), c["dst"], c["src_mask"])
    if flip is None:
        ref = jicp.icp_point_to_point(*[_j(c[k]) for k in ("src", "src_mask", "dst",
                                                           "dst_mask")],
                                      10, c["max_corr_dist"])
        T_r = np.asarray(ref.transform)
        assert int(ref.n_pairs) == n
        assert np.abs(T[:3, :3] - T_r[:3, :3]).max() <= 1e-5
        assert np.abs(T[:3, 3] - T_r[:3, 3]).max() <= 0.01
        assert abs(rmse - float(ref.rmse)) <= 1e-3 * float(ref.rmse)
    if name in ("few_pairs", "no_pairs"):
        assert np.array_equal(T, np.eye(4, dtype=np.float32)) and n == (name == "few_pairs") * 2
    else:
        assert n >= 3 and np.abs(T - np.eye(4)).max() > 1.0
