"""Port parity: bounded map kernels C, D and E (plain versions).

The port's `hamming_nn_bounded`, `euclid_nn_bounded` and
`dedup_blocked_bounded` on CPU tensors (their plain PyTorch versions, which
the CUDA kernels reproduce exactly) against the reference's Pallas kernels
in interpret mode: a cursor that is not tile-aligned, a live tail, rows with
no valid candidate (3e38, index 0), planted ties (lowest index) and the
dedup blocker rules.  Integers exact; d2 rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bshot_slam_tpu.kernels import mapops as jm
from bshot_slam_tpu.ops import hamming as jh
from bshot_slam_tpu.ops.bshot import unpack_bits as j_unpack
from bshot_slam_tpu_torch.kernels import mapops as tm
from bshot_slam_tpu_torch.ops import bshot as tb
from bshot_slam_tpu_torch.ops import hamming as th

BIG = 3.0e38


def _words(rng, n):
    return rng.integers(0, 2**32, (n, 11), dtype=np.uint64).astype(np.uint32)


def _tw(words):
    return torch.tensor(words.view(np.int32))


def _hamming_case(rng, Ka=37, Cb=2100, nv=1031, tail=2048):
    a = _words(rng, Ka)
    b = _words(rng, Cb)
    am = rng.random(Ka) > 0.1
    am[:3] = True
    bm = np.zeros(Cb, bool)
    bm[:nv] = rng.random(nv) > 0.15
    if tail >= 0:
        bm[tail:] = True
        b[tail + 5] = a[0]  # exact match in the tail
    b[[3, 17, 900]] = a[1]  # three-way tie: lowest valid index wins
    bm[[3, 17, 900]] = True
    b[[40, 41]] = a[2]
    bm[40] = False  # the masked twin must lose
    bm[41] = True
    return a, am, b, bm, nv, tail


@pytest.mark.parametrize("tail", [-1, 2048])
def test_hamming_vs_pallas(tail):
    rng = np.random.default_rng(77)
    a, am, b, bm, nv, tail = _hamming_case(rng, tail=tail)
    got = tm.hamming_nn_bounded(_tw(a), torch.tensor(am), _tw(b), torch.tensor(bm),
                                nv, tail_start=tail)
    want = jm.hamming_nn_bounded(
        j_unpack(jnp.asarray(a)).astype(jnp.float32), jnp.asarray(am),
        jnp.asarray(b), jnp.asarray(bm), jnp.int32(nv), tail_start=tail,
        interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    amin, aarg, bmin, barg = (x.numpy() for x in got)
    assert aarg[1] == 3 and amin[1] == 0.0 and aarg[2] == 41
    if tail >= 0:
        assert aarg[0] == tail + 5
    # Rows with no candidate: 3e38 and index 0.
    assert (amin[~am] == np.float32(BIG)).all() and (aarg[~am] == 0).all()
    dead = np.ones(b.shape[0], bool)
    dead[:nv] = False
    if tail >= 0:
        dead[tail:] = False
    assert (bmin[dead] == np.float32(BIG)).all() and (barg[dead] == 0).all()


def test_hamming_all_ties():
    a = np.zeros((8, 11), np.uint32)
    b = np.zeros((64, 11), np.uint32)
    _, aarg, _, barg = tm.hamming_nn_bounded(
        _tw(a), torch.ones(8, dtype=torch.bool), _tw(b),
        torch.ones(64, dtype=torch.bool), 64)
    assert (aarg == 0).all() and (barg == 0).all()


def test_mutual_nn_vs_reference():
    rng = np.random.default_rng(5)
    a, am, b, bm, nv, _ = _hamming_case(rng, tail=-1)
    b[100:137] = a ^ np.uint32(1)  # near-mutual pairs
    bm[100:137] = True
    got = th.mutual_nn_bounded(_tw(a), torch.tensor(am), _tw(b), torch.tensor(bm), nv)
    want = jh.mutual_nn(jnp.asarray(a), jnp.asarray(am), jnp.asarray(b),
                        jnp.asarray(bm))
    np.testing.assert_array_equal(got.src_to_ref.numpy(), np.asarray(want.src_to_ref))
    np.testing.assert_array_equal(got.mutual.numpy(), np.asarray(want.mutual))
    mut = np.asarray(want.mutual)
    assert mut.sum() > 20
    np.testing.assert_array_equal(got.distances.numpy()[mut],
                                  np.asarray(want.distances)[mut])
    d = th.popcount_distances(_tw(a), _tw(b)).numpy()
    np.testing.assert_array_equal(d, np.asarray(jh.popcount_distances(
        jnp.asarray(a), jnp.asarray(b))))


def test_bits_roundtrip():
    rng = np.random.default_rng(9)
    w = _words(rng, 20)
    bits = tb.unpack_bits(_tw(w))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(j_unpack(jnp.asarray(w))))
    np.testing.assert_array_equal(tb.pack_bits(bits).numpy().view(np.uint32), w)


@pytest.mark.parametrize("tail", [-1, 2048])
def test_euclid_vs_pallas(tail):
    rng = np.random.default_rng(78)
    Kq, Cr, nv = 29, 2100, 1190
    q = rng.normal(0, 5000, (Kq, 3)).astype(np.float32)
    r = rng.normal(0, 5000, (Cr, 3)).astype(np.float32)
    qm = rng.random(Kq) > 0.1
    rm = np.zeros(Cr, bool)
    rm[:nv] = rng.random(nv) > 0.1
    r[nv:] = 0.0
    if tail >= 0:
        rm[tail:] = True
        r[tail:] = rng.normal(0, 5000, (Cr - tail, 3))
    r[[11, 500]] = q[0] + 100.0  # planted tie at d2 = 3e4
    rm[[11, 500]] = True
    qm[0] = True
    d2, idx = tm.euclid_nn_bounded(torch.tensor(q), torch.tensor(qm), torch.tensor(r),
                                   torch.tensor(rm), nv, tail_start=tail)
    wd2, widx = jm.euclid_nn_bounded(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                                     jnp.asarray(rm), jnp.int32(nv),
                                     tail_start=tail, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(wd2), rtol=1e-6)
    assert idx[0] == 11
    assert (d2.numpy()[~qm] == np.float32(BIG)).all() and (idx.numpy()[~qm] == 0).all()


def test_euclid_no_candidate():
    d2, idx = tm.euclid_nn_bounded(torch.ones(4, 3), torch.ones(4, dtype=torch.bool),
                                   torch.ones(10, 3), torch.zeros(10, dtype=torch.bool),
                                   10)
    assert (d2 == np.float32(BIG)).all() and (idx == 0).all()


def test_dedup_vs_pallas():
    rng = np.random.default_rng(79)
    K, C, nv = 33, 1300, 1031
    pos = (rng.normal(0, 3000, (K, 3)) // 10 * 10).astype(np.float32)
    seg = rng.random(K).astype(np.float32)
    mpos = (rng.normal(0, 3000, (C, 3)) // 10 * 10).astype(np.float32)
    mpos[:K] = pos + rng.normal(0, 500, (K, 3)).astype(np.float32)
    mpos[K:2 * K] = pos  # exact collisions, decided by seg_ratio alone
    mpos[nv:nv + K] = pos  # past the cursor: never a blocker
    mseg = rng.random(C).astype(np.float32)
    mseg[nv:] = 1.0
    mval = np.zeros(C, bool)
    mval[:nv] = True
    mval[nv:nv + K] = True  # valid flag set past the cursor: still dead
    blk = np.round(pos / 10000.0).astype(np.int32)
    mblk = np.round(mpos / 10000.0).astype(np.int32)
    got = tm.dedup_blocked_bounded(
        torch.tensor(pos), torch.tensor(blk), torch.tensor(seg), torch.tensor(mpos),
        torch.tensor(mblk), torch.tensor(mseg), torch.tensor(mval), nv, 800.0)
    want = np.asarray(jm.dedup_blocked_bounded(
        jnp.asarray(pos), jnp.asarray(blk), jnp.asarray(seg), jnp.asarray(mpos),
        jnp.asarray(mblk), jnp.asarray(mseg), jnp.asarray(np.arange(C) < nv),
        jnp.int32(nv), dedup_radius=800.0, interpret=True))
    np.testing.assert_array_equal(got.numpy(), want)
    # The reference rule, in float64.
    d2 = ((pos[:, None].astype(np.float64) - mpos[None, :nv]) ** 2).sum(-1)
    rule = ((blk[:, None] == mblk[None, :nv]).all(-1) & (d2 < 800.0**2)
            & (mseg[None, :nv] >= seg[:, None])).any(1)
    np.testing.assert_array_equal(got.numpy(), rule)
    assert 0 < rule.sum() < K
