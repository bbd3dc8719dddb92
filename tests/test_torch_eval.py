"""Port parity: the evaluation ops against the reference, on the CPU.

(a) `iss_keypoints` on a cloud of noisy corners near the origin (three
    orthogonal planes each, on a 20 mm grid), at the default radii and at
    the reference test's 150 / 100 mm: kernel A's moments (plain version)
    feed `eigvalsh3`, whose floats part from the reference's compiled
    eigen-solves (tests/test_torch_features.py), and the saliency tests and
    the non-max suppression compare those floats.  Held: keypoint counts
    within 10%, at least 75% of the reference's keypoints found, the
    saliency (l3) of the common ones within 2 mm^2: the float32 covariance
    itself rounds by up to 0.41 mm^2 against float64 at these coordinates,
    on either side (measured: 256 / 256 and 220 common at the default
    radii, 54 / 56 and 42 common at 150 mm; l3 within 0.77 mm^2).
(b) `repeatability`: the reference's example, and random keypoint sets
    (masked rows, rows at the origin), equal to the reference's value.
(c) `voxel_downsample`: centroids and valid flags bit-equal to the
    reference's (its scatter-add sums each slot in row order), with hash
    collisions (a small table), masked rows and negative cells.
(d) `matmul_distances` equal to the reference's; `mutual_nn` with and
    without `use_matmul` gives the reference's mutual pairs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bshot_slam_tpu.config as jc
import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu.ops import hamming as jh
from bshot_slam_tpu.ops import keypoints as jkp
from bshot_slam_tpu.ops import voxelgrid as jvg
from bshot_slam_tpu.ops.bshot import unpack_bits as j_unpack
from bshot_slam_tpu_torch.ops import hamming as th
from bshot_slam_tpu_torch.ops import keypoints as tkp
from bshot_slam_tpu_torch.ops import voxelgrid as tvg
from bshot_slam_tpu_torch.ops.bshot import unpack_bits as t_unpack
from tests.torch_kernel_cases import iss_corners


RADII = {"default": {}, "wide": dict(iss_salient_radius_mm=150.0,
                                     iss_nonmax_radius_mm=100.0)}


@pytest.mark.parametrize("radii", RADII)
def test_iss_keypoints_match_reference(radii):
    pts, mask = iss_corners()
    kw = RADII[radii]
    want = jkp.iss_keypoints(jnp.asarray(pts), jnp.asarray(mask),
                             jc.KeypointConfig(**kw), tile=1024, max_out=256)
    got = tkp.iss_keypoints(torch.tensor(pts), torch.tensor(mask),
                            tc.KeypointConfig(**kw), tile=1024, max_out=256)
    n_j, n_t = int(np.asarray(want.mask).sum()), int(got.mask.sum())
    assert n_j > 20 and abs(n_t - n_j) <= 0.1 * n_j
    wi = np.asarray(want.indices)[:n_j]
    gi = got.indices.numpy()[:n_t]
    common, iw, ig = np.intersect1d(wi, gi, return_indices=True)
    assert len(common) >= 0.75 * n_j
    np.testing.assert_allclose(got.scores.numpy()[ig], np.asarray(want.scores)[iw],
                               rtol=0, atol=2.0)
    np.testing.assert_array_equal(got.positions.numpy()[ig], pts[common])
    assert (got.indices.numpy()[n_t:] == -1).all() and not got.positions[n_t:].any()


def test_repeatability_example():
    src = torch.tensor([[0, 0, 0.001], [100, 0, 0], [5000, 5000, 0]])
    ref = torch.tensor([[10.0, 0, 0], [120, 0, 0]])
    ones3, ones2 = torch.ones(3, dtype=torch.bool), torch.ones(2, dtype=torch.bool)
    r = tkp.repeatability(src, ones3, ref, ones2, 30.0)
    assert r.dtype == torch.float32 and abs(float(r) - 2.0 / 3.0) < 1e-6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_repeatability_matches_reference(seed):
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-5000, 5000, (300, 3)).astype(np.float32)
    src = (ref[rng.permutation(300)[:250]] + rng.normal(0, 20, (250, 3))).astype(np.float32)
    src[:10] = 0.0  # at the origin: not counted
    sm, rm = rng.random(250) > 0.1, rng.random(300) > 0.2
    want = float(jkp.repeatability(*map(jnp.asarray, (src, sm, ref, rm)), 30.0))
    got = float(tkp.repeatability(*map(torch.tensor, (src, sm, ref, rm)), 30.0))
    assert got == want and 0.2 < got < 0.95


@pytest.mark.parametrize("leaf,capacity,seed", [
    (200.0, 4096, 0), (1000.0, 512, 1), (50.0, 64, 2), (333.0, 16384, 3),
])
def test_voxel_downsample_matches_reference(leaf, capacity, seed):
    rng = np.random.default_rng(seed)
    pts = np.concatenate([rng.normal(0, 3000, (3000, 3)),
                          rng.normal(-20000, 40, (500, 3))]).astype(np.float32)
    mask = rng.random(len(pts)) > 0.1
    cj, vj = jvg.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), leaf, capacity)
    ct, vt = tvg.voxel_downsample(torch.tensor(pts), torch.tensor(mask), leaf, capacity)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    assert ct.shape == (capacity, 3) and 0 < int(vt.sum()) < len(pts)


def _words(rng, n):
    return rng.integers(0, 2**32, (n, 11), dtype=np.uint64).astype(np.uint32)


def test_matmul_distances_match_reference():
    rng = np.random.default_rng(5)
    a, b = _words(rng, 70), _words(rng, 90)
    want = jh.matmul_distances(j_unpack(jnp.asarray(a)), j_unpack(jnp.asarray(b)))
    got = th.matmul_distances(t_unpack(torch.tensor(a.view(np.int32))),
                              t_unpack(torch.tensor(b.view(np.int32))))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_matmul", [True, False])
def test_mutual_nn_matches_reference(use_matmul):
    rng = np.random.default_rng(6)
    a, b = _words(rng, 300), _words(rng, 280)
    b[:40] = a[rng.permutation(300)[:40]]
    b[50:53] = a[7]  # a three-way tie: the lowest index wins
    am, bm = rng.random(300) > 0.1, rng.random(280) > 0.1
    am[7] = True
    bm[50:53] = True
    want = jh.mutual_nn(jnp.asarray(a), jnp.asarray(am), jnp.asarray(b), jnp.asarray(bm),
                        use_matmul=use_matmul)
    got = th.mutual_nn(torch.tensor(a.view(np.int32)), torch.tensor(am),
                       torch.tensor(b.view(np.int32)), torch.tensor(bm),
                       use_matmul=use_matmul)
    m = np.asarray(want.mutual)
    np.testing.assert_array_equal(got.mutual.numpy(), m)
    np.testing.assert_array_equal(got.src_to_ref.numpy()[m], np.asarray(want.src_to_ref)[m])
    np.testing.assert_array_equal(got.distances.numpy()[m], np.asarray(want.distances)[m])
    assert int(got.src_to_ref[7]) == 50 and m.sum() >= 30
    other = th.mutual_nn(torch.tensor(a.view(np.int32)), torch.tensor(am),
                         torch.tensor(b.view(np.int32)), torch.tensor(bm),
                         use_matmul=not use_matmul)
    for x, y in zip(got, other):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
