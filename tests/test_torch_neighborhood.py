"""Port parity: radius-neighbourhood kernels A and B (plain versions).

The port's `neighborhood_accumulate` / `segratio_accumulate` on CPU tensors
(their plain PyTorch versions, which the CUDA kernels reproduce exactly)
against the reference's `lax.scan` path and its Pallas kernels in interpret
mode, on the 700-point cloud of tests/test_pallas_kernels.py.  Counts are
exact; float sums as in tests/test_pallas_kernels.py (psum rtol 1e-5,
atol 1e-2; outer products rtol 1e-4, atol 100): only summation order
differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bshot_slam_tpu.config import KeypointConfig
from bshot_slam_tpu.kernels import neighborhood as jk
from bshot_slam_tpu.ops import keypoints as jkp
from bshot_slam_tpu_torch.config import KeypointConfig as TKeypointConfig
from bshot_slam_tpu_torch.kernels import neighborhood as tk
from bshot_slam_tpu_torch.ops import keypoints as tkp

RADIUS = 3000.0


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(55)
    n = 700
    pts = rng.normal(0, 4000, (n, 3)).astype(np.float32)
    mask = np.zeros(n, bool)
    mask[:517] = True  # front-compacted, not tile-aligned
    pts[~mask] = 0.0
    return pts, mask


def _feat(pts):
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return np.stack([np.ones_like(x), x, y, z, x * x, x * y, x * z, y * y,
                     y * z, z * z], axis=-1).astype(np.float32)


def _check_moments(acc, cnt, psum, o6):
    acc = np.asarray(acc)
    np.testing.assert_array_equal(acc[:, 0], np.asarray(cnt))
    np.testing.assert_allclose(acc[:, 1:4], np.asarray(psum), rtol=1e-5, atol=1e-2)
    np.testing.assert_allclose(acc[:, 4:10], np.asarray(o6), rtol=1e-4, atol=100.0)


@pytest.mark.parametrize("capped", [False, True])
def test_accumulate_vs_scan_and_pallas(cloud, capped):
    pts, mask = cloud
    r2_row = None
    if capped:
        r2_row = np.asarray(jkp.capped_r2_rows(jnp.asarray(pts), jnp.asarray(mask),
                                               RADIUS, cap=40, tile=256))
        got_r2 = tkp.capped_r2_rows(torch.tensor(pts), torch.tensor(mask), RADIUS,
                                    cap=40, tile=256)
        np.testing.assert_allclose(got_r2.numpy(), r2_row, rtol=1e-5)
    r2_t = None if r2_row is None else torch.tensor(r2_row)
    r2_j = None if r2_row is None else jnp.asarray(r2_row)
    got = tk.neighborhood_accumulate(torch.tensor(pts), torch.tensor(mask),
                                     torch.tensor(_feat(pts)), RADIUS,
                                     r2_row=r2_t, tile=256)
    cnt, psum, outer = jkp.neighborhood_moments(jnp.asarray(pts), jnp.asarray(mask),
                                                RADIUS, tile=256, r2_row=r2_j)
    o = np.asarray(outer)
    o6 = np.stack([o[:, 0, 0], o[:, 0, 1], o[:, 0, 2], o[:, 1, 1], o[:, 1, 2],
                   o[:, 2, 2]], axis=-1)
    _check_moments(got, cnt, psum, o6)
    feat128 = np.zeros((pts.shape[0], 128), np.float32)
    feat128[:, :10] = _feat(pts)
    pal = np.asarray(jk.neighborhood_accumulate(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(feat128), RADIUS,
        interpret=True, r2_row=r2_j))
    _check_moments(got, pal[:, 0], pal[:, 1:4], pal[:, 4:10])
    # The port's moments helper is the same sweep.
    c2, s2, _ = tkp.neighborhood_moments(torch.tensor(pts), torch.tensor(mask),
                                         RADIUS, tile=256, r2_row=r2_t)
    np.testing.assert_array_equal(c2.numpy(), np.asarray(cnt))


def test_accumulate_all_masked(cloud):
    pts, _ = cloud
    got = tk.neighborhood_accumulate(torch.tensor(pts),
                                     torch.zeros(pts.shape[0], dtype=torch.bool),
                                     torch.tensor(_feat(pts)), RADIUS)
    assert not got.any()
    b = tk.segratio_accumulate(torch.tensor(pts),
                               torch.zeros(pts.shape[0], dtype=torch.bool),
                               torch.tensor(pts), RADIUS)
    assert not b.any()


@pytest.mark.parametrize("sr_type", ["CV", "CVS", "CVSN"])
def test_segratio_vs_scan_and_pallas(cloud, sr_type):
    pts, mask = cloud
    cfg = KeypointConfig(sr_type=sr_type)
    cnt, psum, _ = jkp.neighborhood_moments(jnp.asarray(pts), jnp.asarray(mask),
                                            RADIUS, tile=256)
    ctvec = np.asarray(jnp.asarray(pts) - psum / jnp.maximum(cnt, 1.0)[:, None])
    got = tk.segratio_accumulate(torch.tensor(pts), torch.tensor(mask),
                                 torch.tensor(ctvec), RADIUS,
                                 normalized=(sr_type == "CVSN"), tile=256)
    pal = np.asarray(jk.segratio_accumulate(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(ctvec), RADIUS,
        normalized=(sr_type == "CVSN"), interpret=True))
    np.testing.assert_array_equal(got[:, :2].numpy(), pal[:, :2])
    if sr_type != "CV":
        np.testing.assert_allclose(got[:, 2].numpy(), pal[:, 2], rtol=1e-4, atol=1e-2)
    # Scores against the scan path, from the same moments.
    want = np.asarray(jkp.seg_ratio_scores(jnp.asarray(pts), jnp.asarray(mask), cfg,
                                           tile=256, moments=(cnt, psum)))
    scores = tkp.seg_ratio_scores(
        torch.tensor(pts), torch.tensor(mask), TKeypointConfig(sr_type=sr_type),
        tile=256, moments=(torch.tensor(np.asarray(cnt)), torch.tensor(np.asarray(psum))),
    ).numpy()
    np.testing.assert_array_equal(np.isfinite(scores), np.isfinite(want))
    fin = np.isfinite(want)
    assert fin.sum() > 100
    if sr_type == "CV":  # ratios of exact counts: bit-equal
        np.testing.assert_array_equal(scores[fin], want[fin])
    else:
        np.testing.assert_allclose(scores[fin], want[fin], rtol=1e-4, atol=1e-4)


def test_two_far_clusters():
    """The kernel's box skip must not change results when valid points form
    widely separated clusters (the prune-heavy case)."""
    rng = np.random.default_rng(11)
    n = 1536
    pts = np.zeros((n, 3), np.float32)
    pts[: n // 2] = rng.uniform(0, 2000, (n // 2, 3))
    pts[n // 2:] = rng.uniform(50000, 52000, (n // 2, 3))
    mask = np.ones(n, bool)
    mask[rng.integers(0, n, 100)] = False
    got = tk.neighborhood_accumulate(torch.tensor(pts), torch.tensor(mask),
                                     torch.tensor(_feat(pts)), 800.0)
    cnt, _, _ = jkp.neighborhood_moments(jnp.asarray(pts), jnp.asarray(mask), 800.0,
                                         tile=256)
    np.testing.assert_array_equal(got[:, 0].numpy(), np.asarray(cnt))
    feat128 = np.zeros((n, 128), np.float32)
    feat128[:, :10] = _feat(pts)
    pal = np.asarray(jk.neighborhood_accumulate(
        jnp.asarray(pts), jnp.asarray(mask), jnp.asarray(feat128), 800.0,
        interpret=True))
    # The Pallas kernel prunes tile pairs with no margin for the rounding of
    # the expanded d2, so a pair within f32 slop of the radius may differ.
    assert np.abs(got[:, 0].numpy() - pal[:, 0]).max() <= 2
