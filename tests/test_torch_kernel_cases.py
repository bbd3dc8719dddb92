"""Port parity at the edges: kernels A and D (plain versions) vs the reference.

Every case of `tests/torch_kernel_cases.py` goes through the port's
`neighborhood_accumulate` / `euclid_nn_bounded` on CPU tensors (the plain
PyTorch versions, which the CUDA kernels must reproduce on the card:
`tests/test_torch_cuda.py` runs the same cases there) and through the
reference: its Pallas kernels in interpret mode, and for A's moment
features also its `lax.scan` path.  Counts, argmins and d2 are exact; A's
sums agree to 1e-5 * count * max|feat| (summation order only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bshot_slam_tpu.kernels import mapops as jm
from bshot_slam_tpu.kernels import neighborhood as jk
from bshot_slam_tpu.ops import keypoints as jkp
from bshot_slam_tpu_torch.kernels import mapops as tm
from bshot_slam_tpu_torch.kernels import neighborhood as tk
from tests.torch_kernel_cases import (
    A_CASES, D_CASES, accumulate_case, euclid_case,
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
