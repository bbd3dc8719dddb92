"""Port parity: geometry (se3, eig3) of bshot_slam_tpu_torch vs bshot_slam_tpu.

Same numpy inputs (the ones tests/test_se3.py and tests/test_eig3.py use)
through both packages on the CPU.  Tolerance rtol 1e-5 (elementwise float32
code in both; only library kernels such as matmul and sqrt may round
differently); eigenvector signs must agree exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bshot_slam_tpu.geometry import eig3 as jeig
from bshot_slam_tpu.geometry import se3 as jse3
from bshot_slam_tpu_torch.geometry import eig3 as teig
from bshot_slam_tpu_torch.geometry import se3 as tse3

RTOL = 1e-5


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=atol)


def _poses(rng, n):
    w = rng.normal(size=(n, 3))
    w = w / np.linalg.norm(w, axis=1, keepdims=True) * rng.uniform(0.1, 2.5, (n, 1))
    xi = np.concatenate([rng.normal(size=(n, 3)) * 1000.0, w], axis=1)
    return xi.astype(np.float32)


@pytest.mark.parametrize("fn", ["se3_exp", "so3_exp"])
def test_exp_maps(rng, fn):
    xi = (rng.normal(size=(16, 6)) * np.array([500, 500, 500, 0.5, 0.5, 0.5])
          ).astype(np.float32)
    x = xi if fn == "se3_exp" else xi[:, 3:]
    x[0] = 0.0  # the Taylor branch
    _close(getattr(tse3, fn)(_t(x)), getattr(jse3, fn)(jnp.asarray(x)), 1e-5)


def test_log_maps(rng):
    T = np.array(jse3.se3_exp(jnp.asarray(_poses(rng, 16))))
    T[0] = np.eye(4)
    _close(tse3.se3_log(_t(T)), jse3.se3_log(jnp.asarray(T)), 1e-3)
    _close(tse3.so3_log(_t(T[:, :3, :3])), jse3.so3_log(jnp.asarray(T[:, :3, :3])),
           1e-6)


def test_compose_inverse_apply_heading(rng):
    T = np.asarray(jse3.se3_exp(jnp.asarray(_poses(rng, 8))))
    pts = (rng.normal(size=(8, 50, 3)) * 1000).astype(np.float32)
    _close(tse3.inverse(_t(T)), jse3.inverse(jnp.asarray(T)), 1e-3)
    _close(tse3.compose(_t(T), _t(T[::-1].copy())),
           jse3.compose(jnp.asarray(T), jnp.asarray(T[::-1])), 1e-3)
    _close(tse3.apply(_t(T), _t(pts)), jse3.apply(jnp.asarray(T), jnp.asarray(pts)),
           1e-2)
    _close(tse3.heading_angle(_t(T)), jse3.heading_angle(jnp.asarray(T)), 1e-6)


@pytest.mark.parametrize("weighted", [False, True])
def test_kabsch_batched(rng, weighted):
    T_true = np.asarray(jse3.se3_exp(jnp.asarray(_poses(rng, 6))))
    src = (rng.normal(size=(6, 40, 3)) * 2000).astype(np.float32)
    dst = np.einsum("bij,bnj->bni", T_true[:, :3, :3], src) + T_true[:, None, :3, 3]
    w = None
    if weighted:
        dst[:, 30:] += rng.normal(size=(6, 10, 3)) * 50000  # outliers
        w = np.ones((6, 40), np.float32)
        w[:, 30:] = 0.0
    dst = dst.astype(np.float32)
    got = tse3.kabsch(_t(src), _t(dst), None if w is None else _t(w))
    want = jse3.kabsch(jnp.asarray(src), jnp.asarray(dst),
                       None if w is None else jnp.asarray(w))
    _close(got, want, 1e-2)
    np.testing.assert_allclose(got.numpy(), T_true, rtol=1e-3, atol=1.0)


def test_kabsch_degenerate_no_nan():
    z = np.zeros((10, 3), np.float32)
    T = tse3.kabsch(_t(z), _t(z), _t(np.zeros(10)))
    assert torch.isfinite(T).all()


def _random_sym(rng, n=500, scale=1e6):
    X = rng.normal(size=(n, 3, 5)) * np.sqrt(scale)
    return (X @ np.swapaxes(X, 1, 2)).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "isotropic", "rank_one"])
def test_eigh3(rng, case):
    if case == "random":
        A = _random_sym(rng)
    elif case == "isotropic":
        A = np.tile(2.5 * np.eye(3, dtype=np.float32), (4, 1, 1))
    else:
        v = np.array([1.0, 2.0, 3.0], np.float32)
        A = np.outer(v, v)[None].astype(np.float32)
    lam_t, V_t = teig.eigh3(_t(A))
    lam_j, V_j = map(np.asarray, jeig.eigh3(jnp.asarray(A)))
    scale = np.abs(lam_j).max() + 1.0
    _close(lam_t, lam_j, 1e-5 * scale)
    _close(teig.eigvalsh3(_t(A)), jeig.eigvalsh3(jnp.asarray(A)), 1e-5 * scale)
    _close(V_t, V_j, 1e-4)
    # Signs exactly as the reference's: every (non-degenerate) column points
    # the same way.
    dots = np.einsum("nik,nik->nk", V_t.numpy(), V_j)
    unit = np.linalg.norm(V_j, axis=1) > 0.5
    assert (dots[unit] > 0.99).all()
