"""Closed-form batched 3x3 symmetric eigendecomposition.

A frozen copy of `eigh3` of bshot_slam_tpu_torch/geometry/eig3.py: the
trigonometric closed form with cross-product eigenvectors and one
Rayleigh polish per extreme eigenpair, on the six matrix components as
(...,)-shaped tensors.  The eigenvalues come ascending: normals take
`evecs[..., 0]`, the SHOT frame takes `[..., 2]` and `[..., 0]`.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _components(A: torch.Tensor):
    """(..., 3, 3) symmetric -> six (...,) components a00,a11,a22,a01,a12,a02."""
    return (
        A[..., 0, 0], A[..., 1, 1], A[..., 2, 2],
        A[..., 0, 1], A[..., 1, 2], A[..., 0, 2],
    )


def _eigvals_c(a00, a11, a22, a01, a12, a02):
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (
        b00 * b00 + b11 * b11 + b22 * b22
        + 2.0 * (a01 * a01 + a12 * a12 + a02 * a02)
    ) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detB / torch.clamp(2.0 * p * p * p, min=_EPS), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l1 = q + 2.0 * p * torch.cos(phi)  # largest
    l3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    l2 = 3.0 * q - l1 - l3
    # Degenerate (p2 ~ 0): all eigenvalues equal q.
    iso = p2 < 1e-10 * torch.clamp(q * q, min=1.0)
    l1 = torch.where(iso, q, l1)
    l2 = torch.where(iso, q, l2)
    l3 = torch.where(iso, q, l3)
    return l3, l2, l1


def _eigvec_c(c, lam):
    """Eigenvector of symmetric A for eigenvalue lam via the largest cross
    product of rows of (A - lam I)."""
    a00, a11, a22, a01, a12, a02 = c
    m00, m11, m22 = a00 - lam, a11 - lam, a22 - lam
    c01x = a01 * a12 - a02 * m11
    c01y = a02 * a01 - m00 * a12
    c01z = m00 * m11 - a01 * a01
    c02x = a01 * m22 - a02 * a12
    c02y = a02 * a02 - m00 * m22
    c02z = m00 * a12 - a01 * a02
    c12x = m11 * m22 - a12 * a12
    c12y = a12 * a02 - a01 * m22
    c12z = a01 * a12 - m11 * a02
    n01 = c01x * c01x + c01y * c01y + c01z * c01z
    n02 = c02x * c02x + c02y * c02y + c02z * c02z
    n12 = c12x * c12x + c12y * c12y + c12z * c12z
    use02 = n02 > n01
    bx = torch.where(use02, c02x, c01x)
    by = torch.where(use02, c02y, c01y)
    bz = torch.where(use02, c02z, c01z)
    bn = torch.where(use02, n02, n01)
    use12 = n12 > bn
    bx = torch.where(use12, c12x, bx)
    by = torch.where(use12, c12y, by)
    bz = torch.where(use12, c12z, bz)
    bn = torch.where(use12, n12, bn)
    # Repeated eigenvalue: any vector orthogonal to the largest row of M
    # spans the eigenplane.
    n0 = m00 * m00 + a01 * a01 + a02 * a02
    n1 = a01 * a01 + m11 * m11 + a12 * a12
    n2 = a02 * a02 + a12 * a12 + m22 * m22
    rx, ry, rz, rn = m00, a01, a02, n0
    take1 = n1 > rn
    rx = torch.where(take1, a01, rx)
    ry = torch.where(take1, m11, ry)
    rz = torch.where(take1, a12, rz)
    rn = torch.where(take1, n1, rn)
    take2 = n2 > rn
    rx = torch.where(take2, a02, rx)
    ry = torch.where(take2, a12, ry)
    rz = torch.where(take2, m22, rz)
    rn = torch.where(take2, n2, rn)
    zero = torch.zeros_like(rx)
    # r x x_hat = (0, rz, -ry);  r x y_hat = (-rz, 0, rx): pick the larger.
    na = ry * ry + rz * rz
    nb = rx * rx + rz * rz
    use_b = nb > na
    ox = torch.where(use_b, -rz, zero)
    oy = torch.where(use_b, zero, rz)
    oz = torch.where(use_b, rx, -ry)
    on = torch.where(use_b, nb, na)

    norm = torch.sqrt(torch.clamp(bn, min=1e-40))
    onorm = torch.sqrt(torch.clamp(on, min=1e-40))
    ok = bn > 1e-12 * rn * rn + 1e-40
    ok2 = on > 1e-40
    one = torch.ones_like(rx)
    vx = torch.where(ok, bx / norm, torch.where(ok2, ox / onorm, one))
    vy = torch.where(ok, by / norm, torch.where(ok2, oy / onorm, zero))
    vz = torch.where(ok, bz / norm, torch.where(ok2, oz / onorm, zero))
    return vx, vy, vz


def _rayleigh_c(c, v):
    a00, a11, a22, a01, a12, a02 = c
    vx, vy, vz = v
    avx = a00 * vx + a01 * vy + a02 * vz
    avy = a01 * vx + a11 * vy + a12 * vz
    avz = a02 * vx + a12 * vy + a22 * vz
    return vx * avx + vy * avy + vz * avz


def eigh3(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(eigenvalues ascending (..., 3), eigenvectors (..., 3, 3) columns):
    evecs[..., :, i] pairs evals[..., i]."""
    c = _components(A)
    l3, l2, l1 = _eigvals_c(*c)
    v0 = _eigvec_c(c, l3)
    v2 = _eigvec_c(c, l1)
    v0 = _eigvec_c(c, _rayleigh_c(c, v0))
    v2 = _eigvec_c(c, _rayleigh_c(c, v2))
    l3 = _rayleigh_c(c, v0)
    l1 = _rayleigh_c(c, v2)
    l2 = (c[0] + c[1] + c[2]) - l3 - l1
    # Orthogonalize: middle vector as cross of extremes.
    v0x, v0y, v0z = v0
    v2x, v2y, v2z = v2
    dot = v0x * v2x + v0y * v2y + v0z * v2z
    v2x, v2y, v2z = v2x - dot * v0x, v2y - dot * v0y, v2z - dot * v0z
    n2 = torch.clamp(torch.sqrt(v2x * v2x + v2y * v2y + v2z * v2z), min=1e-20)
    v2x, v2y, v2z = v2x / n2, v2y / n2, v2z / n2
    v1x = v2y * v0z - v2z * v0y
    v1y = v2z * v0x - v2x * v0z
    v1z = v2x * v0y - v2y * v0x
    lam = torch.stack([l3, l2, l1], dim=-1)
    V = torch.stack(
        [
            torch.stack([v0x, v1x, v2x], dim=-1),
            torch.stack([v0y, v1y, v2y], dim=-1),
            torch.stack([v0z, v1z, v2z], dim=-1),
        ],
        dim=-2,
    )
    return lam, V
