"""SE(3) utilities: 4x4 pose matrices and masked rigid fits.

A frozen copy of the functions of bshot_slam_tpu_torch/geometry/se3.py
that the reference step uses: the reference imports nothing of the
program.  Poses are (4, 4) float32 row-matrices T with
`p_world = T[:3, :3] @ p_local + T[:3, 3]`; units are mm and radians.
Every function is batched over leading dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def from_rt(rotation: torch.Tensor, translation: torch.Tensor) -> torch.Tensor:
    """Build (..., 4, 4) from (..., 3, 3) rotation and (..., 3) translation."""
    batch = torch.broadcast_shapes(rotation.shape[:-2], translation.shape[:-1])
    rotation = rotation.expand(batch + (3, 3))
    translation = translation.expand(batch + (3,))
    top = torch.cat([rotation, translation[..., :, None]], dim=-1)
    # The last row of the identity, made on the device: no host copy (which
    # would synchronise) and no in-place write (functorch transforms).
    bottom = torch.eye(4, dtype=rotation.dtype,
                       device=rotation.device)[3].expand(batch + (4,))
    return torch.cat([top, bottom[..., None, :]], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    R = rotation(T)
    t = translation(T)
    Rt = R.transpose(-1, -2)
    return from_rt(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.matmul(A, B)


def apply(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Transform (..., N, 3) points by (..., 4, 4) pose."""
    R = rotation(T)
    t = translation(T)
    return torch.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def heading_angle(T_delta: torch.Tensor) -> torch.Tensor:
    """Angle between the +y heading vector pre/post rotation, radians
    (reference gate metric `acos(h^T R h)`, h = (0, 1, 0))."""
    R = rotation(T_delta)
    return torch.arccos(torch.clamp(R[..., 1, 1], -1.0, 1.0))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [w, x, y, z] -> (..., 3, 3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def kabsch(
    src: torch.Tensor,
    dst: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """Weighted least-squares rigid transform T with dst ~= T(src).

    src, dst: (..., N, 3); weights: (..., N) nonnegative.  Returns
    (..., 4, 4).  Horn's quaternion method: the rotation is the top
    eigenvector of a 4x4 symmetric matrix, found by 30 shifted power
    iterations — the reference's exact formula, so RANSAC hypotheses and
    ICP steps agree with it (an SVD would pick another rounding path).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights / (torch.sum(weights, dim=-1, keepdim=True) + _EPS)
    mu_src = torch.sum(src * w[..., None], dim=-2)
    mu_dst = torch.sum(dst * w[..., None], dim=-2)
    src_c = src - mu_src[..., None, :]
    dst_c = dst - mu_dst[..., None, :]
    # Cross-covariance H[a, b] = sum_i w_i src_i[a] dst_i[b].
    H = torch.einsum("...n,...na,...nb->...ab", w, src_c, dst_c)
    scale = torch.sqrt(torch.sum(H * H, dim=(-2, -1), keepdim=True)) + _EPS
    Hn = H / scale
    Sxx, Sxy, Sxz = Hn[..., 0, 0], Hn[..., 0, 1], Hn[..., 0, 2]
    Syx, Syy, Syz = Hn[..., 1, 0], Hn[..., 1, 1], Hn[..., 1, 2]
    Szx, Szy, Szz = Hn[..., 2, 0], Hn[..., 2, 1], Hn[..., 2, 2]
    K = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        dim=-2,
    )
    # Shift by 2*I (eigenvalues of K/|H| lie in [-2, 2]) -> top eigenpair.
    Ks = K + 2.0 * torch.eye(4, dtype=K.dtype, device=K.device)
    q = torch.ones(K.shape[:-1], dtype=K.dtype, device=K.device)
    for _ in range(30):
        q = torch.einsum("...ij,...j->...i", Ks, q)
        q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    R = quat_to_matrix(q)
    t = mu_dst - torch.einsum("...ij,...j->...i", R, mu_src)
    return from_rt(R, t)
