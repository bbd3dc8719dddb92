"""Bundle adjustment with Schur-complement reduction and matrix-free PCG.

Port of `bshot_slam_tpu.backend.ba`: joint refinement of keyframe poses and
landmark positions from sensor-frame point observations,

    r_o = T_{kf(o)}^-1 l_{lm(o)} - z_o          (3-vector, solved in metres)

by damped Gauss-Newton.  Each iteration eliminates the landmark block in
closed form (Hll is 3x3 block-diagonal) and solves the reduced pose system
S dx = b with preconditioned conjugate gradients whose matvec never forms
S.  Every per-observation sum is an `index_add_` over ids sorted once per
solve (the reference's sorted `segment_sum`).  Jacobians are closed form:
Jl = R^T, Jp = [-I, [p_s]x] for the right perturbation T exp(xi).
`reduce`, when given, finishes every per-observation sum (the sharded
solve's all-reduce over ranks that each hold some observations).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bshot_slam_tpu_torch.geometry import se3


class BAProblem(NamedTuple):
    poses: torch.Tensor  # (M, 4, 4)
    landmarks: torch.Tensor  # (L, 3) world
    obs_kf: torch.Tensor  # (O,) int
    obs_lm: torch.Tensor  # (O,) int
    obs_p: torch.Tensor  # (O, 3) measured sensor-frame position
    obs_mask: torch.Tensor  # (O,) bool


class BAResult(NamedTuple):
    poses: torch.Tensor
    landmarks: torch.Tensor
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


def _inv3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant); the inputs
    are damped SPD blocks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, 1e-30)
    adj = torch.stack([
        torch.stack([co_a, c * h - b * i, b * f - c * e], dim=-1),
        torch.stack([co_b, a * i - c * g, c * d - a * f], dim=-1),
        torch.stack([co_c, b * g - a * h, a * e - b * d], dim=-1),
    ], dim=-2)
    return adj * inv_det[..., None, None]


def _prepare(poses, landmarks, prob: BAProblem, kf, lm):
    R = poses[kf, :3, :3]  # (O, 3, 3)
    t = poses[kf, :3, 3]
    p_s = torch.einsum("oji,oj->oi", R, landmarks[lm] - t)  # R^T (l - t)
    m = prob.obs_mask.to(poses.dtype)
    r = (p_s - prob.obs_p) * m[:, None]
    Jl = R.transpose(-1, -2)
    Jp = torch.cat([-torch.eye(3, dtype=poses.dtype, device=poses.device)
                    .expand(Jl.shape), se3.hat(p_s)], dim=-1)  # (O, 3, 6)
    return r, Jl * m[:, None, None], Jp * m[:, None, None]


def ba_solve(prob: BAProblem, gn_iterations: int = 5, cg_iterations: int = 20,
             lm_lambda: float = 1.0e-4, anchor_weight: float = 1.0e6,
             reduce=None) -> BAResult:
    s = 1.0 / 1000.0  # solve in metres (see backend.posegraph)
    dev = prob.poses.device
    f32 = dict(dtype=torch.float32, device=dev)
    scale = torch.ones((4, 4), **f32)
    scale[:3, 3] = s
    prob = prob._replace(poses=prob.poses * scale, landmarks=prob.landmarks * s,
                         obs_p=prob.obs_p * s)
    M, L = prob.poses.shape[0], prob.landmarks.shape[0]
    kf, lm = prob.obs_kf.long(), prob.obs_lm.long()

    def total(x):
        return x if reduce is None else reduce(x)

    def cost(poses, landmarks):
        r, _, _ = _prepare(poses, landmarks, prob, kf, lm)
        return total(0.5 * torch.sum(r * r))

    # Each reduction axis sorted once per solve.
    perm_kf = torch.argsort(kf, stable=True)
    ids_kf = kf[perm_kf]
    perm_lm = torch.argsort(lm, stable=True)
    ids_lm = lm[perm_lm]

    def seg_kf(x):
        return total(torch.zeros((M,) + x.shape[1:], **f32)
                     .index_add_(0, ids_kf, x[perm_kf]))

    def seg_lm(x):
        return total(torch.zeros((L,) + x.shape[1:], **f32)
                     .index_add_(0, ids_lm, x[perm_lm]))

    eye3 = torch.eye(3, **f32)
    eye6 = torch.eye(6, **f32)
    anchor = torch.zeros((M, 6, 6), **f32)
    anchor[0] = anchor_weight * eye6
    poses, landmarks = prob.poses, prob.landmarks
    lam = torch.full((), lm_lambda, **f32)
    c0 = cost(poses, landmarks)
    for _ in range(gn_iterations):
        r, Jl, Jp = _prepare(poses, landmarks, prob, kf, lm)
        b_p = -seg_kf(torch.einsum("oij,oi->oj", Jp, r))  # (M, 6)
        b_l = -seg_lm(torch.einsum("oij,oi->oj", Jl, r))  # (L, 3)
        Hll = seg_lm(torch.einsum("oik,oij->okj", Jl, Jl)) + (lam + 1e-6) * eye3
        Hll_inv = _inv3(Hll)
        # Block diagonal of the pose Hessian: preconditioner and damping.
        Hpp_blk = seg_kf(torch.einsum("oik,oij->okj", Jp, Jp))  # (M, 6, 6)
        tr = torch.diagonal(Hpp_blk, dim1=-2, dim2=-1).sum(-1)
        damp = lam * eye6[None] * (1.0 + tr)[:, None, None] / 6.0
        P_inv = torch.linalg.inv_ex(Hpp_blk + damp + anchor + 1e-3 * eye6[None])[0]

        w_l = torch.einsum("lij,lj->li", Hll_inv, b_l)
        b_schur = b_p - seg_kf(torch.einsum(
            "oij,oi->oj", Jp, torch.einsum("oij,oj->oi", Jl, w_l[lm])))

        def S_matvec(v):  # v: (M, 6)
            u = torch.einsum("oij,oj->oi", Jp, v[kf])  # (O, 3)
            t_l = seg_lm(torch.einsum("oij,oi->oj", Jl, u))  # (L, 3)
            wl = torch.einsum("lij,lj->li", Hll_inv, t_l)
            corr = torch.einsum("oij,oj->oi", Jl, wl[lm])
            Sv = seg_kf(torch.einsum("oij,oi->oj", Jp, u - corr))
            return Sv + torch.einsum("mij,mj->mi", damp + anchor, v)

        def pc(v):
            return torch.einsum("mij,mj->mi", P_inv, v)

        # Preconditioned CG on S dx = b_schur.
        x = torch.zeros((M, 6), **f32)
        rr = b_schur - S_matvec(x)
        z = pc(rr)
        p = z
        for _ in range(cg_iterations):
            Sp = S_matvec(p)
            rz = torch.sum(rr * z)
            alpha = rz / torch.clamp(torch.sum(p * Sp), min=1e-12)
            x = x + alpha * p
            rr = rr - alpha * Sp
            z_new = pc(rr)
            beta = torch.sum(rr * z_new) / torch.clamp(rz, min=1e-12)
            p = z_new + beta * p
            z = z_new
        dx = x

        # Back-substitute the landmarks.
        u = torch.einsum("oij,oj->oi", Jp, dx[kf])
        t_l = seg_lm(torch.einsum("oij,oi->oj", Jl, u))
        dl = torch.einsum("lij,lj->li", Hll_inv, b_l - t_l)
        poses_new = torch.matmul(poses, se3.se3_exp(dx))
        lm_new = landmarks + dl
        improved = cost(poses_new, lm_new) < cost(poses, landmarks)
        poses = torch.where(improved, poses_new, poses)
        landmarks = torch.where(improved, lm_new, landmarks)
        lam = torch.where(improved, lam * 0.3, lam * 5.0)
    return BAResult(poses=poses / scale, landmarks=landmarks / s,
                    initial_cost=c0, final_cost=cost(poses, landmarks))
