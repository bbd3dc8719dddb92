"""Pose-graph optimisation: Levenberg-Marquardt on SE(3).

Port of `bshot_slam_tpu.backend.posegraph`.  Parameterisation
T_i = T0_i exp(xi_i) with per-node twists; edge residual
r_e = log(Z_e^-1 T_i^-1 T_j) for a measured relative pose Z_e, weighted by
sqrt(edge_weight) and robustified with Huber IRLS weights that are frozen
for each LM iteration.  The problem is solved in metres (mm-scale
translations against radian rotations make the float32 normal equations
singular), with an anchor prior on node 0 fixing the gauge.  Jacobians are
`torch.func.jacrev` of the batched residual; the dense (6M)^2 damped
normal equations are solved with one LU solve per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bshot_slam_tpu_torch.geometry import se3


class PoseGraph(NamedTuple):
    poses0: torch.Tensor  # (M, 4, 4) initial node poses
    edge_i: torch.Tensor  # (E,) int64 source node
    edge_j: torch.Tensor  # (E,) int64 target node
    edge_z: torch.Tensor  # (E, 4, 4) measured T_i^-1 T_j
    edge_weight: torch.Tensor  # (E,) scalar information weight
    edge_mask: torch.Tensor  # (E,) bool


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor  # (M, 4, 4) optimised
    initial_cost: torch.Tensor
    final_cost: torch.Tensor


# Huber threshold on the weighted edge residual norm (in sigmas): consistent
# edges stay quadratic, a contradictory closure grows only linearly.
_HUBER_DELTA = 2.0
_MM_PER_M = 1000.0


def _residuals(xi: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    """(E, 6) weighted (not robustified) edge residuals for (M, 6) twists."""
    T = torch.matmul(g.poses0, se3.se3_exp(xi))
    rel = torch.matmul(se3.inverse(T[g.edge_i]), T[g.edge_j])
    r = se3.se3_log(torch.matmul(se3.inverse(g.edge_z), rel))
    w = torch.sqrt(g.edge_weight) * g.edge_mask.to(torch.float32)
    return r * w[:, None]


def _huber_rho(rn: torch.Tensor) -> torch.Tensor:
    d = _HUBER_DELTA
    return torch.where(rn <= d, rn * rn, d * (2.0 * rn - d))


def _huber_weights(rw: torch.Tensor) -> torch.Tensor:
    """(E,) IRLS sqrt-weights of the current residuals, held fixed for one
    LM iteration (differentiating through them stalls LM)."""
    rn = torch.linalg.norm(rw, dim=-1)
    return torch.sqrt(torch.clamp(_HUBER_DELTA / torch.clamp(rn, min=1e-12),
                                  max=1.0))


def _scale_pose(T: torch.Tensor, s: float) -> torch.Tensor:
    """T with its translation multiplied by s."""
    m = torch.ones((4, 4), dtype=T.dtype, device=T.device)
    m[:3, 3] = s
    return T * m


def optimize_pose_graph(g: PoseGraph, iterations: int = 10,
                        lm_lambda: float = 1.0e-4,
                        anchor_weight: float = 1.0e6) -> PoseGraphResult:
    """LM iterations with an anchor prior on node 0 fixing the gauge."""
    g = g._replace(poses0=_scale_pose(g.poses0, 1.0 / _MM_PER_M),
                   edge_z=_scale_pose(g.edge_z, 1.0 / _MM_PER_M))
    M = g.poses0.shape[0]
    dev = g.poses0.device
    eye = torch.eye(M * 6, dtype=torch.float32, device=dev)
    anchor = torch.zeros((M * 6, M * 6), dtype=torch.float32, device=dev)
    anchor[:6, :6] = anchor_weight * torch.eye(6, device=dev)

    def cost(xi):
        rn = torch.linalg.norm(_residuals(xi, g), dim=-1)
        return (0.5 * torch.sum(_huber_rho(rn))
                + 0.5 * anchor_weight * torch.sum(xi[0] ** 2))

    xi = torch.zeros((M, 6), dtype=torch.float32, device=dev)
    lam = torch.full((), lm_lambda, dtype=torch.float32, device=dev)
    c0 = cost(xi)
    for _ in range(iterations):
        rw = _residuals(xi, g)
        hub = _huber_weights(rw)  # frozen IRLS weights for this iteration
        r = rw * hub[:, None]
        J = torch.func.jacrev(
            lambda x: (_residuals(x, g) * hub[:, None]).reshape(-1))(xi)
        Jf = J.reshape(-1, M * 6)
        H = Jf.T @ Jf + anchor
        b = -Jf.T @ r.reshape(-1)
        b = torch.cat([b[:6] - anchor_weight * xi[0], b[6:]])
        Hd = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye
        dx = torch.linalg.solve_ex(Hd, b)[0].reshape(M, 6)
        xi_new = xi + dx
        improved = cost(xi_new) < cost(xi)
        xi = torch.where(improved, xi_new, xi)
        lam = torch.where(improved, lam * 0.3, lam * 5.0)
    return PoseGraphResult(
        poses=_scale_pose(torch.matmul(g.poses0, se3.se3_exp(xi)), _MM_PER_M),
        initial_cost=c0, final_cost=cost(xi),
    )


def odometry_edges(poses: torch.Tensor, weight: float = 1.0) -> PoseGraph:
    """A chain pose graph from an (M, 4, 4) odometry trajectory."""
    M = poses.shape[0]
    dev = poses.device
    i = torch.arange(M - 1, device=dev)
    j = i + 1
    return PoseGraph(
        poses0=poses, edge_i=i, edge_j=j,
        edge_z=torch.matmul(se3.inverse(poses[i]), poses[j]),
        edge_weight=torch.full((M - 1,), weight, dtype=torch.float32, device=dev),
        edge_mask=torch.ones((M - 1,), dtype=torch.bool, device=dev),
    )


def add_edges(g: PoseGraph, edge_i: torch.Tensor, edge_j: torch.Tensor,
              edge_z: torch.Tensor, weight: torch.Tensor) -> PoseGraph:
    """Append (loop-closure) edges to a graph."""
    dev = g.poses0.device
    return PoseGraph(
        poses0=g.poses0,
        edge_i=torch.cat([g.edge_i, edge_i.to(dev, torch.int64)]),
        edge_j=torch.cat([g.edge_j, edge_j.to(dev, torch.int64)]),
        edge_z=torch.cat([g.edge_z, edge_z.to(dev, torch.float32)]),
        edge_weight=torch.cat([g.edge_weight, weight.to(dev, torch.float32)]),
        edge_mask=torch.cat([g.edge_mask, torch.ones(
            edge_i.shape[0], dtype=torch.bool, device=dev)]),
    )
