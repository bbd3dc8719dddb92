"""Batched-hypothesis RANSAC correspondence rejection.

Port of `bshot_slam_tpu.ops.ransac`: all hypotheses are drawn and scored
at once — (H, 3) index triples without replacement, a batched Kabsch solve,
an (H, K) inlier count — then a weighted refit on the best hypothesis's
inliers.  The draws come from the caller: a `torch.Generator`, or an
(H, 3) tensor of uniform numbers in [0, 1) (so a test can inject the
reference's `jax.random` draws).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bshot_slam_tpu_torch.geometry import se3


class RansacResult(NamedTuple):
    transform: torch.Tensor  # (4, 4) refit on inliers of the best hypothesis
    inliers: torch.Tensor  # (K,) bool
    n_inliers: torch.Tensor  # () int32


def uniform_draws(rng, iterations: int, device) -> torch.Tensor:
    """(H, 3) uniform draws: `rng` itself when it is a tensor, else drawn
    from the `torch.Generator` `rng`."""
    if isinstance(rng, torch.Tensor):
        if tuple(rng.shape) != (iterations, 3):
            raise ValueError(f"draws must have shape ({iterations}, 3)")
        return rng.to(device=device, dtype=torch.float32)
    return torch.rand((iterations, 3), generator=rng, device=device)


def sample_distinct_triples(u: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """(H, 3) index triples WITHOUT replacement from [0, n_valid), from
    (H, 3) uniform draws u: r0 from [0,n), r1 from [0,n-1) shifted past r0,
    r2 from [0,n-2) shifted past both."""
    n = torch.clamp(n_valid, min=3)
    r0 = (u[:, 0] * n).to(torch.int32)
    r1 = (u[:, 1] * (n - 1)).to(torch.int32)
    r1 = r1 + (r1 >= r0).to(torch.int32)
    r2 = (u[:, 2] * (n - 2)).to(torch.int32)
    lo = torch.minimum(r0, r1)
    hi = torch.maximum(r0, r1)
    r2 = r2 + (r2 >= lo).to(torch.int32)
    r2 = r2 + (r2 >= hi).to(torch.int32)
    return torch.stack([r0, r1, r2], dim=1)


def ransac_rigid(
    rng,
    src: torch.Tensor,
    dst: torch.Tensor,
    cmask: torch.Tensor,
    inlier_threshold: float,
    iterations: int = 2000,
) -> RansacResult:
    """Rigid transform from correspondences with outliers (src[i] matches
    dst[i]; cmask marks real ones).  With < 3 valid correspondences the
    identity transform and an empty inlier set are returned."""
    K = src.shape[0]
    dev = src.device
    n_valid = torch.sum(cmask.to(torch.int32))
    # Dense list of valid indices (then the invalid ones) for sampling.
    order = torch.argsort(torch.where(cmask, 0, 1), stable=True)
    draw = sample_distinct_triples(uniform_draws(rng, iterations, dev), n_valid)
    sample_idx = order[torch.clamp(draw, 0, K - 1).long()]  # (H, 3)

    s = src[sample_idx]  # (H, 3, 3)
    d = dst[sample_idx]
    T_h = se3.kabsch(s, d)  # (H, 4, 4)

    src_h = se3.apply(T_h, src[None, :, :])  # (H, K, 3)
    err = torch.linalg.norm(src_h - dst[None, :, :], dim=-1)
    ok = cmask[None, :] & (err < inlier_threshold)
    # Near-collinear source triples make the Kabsch rotation ill-conditioned;
    # zero their score so a degenerate hypothesis can never win.
    area2 = torch.linalg.norm(
        torch.linalg.cross(s[:, 1] - s[:, 0], s[:, 2] - s[:, 0]), dim=-1
    )
    scores = torch.where(area2 > 1e-6, torch.sum(ok.to(torch.int32), dim=1), 0)
    # The first maximum, taken with index_select: indexing with a 0-d tensor
    # reads it on the host, a synchronisation.
    best = torch.argmax(scores).reshape(1)
    inliers = (ok.index_select(0, best)[0] & (n_valid >= 3)
               & (scores.index_select(0, best)[0] > 0))
    w = inliers.to(torch.float32)
    T = se3.kabsch(src, dst, w)
    T = torch.where(torch.sum(w) >= 3, T, torch.eye(4, dtype=T.dtype, device=dev))
    return RansacResult(transform=T, inliers=inliers,
                        n_inliers=torch.sum(inliers.to(torch.int32)))
