#!/usr/bin/env python3
"""Bundle-adjustment throughput of the port on the card — `tools/run_ba_bench.py` on PyTorch.

    python3 bshot_slam_tpu_torch/tools/run_ba_bench.py [--keyframes 64] \\
        [--landmarks 4096] [--obs-per-kf 512] [--gn-iters 10] [--cg-iters 20] [--cpu]

Builds the reference tool's synthetic problem from the same seed and draws
(keyframes on a 30 m circle observing shared landmarks, 10 mm observation
noise, poses and landmarks perturbed by 200 and 300 mm), then times
`backend.ba.ba_solve` end to end through `odometry.graphs` (captured as a
CUDA graph by the warm-up solve and replayed, as the reference's warm-up
compiles its `jax.jit`; on the CPU the same solve runs eagerly): one
warm-up solve, then 3 solves each fenced by a synchronise.  A Gauss-Newton iteration is the Jacobians, the
Schur reduction, the conjugate-gradient solve and the back-substitution.
Prints the reference tool's JSON line (`ba_gn_iters_per_sec`, the cost
reduction) plus the card's name and power limit.  `--cpu` runs it on the
CPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

REPS = 3


def problem_arrays(M: int, L: int, OPK: int, seed: int = 0) -> dict:
    """The reference tool's problem (tools/run_ba_bench.py), draw for draw:
    BAProblem's fields as numpy arrays."""
    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    for i in range(M):
        th = 2 * np.pi * i / M
        c, s = np.cos(th), np.sin(th)
        poses[i, :3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        poses[i, :3, 3] = [30000 * (1 - c), 30000 * s, 0]
    lms = rng.uniform(-60000, 60000, (L, 3)).astype(np.float32)

    obs_kf = np.repeat(np.arange(M, dtype=np.int32), OPK)
    obs_lm = rng.integers(0, L, M * OPK).astype(np.int32)
    Tinv = np.linalg.inv(poses)
    p_s = (np.einsum("oij,oj->oi", Tinv[obs_kf, :3, :3], lms[obs_lm])
           + Tinv[obs_kf, :3, 3])
    p_s += rng.normal(0, 10.0, p_s.shape)

    noisy_poses = poses.copy()
    noisy_poses[:, :3, 3] += rng.normal(0, 200.0, (M, 3))
    return dict(
        poses=noisy_poses,
        landmarks=lms + rng.normal(0, 300.0, (L, 3)).astype(np.float32),
        obs_kf=obs_kf, obs_lm=obs_lm, obs_p=p_s.astype(np.float32),
        obs_mask=np.ones(M * OPK, bool),
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--keyframes", type=int, default=64)
    ap.add_argument("--landmarks", type=int, default=4096)
    ap.add_argument("--obs-per-kf", type=int, default=512)
    ap.add_argument("--gn-iters", type=int, default=10)
    ap.add_argument("--cg-iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    import torch

    from bshot_slam_tpu_torch.backend.ba import BAProblem
    from bshot_slam_tpu_torch.device import card, resolve_device
    from bshot_slam_tpu_torch.odometry.graphs import Graphs
    from bshot_slam_tpu_torch.utils.profiling import fence

    device = resolve_device("cpu" if args.cpu else None)
    M, L, OPK = args.keyframes, args.landmarks, args.obs_per_kf
    prob = BAProblem(**{k: torch.as_tensor(v, device=device)
                        for k, v in problem_arrays(M, L, OPK).items()})

    graphs = Graphs(device)

    def solve():
        res = graphs.ba(prob, gn_iterations=args.gn_iters, cg_iterations=args.cg_iters)
        fence(res)
        return res

    res = solve()  # warm-up
    t0 = time.perf_counter()
    for _ in range(REPS):
        res = solve()
    dt = (time.perf_counter() - t0) / REPS
    reduction = float(res.initial_cost) / max(float(res.final_cost), 1e-9)
    print(json.dumps({
        "metric": "ba_gn_iters_per_sec",
        "value": round(args.gn_iters / dt, 2),
        "unit": "GN iters/s",
        "keyframes": M, "landmarks": L, "observations": M * OPK,
        "cg_iters_per_gn": args.cg_iters,
        "cost_reduction": round(reduction, 1),
        **card(device),
    }), flush=True)
    print(f"# platform={device.type}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    sys.exit(main())
