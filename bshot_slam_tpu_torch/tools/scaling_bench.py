#!/usr/bin/env python3
"""Strong scaling of the sharded SLAM step and the sharded bundle adjustment.

The port's counterpart of `tools/run_scaling_bench.py`: the same fixed-size
problem over 1..N ranks of a process group (each rank a spawned process),
and the reference's efficiency formula

    efficiency(N) = T(n0) * n0 / (N * T(N)),  n0 the smallest rank count.

    python3 bshot_slam_tpu_torch/tools/scaling_bench.py [--ranks 1,2,4]
        [--mode step|ba|both] [--repeats 5] [--cpu] [--dist-backend gloo]

The ranks run on the cards (rank r on card r modulo the cards) or, with
`--cpu`, on the CPU.  Ranks that share one card (they need
`--dist-backend gloo`) or one CPU measure the sharded program's overhead,
not a speedup: the efficiency means scaling only with a card per rank.
On NCCL the step and the solve replay CUDA graphs captured at their
warm-up call (`captures`); on gloo they run eagerly.  Prints one JSON line
per (bench, rank count).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _step_rank(rank: int, repeats: int) -> tuple:
    import numpy as np
    import torch

    from bshot_slam_tpu_torch.config import tiny_config
    from bshot_slam_tpu_torch.odometry import pipeline
    from bshot_slam_tpu_torch.parallel import sharded

    cfg = tiny_config()
    mesh = sharded.make_mesh()
    dev = sharded.mesh_device(mesh)
    step, place = sharded.sharded_odometry_step(mesh, cfg, tile=256)
    rng = np.random.default_rng(0)
    P = cfg.preprocess.max_points
    pts = np.zeros((P, 3), np.float32)
    pts[:P // 2] = rng.uniform(-20000, 20000, (P // 2, 3))
    pts_t = torch.from_numpy(pts).to(dev)
    pmask = (torch.arange(P) < P // 2).to(dev)
    state = place(pipeline.init_state(cfg, device="cpu"))
    gen = torch.Generator(device=dev).manual_seed(0)
    state, _ = step(state, pts_t, pmask, gen)  # first use: builds, captures
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        state, _ = step(state, pts_t, pmask, gen)
    _sync(dev)
    return (time.perf_counter() - t0) / repeats, step.graphs.captures


def _ba_rank(rank: int, repeats: int) -> tuple:
    import numpy as np
    import torch

    from bshot_slam_tpu_torch.backend.ba import BAProblem
    from bshot_slam_tpu_torch.parallel import sharded

    mesh = sharded.make_mesh()
    dev = sharded.mesh_device(mesh)
    rng = np.random.default_rng(0)
    M, L, OPK = 32, 2048, 256
    poses = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    poses[:, :3, 3] = rng.uniform(-5000, 5000, (M, 3))
    lms = rng.uniform(-30000, 30000, (L, 3)).astype(np.float32)
    obs_kf = np.repeat(np.arange(M, dtype=np.int32), OPK)
    obs_lm = rng.integers(0, L, M * OPK).astype(np.int32)
    obs_p = (lms[obs_lm] - poses[obs_kf][:, :3, 3]
             + rng.normal(0, 20, (M * OPK, 3))).astype(np.float32)
    prob = BAProblem(*[torch.from_numpy(a).to(dev) for a in (
        poses, lms, obs_kf, obs_lm, obs_p, np.ones(M * OPK, bool))])
    res = sharded.sharded_ba_solve(mesh, prob, gn_iterations=3)  # captures
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(repeats):
        res = sharded.sharded_ba_solve(mesh, prob, gn_iterations=3)
    _sync(dev)
    del res
    return (time.perf_counter() - t0) / repeats, sharded.ba_graphs(mesh).captures


def report(name: str, times: dict, captures: dict, device: str) -> None:
    n0 = min(times)
    for n, t in sorted(times.items()):
        print(json.dumps({"bench": name, "ranks": n, "device": device,
                          "sec_per_iter": t,
                          "efficiency_vs_smallest": times[n0] * n0 / (n * t),
                          "captures": captures[n]}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--mode", choices=["step", "ba", "both"], default="both")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None)
    args = ap.parse_args(argv)

    import torch

    from bshot_slam_tpu_torch.parallel import multihost

    device = "cpu" if args.cpu else "cuda"
    sizes = [int(s) for s in args.ranks.split(",")]
    cards = 0 if args.cpu else torch.cuda.device_count()
    if max(sizes) > max(cards, 1) or args.cpu:
        print(f"# ranks share {'the CPU' if args.cpu else f'{cards} card(s)'}: "
              "these times measure the sharded program's overhead, not a "
              "speedup", file=sys.stderr)
    benches = {"step": _step_rank, "ba": _ba_rank}
    for name in (["step", "ba"] if args.mode == "both" else [args.mode]):
        times, captures = {}, {}
        for n in sizes:
            out = multihost.spawn_local(benches[name], n, args=(args.repeats,),
                                        backend=args.dist_backend, device=device,
                                        timeout=3600)
            times[n], captures[n] = max(t for t, _ in out), out[0][1]
        report(f"sharded_{'odometry_step' if name == 'step' else 'ba_solve'}",
               times, captures, device)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
