"""Entry points of the port: one odometry step, and a multi-rank dry run.

The port's counterpart of the repository's root `__graft_entry__.py`:

    python -m bshot_slam_tpu_torch.graft_entry [--cpu]
    python -m bshot_slam_tpu_torch.graft_entry --dryrun N [--cpu] [--dist-backend gloo]

`entry()` is one full scan-to-map frame at the tiny configuration;
`dryrun_multichip(n)` runs two sharded steps (`parallel.sharded`) over n
ranks of a process group, each a process of its own, on the cards (rank r on
card r modulo the cards) or, with `--cpu`, on the CPU.  Ranks that share a
card need `--dist-backend gloo` (NCCL refuses a duplicate GPU).  On NCCL the
step is captured as a CUDA graph at its first call and replayed at its
second; the summary gives the captures (0 on gloo or the CPU).
"""

from __future__ import annotations

import argparse
import pathlib
import sys

import numpy as np

TILE = 256


def _example_inputs(cfg, device, seed: int = 0):
    import torch

    from bshot_slam_tpu_torch.odometry import pipeline

    rng = np.random.default_rng(seed)
    P = cfg.preprocess.max_points
    n = P // 2
    pts = np.zeros((P, 3), np.float32)
    pts[:n] = rng.uniform(-20000, 20000, (n, 3))
    pmask = np.zeros(P, bool)
    pmask[:n] = True
    state = pipeline.init_state(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    return (state, torch.from_numpy(pts).to(device),
            torch.from_numpy(pmask).to(device), gen)


def entry(device=None):
    """(fn, example_args): one full scan-to-map odometry frame (features ->
    match -> RANSAC -> gate -> ICP -> map insert) at the tiny configuration,
    on the card unless `device` says otherwise."""
    from bshot_slam_tpu_torch.config import tiny_config
    from bshot_slam_tpu_torch.device import resolve_device
    from bshot_slam_tpu_torch.odometry import pipeline

    cfg = tiny_config()
    dev = resolve_device(device)

    def fn(state, points, pmask, rng):
        return pipeline.odometry_step(state, points, pmask, rng, cfg, TILE)

    return fn, _example_inputs(cfg, dev)


def _dryrun_rank(rank: int) -> dict:
    from bshot_slam_tpu_torch.config import tiny_config
    from bshot_slam_tpu_torch.parallel import comm, sharded

    cfg = tiny_config()
    mesh = sharded.make_mesh()
    step, place = sharded.sharded_odometry_step(mesh, cfg, tile=TILE)
    state, pts, pmask, gen = _example_inputs(cfg, sharded.mesh_device(mesh))
    state = place(state)
    for _ in range(2):  # on NCCL the first captures, the second replays
        state, diag = step(state, pts, pmask, gen)
    return dict(mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                map_rows=state.map.positions.shape[0],
                map_size=int(diag.map_size), pose=diag.pose.cpu().numpy(),
                collectives=sum(c["calls"] for c in comm.counts().values()),
                captures=step.graphs.captures, graphed=not step.graphs.eager)


def dryrun_multichip(n_ranks: int, device: str = "cuda",
                     backend: str | None = None) -> list:
    """Two sharded odometry steps over n ranks ("data" x "map" mesh,
    `sharded.make_mesh`), each rank a spawned process; returns each rank's
    summary and raises when a rank fails, finds an empty map, or disagrees
    with rank 0 on the pose."""
    from bshot_slam_tpu_torch.parallel import multihost

    out = multihost.spawn_local(_dryrun_rank, n_ranks, backend=backend,
                                device=device, timeout=600)
    for r, o in enumerate(out):
        if o["map_size"] <= 0 or not np.array_equal(o["pose"], out[0]["pose"]):
            raise RuntimeError(f"rank {r}: map_size {o['map_size']}, pose "
                               f"{o['pose'].tolist()}")
    print(f"dryrun_multichip OK on {n_ranks} ranks ({device}): mesh "
          f"{out[0]['mesh']}, {out[0]['map_rows']} map rows per rank, "
          f"map_size={out[0]['map_size']}, {out[0]['collectives']} collectives, "
          f"graphed {out[0]['graphed']} ({out[0]['captures']} captures), "
          f"pose=\n{out[0]['pose']}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dryrun", type=int, default=0, metavar="N",
                    help="run dryrun_multichip over N ranks")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="process-group backend (default: nccl with a card "
                         "per rank, gloo on the CPU)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.dryrun:
        dryrun_multichip(args.dryrun, device, args.dist_backend)
        return 0
    fn, ex = entry(device)
    _, diag = fn(*ex)
    print(f"entry() OK on {ex[1].device}: map_size={int(diag.map_size)}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    sys.exit(main())
