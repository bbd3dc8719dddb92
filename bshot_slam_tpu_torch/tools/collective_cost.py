#!/usr/bin/env python3
"""Collectives per frame of the sharded SLAM step, from the comm layer.

The port's counterpart of `tools/run_collective_cost.py`.  Where the
reference reads the collectives GSPMD put into a compiled TPU program, the
port calls each collective itself (`parallel.comm`), so this tool drives the
sharded engine over a synthetic drive on N local ranks and reads the
counters: per call site, the calls and the payload bytes one rank puts in,
per frame (the frames after the first), for both layouts:

  * ("data", "map")      — `sharded.make_mesh`, the single-host mesh;
  * ("hosts", "devices") — `multihost.host_mesh` with N/2 ranks per "host",
                           the map's rows across hosts.

    python3 bshot_slam_tpu_torch/tools/collective_cost.py [--ranks 4] [--cpu]
        [--full] [--frames 3] [--dist-backend gloo] [--out build/collectives_torch.json]

The ranks run on the card (rank r on card r modulo the cards; ranks that
share a card need `--dist-backend gloo`) or, with `--cpu`, on the CPU.  The
tiny configuration by default, `default_config()` with `--full`.  The bytes
are the logical payload (a ring all-reduce moves about twice that on the
wire).  On NCCL the engine replays its steps from CUDA graphs, whose
collectives the comm layer counts once per replay, as the eager step
counts them.  Writes one JSON object to `--out`.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]


def _rank(rank: int, layout_name: str, full: bool, frames: int) -> dict:
    import warnings

    import torch.distributed as dist

    from bshot_slam_tpu_torch.config import default_config, tiny_config
    from bshot_slam_tpu_torch.io import synthetic
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.parallel import comm, multihost, sharded

    cfg = default_config() if full else tiny_config()
    if layout_name == "data_map":
        mesh, axes = sharded.make_mesh(), ("data", "map")
    else:
        mesh = multihost.host_mesh(ranks_per_host=max(1, dist.get_world_size() // 2))
        axes = ("devices", "hosts")
    sweeps, _ = synthetic.render_sequence(frames, cfg.sensor, step_mm=400.0,
                                          noise_mm=20.0, seed=0,
                                          n_firings=cfg.sensor.n_azimuth)
    eng = SlamEngine(cfg, seed=0, mesh=mesh, data_axis=axes[0], map_axis=axes[1])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng.process_sweep(sweeps[0])
        comm.reset_counts()
        for sw in sweeps[1:]:
            eng.process_sweep(sw)
    n = len(sweeps) - 1
    sites = {k: dict(calls=v["calls"] / n, bytes=v["bytes"] / n,
                     syncs=v["syncs"] / n) for k, v in comm.counts().items()}
    return dict(mesh=dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)),
                axes=dict(data=axes[0], map=axes[1]),
                backend=dist.get_backend(), per_frame=sites,
                calls_per_frame=sum(v["calls"] for v in sites.values()),
                bytes_per_frame=sum(v["bytes"] for v in sites.values()),
                map_size=eng.records[-1].map_size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--frames", type=int, default=3,
                    help="synthetic frames (counted: all but the first)")
    ap.add_argument("--full", action="store_true", help="default_config()")
    ap.add_argument("--cpu", action="store_true", help="run the ranks on the CPU")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None)
    ap.add_argument("--out", default=str(REPO / "build" / "collectives_torch.json"))
    args = ap.parse_args(argv)
    if args.frames < 2:
        ap.error("--frames must be at least 2")

    from bshot_slam_tpu_torch.parallel import multihost

    device = "cpu" if args.cpu else "cuda"
    result = dict(ranks=args.ranks, device=device,
                  config="default" if args.full else "tiny",
                  frames_counted=args.frames - 1,
                  note="payload bytes one rank puts in per frame; a ring "
                       "all-reduce moves about twice that on the wire",
                  layouts={})
    for name in ("data_map", "hosts_devices"):
        out = multihost.spawn_local(_rank, args.ranks,
                                    args=(name, args.full, args.frames),
                                    backend=args.dist_backend, device=device,
                                    timeout=3600)
        result["layouts"][name] = out[0]
        print(json.dumps(dict(layout=name, mesh=out[0]["mesh"],
                              calls_per_frame=out[0]["calls_per_frame"],
                              bytes_per_frame=out[0]["bytes_per_frame"])))
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    print(f"-> {path}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
