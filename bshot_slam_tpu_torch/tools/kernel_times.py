#!/usr/bin/env python3
"""Time the port's CUDA kernels from several copies of the package in turn.

    python3 bshot_slam_tpu_torch/tools/kernel_times.py \\
        --root build/parent --root . --root . --root build/parent [--engine]

Each `--root` is a directory that holds a `bshot_slam_tpu_torch` package
(this checkout, or another commit unpacked with
`git archive <commit> | tar -x -C build/parent`).  The roots are measured
one after the other on the same card, each in a process of its own that
builds its kernels into `<root>/build/kernels`; to compare two versions
name them in the order parent, change, change, parent.

Per root and kernel, at the shapes of `chip_smoke.py` phases [3] and [7]
(kernel F on the drive's fourth frame) and with its functions: exactness against the plain version, the median of 25
CUDA-event timings, the device-only time and the device launches per call
from `torch.profiler`, and the host's microseconds per wrapper call.
With `--engine`, also the 24-frame engine run of phase [4] (frames/s, ATE,
final map size) and its profiled pass (the port's kernels per frame).
Prints one JSON line per root and a table, and writes the results to
`--out` (default `build/kernel_times.json`).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]
ROW_KEYS = ("name", "int_mismatch", "float_out_of_tol", "card_plain_rows_differ",
            "ms", "device_ms", "device_launches_per_call", "host_us_per_call",
            "plain_ms", "bound_ms")


def load_smoke():
    """This checkout's chip_smoke.py, whatever package is on the path."""
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure_root(root: str, engine: bool) -> dict:
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import torch

    cs = load_smoke()
    from bshot_slam_tpu_torch import default_config
    from bshot_slam_tpu_torch.device import card_line
    from bshot_slam_tpu_torch.kernels import build_all

    cfg = default_config()
    dev = torch.device("cuda")
    out = {"root": root, "card": card_line(), "build_s": build_all()}
    cs.N_FRAMES = 24 if engine else 4
    sweeps, gt = cs.render_drive(cfg)
    points, nv = cs.frame_cloud(cfg, sweeps[3])
    rows = (cs.check_neighborhood(cfg, points, nv, dev) + cs.check_mapops(cfg, dev)
            + [cs.walk_row(cfg, sweeps[3], dev)])
    out["kernels"] = [{k: r[k] for k in ROW_KEYS} for r in rows]
    if engine:
        res, _ = cs.run_engine(cfg, sweeps, gt, dev)
        out["engine"] = {k: res[k] for k in ("fps", "ate_mm", "map_size", "launches")}
        out["engine"]["own_per_frame"] = cs.profile_engine(cfg, sweeps, dev)[3]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", action="append", default=[],
                    help="directory holding a bshot_slam_tpu_torch package")
    ap.add_argument("--engine", action="store_true",
                    help="also run the 24-frame engine of chip_smoke phase [4]")
    ap.add_argument("--out", default=str(REPO / "build" / "kernel_times.json"),
                    help="file the results are written to, as JSON")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(measure_root(args.one, args.engine)), flush=True)
        return 0
    results = []
    for root in args.root or ["."]:
        cmd = [sys.executable, __file__, "--one", root] + ["--engine"] * args.engine
        done = subprocess.run(cmd, capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout[-2000:], done.stderr[-4000:], file=sys.stderr)
            return 1
        line = done.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        results.append(json.loads(line))
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"{'root':<22}{'kernel':<26}{'event ms':>10}{'device ms':>11}"
          f"{'launches':>9}{'host us':>9}{'exact':>7}")
    for res in results:
        for k in res["kernels"]:
            exact = not (k["int_mismatch"] or k["float_out_of_tol"]
                         or k["card_plain_rows_differ"])
            print(f"{res['root']:<22}{k['name']:<26}{k['ms']:>10.4f}"
                  f"{k['device_ms']:>11.4f}{k['device_launches_per_call']:>9.1f}"
                  f"{k['host_us_per_call']:>9.1f}{str(exact):>7}")
        if "engine" in res:
            e = res["engine"]
            print(f"{res['root']:<22}engine {e['fps']:.3f} frames/s, ATE "
                  f"{e['ate_mm']:.1f} mm, map {e['map_size']}; per frame: "
                  + "; ".join(f"{k} {ms:.4f} ms x{c:.0f}" for k, ms, c in e["own_per_frame"]))
    print(results[0]["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
