#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, on the card.

    python3 slambench/control.py --workload hdl32e.replay --seconds 20 \
        --seeds 101 102 103 ...

For each seed, in one process: the cell's set-up (the step graphs
captured once and shared by the seeds), one window as a run makes it,
then the check twice: the program against the reference (the lower
reading of each number) and the control, the reference computed in the
nearest precision below the configuration's (the cloud in bfloat16, the
step's float32 products in TF32), put in the program's place (the upper
reading).  Prints one JSON line a seed and, last, each number's largest
program reading and smallest control reading.  The benchmark's runs do
not run it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(cell, seeds, seconds: float, device=None) -> dict:
    """{"program": [numbers a seed], "control": [...]} for the seeds."""
    from slambench import harness

    parts = harness.Parts(0.0, T0)
    device = harness.load_program(parts, device, cell.chips)
    graphs = None
    out = {"program": [], "control": []}
    quiet = lambda s: None  # noqa: E731
    for seed in seeds:
        b = harness.build(cell, seed, device, parts, graphs=graphs)
        graphs = b.graphs
        w = harness.window(b, seconds, trace=False)
        b.eng = None
        prog = harness.check(b, w, False, log=quiet)
        ctrl = harness.check(b, w, False, control=True, log=quiet)
        row = {"seed": seed, "frames": w["frames"], "checked": prog["frames"],
               "skipped": prog["skipped"],
               "program": prog["readings"], "control": ctrl["readings"],
               "program_frames": prog["per_frame"], "control_frames": ctrl["per_frame"]}
        print(json.dumps(row), flush=True)
        del row["program_frames"], row["control_frames"]
        out["program"].append(row["program"])
        out["control"].append(row["control"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from slambench import host

    host.steady()
    from slambench import cell as cell_mod

    r = readings(cell_mod.load(args.workload), args.seeds, args.seconds)
    names = r["program"][0].keys()
    print(json.dumps({"lower": {n: max(x[n] for x in r["program"]) for n in names},
                      "upper": {n: min(x[n] for x in r["control"]) for n in names}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
