#!/usr/bin/env python3
"""The benchmark of bshot_slam_tpu_torch: one run of one cell on the card.

    python3 slambench/run.py --workload hdl32e.replay --seed 7 --seconds 20 --trace 0

Prints the set-up's parts, the window's summary and each number the
correctness check compared beside its limit on standard error, and as
the last line of standard output one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1`
`breakdown`, and `check` last.  Exits non-zero, printing no result,
without enough CUDA devices, without the port beside the benchmark, or
when a module of JAX or the JAX package is loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from slambench import host

    host.steady()
    # Build and kernel caches stay inside the checkout, at fixed paths (the
    # port's nvcc and g++ builds go to build/kernels and build/native).
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    from slambench import cell as cell_mod
    from slambench import harness

    age = harness.process_age_s() - (time.perf_counter() - T0)
    try:
        cell = cell_mod.load(args.workload)
        out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), T0,
                               age_s=age)
    except harness.NoDevice as e:
        print(f"slambench: {e}", file=sys.stderr)
        return 3
    except ImportError as e:
        print(f"slambench: the program is not beside the benchmark: {e}",
              file=sys.stderr)
        return 4
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
