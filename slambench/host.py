"""The run's own process made steady before anything heavy is imported.

The host libraries' thread pools (OpenMP, OpenBLAS, MKL) keep one thread:
their idle workers spin between calls (seven of them burned 2.2 CPU-s
each in a 20 s window on an 8-CPU H100 host, and the window's
host work is a single thread's).  The process is held on the last two of
the CPUs it may use, so that its threads stay where they started.
"""

import os

POOL_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def steady() -> None:
    for var in POOL_VARS:
        os.environ[var] = "1"
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpus[-2:])
