"""Kernels A, B and H: the least time of their work (`neighborhood.py`) as a share of their profiled device time, %."""

from slambench import neighborhood


def read(run):
    return neighborhood.roofline_pct(run)
