"""Kernels A-E: the least time of their work (`yardstick.py`) as a share of their profiled device time, %."""

from slambench import readers


def read(run):
    return readers.kernels_roofline_pct(run)
