"""Share of the profiled slice in which no operation ran on the device, %."""

from slambench import readers


def read(run):
    return readers.idle_pct(run)
