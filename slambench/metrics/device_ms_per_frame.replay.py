"""Device ms a frame in the profiled slice (the profiler's device events summed)."""

from slambench import readers


def read(run):
    return readers.profiled(run, "device_s", scale=1e3)
