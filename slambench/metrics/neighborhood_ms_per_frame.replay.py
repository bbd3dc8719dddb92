"""Device ms a frame of kernels A, B and H (both forms) in the profiled slice, by name."""

from slambench import neighborhood


def read(run):
    return neighborhood.ms_per_frame(run)
