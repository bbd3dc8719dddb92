"""Device ms a frame of the port's own CUDA kernels A-F in the profiled slice, by name."""

from slambench import readers


def read(run):
    return readers.kernels_ms_per_frame(run)
