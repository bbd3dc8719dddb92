"""Device operations (kernels, copies, fills) a frame in the profiled slice."""

from slambench import readers


def read(run):
    return readers.profiled(run, "launches")
