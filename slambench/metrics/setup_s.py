"""Seconds from the process's start to the first timed frame (host clock)."""

from slambench import readers


def read(run):
    return run.setup_s
