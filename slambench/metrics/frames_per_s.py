"""Frames completed per second: every frame of the window, flush included, over all of its time (host clock)."""

from slambench import readers


def read(run):
    return readers.frames_per_s(run)
