"""Frames the pipelined engine re-ran after an overflow, as a share of the window's frames (`SlamEngine.n_redispatched`)."""

from slambench import readers


def read(run):
    return run.n_redispatched / run.frames * 100.0 if run.frames else None
