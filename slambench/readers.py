"""Reductions the metric readers under `metrics/` share.  Each returns
None where its run holds nothing to read (a reader then reports nothing)."""

from __future__ import annotations

from slambench import yardstick


def frames_per_s(run):
    """Every frame of the window, flush included, over all of its time."""
    return run.frames / run.window_s if run.frames else None


def span_ms_per_frame(run, span: str):
    """Host ms a frame spends in the calls labelled `span` (every call of
    every wrapped function of that label), over the window's frames."""
    calls = [s for key, ds in run.spans.items() if key.split(".")[0] == span
             for s in ds]
    if not calls or not run.frames:
        return None
    return sum(calls) / run.frames * 1e3


def profiled(run, key: str, scale: float = 1.0):
    """The profiled slice's `key` a frame, times `scale`."""
    p = run.profile
    if p is None or not p["frames"]:
        return None
    return p[key] / p["frames"] * scale


def idle_pct(run):
    p = run.profile
    if p is None or p["window_s"] <= 0:
        return None
    return (1.0 - p["busy_s"] / p["window_s"]) * 100.0


def kernel_seconds(run) -> dict:
    """Profiled device seconds of the port's kernels A-F by letter."""
    out = {}
    for name, s in (run.profile or {}).get("by_kernel", {}).items():
        k = yardstick.kernel_of(name)
        if k is not None:
            out[k] = out.get(k, 0.0) + s
    return out


def kernels_ms_per_frame(run):
    ks = kernel_seconds(run)
    if not ks:
        return None
    return sum(ks.values()) / run.profile["frames"] * 1e3


def kernels_roofline_pct(run):
    """The least time of kernels A-E's work over the profiled frames (the
    reference side's counts) as a share of their profiled device time."""
    ks = kernel_seconds(run)
    counts = run.counts
    spent = sum(s for k, s in ks.items() if k in "ABCDE")
    if not counts or spent <= 0:
        return None
    least = yardstick.least_seconds(counts["frames"])
    return sum(least["per_kernel"].values()) / spent * 100.0
