"""What a traced run reads: host spans around the engine's calls into its
layers, and a profiled slice of the window.

`Spans` wraps, for the length of the window, the engine module's
`build_range_image` and `host_cloud` (host ingest), the shared graphs'
`step` (dispatch), and `SlamEngine._fetched` (the batched device-to-host
copy) and `_finalize` (records), so that every pass's engine is covered.  Only in a traced run does it time them (and
label them for the profiler); in every run it keeps the cloud
`host_cloud` returns for the frames the check compares.  `Slice` runs
`torch.profiler` over a fixed run of frames and reduces its events to a
summary (device busy time, launches, time by kernel, idle gaps by the
host span they fell in); no trace file is written.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

SPAN_NAMES = ("ingest", "dispatch", "fetch", "finalize")


@dataclasses.dataclass
class Run:
    """Everything a metric reader may read of one run."""

    cell: object
    frames: int
    window_s: float
    setup_s: float
    spans: dict
    n_redispatched: int
    captures_in_window: int
    profile: dict | None
    counts: dict | None = None


class Spans:
    """The window's wrappers of the engine's calls (see the module
    docstring); `durations` holds each wrapped call's host seconds."""

    def __init__(self, engine_mod, graphs, enabled: bool):
        self.engine_mod, self.graphs, self.enabled = engine_mod, graphs, enabled
        self.durations = collections.defaultdict(list)  # span -> seconds per call
        self.keep_next_cloud = False
        self.kept_cloud = None
        self._undo = []

    def _wrap(self, owner, attr: str, span: str | None, keep: bool = False):
        orig = getattr(owner, attr)
        timed = self.enabled and span is not None
        if timed:
            from torch.profiler import record_function

        def wrapper(*args, **kwargs):
            if timed:
                t = time.perf_counter()
                with record_function(span):
                    out = orig(*args, **kwargs)
                self.durations[span + "." + attr].append(time.perf_counter() - t)
            else:
                out = orig(*args, **kwargs)
            if keep and self.keep_next_cloud:
                self.keep_next_cloud = False
                self.kept_cloud = (out[0].copy(), int(out[1]))
            return out

        had = attr in vars(owner)
        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, orig, had))

    def install(self) -> None:
        m = self.engine_mod
        self._wrap(m, "host_cloud", "ingest", keep=True)
        if self.enabled:
            self._wrap(m, "build_range_image", "ingest")
            self._wrap(self.graphs, "step", "dispatch")
            self._wrap(m.SlamEngine, "_fetched", "fetch")
            self._wrap(m.SlamEngine, "_finalize", "finalize")

    def uninstall(self) -> None:
        while self._undo:
            owner, attr, orig, had = self._undo.pop()
            if had:
                setattr(owner, attr, orig)
            else:  # an instance's wrapper: the class's method shows again
                delattr(owner, attr)


class Slice:
    """The profiled frames [start, start + n) of a traced window."""

    def __init__(self, start: int, n: int, device, enabled: bool):
        self.start, self.n, self.device, self.enabled = start, n, device, enabled
        self.prof = None
        self.summary = None
        self.frames: list = []
        self._t = 0.0

    def before(self, k: int) -> None:
        if not self.enabled or k != self.start:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._t = time.perf_counter()

    def after(self, k: int) -> None:
        if self.prof is None or k != self.start + self.n:
            return
        self._stop(k)

    def _stop(self, k: int) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        host_s = time.perf_counter() - self._t
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        self.frames = list(range(self.start, k))
        self.summary = summarize(prof, len(self.frames), host_s)

    def close(self) -> None:
        """A window that ended inside the slice profiles what it reached."""
        if self.prof is not None:
            self._stop(self.start + self.n)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, n_frames: int, host_s: float) -> dict:
    """The slice's device events reduced: busy seconds (their union),
    launches, seconds by kernel name, and idle gaps between them summed by
    the host span (`SPAN_NAMES`) open when each gap began ("host" where
    none was)."""
    from torch.autograd import DeviceType

    dev, spans, cpu_lo, cpu_hi = [], [], None, None
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # a span's range as the device saw it is no operation of its own
            if e.name() not in SPAN_NAMES:
                dev.append((s, s + d, e.name()))
        else:
            cpu_lo = s if cpu_lo is None else min(cpu_lo, s)
            cpu_hi = s + d if cpu_hi is None else max(cpu_hi, s + d)
            if e.name() in SPAN_NAMES:
                spans.append((s, s + d, e.name()))
    if not dev:
        return None
    lo = min(cpu_lo if cpu_lo is not None else dev[0][0], min(s for s, _, _ in dev))
    hi = max(cpu_hi if cpu_hi is not None else 0, max(e for _, e, _ in dev))
    busy = _merge([(s, e) for s, e, _ in dev])
    busy_ns = sum(e - s for s, e in busy)
    by_kernel = collections.Counter()
    for s, e, name in dev:
        by_kernel[name] += (e - s) * 1e-9
    gaps = collections.Counter()
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    spans.sort()
    starts = [s for s, _, _ in spans]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        i = bisect.bisect_right(starts, g0) - 1  # the latest span begun by then
        open_ = i >= 0 and spans[i][1] >= g0
        gaps[spans[i][2] if open_ else "host"] += (g1 - g0) * 1e-9
    return {
        "frames": n_frames,
        "host_s": host_s,
        "window_s": (hi - lo) * 1e-9,
        "busy_s": busy_ns * 1e-9,
        "launches": len(dev),
        "device_s": sum(e - s for s, e, _ in dev) * 1e-9,
        "by_kernel": dict(by_kernel),
        "breakdown": {
            "device_ops": [[n, s] for n, s in by_kernel.most_common(10)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
        },
    }
