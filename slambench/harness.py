"""One run of a cell: set-up, the measured window, the check, the result.

Set-up renders the cell's drive on the device, prefills the map, runs one
warm lap of the cell's own drive (capturing the step graphs of the cloud
buckets the window hits), and builds a fresh engine that takes over those
graphs.  The window replays the log in passes of `laps_per_pass` laps,
each from the set-up's start (a fresh engine on the prefilled map and the
same RANSAC seed, taking over the graphs): back to back, each pass
flushed at its end, until `seconds` have passed at the end of a pass.  So
every pass does the same work, whatever the program's speed, and frames/s
is taken over all of it.  With `trace` a fixed slice of frames inside the
window runs under `torch.profiler` and spans time the engine's calls into
its layers (`trace.py`).  After the window the program's outputs for a
sample of frames are compared with the plain reference
(`reference/check.py`)."""

from __future__ import annotations

import math
import os
import sys
import time
import types

import numpy as np

from slambench import cell as cell_mod
from slambench import trace as trace_mod
from slambench import yardstick
from slambench.traffic import prefill as prefill_mod
from slambench.traffic import render

FORBIDDEN = ("jax", "jaxlib", "flax", "bshot_slam_tpu")


class NoDevice(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Top-level names in `sys.modules` that a run must not load, each
    compared whole (the port's own name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started (its start time from /proc), or 0
    where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


class Parts:
    """The set-up's parts, each timed from the end of the one before."""

    def __init__(self, age_s: float, t0: float):
        self.parts = [("interpreter", age_s)]
        self.t = t0

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.parts.append((name, now - self.t))
        self.t = now

    @property
    def total(self) -> float:
        return sum(s for _, s in self.parts)


def run_seeds(seed: int) -> dict:
    """Independent 63-bit seeds for each input a run draws: where in the
    lap the log starts, the prefill rows, the engine's RANSAC draws, and
    the frames the check samples."""
    ss = np.random.SeedSequence(seed % 2**64)
    start, prefill, engine, sample = (int(x) >> 1 for x in ss.generate_state(4, np.uint64))
    return {"start": start, "prefill": prefill, "engine": engine, "sample": sample}


def clone_state(x):
    """A copy of a (nested NamedTuple) state's tensors, queued on the
    current stream."""
    if isinstance(x, tuple):
        return type(x)(*[clone_state(v) for v in x])
    return x.clone()


def drive(cell: cell_mod.Cell, device, seeds: dict) -> list:
    """One lap of the cell's drive, cast on `device`, as the port's
    `LaserSweep`s, starting at the frame the run's seed picks.  The log is
    fixed by the traffic file (its range noise drawn from `noise_seed`), so
    every run replays the same sweeps, and so the same cloud sizes, in
    another order."""
    from bshot_slam_tpu_torch.io.velodyne import LaserSweep

    import torch

    cfgj, tr = cell.config, cell.traffic
    L = int(tr["frames_per_lap"])
    poses = render.circle_trajectory(L, tr["step_mm"],
                                     2 * math.pi * tr["turns_per_lap"] / L,
                                     cfgj["preprocess"]["sensor_height_mm"])
    sensor = cfgj["sensor"]
    gen = torch.Generator(device=device).manual_seed(int(tr["noise_seed"]))
    ticks = render.render_ticks(poses, sensor["vertical_angles_deg"], cfgj["n_firings"],
                                render.scene_boxes(**cfgj["scene"]),
                                sensor["distance_scale_mm"], tr["noise_mm"], gen, device)
    shared = render.sweep_arrays(sensor["n_rings"], cfgj["n_firings"])
    start = seeds["start"] % L
    return [LaserSweep(distance=ticks[(start + i) % L], timestamp_us=i, **shared)
            for i in range(L)]


def prefilled_map(cfg, rows: dict, device):
    """The port's empty map at full capacity with the prefill rows in
    front (`bench_torch._prefilled_map`'s layout)."""
    import torch

    from bshot_slam_tpu_torch.odometry import mapstore

    st = mapstore.init_map(cfg.map, cfg.map.capacity, device=device)
    n = rows["positions"].shape[0]

    def put(x, v):
        x = x.clone()
        x[:n] = v
        return x

    return st._replace(
        positions=put(st.positions, rows["positions"]),
        descriptors=put(st.descriptors, rows["descriptors"]),
        seg_ratios=put(st.seg_ratios, rows["seg_ratios"]),
        blocks=put(st.blocks, rows["blocks"]),
        valid=put(st.valid, torch.ones(n, dtype=torch.bool, device=device)),
        cursor=torch.tensor(n, dtype=torch.int32, device=device),
    )


def make_engine(cfg, cell, device, seeds, rows, graphs=None):
    """The cell's engine (the traffic file's `engine` keywords) on the
    prefilled map; `graphs`: an earlier engine's graphs to take over."""
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine

    kw = dict(cell.traffic["engine"])
    if graphs is not None:
        kw["graphs"] = graphs
    eng = SlamEngine(cfg, seed=seeds["engine"], device=device, **kw)
    eng.state = eng.state._replace(map=prefilled_map(cfg, rows, device))
    eng._place_state()  # as a resume does: the engine re-derives its cursor bound
    return eng


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def pass_frames(cell: cell_mod.Cell, lap: int) -> int:
    """Frames of one pass of the window: `laps_per_pass` laps of `lap`
    frames."""
    return lap * int(cell.traffic["laps_per_pass"])


def keep_mask(n_max: int, chain: int, p: float, seed: int) -> np.ndarray:
    """Frames whose state and cloud are kept for the check: the first
    `chain`, then each later frame with probability `p`."""
    rng = np.random.default_rng(seed)
    keep = rng.random(n_max) < p
    keep[:chain] = True
    return keep


def load_program(parts: Parts, device, chips: int):
    """Import the port, take the device (the card unless `device` is given:
    `NoDevice` without enough cards) and load the kernel and native
    libraries from the build cache in the checkout (built on a first run)."""
    import torch

    import bshot_slam_tpu_torch  # noqa: F401  (the port, and its precision settings)
    from bshot_slam_tpu_torch.io import native_decoder

    parts.mark("import")
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f"the cell needs {chips} CUDA device(s); cuda "
                           f"available: {torch.cuda.is_available()}, count: "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        torch.cuda.init()
        torch.zeros(1, device=device)
        _sync(device)
    device = torch.device(device)
    parts.mark("cuda_init")
    if device.type == "cuda":
        from bshot_slam_tpu_torch import kernels

        kernels.build_all()
    native_decoder.is_available()
    parts.mark("library_load")
    return device


def build(cell: cell_mod.Cell, seed: int, device, parts: Parts, graphs=None):
    """Render the drive, prefill, run the warm lap (capturing the step
    graphs its buckets need, into `graphs` when given) and make the
    window's fresh engine on those graphs."""
    import torch

    cfg = cell_mod.slam_config(cell.config)
    seeds = run_seeds(seed)
    sweeps = drive(cell, device, seeds)
    parts.mark("render")
    gen = torch.Generator(device=device).manual_seed(seeds["prefill"])
    rows = prefill_mod.prefill_rows(cell.traffic["prefill_rows"], cfg.map.snap_mm,
                                    cfg.map.block_size_mm, cfg.descriptor.n_words,
                                    gen, device)
    _sync(device)
    parts.mark("prefill")
    warm = make_engine(cfg, cell, device, seeds, rows, graphs)
    graphs = warm.graphs
    c0, s0 = graphs.captures, graphs.capture_s
    tw = time.perf_counter()
    for sw in sweeps:
        warm.process_sweep(sw)
    if warm.pipelined:
        warm.flush()
    _sync(device)
    warm_s = time.perf_counter() - tw
    del warm
    parts.mark("warm_lap")
    eng = make_engine(cfg, cell, device, seeds, rows, graphs=graphs)
    _sync(device)
    parts.mark("engine")
    return types.SimpleNamespace(cell=cell, cfg=cfg, seeds=seeds, sweeps=sweeps, rows=rows,
                 eng=eng, graphs=graphs, device=device, warm_s=warm_s,
                 captures=graphs.captures - c0, capture_s=graphs.capture_s - s0)


def window(b, seconds: float, trace: bool) -> dict:
    """Replay the log in passes of `laps_per_pass` laps, each on a fresh
    engine from the set-up's start, until `seconds` have passed at the end
    of a pass; keep the state around and the cloud of the frames the check
    compares; with `trace` time the layers' spans and profile the cell's
    slice of frames."""
    import torch

    from bshot_slam_tpu_torch.odometry import engine as engine_mod

    tr, eng, device, L = b.cell.traffic, b.eng, b.device, len(b.sweeps)
    D = pass_frames(b.cell, L)
    rate = L / max(b.warm_s - b.capture_s, 1e-3)
    n_max = int((seconds + 4 * b.warm_s) * max(rate, 1.0) * 4)
    p = min(1.0, 2.0 * int(tr["check_sampled"]) / max(1.0, seconds * rate))
    keep = keep_mask(n_max, int(tr["check_chain"]), p, b.seeds["sample"])
    if trace:  # the map the profiled frames search: its window rows are counted
        keep[int(tr["profile_start"])] = True
    spans = trace_mod.Spans(engine_mod, b.graphs, enabled=trace)
    prof = trace_mod.Slice(int(tr["profile_start"]), int(tr["profile_frames"]),
                           device, enabled=trace)
    snaps: dict = {}
    records, passes = [], []
    n_redispatched = 0
    captures0 = b.graphs.captures
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    k = 0
    spans.install()
    try:
        tstart = time.perf_counter()
        passes.append(tstart)
        while True:
            prof.before(k)
            kept = k < n_max and keep[k]
            if kept:
                before = clone_state(eng.state)
                spans.keep_next_cloud = True
            eng.process_sweep(b.sweeps[k % L])
            if kept:
                snaps[k] = (before, clone_state(eng.state), spans.kept_cloud)
                spans.kept_cloud = None
            k += 1
            prof.after(k)
            if k % D == 0:
                if eng.pipelined:
                    eng.flush()
                records += eng.records
                n_redispatched += eng.n_redispatched
                te = time.perf_counter()
                passes.append(te)
                if te - tstart >= seconds:
                    break
                eng = make_engine(b.cfg, b.cell, device, b.seeds, b.rows, graphs=b.graphs)
        _sync(device)
        window_s = time.perf_counter() - tstart
    finally:
        spans.uninstall()
        prof.close()
    return {"frames": k, "window_s": window_s,
            "pass_s": [b1 - b0 for b0, b1 in zip(passes, passes[1:])],
            "snaps": snaps, "records": records, "spans": spans.durations,
            "n_redispatched": n_redispatched,
            "captures_in_window": b.graphs.captures - captures0,
            "profile": prof.summary, "profiled": prof.frames,
            "peak": (torch.cuda.max_memory_allocated(device)
                     if device.type == "cuda" else 0)}


def checked_frames(b, w: dict, trace: bool) -> list:
    """The chain's frames and, drawn from the seed, `check_sampled` of the
    later frames kept in the window."""
    tr = b.cell.traffic
    chain = [i for i in sorted(w["snaps"]) if i < int(tr["check_chain"])]
    later = [i for i in sorted(w["snaps"]) if i >= int(tr["check_chain"])
             and not (trace and i == int(tr["profile_start"]))]
    n = int(tr["check_sampled"])
    if len(later) > n:
        rng = np.random.default_rng(b.seeds["sample"] + 1)
        later = sorted(rng.choice(later, n, replace=False).tolist())
    return chain + later


def check(b, w: dict, trace: bool, control: bool = False, log=print) -> dict:
    from slambench.reference import check as check_mod

    frames = checked_frames(b, w, trace)
    pstart = int(b.cell.traffic["profile_start"])
    out = check_mod.check(
        b.cell.config, b.sweeps, b.rows, {i: w["snaps"][i] for i in frames},
        w["records"], b.seeds["engine"], b.device, b.cell.limits,
        pass_frames=pass_frames(b.cell, len(b.sweeps)), profiled=w["profiled"],
        profile_state=w["snaps"][pstart][0] if pstart in w["snaps"] else None,
        control=control, log=log)
    out["frames"] = frames
    return out


def run_cell(cell: cell_mod.Cell, seed: int, seconds: float, trace: bool,
             t0: float, age_s: float = 0.0, device=None, log=None) -> dict:
    """One run; returns the result (the keys of the result line, `check`
    last).  `device=None` takes the card and raises `NoDevice` without
    enough of them; tests pass a CPU device."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    parts = Parts(age_s, t0)
    device = load_program(parts, device, cell.chips)
    b = build(cell, seed, device, parts)
    setup_s = parts.total
    log("# setup: " + ", ".join(f"{n} {s:.4f} s" for n, s in parts.parts)
        + f" | sum {setup_s:.4f} s = setup_s; warm lap {len(b.sweeps)} frames "
          f"with {b.captures} captures ({b.capture_s:.4f} s)")
    w = window(b, seconds, trace)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules loaded that a run must not load: {found}")
    import torch

    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if device.type == "cuda"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(w["peak"])}
    prof = w["profile"]
    if trace and prof is not None:
        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
    # The program's state goes before the reference runs.
    b.eng = b.graphs = None
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result = check(b, w, trace, log=log)
    if result["skipped"]:
        log(f"# frames re-run after an overflow, not compared: {result['skipped']}")
    counts = result["_counts"]
    if counts:
        least = yardstick.least_seconds(counts["frames"])
        log(f"# kernels A-E over the profiled frames: least time "
            f"{sum(least['per_kernel'].values()):.6f} s, bound by bytes "
            f"{least['by']['bytes']:.6f} s and by operations "
            f"{least['by']['operations']:.6f} s; window rows {counts['window_rows']}")
    run = trace_mod.Run(
        cell=cell, frames=w["frames"], window_s=w["window_s"],
        setup_s=setup_s, spans=w["spans"],
        n_redispatched=w["n_redispatched"],
        captures_in_window=w["captures_in_window"], profile=prof,
        counts=counts)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell_mod.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {
        "correct": bool(result["correct"]),
        "attempted": w["frames"],
        "failed": w["frames"] - len(w["records"]),
        "metrics": metrics,
        "device": device_info,
    }
    if trace and prof is not None:
        out["breakdown"] = prof["breakdown"]
    recs = w["records"]
    log(f"# window: {w['frames']} frames in {w['window_s']:.4f} s, records "
        f"{len(recs)}, redispatched {w['n_redispatched']}, captures in window "
        f"{w['captures_in_window']}, final map {recs[-1].map_size if recs else 0} "
        f"rows, checked frames {result['frames']}, passes (s) "
        f"{[round(x, 4) for x in w['pass_s']]}")
    for name, (value, limit) in result["numbers"].items():
        log(f"check {name} {value!r} limit {limit!r} "
            f"{'ok' if value <= limit else 'FAILS'}")
    out["check"] = {name: {"value": v, "limit": lim}
                    for name, (v, lim) in result["numbers"].items()}
    return out
