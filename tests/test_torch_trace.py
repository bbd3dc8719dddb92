"""The port's own record of where its time goes (`utils.profiling.RECORDER`)
in the engine and its graphs.

On the CPU: a pipelined drive of three laps over a tiny config, once with
the recorder off and once on.  Off, it records nothing, its calls return
the shared no-op and allocate nothing; on, the records are the same bit
for bit, every frame has its root, ingest and dispatch spans and is
finalized once under a drain, children nest in their parents, self time is
the duration less the children's, one fetch wait is counted per
`fetch_every` frames, the host ingest counts each frame's cloud once (kept
points, bucket, none truncated), and there are no device marks
(`frame_stats` then gives no device numbers).  `frame_stats` reads known values from
hand-built records.  Under an active `torch.profiler` each span is
also a `record_function` range.  On the card (marker `cuda`): marks are read
without a synchronise of their own, from a pool of events sized to the
frames in flight, and each capture is a `slam.capture` span under its key.
This file imports no JAX: the card's machine has none.
"""

import collections
import tracemalloc

import numpy as np
import pytest
import torch

from bshot_slam_tpu_torch import tiny_config
from bshot_slam_tpu_torch.io import synthetic
from bshot_slam_tpu_torch.odometry.engine import SlamEngine, pick_bucket
from bshot_slam_tpu_torch.utils import profiling
from bshot_slam_tpu_torch.utils.profiling import RECORDER

FETCH_EVERY = 3
LAP = 4


@pytest.fixture(autouse=True)
def _recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    RECORDER.disable()
    RECORDER.clear()
    yield
    RECORDER.disable()
    RECORDER.clear()


def _drive(device, on: bool, laps: int = 3, waits=None):
    """(engine, records, events made) of a pipelined drive of `laps` laps of
    LAP sweeps, with the recorder on or off; `waits` is cleared once the
    recorder is on."""
    cfg = tiny_config()
    sweeps, _ = synthetic.render_sequence(LAP, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                          seed=0, n_firings=cfg.sensor.n_azimuth)
    if on:
        RECORDER.enable(device)
    if waits is not None:
        waits.clear()
    eng = SlamEngine(cfg, seed=0, device=device, tile=cfg.runtime.point_tile,
                     pipelined=True, fetch_every=FETCH_EVERY)
    for sw in sweeps * laps:
        eng.process_sweep(sw)
    eng.flush()
    RECORDER.disable()
    records, made = RECORDER.records(), RECORDER.events_made
    RECORDER.clear()
    return eng, records, made


@pytest.fixture(scope="module")
def drives():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        off = _drive("cpu", on=False)[:2]
        on = _drive("cpu", on=True)[:2]
    finally:
        RECORDER.disable()
        RECORDER.clear()
        torch.set_num_threads(n)
    return off, on


def _record_bits(eng):
    return [(r.pose.tobytes(), r.n_inliers, r.n_mutual, r.gated, r.map_size,
             np.float64(r.icp_rmse).tobytes(), r.corr_stats.tobytes(), r.n_dropped)
            for r in eng.records]


def test_off_records_nothing_and_on_changes_no_record(drives):
    (eng_off, rec_off), (eng_on, rec_on) = drives
    assert rec_off == {"spans": [], "counts": [], "marks": []}
    assert len(eng_off.records) == 3 * LAP
    assert _record_bits(eng_off) == _record_bits(eng_on)


def test_off_calls_return_the_noop_and_allocate_nothing():
    def calls(n):
        for _ in range(n):
            with RECORDER.span("slam.x", None):
                RECORDER.count("host_syncs.fetch")
                RECORDER.device_mark("frame_start", None)
            RECORDER.read_marks()

    assert RECORDER.span("slam.x") is profiling.NOOP
    calls(10)
    tracemalloc.start()
    try:
        growth = []
        for n in (100, 10000):
            tracemalloc.reset_peak()
            base = tracemalloc.get_traced_memory()[0]
            calls(n)
            current, peak = tracemalloc.get_traced_memory()
            growth.append((current - base, peak - base))
    finally:
        tracemalloc.stop()
    # nothing kept, and no allocation that grows with the calls
    assert all(kept <= 0 for kept, _ in growth)
    assert growth[1][1] <= max(growth[0][1], 512)
    assert RECORDER.records() == {"spans": [], "counts": [], "marks": []}
    assert RECORDER.events_made == 0


def _frames_of(records):
    return sorted({s["frame"] for s in records["spans"] if s["name"] == "slam.frame"})


def test_every_frame_has_its_spans_and_is_finalized_once_under_a_drain(drives):
    (_, _), (eng, rec) = drives
    spans = rec["spans"]
    frames = _frames_of(rec)
    assert frames == [(eng.serial, i) for i in range(3 * LAP)]
    by = collections.Counter((s["name"], s["frame"]) for s in spans)
    for f in frames:
        for name in ("slam.frame", "slam.ingest", "slam.range_image", "slam.extract",
                     "slam.dispatch", "slam.replay", "slam.finalize"):
            assert by[name, f] == 1, (name, f)
    for s in spans:
        if s["name"] == "slam.finalize":
            drain = spans[s["parent"]]
            assert drain["name"] == "slam.drain" and drain["frame"][0] == eng.serial
        if s["name"] == "slam.frame":
            assert s["parent"] == -1
        if s["name"] in ("slam.ingest", "slam.dispatch"):
            assert spans[s["parent"]]["name"] == "slam.frame"
            assert spans[s["parent"]]["frame"] == s["frame"]
        if s["name"] == "slam.replay":
            assert spans[s["parent"]]["name"] == "slam.dispatch"
        if s["name"] == "slam.fetch_wait":
            assert spans[s["parent"]]["name"] == "slam.drain"
    # the finalize under a drain names the frame it finalizes, in order
    finalized = [s["frame"] for s in spans if s["name"] == "slam.finalize"]
    assert finalized == frames


def test_children_nest_and_self_time_is_duration_less_children(drives):
    (_, _), (_, rec) = drives
    spans = rec["spans"]
    children = collections.defaultdict(int)
    for s in spans:
        assert s["end_ns"] is not None and s["end_ns"] >= s["start_ns"]
        if s["parent"] >= 0:
            p = spans[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"]
            children[s["parent"]] += s["end_ns"] - s["start_ns"]
    for i, s in enumerate(spans):
        assert s["self_ns"] == s["end_ns"] - s["start_ns"] - children[i] >= 0


def test_one_fetch_wait_per_fetch_every_frames(drives):
    (_, _), (eng, rec) = drives
    syncs = collections.Counter()
    for c in rec["counts"]:
        if c["name"].startswith("host_syncs."):
            syncs[c["name"]] += c["n"]
    assert syncs["host_syncs.fetch"] == 3 * LAP // FETCH_EVERY
    # the only other wait: the cursor read of the first frame's map check
    assert set(syncs) == {"host_syncs.fetch", "host_syncs.cursor"}
    assert syncs["host_syncs.cursor"] == 1
    waits = [s for s in rec["spans"] if s["name"] == "slam.fetch_wait"]
    assert len(waits) == syncs["host_syncs.fetch"]


def test_host_ingest_counts_each_frames_cloud_once(drives):
    """`cloud.rows`, `cloud.bucket_rows` and `cloud.truncated_rows` once a
    frame, under its id: the kept points, the bucket the step runs at (the
    smallest holding them) and none cut below the cap."""
    (_, _), (eng, rec) = drives
    frames = _frames_of(rec)
    by = collections.defaultdict(dict)
    for c in rec["counts"]:
        if c["name"].startswith("cloud."):
            assert c["name"] not in by[c["frame"]]
            by[c["frame"]][c["name"]] = c["n"]
    assert sorted(by) == frames
    cfg = tiny_config()
    for f in frames:
        n = by[f]
        assert n["cloud.bucket_rows"] == pick_bucket(n["cloud.rows"], cfg)
        assert 0 < n["cloud.rows"] < cfg.preprocess.max_points
        assert n["cloud.truncated_rows"] == 0
    stats = profiling.frame_stats(rec, {eng.serial})
    rows = sum(by[f]["cloud.rows"] for f in frames)
    buckets = sum(by[f]["cloud.bucket_rows"] for f in frames)
    assert stats["padded_pct"] == pytest.approx(100.0 * (1 - rows / buckets))
    assert stats["truncated_frames"] == 0
    assert stats["cloud_counts"] == {"cloud.rows": rows, "cloud.bucket_rows": buckets,
                                     "cloud.truncated_rows": 0}


def test_no_device_marks_on_the_cpu_and_device_stats_read_nothing(drives):
    (_, _), (eng, rec) = drives
    assert rec["marks"] == []
    stats = profiling.frame_stats(rec, {eng.serial})
    assert stats["frames"] == 3 * LAP
    assert stats["step_device_ms"] is None and stats["device_gap_pct"] is None
    assert stats["fetch_wait_ms"] > 0 and stats["dispatch_ms"] > 0
    assert stats["syncs_per_frame"] == pytest.approx(5 / (3 * LAP))
    assert profiling.frame_stats(rec, {eng.serial + 1}) is None


MS = 1_000_000  # ns


def _spans(rows):
    """Span records from (key, name, start ms, end ms, parent key, frame),
    ordered by start (a parent before its children), parents as indices."""
    rows = sorted(rows, key=lambda r: r[2])
    index = {r[0]: i for i, r in enumerate(rows)}
    return [{"name": name, "start_ns": int(s * MS), "end_ns": int(e * MS),
             "parent": index[p] if p is not None else -1, "frame": f, "attrs": None,
             "self_ns": None}
            for _, name, s, e, p, f in rows]


def _engine(serial: int, t0: float, step_ms: float, slow: float = 0.0):
    """One engine's records: four frames, frame i's marks at t0 + 10 i and
    + step_ms; its host spans from 2 ms before; frame 3's dispatch drains
    (3 ms, a 1 ms fetch wait); the flush drains with an 8 ms fetch wait.
    `slow` ms more in frame 0's dispatch and the flush's wait, and as many
    more syncs."""
    rows, marks = [], []
    for i in range(4):
        f, b = (serial, i), t0 + 10 * i
        k = f"{serial}.{i}"
        end = b + 4.5 if i == 3 else b + 1 + (slow if i == 0 else 0.0)
        rows += [(k + "f", "slam.frame", b - 2, end, None, f),
                 (k + "i", "slam.ingest", b - 2, b - 0.5, k + "f", f),
                 (k + "d", "slam.dispatch", b - 0.5, end, k + "f", f),
                 (k + "r", "slam.replay", b, b + 0.5, k + "d", f)]
        marks += [{"name": "frame_start", "frame": f, "t_ns": int(b * MS)},
                  {"name": "step_start", "frame": f, "t_ns": int((b + 0.25) * MS)},
                  {"name": "replay_end", "frame": f, "t_ns": int((b + step_ms) * MS)}]
    b = t0 + 30
    rows += [(f"{serial}.dr", "slam.drain", b + 0.5, b + 3.5, f"{serial}.3d", (serial, 2)),
             (f"{serial}.dw", "slam.fetch_wait", b + 1, b + 2, f"{serial}.dr", (serial, 2)),
             (f"{serial}.fl", "slam.drain", t0 + 40, t0 + 50 + slow, None, (serial, 3)),
             (f"{serial}.fw", "slam.fetch_wait", t0 + 40, t0 + 48 + slow, f"{serial}.fl",
              (serial, 3))]
    counts = [{"name": "host_syncs.fetch", "n": 1, "frame": (serial, 2), "t_ns": 0},
              {"name": "host_syncs.fetch", "n": 1, "frame": (serial, 3), "t_ns": 0},
              {"name": "host_syncs.cursor", "n": 1, "frame": (serial, 3), "t_ns": 0},
              {"name": "host_syncs.cursor", "n": 1, "frame": None, "t_ns": 0},
              {"name": "host_syncs.n_valid", "n": int(slow), "frame": (serial, 1), "t_ns": 0}]
    return rows, marks, counts


def _two_engines():
    rows1, marks1, counts1 = _engine(1, 100.0, 9.0)
    rows2, marks2, counts2 = _engine(2, 1000.0, 5.0, slow=2.0)
    return {"spans": _spans(rows1 + rows2), "marks": marks1 + marks2,
            "counts": counts1 + counts2}


EXPECTED = {  # engine 1's four frames
    "frames": 4,
    "fetch_wait_ms": (1 + 8) / 4,
    "dispatch_ms": (1.5 * 3 + (5.0 - 3.0)) / 4,
    "syncs_per_frame": 3 / 4,
    "step_device_ms": 9.0,
    "upload_device_ms": 0.25,
    "device_gap_pct": (1 - 36 / 39) * 100,
}


@pytest.mark.parametrize("key", sorted(EXPECTED))
def test_frame_stats_of_hand_built_records(key):
    records = _two_engines()
    assert profiling.frame_stats(records, {1})[key] == pytest.approx(EXPECTED[key], rel=1e-9)
    both = profiling.frame_stats(records)  # engine 2's frames counted too
    if key == "frames":
        assert both[key] == 8
    elif key != "upload_device_ms":
        assert both[key] != pytest.approx(EXPECTED[key], rel=1e-6)


def test_frame_stats_read_nothing_without_records():
    records = _two_engines()
    assert profiling.frame_stats(records, {3}) is None
    assert profiling.frame_stats({"spans": [], "counts": [], "marks": []}) is None
    no_marks = profiling.frame_stats(dict(records, marks=[]), {1})
    assert no_marks["step_device_ms"] is None and no_marks["device_gap_pct"] is None
    assert no_marks["upload_device_ms"] is None and no_marks["gaps"] == {}
    assert no_marks["fetch_wait_ms"] == pytest.approx(EXPECTED["fetch_wait_ms"])


def test_gaps_go_to_the_innermost_span_open_when_they_began():
    stats = profiling.frame_stats(_two_engines(), {1})
    # each of the three gaps (1 ms) begins at the next frame's ingest
    assert stats["gaps"] == {"slam.ingest": pytest.approx(0.003)}


def test_spans_are_profiler_ranges_only_while_it_is_active():
    from torch.profiler import ProfilerActivity, profile

    RECORDER.enable("cpu")
    with RECORDER.span("slam.outside"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with RECORDER.span("slam.frame", (0, 0)):
            with RECORDER.span("slam.ingest"):
                torch.ones(4).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"slam.frame", "slam.ingest"} <= names and "slam.outside" not in names
    spans = RECORDER.records()["spans"]
    assert [s["name"] for s in spans] == ["slam.outside", "slam.frame", "slam.ingest"]
    assert spans[2]["frame"] == (0, 0)  # a child takes its parent's frame


@pytest.mark.cuda
def test_marks_add_no_synchronise_and_captures_name_their_keys(monkeypatch):
    """On the card: the same drive with the recorder off and on makes the
    same number of event and device synchronises; on, every frame has its
    three marks in order, read from a pool of events no larger than the frames in
    flight need, and each capture is a `slam.capture` span under its key."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    waits = collections.Counter()
    event_sync, device_sync = torch.cuda.Event.synchronize, torch.cuda.synchronize

    def counted_event_sync(ev):
        waits["event"] += 1
        return event_sync(ev)

    def counted_device_sync(*a, **k):
        waits["device"] += 1
        return device_sync(*a, **k)

    monkeypatch.setattr(torch.cuda.Event, "synchronize", counted_event_sync)
    monkeypatch.setattr(torch.cuda, "synchronize", counted_device_sync)
    runs = []
    for on in (False, True):
        eng, rec, made = _drive("cuda", on=on, waits=waits)
        runs.append((eng, rec, made, dict(waits)))
    (eng_off, _, made_off, waits_off), (eng_on, rec, made, waits_on) = runs
    assert waits_on == waits_off
    assert _record_bits(eng_off) == _record_bits(eng_on)
    marks = collections.defaultdict(dict)
    for m in rec["marks"]:
        marks[m["frame"]][m["name"]] = m["t_ns"]
    assert sorted(marks) == _frames_of(rec)
    for f, m in marks.items():
        assert m["frame_start"] <= m["step_start"] <= m["replay_end"], f
    assert len(rec["marks"]) == 3 * 3 * LAP
    captures = [s for s in rec["spans"] if s["name"] == "slam.capture"]
    keys = [s["attrs"]["key"] for s in captures]
    assert len(keys) == eng_on.graphs.captures and set(keys) == set(eng_on.graphs._graphs)
    # the anchor and a pool for the frames in flight; none made with it off
    assert made_off == 0 and made <= 3 * (FETCH_EVERY + 1) + 1


def test_cli_profile_trace_holds_the_engine_spans(tmp_path, monkeypatch):
    """`tools/run_odometry.py --profile` turns the recorder on for its
    profiled loop: the Chrome trace holds the engine's spans as ranges, it
    prints their per-frame summary, and the recorder is off again after it."""
    import contextlib
    import io

    import bshot_slam_tpu_torch.config as tc
    from bshot_slam_tpu_torch.tools import run_odometry

    monkeypatch.setattr(tc, "default_config", tc.tiny_config)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run_odometry.main(["--synthetic", "2", "--n-azimuth", "128", "--cpu",
                                  "--profile", str(tmp_path / "trace")]) == 0
    # the spans' summary, with no device numbers on the CPU
    assert "per frame: fetch wait" in out.getvalue()
    assert "step on the device n/a ms" in out.getvalue()
    text = "".join(p.read_text() for p in (tmp_path / "trace").iterdir()
                   if p.name.endswith(".json"))
    for name in ("slam.frame", "slam.ingest", "slam.dispatch", "slam.replay"):
        assert f'"{name}"' in text, name
    assert not RECORDER.on
