"""The harness: cells, configurations, traffic and metric readers found by
name; the result line's shape; what a run refuses and what it loads."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import pytest

from slambench import cell as cell_mod
from slambench import harness, trace
from slambench.reference import check as check_mod
from slambench.tests import tiny

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + WORKLOADS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in WORKLOADS:
        reported = [m for m in BENCH["end_to_end"] if w in m.get("workloads", WORKLOADS)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(w in m.get("workloads", WORKLOADS) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", WORKLOADS)
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_found_by_name(workload):
    """Each cell's configuration, traffic, limits and metric readers are
    files found by its name and its metrics' names."""
    cell = cell_mod.load(workload)
    config, traffic = workload.split(".", 1)
    assert cell.config["name"] == config
    assert cell.traffic["laps_per_pass"] >= 1
    assert cell.limits and set(cell.limits) <= set(check_mod.NUMBERS)
    cfg = cell_mod.slam_config(cell.config)
    assert cfg.sensor.n_rings == len(cell.config["sensor"]["vertical_angles_deg"])
    assert cell.config["reduced"] == []
    empty = trace.Run(cell=cell, frames=0, window_s=0.0, setup_s=1.0,
                      spans={}, n_redispatched=0, captures_in_window=0, profile=None)
    for m in cell.end_to_end + cell.per_layer:
        read = cell_mod.reader(m["name"])
        value = read(empty)
        assert value is None or m["name"] == "setup_s"


def test_forbidden_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "bshot_slam_tpu_torch.extra", sys)
    assert "bshot_slam_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "bshot_slam_tpu.extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.extra", sys)
    assert {"bshot_slam_tpu", "jaxlib"} <= set(harness.forbidden_modules())


LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("traced", [0, 1])
def test_tiny_run_prints_a_contract_line(workload, traced):
    """A tiny run of each traffic mix on the CPU, in its own process: the
    result is one JSON line of the contract's keys, `check` last, and no
    module of JAX or of the JAX package was loaded."""
    code = (
        "import json, sys, time; t0 = time.perf_counter(); sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(2)\n"
        "from slambench import harness; from slambench.tests import tiny\n"
        "out = harness.run_cell(tiny.tiny_cell(%r), 2**31 + 77, 1.0, %s, t0, device='cpu',"
        " log=lambda s: None)\n"
        "out['loaded'] = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps(out))\n" % (str(ROOT), workload, bool(traced)))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    loaded = set(out.pop("loaded"))
    assert not loaded & {"jax", "jaxlib", "flax", "bshot_slam_tpu"}
    keys = list(out)
    assert keys[:5] == LINE_KEYS and keys[-1] == "check"
    assert isinstance(out["correct"], bool) and out["attempted"] >= 5 and out["failed"] == 0
    cell = tiny.tiny_cell(workload)
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in (cell.per_layer if traced else cell.end_to_end)}
    assert set(out["metrics"]) <= want
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    if not traced:
        assert set(out["metrics"]) == want  # host-clock metrics read on any device
    assert set(out["check"]) == set(cell.limits)
    for v in out["check"].values():
        assert set(v) == {"value", "limit"}


def test_run_without_a_card_prints_no_result():
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal needs a machine without one")
    p = subprocess.run([sys.executable, "slambench/run.py", "--workload", WORKLOADS[0],
                        "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_without_the_program_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's own
    files, a run exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for p in BENCH["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "slambench/run.py", "--workload", WORKLOADS[0],
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_setup_parts_account_for_setup_s():
    parts = harness.Parts(0.25, time.perf_counter())
    parts.mark("a")
    parts.mark("b")
    assert [n for n, _ in parts.parts] == ["interpreter", "a", "b"]
    assert abs(parts.total - sum(s for _, s in parts.parts)) < 1e-12


def test_run_seeds_take_large_seeds():
    a, b = harness.run_seeds(2**31 + 5), harness.run_seeds(2**31 + 6)
    assert a == harness.run_seeds(2**31 + 5) and a != b
    assert all(0 <= v < 2**63 for v in a.values())


def test_benchmark_json_texts_and_units():
    one_line = re.compile(r"^[^\t\n]{1,200}$")
    for c in BENCH["configs"]:
        assert one_line.match(c["source"]) and one_line.match(c["why"])
        assert (ROOT / c["file"]).is_file() and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert one_line.match(w["why"]) and w["chips"] in (1, 4)
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert one_line.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_seeds_replay_one_log_in_another_order():
    """Every seed replays the same sweeps (the log is the traffic file's),
    starting where its seed says: the same cloud sizes, in another order."""
    cell = tiny.tiny_cell(WORKLOADS[0])
    a = harness.drive(cell, "cpu", harness.run_seeds(2**31 + 1))
    b = harness.drive(cell, "cpu", harness.run_seeds(2**31 + 2))
    key = lambda sweeps: [sw.distance.tobytes() for sw in sweeps]  # noqa: E731
    assert sorted(key(a)) == sorted(key(b))
    assert key(a) == key(harness.drive(cell, "cpu", harness.run_seeds(2**31 + 1)))
    n = len(a)
    assert any(key(a) == key(b)[i:] + key(b)[:i] for i in range(n))


def test_every_pass_does_the_same_work():
    """The window replays the log in passes from the set-up's start: the
    frames are whole passes, and each pass ends on the same map and pose
    (the CPU is deterministic), whatever the program's speed."""
    import torch

    torch.set_num_threads(2)
    cell = tiny.tiny_cell(WORKLOADS[0])
    parts = harness.Parts(0.0, time.perf_counter())
    device = harness.load_program(parts, "cpu", 1)
    b = harness.build(cell, 2**31 + 11, device, parts)
    D = harness.pass_frames(cell, len(b.sweeps))
    w = harness.window(b, 1.5 * b.warm_s * D / len(b.sweeps), trace=False)
    assert D == 2 * len(b.sweeps) and w["frames"] % D == 0 and w["frames"] >= 2 * D
    assert len(w["pass_s"]) == w["frames"] // D
    ends = [w["records"][i] for i in range(D - 1, w["frames"], D)]
    for rec in ends[1:]:
        assert rec.map_size == ends[0].map_size
        assert (rec.pose == ends[0].pose).all()


def test_steady_host_keeps_one_pool_thread_on_two_cpus():
    code = ("import os, sys; sys.path.insert(0, %r)\n"
            "from slambench import host; host.steady()\n"
            "print(len(os.sched_getaffinity(0)), os.environ['OMP_NUM_THREADS'])\n" % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=60, cwd=ROOT)
    n, threads = p.stdout.split()
    assert 1 <= int(n) <= 2 and threads == "1"
