"""The port's user-facing entry points on the CPU: the odometry CLI, the bench,
the live view and the profiling helpers.

Fast, in process, on the tiny config (`default_config` patched to
`tiny_config`: the port's plain CPU step at the full config costs ~19 s a
frame on one thread, most of it the plain Hamming scan of a 16384-row map):
(a) `run_odometry --synthetic 2 --cpu --checkpoint`, then `--resume` from
    it: the combined trajectory and checkpoint hold all four frames, and the
    reference's `load_state` reads the port's file;
(b) a PCAP input (the native stream) with `--frames`;
(c) `--sharded` raises NotImplementedError;
(c2) the evaluation CLIs: `run_preprocess_eval` (with a select list and PLY
    export) and `show_pointcloud` print what the reference's tools print on
    the same arguments; `run_kp_eval` and the three `run_analysis`
    experiments write their lines, JSON and charts, the `ground`
    experiment's accuracies equal to the reference's;
(d) `bench_torch._prefilled_map` equals `bench.py`'s array by array; a CPU
    run of `bench_torch.main` prints bench.py's JSON keys first; `--full`'s
    host and device-preprocess clouds hold the same points and both step;
(e) the viz copies write the reference's bytes; `LiveView` draws a port
    engine; `utils.profiling` times and traces.
Slow (subprocesses at the full config with few azimuth bins, as
tests/test_tools.py runs the reference's CLI): `--pipeline`, `--backend`
with periodic passes and BA, `--live` with `--step`, and `--udp`.
"""

import contextlib
import dataclasses
import io
import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu_torch.io import pcap, synthetic, velodyne
from bshot_slam_tpu_torch.tools import run_odometry

ROOT = pathlib.Path(__file__).resolve().parents[1]
CLI = ROOT / "bshot_slam_tpu_torch" / "tools" / "run_odometry.py"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other engine test files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(tc, "default_config", tc.tiny_config)


def _cli(*args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run_odometry.main([str(a) for a in args]) == 0
    return out.getvalue()


# -- (a)-(c) the CLI, fast -----------------------------------------------------


def test_cli_checkpoint_then_resume(tmp_path, tiny):
    from bshot_slam_tpu.checkpoint import load_state as jax_load_state

    ck, ck2 = tmp_path / "ck", tmp_path / "ck2"
    t1, t2 = tmp_path / "t1.txt", tmp_path / "t2.txt"
    out = _cli("--synthetic", 2, "--n-azimuth", 128, "--cpu", "--eval-corr",
               "--checkpoint", ck, "--out", t1)
    assert "engine on cpu" in out and "frame    1" in out and "corr dist mm" in out
    assert len(t1.read_text().strip().splitlines()) == 2
    out = _cli("--synthetic", 2, "--n-azimuth", 128, "--cpu", "--resume", ck,
               "--checkpoint", ck2, "--out", t2, "--gold", t1)
    assert "resumed from" in out and "frame_idx=2" in out and "ATE RMSE vs" in out
    lines = t2.read_text().strip().splitlines()
    assert len(lines) == 4 and lines[:2] == t1.read_text().strip().splitlines()
    state, poses = jax_load_state(str(ck2))
    assert poses.shape == (4, 4, 4) and int(state.frame_idx) == 4


def test_cli_reads_a_pcap(tmp_path, tiny):
    cfg = tc.tiny_config()
    sweeps, _ = synthetic.render_sequence(4, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                          seed=11, n_firings=cfg.sensor.n_azimuth)
    path = tmp_path / "drive.pcap"
    pcap.write_udp_payloads(str(path), velodyne.encode_packets(sweeps, cfg.sensor))
    traj = tmp_path / "t.txt"
    out = _cli(path, "--skip", 1, "--frames", 2, "--cpu", "--out", traj)
    assert "2 frames in" in out
    assert len(traj.read_text().strip().splitlines()) == 2


def test_cli_sharded_raises(tmp_path, capfd):
    """`--sharded` refuses the inputs and views one rank cannot serve alone
    (a usage error), and otherwise runs over two gloo ranks on the CPU: the
    trajectory file equals the single-process run's byte for byte (the
    default config at 64 azimuth bins: the ranks re-import the CLI; rank 0
    prints to the inherited stdout)."""
    with pytest.raises(SystemExit):
        run_odometry.main(["--synthetic", "2", "--cpu", "--sharded", "2",
                           "--live", str(tmp_path / "live")])
    args = ["--synthetic", "2", "--n-azimuth", "64", "--cpu"]
    _cli(*args, "--out", tmp_path / "one.txt")
    capfd.readouterr()
    assert run_odometry.main([str(a) for a in args] + [
        "--sharded", "2", "--out", str(tmp_path / "two.txt")]) == 0
    out = capfd.readouterr().out
    assert "sharded over 2 ranks" in out and out.count("frame ") == 2
    assert (tmp_path / "two.txt").read_bytes() == (tmp_path / "one.txt").read_bytes()


# -- (c2) the evaluation CLIs --------------------------------------------------


def _run_main(mod, *args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert mod.main([str(a) for a in args]) == 0
    return out.getvalue()


def _reference_tool(name, monkeypatch, *args) -> str:
    """The reference's `tools/<name>.py` in process, on the CPU."""
    import runpy

    monkeypatch.setattr(sys, "argv", [name, *map(str, args)])
    main = runpy.run_path(str(ROOT / "tools" / f"{name}.py"))["main"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main() == 0
    return out.getvalue()


def test_preprocess_eval_cli_matches_reference(tmp_path, tiny, monkeypatch):
    from bshot_slam_tpu_torch.tools import run_preprocess_eval

    sel = tmp_path / "sel.txt"
    sel.write_text(" ".join(str(i) for i in range(0, 3000, 7)) + "\n1 2 3\n")
    args = ("--synthetic", 2, "--n-azimuth", 128, "--select", sel, "--cpu")
    got = _run_main(run_preprocess_eval, *args, "--ply-out", tmp_path / "ply")
    want = _reference_tool("run_preprocess_eval", monkeypatch, *args)
    assert got == want and got.count("accuracy=") == 2
    assert len(list((tmp_path / "ply").glob("frame_*.ply"))) == 2


def test_show_pointcloud_cli_matches_reference(tmp_path, monkeypatch):
    from bshot_slam_tpu_torch.tools import show_pointcloud

    got = _run_main(show_pointcloud, "--synthetic", 2, "--n-azimuth", 128, "--cpu",
               "--out", tmp_path / "port")
    want = _reference_tool("show_pointcloud", monkeypatch, "--synthetic", 2,
                           "--n-azimuth", 128, "--out", tmp_path / "ref")
    assert got.replace("port", "ref") == want and want.count("returns") == 2
    head = (tmp_path / "port" / "sweep_00000.ply").read_text().split("end_header")[0]
    assert head == (tmp_path / "ref" / "sweep_00000.ply").read_text().split("end_header")[0]


def test_kp_eval_cli(tiny):
    from bshot_slam_tpu_torch.tools import run_kp_eval

    out = _run_main(run_kp_eval, "--synthetic", 2, "--n-azimuth", 256, "--cpu")
    lines = out.strip().splitlines()
    assert len(lines) == 2 and "SR n=" in lines[0] and "ISS n=" in lines[0]
    assert "repeat SR=" in lines[1]


@pytest.mark.parametrize("experiment", ["ground", "repeatability", "correspondences"])
def test_analysis_cli(tmp_path, tiny, experiment):
    from bshot_slam_tpu_torch.tools import run_analysis

    args = (experiment, "--synthetic", 2, "--n-azimuth", 128, "--vert-inits=-0.6,-0.9",
            "--cpu", "--out")
    out = _run_main(run_analysis, *args, tmp_path / "port")
    assert "stats ->" in out and list((tmp_path / "port").glob("*.svg"))
    got = json.loads((tmp_path / "port" / f"{experiment}.json").read_text())
    assert len(got["frame"]) == 2
    if experiment == "ground":  # the classes alone decide: any max_points
        ref = ROOT / "tools" / "run_analysis.py"
        proc = subprocess.run([sys.executable, str(ref), *map(str, args),
                               str(tmp_path / "ref")], capture_output=True, text=True,
                              env=dict(os.environ, JAX_PLATFORMS="cpu"), timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
        want = json.loads((tmp_path / "ref" / "ground.json").read_text())
        assert got == want


# -- (d) the bench -------------------------------------------------------------


def test_bench_prefill_matches_reference():
    import bench
    import bench_torch
    import bshot_slam_tpu.config as jc

    want = bench._prefilled_map(jc.default_config(), 131072)
    got = bench_torch._prefilled_map(tc.default_config(), 131072, device="cpu")
    assert got._fields == want._fields
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        if f == "descriptors":
            b = b.view(np.uint32)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_bench_cpu_run_prints_the_reference_line(tiny, monkeypatch, capsys):
    import bench_torch

    monkeypatch.setattr(bench_torch, "PREFILL_LANDMARKS", 500)
    rc = bench_torch.main(["3", "--cpu"])
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[0])
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "ate_vs_gt_mm",
                          "quality_ok"]
    assert line["metric"] == "engine_frames_per_sec_per_chip" and line["value"] > 0
    assert rc == (0 if line["quality_ok"] else 1)
    assert "# cpu" in err and "redispatched=" in err


def test_bench_step_only_forms():
    """`--full`'s two step-only passes: the host clouds and the device
    preprocess's masked clouds hold the same points; both step."""
    import bench_torch

    cfg = tc.tiny_config()
    sweeps, _ = synthetic.render_sequence(2, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                          seed=11, n_firings=cfg.sensor.n_azimuth)
    host = bench_torch.host_clouds(cfg, sweeps, "cpu")
    dev = bench_torch.device_clouds(cfg, sweeps, "cpu")
    for (hp, _, nv), (dp, dm, _) in zip(host, dev):
        assert int(dm.sum()) == nv and dp.shape == hp.shape
        torch.testing.assert_close(dp[:nv], hp[:nv], rtol=0, atol=0.05)
    small = dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, capacity=4096))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bench_torch, "PREFILL_LANDMARKS", 500)
        assert bench_torch.step_only_fps(small, dev, "cpu") > 0
        assert bench_torch.step_only_fps(small, host, "cpu") > 0


# -- (e) viz and profiling -----------------------------------------------------


def test_viz_copies_write_the_reference_bytes(tmp_path):
    from bshot_slam_tpu.viz import charts as jcharts
    from bshot_slam_tpu.viz import export as jexport
    from bshot_slam_tpu_torch.viz import charts, export

    rng = np.random.default_rng(0)
    pts = rng.uniform(-1000, 1000, (50, 3)).astype(np.float32)
    cls = rng.integers(0, 4, (4, 8))
    xyz = rng.uniform(-1000, 1000, (4, 8, 3))
    for mod, name in ((export, "port"), (jexport, "ref")):
        mod.save_ply(str(tmp_path / f"{name}.ply"), pts, np.full((50, 3), 128, np.uint8))
        mod.save_classified_cloud(str(tmp_path / f"{name}_cl.ply"), xyz, cls,
                                  np.ones((4, 8), bool))
        mod.save_trajectory_svg(str(tmp_path / f"{name}.svg"), [pts, pts + 100],
                                labels=["est", "gt"])
    for mod, name in ((charts, "port"), (jcharts, "ref")):
        mod.save_line_chart_svg(str(tmp_path / f"{name}_chart.svg"), range(5),
                                {"a": [1, 2, 3, 2, 1], "b": [0, 1, 0, 1, 0]},
                                "t", "x", "y")
    for suffix in (".ply", "_cl.ply", ".svg", "_chart.svg"):
        assert (tmp_path / f"port{suffix}").read_bytes() == \
            (tmp_path / f"ref{suffix}").read_bytes(), suffix


def test_live_view_draws_a_port_engine(tmp_path):
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.viz.live import LiveView

    cfg = tc.tiny_config()
    sweeps, _ = synthetic.render_sequence(3, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                          seed=11, n_firings=cfg.sensor.n_azimuth)
    eng = SlamEngine(cfg, seed=0, tile=cfg.runtime.point_tile, device="cpu",
                     keep_corr=True)
    live = LiveView(str(tmp_path), every=1)
    for sw in sweeps:
        eng.process_sweep(sw)
        assert live.maybe_update(eng)
    stats = json.loads((tmp_path / "live.json").read_text())
    assert stats["frame"] == 3 and stats["map_size"] == eng.records[-1].map_size
    assert stats["corr_drawn"] > 0
    svg = (tmp_path / "live.svg").read_text()
    assert "<svg" in svg and "polyline" in svg and "map keypoints" in svg
    p3 = json.loads((tmp_path / "live_points.json").read_text())
    assert len(p3["traj"]) == 3 and len(p3["map"]) == int(eng.state.map.valid.sum())


def test_profiling_helpers(tmp_path):
    from bshot_slam_tpu_torch.utils import profiling

    t = profiling.TicToc()
    with profiling.trace(str(tmp_path / "trace")):
        x = torch.ones(64, 64) @ torch.ones(64, 64)
    profiling.fence({"x": (x, [x])})  # CPU tensors: nothing to wait for
    assert t.toc() > 0
    assert any(p.name.endswith(".json") for p in (tmp_path / "trace").iterdir())


# -- slow: the CLI as a subprocess at the full config --------------------------


def _run(*args, timeout=1800, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, str(CLI), *map(str, args)],
                          capture_output=True, text=True, timeout=timeout, env=env, **kw)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.slow
def test_cli_pipelined(tmp_path):
    out = tmp_path / "traj.txt"
    stdout = _run("--synthetic", 5, "--n-azimuth", 128, "--cpu", "--pipeline",
                  "--out", out)
    assert "5 frames" in stdout
    assert len(out.read_text().strip().splitlines()) == 5


@pytest.mark.slow
def test_cli_backend(tmp_path):
    gold = tmp_path / "gold.txt"
    gold.write_text("\n".join("0 0 0" for _ in range(6)) + "\n")
    stdout = _run("--synthetic", 6, "--n-azimuth", 128, "--cpu", "--backend",
                  "--backend-every", 3, "--ba", "--gold", gold,
                  "--checkpoint", tmp_path / "ck")
    assert "backend:" in stdout and "corrections applied" in stdout
    assert "BA:" in stdout
    assert (tmp_path / "ck" / "backend_state.npz").exists()


@pytest.mark.slow
def test_cli_live_view_and_step(tmp_path):
    live = tmp_path / "live"
    stdout = _run("--synthetic", 3, "--n-azimuth", 128, "--cpu", "--live", live,
                  "--live-every", 1, "--step", input="\nc\n")
    assert "[step]" in stdout
    stats = json.loads((live / "live.json").read_text())
    assert stats["frame"] == 3 and stats["map_size"] > 0
    assert (live / "live.html").exists() and (live / "live3d.html").exists()


@pytest.mark.slow
def test_cli_live_udp(tmp_path):
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    sensor = tc.SensorConfig(n_azimuth=128)
    sweeps, _ = synthetic.render_sequence(3, sensor, seed=2, n_firings=128)
    pkts = velodyne.encode_packets(sweeps, sensor)
    out = tmp_path / "traj.txt"
    proc = subprocess.Popen(
        [sys.executable, str(CLI), "--udp", str(port), "--udp-idle", "60",
         "--frames", "2", "--n-azimuth", "128", "--cpu", "--out", str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    stop = threading.Event()

    def feeder():
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        while not stop.is_set():
            for p in pkts:
                tx.sendto(p.tobytes(), ("127.0.0.1", port))
                time.sleep(0.002)
        tx.close()

    t = threading.Thread(target=feeder, daemon=True)
    t.start()
    try:
        stdout, _ = proc.communicate(timeout=1800)
    finally:
        stop.set()
        proc.kill()
        t.join(timeout=5)
    assert proc.returncode == 0, stdout[-2000:]
    assert "frame    1" in stdout
    assert len(out.read_text().strip().splitlines()) == 2
