"""The HDL-64E S2 preset (`config.hdl64e_config`, the KITTI odometry
benchmark's sensor) on the CPU.

(a) The preset: 64 angles in the S2 manual's nominal block spacing, its
    range image's rows sorted, `max_points` within kernels A and B's
    `MAX_ROWS`, the cloud ladder ascending to `max_points`, the other
    settings those of `default_config()`, and the benchmark's configuration
    file `slambench/configs/hdl64e.json` the preset as run.
(b) Host ingest at 64 rings against `slambench/reference/ingest.py` on
    rendered sweeps (few azimuth bins): the range image and the port's plain
    classify + extract bit-equal, the native library's cloud with the same
    kept points in the same order, within float32 rounding; `pick_bucket`
    above 49152 as the reference picks.
(c) `cloud.truncated_rows` counts the kept points a small `max_points`
    cuts, `frame_stats` the frames truncated and the padded share.
(d) Three chained frames of a tiny 64-ring config, synchronous and
    pipelined, against `slambench/reference/step.py` under
    `slambench/limits/hdl64e.replay.json`.
(e) A 64-ring sensor's packets are refused (they need the unit's
    calibration file): by `run_odometry.py --sensor hdl64e` with a PCAP or
    `--udp`, by the python decoder and encoder, the UDP capture, and the
    native decode and stream, in Python and in the library itself; with
    `--synthetic` the CLI runs the preset and `--profile` prints the cloud
    counters.
(f) The tiny cell's check: a sound run within its limits; a step that
    leaves its state unchanged, an ingest that drops half of each cloud, and
    the control (the reference's cloud in bfloat16) each fail it.
"""

import contextlib
import ctypes
import dataclasses
import io
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu_torch.io import native_decoder, pcap, synthetic, udp, velodyne
from bshot_slam_tpu_torch.kernels import neighborhood as K
from bshot_slam_tpu_torch.odometry import engine as engine_mod
from bshot_slam_tpu_torch.odometry.engine import SlamEngine, pick_bucket
from bshot_slam_tpu_torch.ops import preprocess_host
from bshot_slam_tpu_torch.ops.rangeimage import build_range_image, sorted_vertical_angles_rad
from bshot_slam_tpu_torch.utils import profiling
from bshot_slam_tpu_torch.utils.profiling import RECORDER
from slambench import cell as cell_mod
from slambench import control, harness
from slambench.reference import check as check_mod
from slambench.reference import config as ref_config
from slambench.reference import ingest
from slambench.tests import tiny
from slambench.traffic import prefill

CELL = "hdl64e.replay"
N_AZ = 256


@pytest.fixture(autouse=True)
def _one_thread_recorder_off():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    RECORDER.disable()
    RECORDER.clear()
    yield
    RECORDER.disable()
    RECORDER.clear()
    torch.set_num_threads(n)


def tiny64(max_points: int = 2048) -> tc.SlamConfig:
    """`tiny_config`'s sizes on the HDL-64E preset's sensor (few azimuth
    bins), car box, sensor height and cloud ladder."""
    full, t = tc.hdl64e_config(), tc.tiny_config()
    return t.replace(
        sensor=dataclasses.replace(full.sensor, n_azimuth=N_AZ),
        preprocess=dataclasses.replace(full.preprocess, max_points=max_points),
        runtime=dataclasses.replace(t.runtime, cloud_buckets=full.runtime.cloud_buckets))


def reference_cfg(cfg: tc.SlamConfig):
    """The reference's view of `cfg` (the configuration file's form)."""
    return ref_config.from_json(
        {s: dataclasses.asdict(getattr(cfg, s)) for s in ref_config.SECTIONS})


def sweeps64(sensor, n: int = 3, n_firings: int = 241, noise_mm: float = 20.0):
    """Sweeps of `default_scene(0)` at 1.73 m, fewer firings than bins as
    the HDL-64E's 2083 in 2176."""
    poses = synthetic.straight_trajectory(n, 400.0, sensor_height_mm=1730.0,
                                          yaw_rate_rad=0.05)
    scene = synthetic.default_scene(0)
    return [synthetic.render_sweep(scene, sensor, p, noise_mm=noise_mm, seed=i,
                                   n_firings=n_firings) for i, p in enumerate(poses)]


# -- (a) the preset -----------------------------------------------------------


def test_preset_angles_in_nominal_spacing():
    s = tc.HDL64E_SENSOR
    a = np.asarray(s.vertical_angles_deg)
    assert s.name == "HDL-64E S2" and s.n_rings == 64 and a.shape == (64,)
    assert s.distance_scale_mm == 2.0
    np.testing.assert_allclose(np.diff(a[:32]), -1.0 / 3.0, atol=1e-12)
    np.testing.assert_allclose(np.diff(a[32:]), -0.5, atol=1e-12)
    assert a[0] == 2.0 and a[32] == pytest.approx(-8.83)
    assert a[31] == pytest.approx(2.0 - 31 / 3) and a[63] == pytest.approx(-24.33)
    assert len(set(a.tolist())) == 64
    assert s.n_azimuth >= 2083  # a bin for every firing of a turn


def test_preset_rows_sorted():
    s = tc.HDL64E_SENSOR
    vert = sorted_vertical_angles_rad(s)
    assert vert.shape == (64,) and np.all(np.diff(vert) > 0)
    # each ring lands on the row of its angle's rank
    sw = sweeps64(dataclasses.replace(s, n_azimuth=N_AZ), n=1)[0]
    ri = build_range_image(sw, dataclasses.replace(s, n_azimuth=N_AZ))
    rank = np.argsort(np.argsort(s.vertical_angles_deg))
    for ring in (0, 31, 32, 63):
        col = int(sw.azimuth_deg[sw.ring == ring][0] / 360.0 * N_AZ)
        d = sw.distance[sw.ring == ring][0] * s.distance_scale_mm
        assert ri.range_mm[rank[ring], col] == np.float32(d)


def test_preset_fits_kernels_a_and_b():
    cfg = tc.hdl64e_config()
    ladder = cfg.runtime.cloud_buckets
    assert cfg.preprocess.max_points <= K.MAX_ROWS
    assert cfg.preprocess.max_points == 131072
    assert list(ladder) == sorted(set(ladder)) and ladder[-1] == cfg.preprocess.max_points
    assert ladder[:len(tc.RuntimeConfig().cloud_buckets)] == tc.RuntimeConfig().cloud_buckets
    assert {65536, 98304, 131072} <= set(ladder)


def test_preset_keeps_the_default_settings():
    cfg, d = tc.hdl64e_config(), tc.default_config()
    for section in ("keypoints", "descriptor", "match", "map", "backend"):
        assert getattr(cfg, section) == getattr(d, section)
    p = cfg.preprocess
    assert p.sensor_height_mm == 1730.0
    assert (p.car_x_mm, p.car_y_mm, p.car_z_mm) == ((-910.0, 910.0), (-2390.0, 2390.0),
                                                    (-1730.0, 100.0))
    assert dataclasses.replace(p, sensor_height_mm=2450.0, max_points=49152,
                               car_x_mm=d.preprocess.car_x_mm,
                               car_y_mm=d.preprocess.car_y_mm,
                               car_z_mm=d.preprocess.car_z_mm) == d.preprocess
    assert d.preprocess.max_points == 49152 and d.sensor.n_rings == 32


def test_benchmark_file_is_the_preset():
    cell = cell_mod.load(CELL)
    assert cell_mod.slam_config(cell.config) == tc.hdl64e_config()
    assert cell.config["reduced"] == [] and cell.config["n_firings"] == 2083
    assert cell.chips == 1 and cell.traffic == cell_mod.load("hdl32e.replay").traffic


# -- (b) host ingest at 64 rings ----------------------------------------------


@pytest.mark.parametrize("max_points", [1800, 4096])
def test_host_ingest_at_64_rings_matches_the_reference(max_points):
    cfg = tiny64(max_points)
    rcfg = reference_cfg(cfg)
    for sw in sweeps64(cfg.sensor):
        ri = build_range_image(sw, cfg.sensor)
        r, a, v = ingest.build_range_image(sw.azimuth_deg, sw.ring, sw.distance, rcfg.sensor)
        for got, want in ((ri.range_mm, r), (ri.azimuth_rad, a), (ri.vert_rad, v)):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        want, nv = ingest.host_cloud(sw.azimuth_deg, sw.ring, sw.distance, rcfg)
        # the port's plain classify + extract: bit-equal
        cl, xyz, valid = preprocess_host.preprocess_host(ri.range_mm, ri.azimuth_rad,
                                                         ri.vert_rad, cfg.preprocess)
        pts, n_plain = preprocess_host.extract_cloud_host(cl, xyz, valid, None, max_points)
        assert n_plain == nv and np.array_equal(pts, want[:nv])
        # the engine's native ingest: the same points in the same order; sin
        # and cos of float32 round apart from numpy's by a unit or two
        got, n_native = engine_mod.host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad,
                                              None, cfg)
        assert n_native == nv and got.shape == want.shape
        assert np.abs(got - want).max() <= 0.05
        assert not got[nv:].any()


@pytest.mark.parametrize("n,bucket", [(49152, 49152), (49153, 65536), (65536, 65536),
                                      (65537, 98304), (98305, 131072), (120799, 131072),
                                      (131072, 131072), (140000, 131072)])
def test_pick_bucket_above_49152(n, bucket):
    cfg = tc.hdl64e_config()
    assert pick_bucket(n, cfg) == bucket
    assert ingest.pick_bucket(n, cfg.runtime.cloud_buckets, cfg.preprocess.max_points) == bucket


# -- (c) the cloud counters ---------------------------------------------------


def test_truncated_rows_count_a_cloud_cut_at_max_points():
    sweeps = sweeps64(tiny64().sensor)
    kept = []
    for sw in sweeps:
        _, n = ingest.host_cloud(sw.azimuth_deg, sw.ring, sw.distance,
                                 reference_cfg(tiny64(K.MAX_ROWS)))
        kept.append(n)
    cap = (min(kept) + max(kept)) // 2
    assert min(kept) < cap < max(kept)  # frames under and over the cap
    cfg = tiny64(cap)
    RECORDER.enable("cpu")
    eng = SlamEngine(cfg, seed=0, device="cpu", tile=cfg.runtime.point_tile)
    for sw in sweeps:
        eng.process_sweep(sw)
    RECORDER.disable()
    rec = RECORDER.records()
    by = {}
    for c in rec["counts"]:
        if c["name"].startswith("cloud."):
            by.setdefault(c["frame"][1], {})[c["name"]] = c["n"]
    assert sorted(by) == list(range(len(sweeps)))
    for i, n in enumerate(kept):
        assert by[i] == {"cloud.rows": min(n, cap), "cloud.bucket_rows": cap,
                         "cloud.truncated_rows": max(n - cap, 0)}
    stats = profiling.frame_stats(rec, {eng.serial})
    assert stats["truncated_frames"] == sum(n > cap for n in kept)
    rows = sum(min(n, cap) for n in kept)
    assert stats["padded_pct"] == pytest.approx(100.0 * (1 - rows / (cap * len(kept))))
    assert stats["cloud_counts"]["cloud.truncated_rows"] == sum(max(n - cap, 0) for n in kept)


def test_kept_rows_counts_what_extraction_keeps():
    cfg = tiny64(K.MAX_ROWS)
    sw = sweeps64(cfg.sensor, n=1)[0]
    ri = build_range_image(sw, cfg.sensor)
    cl, _, _ = preprocess_host.preprocess_host(ri.range_mm, ri.azimuth_rad, ri.vert_rad,
                                               cfg.preprocess)
    _, nv = engine_mod.host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad, None, cfg)
    assert engine_mod.kept_rows(cl, ri.range_mm, None) == nv
    sel = np.zeros(cl.shape, bool)
    sel[:, : N_AZ // 2] = True
    _, n_sel = engine_mod.host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad, sel, cfg)
    assert engine_mod.kept_rows(cl, ri.range_mm, sel) == n_sel < nv


# -- (d) chained frames against the benchmark's reference ----------------------


@pytest.mark.parametrize("pipelined", [False, True])
def test_three_chained_frames_against_the_reference(pipelined):
    """The tiny 64-ring cell's first three frames from its prefilled map, as
    one chain on each side, within `limits/hdl64e.replay.json`."""
    cell = tiny.tiny_cell(CELL)
    cfg = cell_mod.slam_config(cell.config)
    seeds = harness.run_seeds(2**31 + 64)
    sweeps = harness.drive(cell, torch.device("cpu"), seeds)
    rows = prefill.prefill_rows(
        cell.traffic["prefill_rows"], cfg.map.snap_mm, cfg.map.block_size_mm,
        cfg.descriptor.n_words, torch.Generator().manual_seed(seeds["prefill"]), "cpu")
    eng = SlamEngine(cfg, seed=seeds["engine"], device="cpu", tile=cfg.runtime.point_tile,
                     pipelined=pipelined, fetch_every=64 if pipelined else 1)
    eng.state = eng.state._replace(map=harness.prefilled_map(cfg, rows, "cpu"))
    eng._place_state()
    snaps = {}
    for k, sw in enumerate(sweeps[:3]):
        ri = build_range_image(sw, cfg.sensor)
        cloud = engine_mod.host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad, None, cfg)
        before = harness.clone_state(eng.state)
        eng.process_sweep(sw)
        snaps[k] = (before, harness.clone_state(eng.state), cloud)
    eng.flush()
    assert len(eng.records) == 3 and eng.n_redispatched == 0
    out = check_mod.check(cell.config, sweeps, rows, snaps, eng.records, seeds["engine"],
                          "cpu", cell.limits, pass_frames=len(sweeps), log=lambda s: None)
    assert [f["chained"] for f in out["per_frame"]] == [True] * 3
    assert out["correct"], out["numbers"]
    assert out["readings"]["keypoints_gap_pct"] == 0.0
    assert out["readings"]["pose_median_gap_mm"] < 0.05


# -- (e) refusals and the CLI --------------------------------------------------


@pytest.fixture(scope="module")
def capture(tmp_path_factory):
    """A small HDL-32E capture on disk."""
    sensor = tc.SensorConfig(n_azimuth=64)
    sweeps, _ = synthetic.render_sequence(3, sensor, seed=3, n_firings=64)
    path = tmp_path_factory.mktemp("cap") / "cap.pcap"
    pcap.write_udp_payloads(str(path), velodyne.encode_packets(sweeps, sensor))
    return str(path), sweeps


@pytest.mark.parametrize("how", ["pcap", "udp"])
def test_cli_refuses_hdl64e_packets(capture, how):
    from bshot_slam_tpu_torch.tools import run_odometry

    args = [capture[0]] if how == "pcap" else ["--udp", "2368"]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert run_odometry.main(args + ["--sensor", "hdl64e", "--cpu"]) == 2
    assert "calibration" in err.getvalue() and "--synthetic" in err.getvalue()


REFUSERS = {
    "decode_packets": lambda cap, s: velodyne.decode_packets(
        velodyne.encode_packets(cap[1], tc.SensorConfig(n_azimuth=64)), s),
    "encode_packets": lambda cap, s: velodyne.encode_packets(cap[1], s),
    "decode_pcap_native": lambda cap, s: native_decoder.decode_pcap_native(cap[0], s),
    "NativeSweepStream": lambda cap, s: native_decoder.NativeSweepStream(cap[0], s),
    "UdpCapture": lambda cap, s: udp.UdpCapture(s, address="127.0.0.1", port=0),
}


@pytest.mark.parametrize("name", sorted(REFUSERS))
def test_decoders_refuse_a_64_ring_sensor(capture, name):
    with pytest.raises(ValueError, match="calibration"):
        REFUSERS[name](capture, tc.HDL64E_SENSOR)


def test_native_library_refuses_64_rings(capture):
    lib = native_decoder._load()
    path = capture[0].encode()
    good = lib.vd_decode_pcap(path, 32)
    assert good and good.contents.n_sweeps >= 1
    lib.vd_free(good)
    assert not lib.vd_decode_pcap(path, 64)
    row_of_ring = np.arange(64, dtype=np.int32)
    assert not lib.vd_stream_open(path, 64, N_AZ,
                                  row_of_ring.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                  ctypes.c_float(2.0), 0, 4)


def test_cli_runs_the_preset_on_synthetic_input_and_prints_the_counters(tmp_path,
                                                                         monkeypatch):
    from bshot_slam_tpu_torch.tools import run_odometry

    small = tiny64(4096)
    monkeypatch.setattr(tc, "hdl64e_config", lambda: small)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run_odometry.main(["--sensor", "hdl64e", "--synthetic", "2", "--n-azimuth",
                                  str(N_AZ), "--cpu", "--profile", str(tmp_path / "t")]) == 0
    text = out.getvalue()
    assert "2 frames in" in text and "clouds: padded" in text
    assert "0 frames truncated at max_points" in text
    for name in ("cloud.rows", "cloud.bucket_rows", "cloud.truncated_rows"):
        assert name in text


# -- (f) the cell's check catches the planted faults ----------------------------

# Run in a process of its own: a run refuses a process that has loaded JAX,
# and this one has (tests/conftest.py).
FAULT_RUNS = """
import json, sys
sys.path.insert(0, %r)
import torch
torch.set_num_threads(2)
from bshot_slam_tpu_torch.odometry import engine as engine_mod
from bshot_slam_tpu_torch.odometry import graphs as graphs_mod
from slambench import harness
from slambench.tests import tiny


def run():
    out = harness.run_cell(tiny.tiny_cell(%r), 2**31 + 99, 1.0, False, 0.0,
                           device="cpu", log=lambda s: None)
    return {"correct": out["correct"],
            "failing": sorted(k for k, v in out["check"].items() if v["value"] > v["limit"])}


def state_left_unchanged():
    orig = graphs_mod.Graphs.step

    def step(self, cfg, tile, state, ok, *args, **kwargs):
        before = graphs_mod.clone_tree(state)
        bufs, okb, diag = orig(self, cfg, tile, state, ok, *args, **kwargs)
        for b, s in zip(graphs_mod.leaves(bufs), graphs_mod.leaves(before)):
            b.copy_(s)
        return bufs, okb, diag

    graphs_mod.Graphs.step = step
    return lambda: setattr(graphs_mod.Graphs, "step", orig)


def half_the_cloud():
    orig = engine_mod.host_cloud

    def host_cloud(*args, **kwargs):
        points, nv = orig(*args, **kwargs)
        points = points.copy()
        points[nv // 2:] = 0.0
        return points, nv // 2

    engine_mod.host_cloud = host_cloud
    return lambda: setattr(engine_mod, "host_cloud", orig)


out = {"sound": run()}
for fault in (state_left_unchanged, half_the_cloud):
    undo = fault()
    out[fault.__name__] = run()
    undo()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fault_runs():
    root = pathlib.Path(__file__).resolve().parents[1]
    p = subprocess.run([sys.executable, "-c", FAULT_RUNS % (str(root), CELL)],
                       capture_output=True, text=True, timeout=600, cwd=root)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault,number", [("state_left_unchanged", "map_rows_median_gap"),
                                          ("half_the_cloud", "cloud_gap_pct")])
def test_planted_fault_fails_the_cell(fault_runs, fault, number):
    """The tiny 64-ring cell, sound, reads within its limits; a step that
    leaves its state unchanged, or an ingest that drops half of each cloud,
    fails `correct` on the number that sees it."""
    assert fault_runs["sound"] == {"correct": True, "failing": []}
    assert not fault_runs[fault]["correct"] and number in fault_runs[fault]["failing"]


def test_control_fails_the_cell_on_the_cpu():
    """The reference with its cloud in bfloat16 in the program's place
    fails the cell's limits (the CPU has no TF32)."""
    torch.set_num_threads(2)
    cell = tiny.tiny_cell(CELL)
    r = control.readings(cell, [2**31 + 99], 1.0, device="cpu")
    ctrl = r["control"][0]
    assert any(ctrl[n] > cell.limits[n] for n in cell.limits)
