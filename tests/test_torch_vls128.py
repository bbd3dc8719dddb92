"""The VLS-128 preset (`config.vls128_config`, a Velodyne Alpha Prime as the
Boreas dataset carries it) on the CPU, and what it shares with the HDL-64E
preset (`config.hdl64e_config`), each such test run on both presets.

(a) The preset: 128 distinct angles in the datasheet's +15 to -25 deg with
    a central band at its 0.11 deg minimum, the range image's rows sorted,
    `max_points` 230400 (every ray of a sweep) within kernels A, B and H's
    `MAX_ROWS`, the cloud ladder continued past 131072 to 230400, the
    other settings those of `default_config()`, and the benchmark's
    configuration file the preset as run.
(b) Host ingest at 128 rings (few azimuth bins): the native binning bit
    for bit `ops.rangeimage`'s image, the native classes cell for cell the
    plain classify's, the same kept points in the same order within
    float32 rounding; the plain classify + extract bit-equal to
    `slambench/reference/ingest.py`; `pick_bucket` past 131072 as the
    reference picks.
(c) `frame_stats` counts the frames whose bucket passes the rows it is
    given (`NARROW_ROWS` in the CLI: A, B and H in their wide form) from
    the `cloud.bucket_rows` counter.
(d) Three chained frames of a tiny variant of each preset, synchronous and
    pipelined, against `slambench/reference/step.py` under the cell's
    limits.
(e) The packets of a 64- or 128-ring sensor are refused, with the reason:
    by `run_odometry.py --sensor` with a PCAP or `--udp`, the python
    decoder and encoder, the UDP capture and the native decode and stream,
    in Python and in the library itself; with `--synthetic` the CLI runs
    the preset and `--profile` prints the cloud counters.
(f) Each preset's tiny cell's check: a sound run within its limits; a
    step that leaves its state unchanged, an ingest that drops half of each
    cloud, and the control (the reference's cloud in bfloat16) each fail
    it.

The tests of what both presets share live here alone, each run on both.
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

N_AZ = 256


@dataclasses.dataclass(frozen=True)
class Preset:
    config: object  # the preset's constructor
    sensor: tc.SensorConfig
    n_firings: int  # firings a turn of the benchmark's configuration
    refusal: str  # what the decoders' refusal names


PRESETS = {
    "hdl64e": Preset(tc.hdl64e_config, tc.HDL64E_SENSOR, 2083, "calibration"),
    "vls128": Preset(tc.vls128_config, tc.VLS128_SENSOR, 1800, "packet decoder"),
}


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


def tiny_of(name: str, max_points: int = 2048) -> tc.SlamConfig:
    """`tiny_config`'s sizes on the preset's sensor (few azimuth bins), car
    box, sensor height and cloud ladder."""
    full, t = PRESETS[name].config(), tc.tiny_config()
    return t.replace(
        sensor=dataclasses.replace(full.sensor, n_azimuth=N_AZ),
        preprocess=dataclasses.replace(full.preprocess, max_points=max_points),
        runtime=dataclasses.replace(t.runtime, cloud_buckets=full.runtime.cloud_buckets))


def reference_cfg(cfg: tc.SlamConfig):
    """The reference's view of `cfg` (the configuration file's form)."""
    return ref_config.from_json(
        {s: dataclasses.asdict(getattr(cfg, s)) for s in ref_config.SECTIONS})


def sweeps_of(cfg: tc.SlamConfig, n: int = 3, n_firings: int = 241):
    """Sweeps of `default_scene(0)` at the preset's height, fewer firings
    than bins as each sensor's turn in 2176."""
    poses = synthetic.straight_trajectory(
        n, 400.0, sensor_height_mm=cfg.preprocess.sensor_height_mm, yaw_rate_rad=0.05)
    scene = synthetic.default_scene(0)
    return [synthetic.render_sweep(scene, cfg.sensor, p, noise_mm=20.0, seed=i,
                                   n_firings=n_firings) for i, p in enumerate(poses)]


# -- (a) the preset -----------------------------------------------------------


def test_vls128_angles_in_the_datasheet_envelope():
    s = tc.VLS128_SENSOR
    a = np.asarray(s.vertical_angles_deg)
    assert s.name == "VLS-128" and s.n_rings == 128 and a.shape == (128,)
    assert s.distance_scale_mm == 2.0
    assert len(set(a.tolist())) == 128
    assert a.max() == 15.0 and a.min() == pytest.approx(-25.0)
    assert np.all(a >= -25.0 - 1e-9) and np.all(a <= 15.0)
    gaps = -np.diff(a)  # descending firing order
    assert np.all(gaps > 0)
    np.testing.assert_allclose(gaps[32:95], 0.11, atol=1e-12)  # the central band
    assert a[32] == 3.0 and a[95] == pytest.approx(-3.93)
    assert gaps.min() == pytest.approx(0.11)  # the datasheet's finest spacing
    assert s.n_azimuth >= 1800  # a bin for every firing of a turn


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_rows_sorted(name):
    s = PRESETS[name].sensor
    vert = sorted_vertical_angles_rad(s)
    assert vert.shape == (s.n_rings,) and np.all(np.diff(vert) > 0)
    # each ring lands on the row of its angle's rank
    small = dataclasses.replace(s, n_azimuth=N_AZ)
    sw = sweeps_of(tiny_of(name), n=1)[0]
    ri = build_range_image(sw, small)
    rank = np.argsort(np.argsort(s.vertical_angles_deg))
    for ring in (0, 31, 32, s.n_rings // 2, s.n_rings - 1):
        hits = np.flatnonzero((sw.ring == ring) & (sw.distance > 0))
        col = int(sw.azimuth_deg[hits[0]] / 360.0 * N_AZ)
        d = sw.distance[hits[0]] * s.distance_scale_mm
        assert ri.range_mm[rank[ring], col] == np.float32(d)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_fits_kernels_a_b_and_h(name):
    cfg = PRESETS[name].config()
    ladder = cfg.runtime.cloud_buckets
    assert cfg.preprocess.max_points <= K.MAX_ROWS
    assert list(ladder) == sorted(set(ladder)) and ladder[-1] == cfg.preprocess.max_points
    assert ladder[:len(tc.RuntimeConfig().cloud_buckets)] == tc.RuntimeConfig().cloud_buckets
    assert {65536, 98304, 131072} <= set(ladder)
    if name == "hdl64e":
        assert cfg.preprocess.max_points == K.NARROW_ROWS == 131072
    else:  # every ray of a sweep: 128 x 1800, so no frame is cut
        assert cfg.preprocess.max_points == 230400 == 128 * PRESETS[name].n_firings
        assert [b for b in ladder if b > K.NARROW_ROWS] == [163840, 196608, 230400]
        assert ladder[:len(tc.hdl64e_config().runtime.cloud_buckets)] == \
            tc.hdl64e_config().runtime.cloud_buckets


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_keeps_the_default_settings(name):
    cfg, d = PRESETS[name].config(), tc.default_config()
    for section in ("keypoints", "descriptor", "match", "map", "backend"):
        assert getattr(cfg, section) == getattr(d, section)
    p = cfg.preprocess
    height, box = {"hdl64e": (1730.0, ((-910.0, 910.0), (-2390.0, 2390.0),
                                        (-1730.0, 100.0))),
                   "vls128": (2000.0, ((-950.0, 950.0), (-2450.0, 2450.0),
                                        (-2000.0, 100.0)))}[name]
    assert p.sensor_height_mm == height and (p.car_x_mm, p.car_y_mm, p.car_z_mm) == box
    assert dataclasses.replace(p, sensor_height_mm=2450.0, max_points=49152,
                               car_x_mm=d.preprocess.car_x_mm,
                               car_y_mm=d.preprocess.car_y_mm,
                               car_z_mm=d.preprocess.car_z_mm) == d.preprocess
    assert d.preprocess.max_points == 49152 and d.sensor.n_rings == 32


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_benchmark_file_is_the_preset(name):
    cell = cell_mod.load(f"{name}.replay")
    assert cell_mod.slam_config(cell.config) == PRESETS[name].config()
    assert cell.config["reduced"] == [] and cell.config["n_firings"] == PRESETS[name].n_firings
    assert cell.chips == 1 and cell.traffic == cell_mod.load("hdl32e.replay").traffic


# -- (b) host ingest ----------------------------------------------------------


@pytest.mark.parametrize("max_points", [1800, 4096])
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_host_ingest_matches_the_reference(name, max_points):
    cfg = tiny_of(name, max_points)
    rcfg = reference_cfg(cfg)
    for sw in sweeps_of(cfg):
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


@pytest.mark.parametrize("selected", [False, True])
def test_native_ingest_at_128_rings_is_the_plain_one(selected):
    """128 rings x 256 bins: the library's binning is `ops.rangeimage`'s
    image bit for bit (a select list too), its classes the plain
    classify's cell for cell, and its cloud the plain extract's points in
    the same order within float32 rounding."""
    cfg = tiny_of("vls128", 128 * N_AZ)
    sw = sweeps_of(cfg, n=1, n_firings=N_AZ - 3)[0]
    sel = (np.random.default_rng(5).choice(len(sw), len(sw) // 3, replace=False)
           if selected else None)
    got = native_decoder.build_range_image(sw, cfg.sensor, sel)
    want = build_range_image(sw, cfg.sensor, sel)
    assert got.range_mm.shape == (128, N_AZ)
    for field in ("range_mm", "azimuth_rad", "vert_rad", "selected"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), field
    pcfg = cfg.preprocess
    cls_h, xyz_h, valid_h = preprocess_host.preprocess_host(
        want.range_mm, want.azimuth_rad, want.vert_rad, pcfg)
    pts_h, nv_h = preprocess_host.extract_cloud_host(cls_h, xyz_h, valid_h,
                                                     want.selected, pcfg.max_points)
    pts_n, nv_n, cls_n = native_decoder.preprocess_extract_native(
        want.range_mm, want.azimuth_rad, want.vert_rad, pcfg, want.selected,
        pcfg.max_points)
    np.testing.assert_array_equal(cls_n, cls_h)
    assert nv_n == nv_h > 1000
    np.testing.assert_allclose(pts_n[:nv_n], pts_h[:nv_h], rtol=0, atol=0.05)


@pytest.mark.parametrize("n,bucket", [(131072, 131072), (131073, 163840), (163840, 163840),
                                      (163841, 196608), (196609, 230400), (208472, 230400),
                                      (230400, 230400), (240000, 230400)])
def test_pick_bucket_past_131072(n, bucket):
    cfg = tc.vls128_config()
    assert pick_bucket(n, cfg) == bucket
    assert ingest.pick_bucket(n, cfg.runtime.cloud_buckets, cfg.preprocess.max_points) == bucket


# -- (c) the cloud counters ---------------------------------------------------


def test_wide_frames_count_buckets_past_narrow_rows():
    """`frame_stats`' `wide_frames`: the frames whose `cloud.bucket_rows`
    passes the rows it is given (`NARROW_ROWS` in the CLI), here a tiny
    ladder's middle bucket; without rows it counts none."""
    cfg = tiny_of("vls128", 8192)
    sweeps = [sweeps_of(cfg, n=1, n_firings=f)[0] for f in (40, 241, 120)]
    kept = [ingest.host_cloud(sw.azimuth_deg, sw.ring, sw.distance, reference_cfg(cfg))[1]
            for sw in sweeps]
    ladder = tuple(sorted({-(-n // 256) * 256 for n in kept}))
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime, cloud_buckets=ladder))
    buckets = [pick_bucket(n, cfg) for n in kept]
    cut = sorted(buckets)[len(buckets) // 2] - 1
    assert min(buckets) <= cut < max(buckets)  # frames on both sides
    RECORDER.enable("cpu")
    eng = SlamEngine(cfg, seed=0, device="cpu", tile=cfg.runtime.point_tile)
    for sw in sweeps:
        eng.process_sweep(sw)
    RECORDER.disable()
    stats = profiling.frame_stats(RECORDER.records(), {eng.serial}, wide_rows=cut)
    assert stats["wide_frames"] == sum(b > cut for b in buckets)
    assert stats["cloud_counts"]["cloud.bucket_rows"] == sum(buckets)
    assert profiling.frame_stats(RECORDER.records(), {eng.serial})["wide_frames"] is None


WIDE_NAMES = {  # names of both forms as torch.profiler gives them on the card
    "void (anonymous namespace)::wide::accumulate_kernel<12>(float4 const*, float const*)": 0.5,
    "void (anonymous namespace)::accumulate_kernel<12>(float4 const*, float const*)": 0.25,
    "(anonymous namespace)::wide::pack_cloud_kernel(float const*, unsigned char const*)": 0.01,
    "void (anonymous namespace)::wide::segratio_kernel<false>(float4 const*)": 0.4,
    "(anonymous namespace)::wide::shot_pack_kernel(float const*, unsigned char const*)": 0.002,
    "(anonymous namespace)::shot_select_kernel(float const*, unsigned char const*)": 0.008,
    "(anonymous namespace)::eig3_kernel(float const*, float*, float*, int)": 0.001,
    "void at::native::vectorized_elementwise_kernel<4>(int)": 0.3,
}


def test_neighborhood_metrics_read_both_forms():
    """`neighborhood_*.replay` read A's, B's and H's kernels in both forms
    (and no other), `kernels_*.replay` still find A and B in the wide form,
    and a run without a profiled slice reads nothing."""
    from slambench import neighborhood, readers, trace, yardstick

    cell = cell_mod.load("vls128.replay")
    frames = [dict(points=150000, in_radius=8.0e9, keypoints=600, window_rows=2000,
                   icp_iterations=10)] * 2
    run = trace.Run(cell=cell, frames=2, window_s=1.0, setup_s=1.0, spans={},
                    n_redispatched=0, captures_in_window=0,
                    profile={"frames": 2, "by_kernel": WIDE_NAMES},
                    counts={"frames": frames, "window_rows": 2000})
    spent = 0.5 + 0.25 + 0.01 + 0.4 + 0.002 + 0.008
    assert neighborhood.ms_per_frame(run) == pytest.approx(spent / 2 * 1e3)
    least = 0.0
    for f in frames:
        work = yardstick.frame_work(**f)
        h = (150000 * 16 + 600 * 384 * 8, {"f32": 8.0 * 600 * 150000})
        least += sum(yardstick.bound_s(*w)[0] for w in (work["A"], work["B"], h))
    assert neighborhood.roofline_pct(run) == pytest.approx(least / spent * 100.0)
    assert readers.kernel_seconds(run) == pytest.approx({"A": 0.76, "B": 0.4})
    empty = dataclasses.replace(run, profile=None, counts=None)
    assert neighborhood.ms_per_frame(empty) is None
    assert neighborhood.roofline_pct(empty) is None


# -- (d) chained frames against the benchmark's reference ----------------------


@pytest.mark.parametrize("pipelined", [False, True])
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_three_chained_frames_against_the_reference(name, pipelined):
    """The tiny cell's first three frames from its prefilled map, as one
    chain on each side, within `limits/<cell>.json`."""
    cell = tiny.tiny_cell(f"{name}.replay")
    cfg = cell_mod.slam_config(cell.config)
    seeds = harness.run_seeds(2**31 + PRESETS[name].sensor.n_rings)
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
    assert all(c[1] > 0 for _, _, c in snaps.values())
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
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_cli_refuses_the_preset_packets(capture, name, how):
    from bshot_slam_tpu_torch.tools import run_odometry

    args = [capture[0]] if how == "pcap" else ["--udp", "2368"]
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert run_odometry.main(args + ["--sensor", name, "--cpu"]) == 2
    assert PRESETS[name].refusal in err.getvalue() and "--synthetic" in err.getvalue()


REFUSERS = {
    "decode_packets": lambda cap, s: velodyne.decode_packets(
        velodyne.encode_packets(cap[1], tc.SensorConfig(n_azimuth=64)), s),
    "encode_packets": lambda cap, s: velodyne.encode_packets(cap[1], s),
    "decode_pcap_native": lambda cap, s: native_decoder.decode_pcap_native(cap[0], s),
    "NativeSweepStream": lambda cap, s: native_decoder.NativeSweepStream(cap[0], s),
    "UdpCapture": lambda cap, s: udp.UdpCapture(s, address="127.0.0.1", port=0),
}


@pytest.mark.parametrize("refuser", sorted(REFUSERS))
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_decoders_refuse_the_preset_sensor(capture, name, refuser):
    with pytest.raises(ValueError, match=PRESETS[name].refusal):
        REFUSERS[refuser](capture, PRESETS[name].sensor)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_native_library_refuses_the_preset_rings(capture, name):
    lib = native_decoder._load()
    path = capture[0].encode()
    rings = PRESETS[name].sensor.n_rings
    good = lib.vd_decode_pcap(path, 32)
    assert good and good.contents.n_sweeps >= 1
    lib.vd_free(good)
    assert not lib.vd_decode_pcap(path, rings)
    row_of_ring = np.arange(rings, dtype=np.int32)
    assert not lib.vd_stream_open(path, rings, N_AZ,
                                  row_of_ring.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                                  ctypes.c_float(2.0), 0, 4)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_cli_runs_the_preset_on_synthetic_input_and_prints_the_counters(
        tmp_path, monkeypatch, name):
    from bshot_slam_tpu_torch.tools import run_odometry

    small = tiny_of(name, 4096 if name == "hdl64e" else 16384)  # every kept point
    monkeypatch.setattr(tc, PRESETS[name].config.__name__, lambda: small)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert run_odometry.main(["--sensor", name, "--synthetic", "2", "--n-azimuth",
                                  str(N_AZ), "--cpu", "--profile", str(tmp_path / "t")]) == 0
    text = out.getvalue()
    assert "2 frames in" in text and "clouds: padded" in text
    assert "0 frames truncated at max_points, 0 past 131072 rows" in text
    for counter in ("cloud.rows", "cloud.bucket_rows", "cloud.truncated_rows"):
        assert counter in text


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


@pytest.fixture(scope="module", params=sorted(PRESETS))
def fault_runs(request):
    """The preset's tiny cell run sound and under each planted fault."""
    root = pathlib.Path(__file__).resolve().parents[1]
    cell = f"{request.param}.replay"
    p = subprocess.run([sys.executable, "-c", FAULT_RUNS % (str(root), cell)],
                       capture_output=True, text=True, timeout=600, cwd=root)
    assert p.returncode == 0, p.stderr[-2000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault,number", [("state_left_unchanged", "map_rows_median_gap"),
                                          ("half_the_cloud", "cloud_gap_pct")])
def test_planted_fault_fails_the_cell(fault_runs, fault, number):
    """The tiny cell, sound, reads within its limits; a step that leaves its
    state unchanged, or an ingest that drops half of each cloud, fails
    `correct` on the number that sees it."""
    assert fault_runs["sound"] == {"correct": True, "failing": []}
    assert not fault_runs[fault]["correct"] and number in fault_runs[fault]["failing"]


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_control_fails_the_cell_on_the_cpu(name):
    """The reference with its cloud in bfloat16 in the program's place
    fails the cell's limits (the CPU has no TF32)."""
    torch.set_num_threads(2)
    cell = tiny.tiny_cell(f"{name}.replay")
    r = control.readings(cell, [2**31 + 99], 1.0, device="cpu")
    ctrl = r["control"][0]
    assert any(ctrl[n] > cell.limits[n] for n in cell.limits)
