"""The port's host ingest against the reference, on the CPU.

(a) The copies: `io/pcap.py` writes the same bytes and reads the same
    payloads as the reference's; `utils/trajectory.py` writes the same text;
    `io/udp.py`'s capture thread turns loopback datagrams into complete
    sweeps and `close()` stops it (as tests/test_io.py does for the
    reference).
(b) The native library, built by g++ from the port's own copy of the
    source into build/native/ (never the committed native/*.so), against
    the reference's python decoder and numpy preprocess, at the reference's
    tolerances (tests/test_native_decoder.py): decoded range images within
    1e-3 mm, azimuths within 1e-5 rad, classes cell-exact, kept counts
    equal, points within 0.05 mm, at any gradient threshold; packet
    pathologies are skipped as the python decoder skips them.  The
    library's range-image binning is `ops.rangeimage`'s bit for bit (16,
    32 and 64 rings, select lists, shared bins), and hands what it does not
    take to it.
(c) Garbage returns None or raises as the reference's does; a source that
    does not compile raises with the compiler's output.
(d) The engine's `process_sweep` bins and classifies in the library, and
    its records equal those of the engine fed the native clouds directly.
"""

import dataclasses
import pathlib
import socket
import struct
import time

import numpy as np
import pytest
import torch

import bshot_slam_tpu.config as jc
import bshot_slam_tpu_torch.config as tc
from bshot_slam_tpu.io import pcap as jpcap
from bshot_slam_tpu.io import synthetic as jsyn
from bshot_slam_tpu.io import velodyne as jvel
from bshot_slam_tpu.ops import preprocess_host as jph
from bshot_slam_tpu.ops.rangeimage import build_range_image as jbuild
from bshot_slam_tpu.utils import trajectory as jtraj
from bshot_slam_tpu_torch.io import native_decoder as nd
from bshot_slam_tpu_torch.io import pcap, synthetic, velodyne
from bshot_slam_tpu_torch.odometry import engine as tengine
from bshot_slam_tpu_torch.ops import preprocess_host as ph
from bshot_slam_tpu_torch.ops import rangeimage
from bshot_slam_tpu_torch.ops.rangeimage import build_range_image
from bshot_slam_tpu_torch.utils import trajectory

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "tests" / "fixtures" / "golden.pcap"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other engine test files use."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _capture(tmp_path, n_frames=3, n_az=96, seed=5):
    sensor = tc.SensorConfig(n_azimuth=n_az)
    sweeps, _ = synthetic.render_sequence(n_frames, sensor, seed=seed, n_firings=n_az)
    payloads = velodyne.encode_packets(sweeps, sensor)
    path = str(tmp_path / "cap.pcap")
    pcap.write_udp_payloads(path, payloads)
    return path, sensor, payloads


def _python_sweeps(path, sensor, skip=0):
    """The reference's python decode of a capture."""
    payloads, _ = jpcap.read_udp_payloads(path)
    return jvel.sweeps_from_payloads(payloads, jc.SensorConfig(n_azimuth=sensor.n_azimuth),
                                     skip=skip)


# -- (a) the copies ----------------------------------------------------------


def test_pcap_bytes_and_payloads_equal_reference(tmp_path):
    sensor = tc.SensorConfig(n_azimuth=64)
    sweeps, _ = synthetic.render_sequence(2, sensor, seed=1, n_firings=64)
    payloads = velodyne.encode_packets(sweeps, sensor)
    ts = np.arange(payloads.shape[0], dtype=np.int64) * 777 + 10**6
    mine, ref = tmp_path / "port.pcap", tmp_path / "ref.pcap"
    pcap.write_udp_payloads(str(mine), payloads, ts)
    jpcap.write_udp_payloads(str(ref), payloads, ts)
    assert mine.read_bytes() == ref.read_bytes()
    got, got_ts = pcap.read_udp_payloads(str(ref))
    want, want_ts = jpcap.read_udp_payloads(str(ref))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_ts, want_ts)
    np.testing.assert_array_equal(got, payloads)
    # The encoder is the port's copy too: the reference encodes the same bytes.
    jsweeps, _ = jsyn.render_sequence(2, jc.SensorConfig(n_azimuth=64), seed=1,
                                      n_firings=64)
    np.testing.assert_array_equal(
        jvel.encode_packets(jsweeps, jc.SensorConfig(n_azimuth=64)), payloads)


def test_trajectory_text_equal_reference(tmp_path):
    pos = np.random.default_rng(0).uniform(-1e5, 1e5, (7, 3))
    mine, ref = tmp_path / "port.txt", tmp_path / "ref.txt"
    trajectory.save_xyz(str(mine), pos)
    jtraj.save_xyz(str(ref), pos)
    assert mine.read_text() == ref.read_text()
    np.testing.assert_array_equal(trajectory.load_xyz(str(ref)), jtraj.load_xyz(str(ref)))
    np.testing.assert_allclose(trajectory.load_xyz(str(mine)), pos)


def test_udp_capture_loopback():
    """Datagrams in, complete sweeps out of the queue, the incomplete tail
    never emitted; `close()` ends the capture thread."""
    from bshot_slam_tpu_torch.io.udp import UdpCapture

    sensor = tc.default_config().sensor
    sweeps, _ = synthetic.render_sequence(3, sensor, seed=2, n_firings=96)
    pkts = velodyne.encode_packets(sweeps, sensor)
    cap = UdpCapture(sensor, address="127.0.0.1", port=0, packets_per_batch=4)
    try:
        tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        for p in pkts:
            tx.sendto(p.tobytes(), ("127.0.0.1", cap.port))
            time.sleep(0.001)
        tx.close()
        got = []
        deadline = time.time() + 10.0
        while len(got) < 2 and time.time() < deadline:
            sw = cap.retrieve(timeout=0.2)
            if sw is not None:
                got.append(sw)
        assert len(got) >= 2  # 3 rotations sent; the last is an open tail
        want = velodyne.sweeps_from_payloads(pkts, sensor)
        for sw, ref in zip(got, want):
            assert (np.diff(sw.azimuth_deg) >= 0).all()
            np.testing.assert_array_equal(sw.distance, ref.distance)
        assert cap.is_run()
    finally:
        cap.close()
    assert not cap.is_run()


# -- (b) the native library --------------------------------------------------


def test_library_built_from_the_ports_source():
    lib = nd._load()
    built = pathlib.Path(lib._name)
    assert built.parent == ROOT / "build" / "native"
    assert built.name.startswith("velodyne_decoder-")
    assert nd.SOURCE == ROOT / "bshot_slam_tpu_torch" / "native" / "velodyne_decoder.cpp"
    assert not any("march" in f for f in nd.GXX_FLAGS)
    assert nd.is_available() and nd.stream_available()


def test_native_decode_matches_reference_python(tmp_path):
    path, sensor, _ = _capture(tmp_path)
    native = nd.decode_pcap_native(path, sensor)
    python = _python_sweeps(path, sensor)
    assert native is not None and len(native) == len(python) > 0
    jsensor = jc.SensorConfig(n_azimuth=sensor.n_azimuth)
    for a, b in zip(native, python):
        ra, rb = build_range_image(a, sensor), jbuild(b, jsensor)
        np.testing.assert_allclose(ra.range_mm, rb.range_mm, atol=1e-3)
        np.testing.assert_allclose(ra.azimuth_rad, rb.azimuth_rad, atol=1e-5)
    skipped = nd.decode_pcap_native(path, sensor, skip=1)
    assert len(skipped) == len(native) - 1
    np.testing.assert_array_equal(skipped[0].distance, native[1].distance)


def test_native_stream_matches_reference_python():
    """The C++ producer thread bins each rotation as the reference's python
    decode + build_range_image does, frame for frame; skip and an early
    close work."""
    sensor = tc.SensorConfig(n_azimuth=512)
    jsensor = jc.SensorConfig(n_azimuth=512)
    golds = [jbuild(sw, jsensor) for sw in _python_sweeps(str(GOLDEN), sensor)]
    native = list(nd.NativeSweepStream(str(GOLDEN), sensor))
    assert len(native) >= len(golds) > 0
    for ri_n, ri_p in zip(native[len(native) - len(golds):], golds):
        np.testing.assert_allclose(ri_n.range_mm, ri_p.range_mm, atol=1e-3)
        np.testing.assert_allclose(ri_n.azimuth_rad, ri_p.azimuth_rad, atol=1e-5)
        np.testing.assert_allclose(ri_n.vert_rad, ri_p.vert_rad, atol=1e-7)
    skipped = list(nd.NativeSweepStream(str(GOLDEN), sensor, skip=2))
    assert len(skipped) == len(native) - 2
    s = nd.NativeSweepStream(str(GOLDEN), sensor, queue=1)
    next(iter(s))
    s.close()  # while the producer may still be ahead: must not hang


@pytest.fixture(scope="module")
def preprocess_cases():
    rng = np.random.default_rng(3)
    sensor = jc.SensorConfig(n_azimuth=512)
    sweeps, _ = jsyn.render_sequence(2, sensor, seed=9, n_firings=512)
    cases = []
    for sw in sweeps:
        ri = jbuild(sw, sensor)
        cases.append((ri.range_mm, ri.azimuth_rad, ri.vert_rad, None))
    adv, _ = jsyn.render_sequence(1, sensor, seed=4, n_firings=512, adversarial=True)
    ri = jbuild(adv[0], sensor)
    cases.append((ri.range_mm, ri.azimuth_rad, ri.vert_rad, ri.selected))
    R, A = sensor.n_rings, sensor.n_azimuth
    r = rng.uniform(0, 40000, (R, A)).astype(np.float32)
    r[rng.random((R, A)) < 0.3] = 0.0
    az = np.broadcast_to(
        np.linspace(0, 2 * np.pi, A, endpoint=False, dtype=np.float32), (R, A)).copy()
    vert = np.deg2rad(np.sort(np.asarray(sensor.vertical_angles_deg))).astype(np.float32)
    cases.append((r, az, vert, None))
    cases.append((r, az, vert, rng.random((R, A)) < 0.5))
    return cases


@pytest.mark.parametrize("case", range(5), ids=["drive0", "drive1", "adversarial",
                                                  "random", "random_selected"])
def test_native_preprocess_matches_reference_numpy(preprocess_cases, case):
    r_mm, a_rad, v_rad, selected = preprocess_cases[case]
    pcfg = jc.PreprocessConfig()
    cls_h, xyz_h, valid_h = jph.preprocess_host(r_mm, a_rad, v_rad, pcfg)
    pts_h, nv_h = jph.extract_cloud_host(cls_h, xyz_h, valid_h, selected, pcfg.max_points)
    pts_n, nv_n, cls_n = nd.preprocess_extract_native(
        r_mm, a_rad, v_rad, tc.PreprocessConfig(), selected, pcfg.max_points)
    np.testing.assert_array_equal(cls_n, cls_h)
    assert nv_n == nv_h > 0
    np.testing.assert_allclose(pts_n, pts_h, rtol=0, atol=0.05)


def _bin_case(name):
    """(sweep, sensor, selected indices) of a range-image binning case."""
    sensor = {"vlp16": tc.VLP16_SENSOR, "hdl64e": tc.HDL64E_SENSOR}.get(
        name.split("_")[0], tc.SensorConfig())
    n_firings = {"hdl64e": 2083, "vlp16": 1800}.get(name.split("_")[0], 2176)
    if name.endswith("collisions"):
        sensor, n_firings = dataclasses.replace(sensor, n_azimuth=256), 700
    sw = synthetic.render_sweep(synthetic.default_scene(0), sensor,
                                synthetic.straight_trajectory(2, 400.0)[1], noise_mm=10.0,
                                seed=2, n_firings=n_firings)
    sel = None
    if name.endswith("selected"):
        sel = np.random.default_rng(5).choice(len(sw), len(sw) // 3, replace=False)
    if name.endswith("float32"):
        sw.azimuth_deg = sw.azimuth_deg.astype(np.float32)
    if name.endswith("negative"):
        sw.azimuth_deg = sw.azimuth_deg - 1.0
    if name.endswith("nan"):
        sw.azimuth_deg = sw.azimuth_deg.copy()
        sw.azimuth_deg[len(sw) // 2] = np.nan
    if name.endswith("empty"):
        sw = velodyne.LaserSweep(sw.azimuth_deg[:0], sw.ring[:0], sw.distance[:0],
                                 sw.intensity[:0], timestamp_us=7)
    return sw, sensor, sel


@pytest.mark.parametrize("name", ["hdl32e", "vlp16", "hdl64e", "hdl32e_selected",
                                  "hdl64e_selected", "hdl32e_collisions", "hdl32e_float32",
                                  "hdl32e_empty"])
def test_native_range_image_is_the_numpy_one(name):
    """The engine's binning in the library gives `ops.rangeimage`'s image
    bit for bit: 16, 32 and 64 rings, select lists, firings sharing a bin,
    a sweep with no firing.  Arrays in other dtypes are binned in the
    decoders' dtypes (float32 azimuths as their float64 values)."""
    sw, sensor, sel = _bin_case(name)
    got = nd.build_range_image(sw, sensor, sel)
    sw.azimuth_deg = sw.azimuth_deg.astype(np.float64)
    want = build_range_image(sw, sensor, sel)
    for field in ("range_mm", "azimuth_rad", "vert_rad", "selected"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), field
    assert got.timestamp_us == want.timestamp_us


def test_native_range_image_refuses_a_ring_outside_the_sensor():
    sw, sensor, _ = _bin_case("hdl32e")
    sw.ring = sw.ring.copy()
    sw.ring[5] = sensor.n_rings
    with pytest.raises(IndexError):
        build_range_image(sw, sensor)
    with pytest.raises(IndexError):
        nd.build_range_image(sw, sensor)


@pytest.mark.parametrize("name", ["hdl32e_negative", "hdl32e_nan"])
def test_native_range_image_refuses_an_azimuth_outside_the_turn(name):
    """An azimuth below 0 (which numpy's indexing would wrap into the last
    columns) or not a number is refused, with no image."""
    sw, sensor, _ = _bin_case(name)
    with pytest.raises(ValueError, match="azimuth"):
        nd.build_range_image(sw, sensor)


@pytest.mark.parametrize("grad_th", [10.0, 30.0, 45.0, 60.0, 70.0, -30.0, -79.0])
def test_native_classify_at_any_gradient_threshold(preprocess_cases, grad_th):
    """The library settles the gradient test from s = sin(gradient) away
    from the threshold and runs asin only near it: classes cell-exact with
    the plain version's, which runs asin everywhere.  (From 75 degrees up
    the two part on 2 cells of the 64-ring sweep whether or not the band is
    used: asinf times 57.29578f against numpy's degrees(arcsin).)"""
    sensor = tc.HDL64E_SENSOR
    sw = synthetic.render_sweep(synthetic.adversarial_scene(2), sensor,
                                synthetic.straight_trajectory(2, 400.0,
                                                              sensor_height_mm=1730.0)[1],
                                noise_mm=20.0, seed=3, n_firings=2083, self_car=True)
    ri = build_range_image(sw, sensor)
    cases = [(ri.range_mm, ri.azimuth_rad, ri.vert_rad, None)] + preprocess_cases[3:]
    pcfg = dataclasses.replace(tc.hdl64e_config().preprocess, grad_th_deg=grad_th)
    for r_mm, a_rad, v_rad, selected in cases:
        cls_h, xyz_h, valid_h = ph.preprocess_host(r_mm, a_rad, v_rad, pcfg)
        pts_h, nv_h = ph.extract_cloud_host(cls_h, xyz_h, valid_h, selected,
                                            pcfg.max_points)
        pts_n, nv_n, cls_n = nd.preprocess_extract_native(r_mm, a_rad, v_rad, pcfg,
                                                          selected, pcfg.max_points)
        np.testing.assert_array_equal(cls_n, cls_h)
        assert nv_n == nv_h > 0
        np.testing.assert_allclose(pts_n, pts_h, rtol=0, atol=0.05)


@pytest.mark.parametrize("cap", [1, 1000, 8000])
def test_native_extract_cut_at_a_cap_is_the_head_of_the_whole(cap):
    """The library walks the image row by row but emits the kept points
    azimuth-major: a cloud cut at `cap` is the first `cap` points of the
    uncut one, bit for bit, and the classes do not depend on the cap."""
    sensor = tc.HDL64E_SENSOR
    sw = synthetic.render_sweep(synthetic.default_scene(1), sensor,
                                synthetic.straight_trajectory(2, 400.0,
                                                              sensor_height_mm=1730.0)[1],
                                noise_mm=20.0, seed=5, n_firings=2083)
    ri = build_range_image(sw, sensor)
    pcfg = tc.hdl64e_config().preprocess
    args = (ri.range_mm, ri.azimuth_rad, ri.vert_rad, pcfg, ri.selected)
    pts, nv, cls = nd.preprocess_extract_native(*args, pcfg.max_points)
    pts_c, nv_c, cls_c = nd.preprocess_extract_native(*args, cap)
    assert nv > 8000 and nv_c == cap
    assert pts_c.tobytes() == pts[:cap].tobytes()
    np.testing.assert_array_equal(cls_c, cls)


def test_packet_pathologies_skipped_as_reference(tmp_path):
    """Wrong sensor type, a corrupt block marker, an impossible azimuth and a
    truncated record: the native decoder keeps what the reference's python
    decoder keeps."""
    path, sensor, payloads = _capture(tmp_path)
    bad = payloads.copy()
    pk = bad.view(velodyne._PACKET_DTYPE).reshape(bad.shape[0])
    pk[1]["sensor_type"] = 0x99
    pk[3]["firings"][2]["block_id"] = 0x1234
    pk[4]["firings"][0]["azimuth"] = 40000
    bad_path = str(tmp_path / "bad.pcap")
    pcap.write_udp_payloads(bad_path, bad)
    with open(bad_path, "ab") as f:
        n = 42 + 600
        f.write(struct.pack("<IIII", 0, 0, n, n) + b"\x00" * n)
    python = _python_sweeps(bad_path, sensor)
    native = nd.decode_pcap_native(bad_path, sensor)
    assert native is not None and len(native) == len(python) > 0
    jsensor = jc.SensorConfig(n_azimuth=sensor.n_azimuth)
    for a, b in zip(native, python):
        np.testing.assert_allclose(build_range_image(a, sensor).range_mm,
                                   jbuild(b, jsensor).range_mm)
    clean = sum(len(s) for s in nd.decode_pcap_native(path, sensor))
    assert sum(len(s) for s in native) < clean


# -- (c) garbage and failed builds -------------------------------------------


def test_garbage_returns_none_or_raises(tmp_path):
    sensor = tc.default_config().sensor
    garbage = tmp_path / "garbage.pcap"
    garbage.write_bytes(b"this is not a pcap file at all, sorry" * 10)
    trunc = tmp_path / "trunc.pcap"
    trunc.write_bytes(b"\xd4\xc3\xb2\xa1" + b"\x00" * 20)  # a header, no records
    empty = tmp_path / "empty.pcap"
    empty.write_bytes(b"")
    with pytest.raises(ValueError):
        pcap.read_udp_payloads(str(garbage))
    for p in (empty, trunc):
        assert len(pcap.read_udp_payloads(str(p))[0]) == 0
    for p in (garbage, empty, tmp_path / "missing.pcap"):
        assert nd.decode_pcap_native(str(p), sensor) is None
        with pytest.raises(RuntimeError):
            nd.NativeSweepStream(str(p), sensor)
    assert nd.decode_pcap_native(str(trunc), sensor) == []
    assert list(nd.NativeSweepStream(str(trunc), sensor)) == []
    img = np.zeros((sensor.n_rings, 16), np.float32)
    with pytest.raises(ValueError):
        nd.preprocess_extract_native(img, img[:, :8], img[:, 0],
                                     tc.PreprocessConfig(), None, 64)


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "velodyne_decoder.cpp"
    bad.write_text("int main( { return 0; }\n")
    monkeypatch.setattr(nd, "SOURCE", bad)
    monkeypatch.setattr(nd, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(nd, "_lib", None)
    with pytest.raises(RuntimeError, match="with g\\+\\+ failed"):
        nd.is_available()
    assert not list((tmp_path / "native").glob("*.so"))


# -- (d) the engine ----------------------------------------------------------


def test_engine_takes_the_native_path(monkeypatch):
    cfg = tc.tiny_config()
    sweeps, _ = synthetic.render_sequence(2, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                          seed=11, n_firings=cfg.sensor.n_azimuth)
    calls = []
    native = nd.preprocess_extract_native

    def counting(*a, **k):
        calls.append(1)
        return native(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("the engine ran the numpy plain version")

    monkeypatch.setattr(nd, "preprocess_extract_native", counting)
    monkeypatch.setattr(ph, "preprocess_host", refuse)
    monkeypatch.setattr(rangeimage, "build_range_image", refuse)
    eng = tengine.SlamEngine(cfg, seed=0, device="cpu", tile=cfg.runtime.point_tile)
    for sw in sweeps:
        eng.process_sweep(sw)
    assert len(calls) == 2
    # The same clouds given directly: the same records.
    direct = tengine.SlamEngine(cfg, seed=0, device="cpu", tile=cfg.runtime.point_tile)
    for sw in sweeps:
        ri = build_range_image(sw, cfg.sensor)
        pts, nv = native(ri.range_mm, ri.azimuth_rad, ri.vert_rad, cfg.preprocess,
                         ri.selected, cfg.preprocess.max_points)[:2]
        points = np.zeros((tengine.pick_bucket(nv, cfg), 3), np.float32)
        points[:nv] = pts
        direct.process_compact(points, nv)
    for a, b in zip(eng.records, direct.records):
        np.testing.assert_array_equal(a.pose, b.pose)
        assert (a.n_inliers, a.map_size) == (b.n_inliers, b.map_size)


def test_pcap_stream_drives_the_engine(tmp_path):
    """A PCAP of the tiny drive, read by NativeSweepStream, through the
    engine: its clouds are those of the sweeps' range images up to the
    azimuth's centidegree quantization (range images equal, azimuths within
    7.7e-5 rad), which the tiny config's few matches turn
    into position differences of up to 39.9 mm (measured); held at 50 mm."""
    cfg = tc.tiny_config()
    sweeps, _ = synthetic.render_sequence(4, cfg.sensor, step_mm=300.0, noise_mm=10.0,
                                          seed=11, n_firings=cfg.sensor.n_azimuth)
    path = str(tmp_path / "drive.pcap")
    pcap.write_udp_payloads(path, velodyne.encode_packets(sweeps, cfg.sensor))
    tile = cfg.runtime.point_tile
    a = tengine.SlamEngine(cfg, seed=0, device="cpu", tile=tile)
    with nd.NativeSweepStream(path, cfg.sensor) as stream:
        for ri in stream:
            a.process_frame(ri)
    b = tengine.SlamEngine(cfg, seed=0, device="cpu", tile=tile)
    for sw in sweeps[:len(a.records)]:
        b.process_sweep(sw)
    assert len(a.records) == len(sweeps) - 1  # the open last rotation is dropped
    assert np.abs(a.trajectory - b.trajectory).max() < 50.0
