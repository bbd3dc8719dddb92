"""ctypes bindings for the native PCAP/Velodyne decoder and host preprocess.

Port of `bshot_slam_tpu.io.native_decoder`.  The library is built from the
port's own copy of the source, `native/velodyne_decoder.cpp`, at first use:

    g++ -O3 -fno-math-errno -std=c++17 -fPIC -shared \
        -o build/native/velodyne_decoder-<hash>.so native/velodyne_decoder.cpp -lpthread

(`kernels/_build.start_build`: named by a hash of the source and the
flags, written to a temporary name and renamed, so processes building at
once do not collide).  It is built without `-march=native`, so the library
runs on any x86-64 host (the reference's committed `native/*.so` was built
for the host that made it, and the port never loads it).
`-fno-math-errno` lets the compiler put `sqrt` on SIMD lanes (the
classify's row passes); it changes no result, only that `errno` is left
alone.  A failed build raises with the compiler's output; nothing
falls back to the python path quietly.  Entry points: `decode_pcap_native`
(whole capture into sweeps), `NativeSweepStream` (a C++ producer thread
that parses and bins each rotation into a `RangeImage`),
`build_range_image` (one decoded sweep binned, the plain version being
`ops.rangeimage.build_range_image`) and `preprocess_extract_native`
(classify + compact extract of one sweep, the plain version being
`ops.preprocess_host`).
"""

from __future__ import annotations

import ctypes
import pathlib
import shutil
import threading
from typing import List, Optional

import numpy as np

from bshot_slam_tpu_torch.config import SensorConfig
from bshot_slam_tpu_torch.io.velodyne import LaserSweep, sensor_type
from bshot_slam_tpu_torch.kernels import _build

_PKG = pathlib.Path(__file__).resolve().parents[1]
SOURCE = _PKG / "native" / "velodyne_decoder.cpp"
BUILD_DIR = _PKG.parent / "build" / "native"
GXX_FLAGS = ("-O3", "-fno-math-errno", "-std=c++17", "-fPIC", "-shared")

_LOCK = threading.Lock()
_lib = None


class _DecodedCapture(ctypes.Structure):
    _fields_ = [
        ("azimuth_deg", ctypes.POINTER(ctypes.c_float)),
        ("ring", ctypes.POINTER(ctypes.c_int32)),
        ("distance", ctypes.POINTER(ctypes.c_uint16)),
        ("intensity", ctypes.POINTER(ctypes.c_uint8)),
        ("n_lasers", ctypes.c_int64),
        ("sweep_starts", ctypes.POINTER(ctypes.c_int64)),
        ("n_sweeps", ctypes.c_int64),
    ]


class _VdStreamOpaque(ctypes.Structure):
    pass


class _PreprocessCfg(ctypes.Structure):
    _fields_ = [
        ("vert_init_rad", ctypes.c_float),
        ("sensor_height_mm", ctypes.c_float),
        ("grad_th_deg", ctypes.c_float),
        ("lowpt_th_mm", ctypes.c_float),
        ("height_th_mm", ctypes.c_float),
        ("dist_th_mm", ctypes.c_float),
        ("angdiff_th_rad", ctypes.c_float),
        ("car_x0", ctypes.c_float), ("car_x1", ctypes.c_float),
        ("car_y0", ctypes.c_float), ("car_y1", ctypes.c_float),
        ("car_z0", ctypes.c_float), ("car_z1", ctypes.c_float),
    ]


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the native decoder cannot be built")
    return found


def _load() -> ctypes.CDLL:
    """The library, built on first use, with every entry point bound."""
    global _lib
    with _LOCK:
        if _lib is None:
            started = _build.start_build(_gxx, SOURCE, (), GXX_FLAGS, BUILD_DIR,
                                         libs=("-lpthread",))
            lib = _build.finish_build("native/velodyne_decoder.cpp with g++",
                                      *started)
            f32p = ctypes.POINTER(ctypes.c_float)
            stream_p = ctypes.POINTER(_VdStreamOpaque)
            lib.vd_decode_pcap.restype = ctypes.POINTER(_DecodedCapture)
            lib.vd_decode_pcap.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.vd_free.restype = None
            lib.vd_free.argtypes = [ctypes.POINTER(_DecodedCapture)]
            lib.vd_stream_open.restype = stream_p
            lib.vd_stream_open.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int32), ctypes.c_float, ctypes.c_int,
                ctypes.c_int,
            ]
            lib.vd_stream_next.restype = ctypes.c_int
            lib.vd_stream_next.argtypes = [stream_p, f32p, f32p]
            lib.vd_stream_close.restype = None
            lib.vd_stream_close.argtypes = [stream_p]
            lib.vd_bin_sweep.restype = ctypes.c_int
            lib.vd_bin_sweep.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int64, ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
                ctypes.c_int, ctypes.c_float, f32p, f32p,
                ctypes.POINTER(ctypes.c_uint8),
            ]
            lib.vd_preprocess_extract.restype = ctypes.c_int64
            lib.vd_preprocess_extract.argtypes = [
                f32p, f32p, f32p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(_PreprocessCfg), ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int32), f32p, f32p, ctypes.c_int64,
            ]
            _lib = lib
        return _lib


def is_available() -> bool:
    """True once the library is built and loaded (raises if it cannot be
    built)."""
    return _load() is not None


def stream_available() -> bool:
    """True when the stream API is there: the port's library always has it
    (raises if the library cannot be built)."""
    return hasattr(_load(), "vd_stream_open")


def decode_pcap_native(
    path: str, sensor: SensorConfig, skip: int = 0
) -> Optional[List[LaserSweep]]:
    """Native parse+decode of a PCAP capture into complete sweeps.

    Returns None when the file is unreadable or not a little-endian classic
    pcap (as the reference does); ValueError for a sensor the decoder cannot
    read (`velodyne.sensor_type`)."""
    sensor_type(sensor)
    lib = _load()
    cap = lib.vd_decode_pcap(str(path).encode(), sensor.n_rings)
    if not cap:
        return None
    try:
        c = cap.contents
        n = int(c.n_lasers)
        az = np.ctypeslib.as_array(c.azimuth_deg, (n,)).astype(np.float64)
        ring = np.ctypeslib.as_array(c.ring, (n,)).copy()
        dist = np.ctypeslib.as_array(c.distance, (n,)).copy()
        inten = np.ctypeslib.as_array(c.intensity, (n,)).copy()
        n_sweeps = int(c.n_sweeps)
        starts = np.ctypeslib.as_array(c.sweep_starts, (n_sweeps + 1,)).copy()
    finally:
        lib.vd_free(cap)

    sweeps = []
    for k in range(skip, n_sweeps):
        s, e = int(starts[k]), int(starts[k + 1])
        sweeps.append(
            LaserSweep(
                azimuth_deg=az[s:e], ring=ring[s:e], distance=dist[s:e],
                intensity=inten[s:e],
            )
        )
    return sweeps


class NativeSweepStream:
    """Producer/consumer PCAP ingest, fully native: a C++ background thread
    parses packets and bins each rotation into upload-ready dense
    (n_rings, n_azimuth) range/azimuth arrays behind a bounded queue — the
    reference's capture-thread architecture (VelodyneCapture.h:172,78-80)
    with the range-image build moved into the producer.

    Iterate to receive `ops.rangeimage.RangeImage` objects; close() (or the
    context manager / garbage collection) releases the thread.
    """

    def __init__(self, path: str, sensor: SensorConfig, skip: int = 0,
                 queue: int = 4):
        from bshot_slam_tpu_torch.ops.rangeimage import row_of_ring, sorted_vertical_angles_rad

        self._handle = None
        sensor_type(sensor)  # ValueError for a sensor the decoder cannot read
        self._lib = _load()
        rows = row_of_ring(sensor)
        self._handle = self._lib.vd_stream_open(
            str(path).encode(), sensor.n_rings, sensor.n_azimuth,
            rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            ctypes.c_float(sensor.distance_scale_mm), skip, queue,
        )
        if not self._handle:
            raise RuntimeError(f"cannot open {path!r} as a pcap capture")
        self._shape = (sensor.n_rings, sensor.n_azimuth)
        self._vert = sorted_vertical_angles_rad(sensor)

    def __iter__(self):
        from bshot_slam_tpu_torch.ops.rangeimage import RangeImage

        f32p = ctypes.POINTER(ctypes.c_float)
        while self._handle:
            rng = np.empty(self._shape, np.float32)
            az = np.empty(self._shape, np.float32)
            ok = self._lib.vd_stream_next(self._handle, rng.ctypes.data_as(f32p),
                                          az.ctypes.data_as(f32p))
            if not ok:
                break
            yield RangeImage(
                range_mm=rng, azimuth_rad=az, vert_rad=self._vert,
                selected=np.ones(self._shape, bool),
            )
        self.close()

    def close(self):
        h, self._handle = self._handle, None
        if h:
            self._lib.vd_stream_close(h)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()


def build_range_image(sweep: LaserSweep, sensor: SensorConfig,
                      selected_indices: Optional[np.ndarray] = None):
    """`ops.rangeimage.build_range_image` with the firings binned in the
    library: the same `RangeImage`, bit for bit, of the sweep's arrays in
    the decoders' dtypes (float64 azimuths, int32 rings, uint16 ticks).
    Raises IndexError for a ring outside the sensor and ValueError for an
    azimuth below 0 or not a number."""
    from bshot_slam_tpu_torch.ops import rangeimage

    range_mm, azimuth_rad, selected = rangeimage.blank_image(sensor)
    sel = None
    if selected_indices is not None:
        sel = np.zeros(len(sweep), np.uint8)
        sel[np.asarray(selected_indices, np.int64)] = 1
    az = np.ascontiguousarray(sweep.azimuth_deg, np.float64)
    ring = np.ascontiguousarray(sweep.ring, np.int32)
    dist = np.ascontiguousarray(sweep.distance, np.uint16)
    rows = rangeimage.row_of_ring(sensor)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    rc = _load().vd_bin_sweep(
        az.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ring.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        dist.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        None if sel is None else sel.ctypes.data_as(u8p), len(sweep),
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), sensor.n_rings,
        sensor.n_azimuth, ctypes.c_float(sensor.distance_scale_mm),
        range_mm.ctypes.data_as(f32p), azimuth_rad.ctypes.data_as(f32p),
        selected.ctypes.data_as(u8p))
    if rc == -1:
        raise IndexError(f"a ring id outside the {sensor.n_rings} rings of "
                         f"{sensor.name}")
    if rc == -2:
        raise ValueError("an azimuth below 0 degrees or not a number")
    return rangeimage.RangeImage(
        range_mm=range_mm, azimuth_rad=azimuth_rad,
        vert_rad=rangeimage.sorted_vertical_angles_rad(sensor),
        selected=selected, timestamp_us=sweep.timestamp_us)


def preprocess_extract_native(range_mm, azimuth_rad, vert_rad, cfg,
                              selected, max_points: int):
    """Native classify + compact-extract of one sweep (mirrors
    ops.preprocess_host; reference: src/preprocess.cpp:73-216).

    Returns (points (n, 3) float32, n_valid, classes (R, A) int32); raises
    ValueError on arguments the library refuses."""
    lib = _load()
    r = np.ascontiguousarray(range_mm, np.float32)
    a = np.ascontiguousarray(azimuth_rad, np.float32)
    v = np.ascontiguousarray(vert_rad, np.float32)
    R, A = r.shape
    if a.shape != (R, A) or v.shape != (R,):
        raise ValueError(f"range {r.shape}, azimuth {a.shape} and vertical "
                         f"angles {v.shape} do not describe one (R, A) image")
    c = _PreprocessCfg(
        cfg.vert_init_rad, cfg.sensor_height_mm, cfg.grad_th_deg,
        cfg.lowpt_th_mm, cfg.height_th_mm, cfg.dist_th_mm,
        cfg.angdiff_th_rad,
        cfg.car_x_mm[0], cfg.car_x_mm[1], cfg.car_y_mm[0], cfg.car_y_mm[1],
        cfg.car_z_mm[0], cfg.car_z_mm[1],
    )
    classes = np.empty((R, A), np.int32)
    scratch = np.empty(3 * R * A, np.float32)  # the cells' X, Y and Z planes
    pts = np.empty((max_points, 3), np.float32)
    if selected is not None:
        sel = np.ascontiguousarray(np.asarray(selected, bool).astype(np.uint8))
        if sel.shape != (R, A):
            raise ValueError(f"selected {sel.shape} is not the image's {(R, A)}")
        sel_p = sel.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    else:
        sel_p = None
    f32p = ctypes.POINTER(ctypes.c_float)
    n = lib.vd_preprocess_extract(
        r.ctypes.data_as(f32p), a.ctypes.data_as(f32p),
        v.ctypes.data_as(f32p), R, A, ctypes.byref(c), sel_p,
        classes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        scratch.ctypes.data_as(f32p), pts.ctypes.data_as(f32p), max_points,
    )
    if n < 0:
        raise ValueError(f"vd_preprocess_extract refused a ({R}, {A}) image")
    return pts[:n].copy(), int(n), classes
