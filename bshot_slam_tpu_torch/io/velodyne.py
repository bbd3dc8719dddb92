"""Velodyne packet decoding and sweep assembly (host-side, numpy).

Rebuilds the capability of the reference's header-only capture class
(reference: include/VelodyneCapture.h) as vectorized numpy over whole packet
batches instead of a per-laser C++ loop: 1206-byte data packets hold
12 firings x (2B block id, 2B rotational position, 32 x (2B distance, 1B
intensity)) + 4B GPS timestamp + 1B mode + 1B sensor type (reference:
VelodyneCapture.h:89-110).  Azimuth interpolation for dual-firing VLP-16
blocks follows reference VelodyneCapture.h:462-469; sweep boundaries are
azimuth wrap-arounds (reference: VelodyneCapture.h:500-506).

A C++ fast path with the same contract lives in native/velodyne_decoder.cpp
(loaded via ctypes when built); this module is the always-available fallback
and the semantic ground truth for its tests.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np

from bshot_slam_tpu_torch.config import SensorConfig, VLP16_SENSOR

PACKET_SIZE = 1206
LASER_PER_FIRING = 32
FIRING_PER_PKT = 12
SENSOR_HDL32E = 0x21
SENSOR_VLP16 = 0x22
# The HDL-64E's packets interleave two blocks of 32 lasers, and its angles
# and distance corrections come from the unit's own calibration file
# (db.xml): without one its packets would decode into wrong points.
HDL64E_REFUSAL = ("decoding HDL-64E packets needs the unit's per-laser "
                  "calibration (db.xml), which the port does not read; "
                  "only the 16- and 32-ring sensors decode")


def sensor_type(sensor: SensorConfig) -> int:
    """The factory byte of the sensor's packets; ValueError for a sensor
    whose packets the decoders cannot read (any but 16 or 32 rings)."""
    if sensor.n_rings == 16:
        return SENSOR_VLP16
    if sensor.n_rings == 32:
        return SENSOR_HDL32E
    raise ValueError(f"{sensor.name} ({sensor.n_rings} rings): {HDL64E_REFUSAL}")

# One firing block: u16 block id, u16 azimuth (0.01 deg), 32 x (u16 dist, u8 int)
_FIRING_DTYPE = np.dtype(
    [
        ("block_id", "<u2"),
        ("azimuth", "<u2"),
        ("returns", [("distance", "<u2"), ("intensity", "u1")], (LASER_PER_FIRING,)),
    ]
)
_PACKET_DTYPE = np.dtype(
    [
        ("firings", _FIRING_DTYPE, (FIRING_PER_PKT,)),
        ("gps_timestamp", "<u4"),
        ("mode", "u1"),
        ("sensor_type", "u1"),
    ]
)
assert _PACKET_DTYPE.itemsize == PACKET_SIZE


@dataclasses.dataclass
class LaserSweep:
    """One 360-degree rotation of raw returns (flat arrays, firing order).

    Equivalent of the reference's `vector<Laser>` queue element
    (reference: VelodyneCapture.h:43-60,80).  `distance` is raw ticks
    (2 mm each); `azimuth_deg` is degrees in [0, 360).
    """

    azimuth_deg: np.ndarray  # (n,) float64
    ring: np.ndarray  # (n,) int32, index into the sensor's firing-order LUT
    distance: np.ndarray  # (n,) uint16 raw ticks
    intensity: np.ndarray  # (n,) uint8
    timestamp_us: int = 0

    def __len__(self) -> int:
        return int(self.azimuth_deg.shape[0])


def decode_packets(
    payloads: np.ndarray, sensor: SensorConfig
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Decode (n_pkt, 1206) uint8 payloads -> flat per-laser arrays.

    Returns (azimuth_deg f64, ring i32, distance u16, intensity u8), each of
    shape (n_pkt * 12 * 32,), in firing order.
    """
    if payloads.ndim == 1:
        payloads = payloads[None]
    pkts = payloads.view(_PACKET_DTYPE).reshape(payloads.shape[0])
    n_lasers = sensor.n_rings

    # Sensor-type gate (reference asserts the factory byte,
    # VelodyneCapture.h:443; here mismatched packets are skipped): 0
    # tolerates factory-byte-less streams.
    expected = sensor_type(sensor)
    st = pkts["sensor_type"]
    pkts = pkts[(st == 0) | (st == expected)]

    az_raw = pkts["firings"]["azimuth"].astype(np.float64)  # (P, 12)

    # Corrupt-firing gates: bad block marker or impossible azimuth (the
    # native decoder applies the same tests packet-for-packet).
    bid = pkts["firings"]["block_id"]
    ok_firing = ((bid == 0) | (bid == 0xEEFF)) & (az_raw < 36000.0)

    # Interpolated half-step between firing 0 and 1 of each packet
    # (reference: VelodyneCapture.h:462-469).  A packet whose first two
    # firings did not BOTH pass the gates gets d01 = 0 — a corrupt raw
    # azimuth there would otherwise skew (or make negative) the azimuths
    # of every surviving second-sequence laser in the packet.
    if az_raw.shape[0]:
        d01 = az_raw[:, 1] - az_raw[:, 0]
        d01 = np.where(d01 < 0, d01 + 36000.0, d01) / 2.0
        d01 = np.where(ok_firing[:, 0] & ok_firing[:, 1], d01, 0.0)
    else:
        d01 = np.zeros((0,))

    laser_idx = np.arange(LASER_PER_FIRING)
    az = np.broadcast_to(az_raw[:, :, None], az_raw.shape + (LASER_PER_FIRING,))
    # Second half of a VLP-16 block fires ~half an azimuth step later
    # (reference: VelodyneCapture.h:480-483).
    az = az + np.where(laser_idx >= n_lasers, d01[:, None, None], 0.0)
    az = np.where(az >= 36000.0, az - 36000.0, az)

    ring = np.broadcast_to(
        (laser_idx % n_lasers).astype(np.int32), az.shape
    )
    dist = pkts["firings"]["returns"]["distance"]
    inten = pkts["firings"]["returns"]["intensity"]
    keep = np.broadcast_to(ok_firing[:, :, None], az.shape).reshape(-1)
    return (
        (az / 100.0).reshape(-1)[keep],
        ring.reshape(-1)[keep],
        dist.reshape(-1)[keep],
        inten.reshape(-1)[keep],
    )


def split_sweeps(
    azimuth_deg: np.ndarray,
    ring: np.ndarray,
    distance: np.ndarray,
    intensity: np.ndarray,
    timestamps_us: np.ndarray | None = None,
) -> List[LaserSweep]:
    """Split flat firing-order laser arrays at azimuth wrap-arounds.

    Mirrors the reference's `last_azimuth > azimuth` rotation boundary
    (reference: VelodyneCapture.h:500-506); the trailing partial rotation is
    dropped, like the reference's never-flushed tail buffer.
    """
    if azimuth_deg.size == 0:
        return []
    wraps = np.nonzero(azimuth_deg[1:] < azimuth_deg[:-1])[0] + 1
    sweeps = []
    starts = np.concatenate([[0], wraps])
    ends = wraps  # drop the tail segment
    for s, e in zip(starts, ends):
        ts = int(timestamps_us[s]) if timestamps_us is not None else 0
        sweeps.append(
            LaserSweep(
                azimuth_deg=azimuth_deg[s:e],
                ring=ring[s:e],
                distance=distance[s:e],
                intensity=intensity[s:e],
                timestamp_us=ts,
            )
        )
    return sweeps


def sweeps_from_payloads(
    payloads: np.ndarray, sensor: SensorConfig, skip: int = 0
) -> List[LaserSweep]:
    """Decode a batch of packet payloads and assemble whole sweeps.

    `skip` drops the first N sweeps, the equivalent of the reference's
    start-frame fast-forward (reference: VelodyneCapture.h:491-497).
    """
    az, ring, dist, inten = decode_packets(payloads, sensor)
    return split_sweeps(az, ring, dist, inten)[skip:]


def encode_packets(sweep_list: Sequence[LaserSweep], sensor: SensorConfig) -> np.ndarray:
    """Inverse of decode: pack sweeps into (n_pkt, 1206) payloads.

    Only used by tests and the synthetic-data PCAP writer; firings are
    emitted one azimuth per block with all rings, zero-padded to whole
    packets.
    """
    kind = sensor_type(sensor)
    firings = []  # (azimuth_centideg, dist[32], inten[32])
    for sweep in sweep_list:
        az_vals, inverse = np.unique(sweep.azimuth_deg, return_inverse=True)
        n_f = az_vals.shape[0]
        dist = np.zeros((n_f, LASER_PER_FIRING), np.uint16)
        inten = np.zeros((n_f, LASER_PER_FIRING), np.uint8)
        dist[inverse, sweep.ring] = sweep.distance
        inten[inverse, sweep.ring] = sweep.intensity
        for f in range(n_f):
            firings.append((int(round(az_vals[f] * 100.0)) % 36000, dist[f], inten[f]))
    # pad to a whole number of packets with copies of the last firing
    while len(firings) % FIRING_PER_PKT != 0:
        firings.append(firings[-1])
    n_pkt = len(firings) // FIRING_PER_PKT
    out = np.zeros((n_pkt, PACKET_SIZE), np.uint8)
    pkt = out.view(_PACKET_DTYPE).reshape(n_pkt)
    for i, (az, dist, inten) in enumerate(firings):
        p, f = divmod(i, FIRING_PER_PKT)
        pkt[p]["firings"][f]["block_id"] = 0xEEFF
        pkt[p]["firings"][f]["azimuth"] = az
        pkt[p]["firings"][f]["returns"]["distance"] = dist
        pkt[p]["firings"][f]["returns"]["intensity"] = inten
    pkt["sensor_type"] = kind
    pkt["mode"] = 0x37
    return out
