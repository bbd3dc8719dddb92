"""Minimal PCAP reader/writer for Velodyne UDP captures (no libpcap).

The reference shells out to libpcap (reference: include/VelodyneCapture.h:
413-526, `pcap_next_ex` loop) and checks `header->len - 42 == 1206` — a
42-byte Ethernet+IPv4+UDP header in front of each 1206-byte data packet
(reference: VelodyneCapture.h:431).  This module parses the classic pcap
container directly with numpy so ingest needs no native dependency; the
C++ decoder (native/velodyne_decoder.cpp, bound by io/native_decoder.py)
provides a faster combined parse+decode path with identical semantics.
"""

from __future__ import annotations

import struct
from typing import Iterator, List, Tuple

import numpy as np

PCAP_MAGIC_LE_US = 0xA1B2C3D4
PCAP_MAGIC_LE_NS = 0xA1B23C4D
_LINK_HEADER = 42  # Ethernet(14) + IPv4(20) + UDP(8)


def read_udp_payloads(
    path: str, payload_size: int = 1206
) -> Tuple[np.ndarray, np.ndarray]:
    """Read a pcap file, returning (payloads (n, payload_size) u8, ts_us (n,) i64).

    Records whose captured payload (after the 42-byte link header) is not
    exactly `payload_size` bytes are skipped, matching the reference's
    length gate (reference: VelodyneCapture.h:429-433).
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 24:
        return np.zeros((0, payload_size), np.uint8), np.zeros((0,), np.int64)
    magic = struct.unpack("<I", data[:4])[0]
    if magic == PCAP_MAGIC_LE_US:
        endian, ns = "<", False
    elif magic == PCAP_MAGIC_LE_NS:
        endian, ns = "<", True
    elif magic in (0xD4C3B2A1, 0x4D3CB2A1):
        endian, ns = ">", magic == 0x4D3CB2A1
    else:
        raise ValueError(f"not a pcap file: magic={magic:#x}")

    payloads: List[bytes] = []
    stamps: List[int] = []
    off = 24
    rec = struct.Struct(endian + "IIII")
    n = len(data)
    while off + 16 <= n:
        ts_sec, ts_frac, incl_len, _orig_len = rec.unpack_from(data, off)
        off += 16
        if off + incl_len > n:
            break
        if incl_len - _LINK_HEADER == payload_size:
            payloads.append(data[off + _LINK_HEADER : off + incl_len])
            us = ts_frac // 1000 if ns else ts_frac
            stamps.append(ts_sec * 1_000_000 + us)
        off += incl_len
    if not payloads:
        return np.zeros((0, payload_size), np.uint8), np.zeros((0,), np.int64)
    arr = np.frombuffer(b"".join(payloads), np.uint8).reshape(-1, payload_size)
    return arr, np.asarray(stamps, np.int64)


def write_udp_payloads(
    path: str,
    payloads: np.ndarray,
    ts_us: np.ndarray | None = None,
    src_port: int = 2368,
    dst_port: int = 2368,
) -> None:
    """Write (n, k) u8 payloads as UDP/IPv4/Ethernet pcap records (test fixture)."""
    payloads = np.asarray(payloads, np.uint8)
    n_pkt, k = payloads.shape
    if ts_us is None:
        ts_us = np.arange(n_pkt, dtype=np.int64) * 553  # ~1806 pkt/s like HDL-32E
    eth = b"\xff" * 6 + b"\x00" * 6 + b"\x08\x00"
    with open(path, "wb") as f:
        f.write(struct.pack("<IHHiIII", PCAP_MAGIC_LE_US, 2, 4, 0, 0, 65535, 1))
        for i in range(n_pkt):
            ip_len = 20 + 8 + k
            ip = struct.pack(
                ">BBHHHBBH4s4s", 0x45, 0, ip_len, i & 0xFFFF, 0, 64, 17, 0,
                bytes([192, 168, 1, 201]), bytes([192, 168, 1, 1]),
            )
            udp = struct.pack(">HHHH", src_port, dst_port, 8 + k, 0)
            frame = eth + ip + udp + payloads[i].tobytes()
            ts = int(ts_us[i])
            f.write(struct.pack("<IIII", ts // 1_000_000, ts % 1_000_000,
                                len(frame), len(frame)))
            f.write(frame)
