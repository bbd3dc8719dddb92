"""Live Velodyne UDP capture: background thread + sweep queue.

Rebuild of the reference's sensor path (reference: include/VelodyneCapture.h
:315-408 — Boost.Asio socket, capture thread, mutex-guarded rotation queue)
on the Python stdlib: a daemon thread receives 1206-byte datagrams, batches
them, decodes with the vectorized packet decoder, and publishes complete
sweeps to a bounded queue.  `retrieve()` is non-blocking and returns None
when no sweep is ready, matching the reference's try_lock/empty-vector
behavior (reference: VelodyneCapture.h:290-303).
"""

from __future__ import annotations

import queue
import socket
import threading
from typing import Optional

import numpy as np

from bshot_slam_tpu_torch.config import SensorConfig
from bshot_slam_tpu_torch.io.velodyne import (
    PACKET_SIZE,
    LaserSweep,
    decode_packets,
    sensor_type,
    split_sweeps,
)


class UdpCapture:
    def __init__(
        self,
        sensor: SensorConfig,
        address: str = "0.0.0.0",
        port: int = 2368,
        queue_size: int = 8,
        packets_per_batch: int = 64,
    ):
        sensor_type(sensor)  # ValueError for a sensor the decoder cannot read
        self.sensor = sensor
        self._queue: "queue.Queue[LaserSweep]" = queue.Queue(queue_size)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((address, port))
        self._sock.settimeout(0.5)
        self._run = True
        self._packets_per_batch = packets_per_batch
        self._thread = threading.Thread(target=self._capture_loop, daemon=True)
        self._thread.start()

    def _capture_loop(self) -> None:
        pending = np.zeros((0,), np.float64)
        tail = (pending, np.zeros(0, np.int32), np.zeros(0, np.uint16),
                np.zeros(0, np.uint8))
        batch = []
        while self._run:
            try:
                data, _ = self._sock.recvfrom(2048)
            except socket.timeout:
                continue
            except OSError:
                break
            if len(data) != PACKET_SIZE:
                continue
            batch.append(np.frombuffer(data, np.uint8))
            if len(batch) < self._packets_per_batch:
                continue
            az, ring, dist, inten = decode_packets(np.stack(batch), self.sensor)
            batch = []
            az = np.concatenate([tail[0], az])
            ring = np.concatenate([tail[1], ring])
            dist = np.concatenate([tail[2], dist])
            inten = np.concatenate([tail[3], inten])
            sweeps = split_sweeps(az, ring, dist, inten)
            # keep the incomplete rotation as the tail for the next batch
            if len(az):
                wraps = np.nonzero(az[1:] < az[:-1])[0] + 1
                cut = wraps[-1] if len(wraps) else 0
                tail = (az[cut:], ring[cut:], dist[cut:], inten[cut:])
            for sw in sweeps:
                try:
                    self._queue.put_nowait(sw)
                except queue.Full:  # drop oldest, keep streaming
                    try:
                        self._queue.get_nowait()
                        self._queue.put_nowait(sw)
                    except queue.Empty:
                        pass

    @property
    def port(self) -> int:
        """Bound UDP port (useful with port=0 for an ephemeral port)."""
        return self._sock.getsockname()[1]

    def retrieve(self, timeout: Optional[float] = None) -> Optional[LaserSweep]:
        """Next complete sweep, or None (non-blocking when timeout=None)."""
        try:
            if timeout is None:
                return self._queue.get_nowait()
            return self._queue.get(timeout=timeout)
        except queue.Empty:
            return None

    def is_run(self) -> bool:
        return self._run and self._thread.is_alive()

    def close(self) -> None:
        self._run = False
        try:
            self._sock.close()
        except OSError:
            pass
        self._thread.join(timeout=2.0)
