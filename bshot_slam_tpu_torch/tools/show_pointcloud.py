#!/usr/bin/env python3
"""Raw-sweep viewer of the port — `tools/show_pointcloud.py` on PyTorch.

The reference's `ShowPointCloud` (test/ShowPointCloud.cpp): sweeps decoded
with no preprocessing and exported, the OpenCV viz window replaced by
headless PLY files coloured by laser ring.  The polar-to-XYZ conversion
runs on the card (`--cpu`: on the CPU).

Usage: show_pointcloud.py capture.pcap --out dir [--frames N] [--skip N] [--cpu]
       show_pointcloud.py --synthetic 3 --out dir [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pcap", nargs="?")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N")
    ap.add_argument("--sensor", choices=["hdl32e", "vlp16"], default="hdl32e")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--skip", type=int, default=0)
    ap.add_argument("--n-azimuth", type=int, default=0)
    ap.add_argument("--out", required=True, help="output directory for PLYs")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from bshot_slam_tpu_torch.config import VLP16_SENSOR, default_config
    from bshot_slam_tpu_torch.device import resolve_device
    from bshot_slam_tpu_torch.tools.run_preprocess_eval import load_sweeps
    from bshot_slam_tpu_torch.viz.export import save_ply

    device = resolve_device("cpu" if args.cpu else None)
    sensor = VLP16_SENSOR if args.sensor == "vlp16" else default_config().sensor
    if args.n_azimuth:
        sensor = dataclasses.replace(sensor, n_azimuth=args.n_azimuth)
    sweeps = load_sweeps(args, sensor)

    vert_lut = torch.deg2rad(torch.tensor(sensor.vertical_angles_deg,
                                          dtype=torch.float32, device=device))
    os.makedirs(args.out, exist_ok=True)
    for i, sw in enumerate(sweeps):
        # Polar -> XYZ in mm, exactly as captured (ShowPointCloud.cpp renders
        # the raw rotation, no ground or occlusion removal).  Distance ticks
        # are 2 mm each (reference: preprocess.cpp:46); x east = sin az,
        # y north = cos az, as in the preprocess.
        good = np.asarray(sw.distance) > 0
        dist = torch.as_tensor(np.asarray(sw.distance, np.float32)[good], device=device) * 2.0
        az = torch.deg2rad(torch.as_tensor(np.asarray(sw.azimuth_deg, np.float32)[good],
                                           device=device))
        ring = np.asarray(sw.ring, np.int64)[good]
        vert = vert_lut[torch.as_tensor(ring, device=device)]
        xy = dist * torch.cos(vert)
        xyz = torch.stack([xy * torch.sin(az), xy * torch.cos(az),
                           dist * torch.sin(vert)], dim=-1).cpu().numpy()
        t = ring / max(len(vert_lut) - 1, 1)
        colors = np.stack([255 * t, 64 + 0 * t, 255 * (1 - t)], axis=-1).astype(np.uint8)
        path = os.path.join(args.out, f"sweep_{i:05d}.ply")
        save_ply(path, xyz, colors)
        print(f"{path}: {len(xyz)} returns")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    sys.exit(main())
