"""The reference's full-width drive, recorded for the port to be held against.

    JAX_PLATFORMS=cpu python tests/torch_reference_drive.py

Runs the JAX package on the CPU exactly as `bench.py` drives it, with exact
top-k (`RuntimeConfig.exact_topk=True`; the port's top-k is always exact):
`default_config()`, `render_sequence(129, step_mm=400, noise_mm=20,
seed=0, n_firings=n_azimuth, yaw_rate_rad=2 pi / 129)`, the map prefilled
by `bench._prefilled_map` to 65,536 far-away landmarks, and
`SlamEngine(cfg, seed=0, pipelined=True, fetch_every=64)` with no backend.
Writes `tests/fixtures/torch_jax_drive.npz`:

  poses    (129, 4, 4) float32  each frame's pose, as the records hold it
  inliers  (129,) int32         RANSAC inliers of each frame
  cursor   ()  int64            the map cursor after the last frame
  gt       (129, 4, 4) float64  ground-truth sensor poses
  meta     str                  JSON: {"args": ARGS, "config": asdict(cfg)}

`chip_smoke.py` (phase [6]) loads the file with numpy alone and holds the
card's run of the same drive against it; `tests/test_torch_reference_drive.py`
checks that the file still describes the port's configuration and that the
JAX package regenerates its first frames.  The card machine has no JAX, so
the reference run is this committed file.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "torch_jax_drive.npz"
ARGS = {
    "n_frames": 129, "step_mm": 400.0, "noise_mm": 20.0, "scene_seed": 0,
    "yaw_rate_rad": 2 * math.pi / 129, "prefill": 65536, "engine_seed": 0,
    "pipelined": True, "fetch_every": 64, "backend": False, "exact_topk": True,
}


def config_dict(cfg) -> dict:
    """`dataclasses.asdict(cfg)` as it reads back from JSON (tuples become
    lists), so two configurations compare field for field."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def reference_config():
    """The JAX package's `default_config()` with exact top-k."""
    from bshot_slam_tpu.config import default_config

    cfg = default_config()
    return dataclasses.replace(
        cfg, runtime=dataclasses.replace(cfg.runtime, exact_topk=ARGS["exact_topk"]))


def run(n_frames: int | None = None) -> dict:
    """The JAX engine over the first `n_frames` frames of the drive (all of
    them by default; the frames do not depend on how many are rendered)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, str(ROOT))
    import bench
    from bshot_slam_tpu.io import synthetic
    from bshot_slam_tpu.odometry.engine import SlamEngine

    n = ARGS["n_frames"] if n_frames is None else n_frames
    cfg = reference_config()
    sweeps, gt = synthetic.render_sequence(
        n, cfg.sensor, step_mm=ARGS["step_mm"], noise_mm=ARGS["noise_mm"],
        seed=ARGS["scene_seed"], n_firings=cfg.sensor.n_azimuth,
        yaw_rate_rad=ARGS["yaw_rate_rad"])
    eng = SlamEngine(cfg, seed=ARGS["engine_seed"], pipelined=ARGS["pipelined"],
                     fetch_every=ARGS["fetch_every"])
    eng.state = eng.state._replace(
        map=bench._prefilled_map(cfg, cfg.map.capacity, n=ARGS["prefill"]))
    for sw in sweeps:
        eng.process_sweep(sw)
    eng.flush()
    return dict(
        poses=np.stack([r.pose for r in eng.records]).astype(np.float32),
        inliers=np.array([r.n_inliers for r in eng.records], np.int32),
        cursor=np.int64(int(eng.state.map.cursor)),
        gt=np.asarray(gt, np.float64),
        meta=json.dumps({"args": ARGS, "config": config_dict(cfg)}),
    )


def load(path=FIXTURE) -> dict:
    """The fixture's arrays, with `meta` parsed."""
    with np.load(path) as z:
        out = {k: z[k] for k in z.files}
    out["meta"] = json.loads(str(out["meta"]))
    return out


def main() -> int:
    t0 = time.perf_counter()
    out = run()
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **out)
    print(f"{len(out['poses'])} frames in {time.perf_counter() - t0:.1f} s on the "
          f"CPU; final map cursor {int(out['cursor'])}, inliers "
          f"{out['inliers'].min()}..{out['inliers'].max()} -> {FIXTURE} "
          f"({FIXTURE.stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
