"""Worker process of the port's two-process multi-host test (run by
tests/test_torch_multihost.py, not by pytest directly).

Usage: python tests/torch_multihost_worker.py <process_id> <num_processes> <port>

Joins a gloo process group over localhost on the CPU
(`parallel.multihost.initialize`), builds the ("hosts", "devices") mesh
(`host_mesh`: every process a host of one rank) and checks:

  * one multi-host odometry step (`multihost_odometry_step`, the state
    placed by `make_global`) gives this process's own single-process
    step's packed diagnostics bit for bit;
  * the map is partitioned across the processes: this process holds C / H
    rows of every map array, rows pid::H of the single-process map;
  * the engine over a short synthetic sequence on the process-spanning mesh
    (every process runs the same host loop) gives the single-process
    engine's records bit for bit, and its map stays partitioned.

Prints "MULTIHOST_OK pid=<i>" on success; a failed check exits non-zero.
"""

import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)

    from bshot_slam_tpu_torch.config import tiny_config
    from bshot_slam_tpu_torch.io import synthetic
    from bshot_slam_tpu_torch.odometry import pipeline
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.parallel import multihost, sharded
    from tests.torch_sharded_cases import records, step_inputs

    dev = multihost.initialize(f"localhost:{port}", nproc, pid)
    assert dev.type == "cpu", dev
    mesh = multihost.host_mesh()
    assert dict(zip(mesh.mesh_dim_names, mesh.mesh.shape)) == {
        "hosts": nproc, "devices": 1}

    cfg = tiny_config()
    pts, pm = step_inputs(cfg)
    one_cfg = sharded.mesh_runtime_overrides(cfg, 1)
    ref_state, ref_diag = pipeline.odometry_step(
        pipeline.init_state(one_cfg, device="cpu"), torch.from_numpy(pts),
        torch.from_numpy(pm), torch.Generator().manual_seed(0), one_cfg, 256)

    step, _ = multihost.multihost_odometry_step(mesh, cfg, tile=256)
    spec = sharded.state_shardings(mesh, map_axis="hosts")
    host_state = pipeline.OdometryState(*[
        type(part)(*[x.numpy() for x in part]) if isinstance(part, tuple)
        else part.numpy() for part in pipeline.init_state(cfg, device="cpu")])
    gstate = multihost.make_global(mesh, spec, host_state)
    gpts = multihost.make_global(mesh, None, pts)
    gpm = multihost.make_global(mesh, None, pm)
    new_state, diag = step(gstate, gpts, gpm, torch.Generator().manual_seed(0))
    assert diag.packed.numpy().tobytes() == ref_diag.packed.numpy().tobytes()

    C = cfg.map.capacity
    for f in ("positions", "descriptors", "seg_ratios", "valid"):
        local = getattr(new_state.map, f)
        assert local.shape[0] == C // nproc, (f, local.shape)
        assert torch.equal(local, getattr(ref_state.map, f)[pid::nproc]), f

    warnings.simplefilter("ignore")
    sweeps, _ = synthetic.render_sequence(
        4, cfg.sensor, step_mm=350.0, noise_mm=10.0, seed=5,
        n_firings=cfg.sensor.n_azimuth)
    local_eng = SlamEngine(one_cfg, seed=0, tile=256, device="cpu")
    dist_eng = SlamEngine(cfg, seed=0, tile=256, mesh=mesh, data_axis="devices",
                          map_axis="hosts")
    for sw in sweeps:
        local_eng.process_sweep(sw)
        dist_eng.process_sweep(sw)
    assert records(dist_eng) == records(local_eng)
    assert (dist_eng.state.map.positions.shape[0] * nproc
            == local_eng.state.map.positions.shape[0])
    torch.distributed.destroy_process_group()
    print(f"MULTIHOST_OK pid={pid}", flush=True)


if __name__ == "__main__":
    main()
