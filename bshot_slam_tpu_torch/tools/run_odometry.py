#!/usr/bin/env python3
"""Odometry CLI of the port — `tools/run_odometry.py` on PyTorch.

The reference's `odometry_test` (test/odometry_test.cpp:49, usage
`./odometry_test pcap [SelectedPoints] [Load_Traj] [Save_Traj]`), headless:
sweeps from a PCAP (the native stream, else the native decode, else the
python decoder), a live UDP port or a synthetic drive go through
`SlamEngine` on the card (`--cpu`: the plain PyTorch path on the CPU), and
the trajectory, a checkpoint and a live view come out.  It takes the
reference's arguments.  `--sharded N` runs the engine over N local ranks of
a process group (`parallel.sharded`), each a spawned process on card
r modulo the cards (or the CPU with `--cpu`); every rank reads the same
input and rank 0 prints and writes the outputs.  Ranks that share a card
need `--dist-backend gloo`.  On NCCL the sharded steps and `--ba`'s sharded
solve replay CUDA graphs; on gloo they run eagerly.  `--sharded` takes
neither `--udp`, `--live`, `--step` nor `--profile`.  `--sensor hdl64e`
runs `config.hdl64e_config()` (the KITTI odometry benchmark's HDL-64E S2)
on `--synthetic` input only: its packets need the unit's calibration file,
which the decoders do not read, so it refuses a PCAP or `--udp` (exit 2).

Examples:
  python3 bshot_slam_tpu_torch/tools/run_odometry.py capture.pcap --skip 686 --out traj.txt
  python3 bshot_slam_tpu_torch/tools/run_odometry.py --synthetic 20 --out traj.txt --gold gold.txt
  python3 bshot_slam_tpu_torch/tools/run_odometry.py --synthetic 10 --sharded 2 --dist-backend gloo
  python3 bshot_slam_tpu_torch/tools/run_odometry.py --sensor hdl64e --synthetic 129 --profile prof
  python3 -m bshot_slam_tpu_torch.tools.run_odometry --synthetic 2 --n-azimuth 128 --cpu
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import itertools
import pathlib
import sys
import time


class _UdpSweepIter:
    """Iterates live sweeps off a UdpCapture until a frame cap or idle
    timeout (the reference main loop's `capture.isRun()` + retrieve poll,
    odometry_test.cpp:122-132)."""

    def __init__(self, cap, max_frames: int, idle_timeout: float):
        self.cap, self.max_frames, self.idle = cap, max_frames, idle_timeout

    def __iter__(self):
        try:
            n = 0
            while n < self.max_frames and self.cap.is_run():
                sw = self.cap.retrieve(timeout=self.idle)
                if sw is None:
                    break
                yield sw
                n += 1
        finally:
            # Always release the socket + capture thread, even when the
            # consumer raises or stops iterating early.
            self.cap.close()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pcap", nargs="?", help="Velodyne PCAP capture")
    ap.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="run on N synthetic frames instead of a PCAP")
    ap.add_argument("--sensor", choices=["hdl32e", "vlp16", "hdl64e"], default="hdl32e",
                    help="hdl64e: the KITTI odometry benchmark's HDL-64E S2 "
                         "(`config.hdl64e_config`), synthetic input only")
    ap.add_argument("--skip", type=int, default=0,
                    help="skip initial sweeps (reference Start_Frame)")
    ap.add_argument("--frames", type=int, default=0, help="max frames (0 = all)")
    ap.add_argument("--sr-type", choices=["CV", "CVS", "CVSN"], default="CV")
    ap.add_argument("--neighbor-cap", action="store_true",
                    help="reference-parity mode: cap neighborhoods at "
                         "~300 nearest (lidar_odometry.cpp:70) via "
                         "per-point shrunk balls")
    ap.add_argument("--no-icp", action="store_true")
    ap.add_argument("--eval-corr", action="store_true",
                    help="print per-frame correspondence distance stats "
                         "(reference setEvaluateCorr)")
    ap.add_argument("--n-azimuth", type=int, default=0,
                    help="override azimuth bins (synthetic; smaller = faster)")
    ap.add_argument("--out", help="save trajectory xyz text")
    ap.add_argument("--gold", help="compare against a saved trajectory (ATE)")
    ap.add_argument("--checkpoint", help="save final SLAM state to this dir")
    ap.add_argument("--resume", help="resume from a checkpoint dir (map, "
                    "reference frame, pose and prior trajectory carry over; "
                    "either package's files)")
    ap.add_argument("--udp", type=int, default=0, metavar="PORT",
                    help="live capture: listen for Velodyne packets on this "
                         "UDP port instead of reading a PCAP")
    ap.add_argument("--udp-idle", type=float, default=5.0,
                    help="stop live capture after this many idle seconds")
    ap.add_argument("--noise", type=float, default=20.0, metavar="MM",
                    help="synthetic: per-point range noise sigma (mm)")
    ap.add_argument("--adversarial", action="store_true",
                    help="synthetic: hardened scene (ground undulation, low "
                         "clutter, self-car returns)")
    ap.add_argument("--yaw-rate", type=float, default=0.0,
                    help="synthetic: constant yaw per frame (rad); e.g. "
                         "2*pi/N drives a closed loop in N frames")
    ap.add_argument("--live", metavar="DIR",
                    help="live headless view: refresh DIR/live.svg + "
                         "live.json during the run (open DIR/live.html in "
                         "a browser) — the reference's per-frame OpenCV "
                         "window (odometry_test.cpp:195-345), headless")
    ap.add_argument("--live-every", type=int, default=5, metavar="N",
                    help="refresh the live view every N frames")
    ap.add_argument("--step", action="store_true",
                    help="single-step: pause after every frame (Enter = "
                         "next, c = free-run, q = quit) — the reference's "
                         "stopFlag loop (odometry_test.cpp:339-386)")
    ap.add_argument("--profile", metavar="DIR",
                    help="write a torch.profiler trace of the frame loop to "
                         "DIR (Chrome trace, with the engine's slam.* spans "
                         "as ranges) and print their per-frame summary (the "
                         "equivalent of the reference's TicToc prints)")
    ap.add_argument("--backend", action="store_true",
                    help="enable keyframes + B-SHOT loop closure + pose-"
                         "graph optimization")
    ap.add_argument("--ba", action="store_true",
                    help="with --backend: bundle-adjust keyframe poses + "
                         "map landmarks over the odometry inlier "
                         "observations after the run")
    ap.add_argument("--backend-every", type=int, default=0, metavar="N",
                    help="with --backend: run loop closure + pose graph + "
                         "map re-anchoring every N frames during the run, "
                         "so later frames match the corrected map")
    ap.add_argument("--pipeline", action="store_true",
                    help="throughput mode: defer diagnostics fetches so host "
                    "work overlaps device compute (records lag; composes "
                    "with --backend — periodic backend passes drain the "
                    "pipeline first)")
    ap.add_argument("--sharded", type=int, default=0, metavar="N",
                    help="run the engine over N ranks of a process group (map "
                         "rows sharded over the map axis, clouds' query rows "
                         "over the data axis), one spawned process each")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="with --sharded: the process-group backend (default: "
                         "nccl with a card per rank, gloo on the CPU; ranks "
                         "sharing a card need gloo)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the plain PyTorch path) instead of "
                         "the card")
    return ap


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if not args.sharded:
        return _run(args, ap)
    bad = [f for f in ("udp", "live", "step", "profile") if getattr(args, f)]
    if bad:
        ap.error(f"--sharded takes no --{', --'.join(bad)}")
    from bshot_slam_tpu_torch.parallel import multihost

    sys.stdout.flush()
    multihost.spawn_local(_sharded_rank, args.sharded, args=(argv,),
                          backend=args.dist_backend,
                          device="cpu" if args.cpu else "cuda", timeout=24 * 3600)
    return 0


def _sharded_rank(rank: int, argv) -> None:
    """One rank of `--sharded`: the whole run over the mesh.  Rank 0
    prints as it goes; the others' output is dropped."""
    from bshot_slam_tpu_torch.parallel import sharded

    ap = _parser()
    args = ap.parse_args(argv)
    with contextlib.redirect_stdout(sys.stdout if rank == 0 else io.StringIO()):
        rc = _run(args, ap, mesh=sharded.make_mesh())
    sys.stdout.flush()
    if rc:
        raise RuntimeError(f"rank {rank} exited with {rc}")


def _run(args, ap, mesh=None) -> int:
    import numpy as np
    import torch

    from bshot_slam_tpu_torch.config import VLP16_SENSOR, default_config, hdl64e_config
    from bshot_slam_tpu_torch.io import pcap as pcap_io
    from bshot_slam_tpu_torch.io import synthetic, velodyne
    from bshot_slam_tpu_torch.odometry.engine import SlamEngine
    from bshot_slam_tpu_torch.utils import trajectory as traj_io
    from bshot_slam_tpu_torch.utils.metrics import ate_rmse
    from bshot_slam_tpu_torch.utils.profiling import RECORDER, frame_stats, trace

    device = "cpu" if args.cpu else None  # None: the card, or raise
    cfg = default_config()
    if args.sensor == "vlp16":
        cfg = dataclasses.replace(cfg, sensor=VLP16_SENSOR)
    elif args.sensor == "hdl64e":
        if args.udp or (args.pcap and not args.synthetic):
            print(f"--sensor hdl64e: {velodyne.HDL64E_REFUSAL}; use --synthetic N",
                  file=sys.stderr)
            return 2
        cfg = hdl64e_config()
    if args.n_azimuth:
        cfg = dataclasses.replace(
            cfg, sensor=dataclasses.replace(cfg.sensor, n_azimuth=args.n_azimuth)
        )
    cfg = dataclasses.replace(
        cfg,
        keypoints=dataclasses.replace(
            cfg.keypoints, sr_type=args.sr_type,
            neighbor_cap_mode=args.neighbor_cap,
        ),
        match=dataclasses.replace(cfg.match, run_icp=not args.no_icp),
    )

    if args.udp:
        # Live sensor ingest (reference: VelodyneCapture.h:315-408 capture
        # thread over a UDP socket); stream sweeps until --frames or idle.
        from bshot_slam_tpu_torch.io.udp import UdpCapture

        cap = UdpCapture(cfg.sensor, port=args.udp)
        print(f"listening for Velodyne packets on UDP :{cap.port}")
        sweeps = _UdpSweepIter(cap, args.frames or 10**9,
                               idle_timeout=args.udp_idle)
    elif args.synthetic:
        sweeps, gt_poses = synthetic.render_sequence(
            args.synthetic, cfg.sensor, step_mm=400.0, noise_mm=args.noise,
            seed=0, yaw_rate_rad=args.yaw_rate, n_firings=cfg.sensor.n_azimuth,
            adversarial=args.adversarial,
            sensor_height_mm=cfg.preprocess.sensor_height_mm,
        )
    else:
        if not args.pcap:
            ap.error("provide a PCAP path, --synthetic N, or --udp PORT")
        from bshot_slam_tpu_torch.io import native_decoder

        sweeps = None
        if native_decoder.stream_available():
            # Fully native producer/consumer ingest: a C++ thread parses +
            # bins rotations into upload-ready arrays behind a bounded
            # queue, overlapping decode with device compute (the reference
            # capture-thread architecture, VelodyneCapture.h:172).
            try:
                sweeps = native_decoder.NativeSweepStream(
                    args.pcap, cfg.sensor, skip=args.skip
                )
            except RuntimeError:  # not a little-endian classic pcap
                sweeps = None
        if sweeps is None and native_decoder.is_available():
            sweeps = native_decoder.decode_pcap_native(
                args.pcap, cfg.sensor, skip=args.skip
            )
        if sweeps is None:  # the python decoder reads big-endian files too
            payloads, _ = pcap_io.read_udp_payloads(args.pcap)
            sweeps = velodyne.sweeps_from_payloads(payloads, cfg.sensor,
                                                   skip=args.skip)
        if sweeps is None or (isinstance(sweeps, list) and not sweeps):
            print("no complete sweeps found", file=sys.stderr)
            return 1
    if args.frames and not args.udp:  # the UDP iterator caps itself
        if isinstance(sweeps, list):
            sweeps = sweeps[: args.frames]
        else:
            sweeps = itertools.islice(sweeps, args.frames)

    pipelined = args.pipeline
    eng = SlamEngine(cfg, enable_backend=args.backend,
                     backend_every=args.backend_every,
                     pipelined=pipelined,
                     fetch_every=16 if pipelined else 1,
                     keep_corr=bool(args.live), device=device, mesh=mesh)
    print(f"engine on {eng.device}"
          + (f" ({torch.cuda.get_device_name(eng.device)})"
             if eng.device.type == "cuda" else "")
          + ("" if mesh is None else
             f", sharded over {mesh.mesh.numel()} ranks: mesh "
             f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}, graphed "
             f"{not eng.graphs.eager} (eager where gloo stages through the host)"))
    prior_traj = None
    if args.resume:
        from bshot_slam_tpu_torch.checkpoint import load_backend, load_state

        eng.state, prior_poses = load_state(args.resume, device=eng.device,
                                            mesh=mesh)
        eng._place_state()
        prior_traj = prior_poses[:, :3, 3] if len(prior_poses) else None
        print(f"resumed from {args.resume}: map={int(eng.state.map.cursor)} "
              f"frame_idx={int(eng.state.frame_idx)}")
        if args.backend and load_backend(args.resume, eng):
            print(f"  backend: {eng._kf_count} keyframes, "
                  f"{len(eng.loop_edges)} loop edges restored")

    live = None
    if args.live:
        from bshot_slam_tpu_torch.viz.live import LiveView

        live = LiveView(args.live, every=args.live_every)
        print(f"live view -> {args.live}/live.html")
    gold_traj = None
    if args.gold:
        gold_traj = traj_io.load_xyz(args.gold)
    stepping = args.step
    prof = contextlib.ExitStack()
    if args.profile:  # the engine's slam.* spans show as ranges in the trace
        RECORDER.enable(eng.device)
        prof.callback(RECORDER.disable)
        prof.enter_context(trace(args.profile))
    t_start = time.perf_counter()
    for i, sw in enumerate(sweeps):
        t0 = time.perf_counter()
        rec = eng.process_frame(sw)
        dt = (time.perf_counter() - t0) * 1e3
        if rec is None:  # pipelined: nothing finalized yet
            continue
        # In pipelined mode records lag the submitted frame; print
        # the newest finalized frame's index.
        fi = len(eng.records) - 1 if pipelined else i
        pos = rec.pose[:3, 3]
        print(
            f"frame {fi:4d}  pos=({pos[0]:9.0f},{pos[1]:9.0f},{pos[2]:8.0f})mm  "
            f"mutual={rec.n_mutual:4d} inliers={rec.n_inliers:4d} "
            f"{'GATED' if rec.gated else '     '} map={rec.map_size:6d}  "
            f"{dt:7.1f}ms"
        )
        if args.eval_corr:
            m, s, md = rec.corr_stats
            print(f"      corr dist mm: mean={m:.1f} sd={s:.1f} median={md:.1f}")
        if live:
            live.maybe_update(eng, gold_traj)
        if stepping:
            try:
                ans = input("[step] Enter=next  c=continue  q=quit > ")
            except EOFError:
                ans = "c"
            if ans.strip().lower().startswith("q"):
                break
            if ans.strip().lower().startswith("c"):
                stepping = False
    eng.flush()  # pipelined: finalize in-flight frames (else no-op)
    total = time.perf_counter() - t_start
    prof.close()
    if live and eng.records:
        live.update(eng, gold_traj)
    if args.profile:
        print(f"profiler trace -> {args.profile}")
        st = frame_stats(RECORDER.records())
        RECORDER.clear()
        if st is not None:
            def ms(v):
                return "n/a" if v is None else f"{v:.3f}"

            print(f"per frame: fetch wait {ms(st['fetch_wait_ms'])} ms, dispatch "
                  f"{ms(st['dispatch_ms'])} ms, syncs {st['syncs_per_frame']:.3f}, step "
                  f"on the device {ms(st['step_device_ms'])} ms, device gaps "
                  f"{ms(st['device_gap_pct'])} %")
            print(f"clouds: padded {ms(st['padded_pct'])} % of the buckets' rows, "
                  f"{st['truncated_frames']} frames truncated at max_points; "
                  + ", ".join(f"{k} {v}" for k, v in sorted(st["cloud_counts"].items())))
    n = len(eng.records)
    print(f"{n} frames in {total:.1f}s ({n / total:.2f} fps incl. first-use builds)")
    if args.eval_corr and n > 1:
        # Across-frame aggregate of the per-frame stats — the numbers the
        # reference's MATLAB scripts plot from hand-copied stdout
        # (reference: test/Correspondences_analysis.m:7-30).
        cs = np.stack([r.corr_stats for r in eng.records[1:]])
        med = cs[:, 2]
        print(
            f"corr median over {n - 1} frames: "
            f"min={med.min():.1f} mean={med.mean():.1f} max={med.max():.1f} mm; "
            f"inliers mean={np.mean([r.n_inliers for r in eng.records[1:]]):.1f}"
        )

    gt_rel = None
    if args.synthetic and not args.resume and n:
        # SLAM's world frame is the first sensor pose.
        gt_rel = np.linalg.inv(gt_poses[0])[None] @ np.asarray(gt_poses)[:n]
        print(f"ATE RMSE vs synthetic ground truth: "
              f"{ate_rmse(eng.trajectory, gt_rel[:, :3, 3]):.1f} mm")
    if args.backend:
        raw_traj = eng.trajectory.copy()
        kf_poses, edges = eng.optimize_backend()
        n_kf = eng._kf_count
        kf_idx = eng.keyframes.frame_idx[:n_kf].cpu().numpy()
        print(f"backend: {n_kf} keyframes, "
              f"{len(edges)} loop closures; pose graph optimized")
        if gt_rel is not None and n_kf >= 2:
            gt_kf = gt_rel[kf_idx, :3, 3]
            opt_ate = ate_rmse(kf_poses[:, :3, 3], gt_kf)
            raw_ate = ate_rmse(eng.poses[kf_idx][:, :3, 3], gt_kf)
            print(f"keyframe ATE RMSE: raw={raw_ate:.1f} mm "
                  f"optimized={opt_ate:.1f} mm")
        summary = eng.apply_backend_corrections()
        print(f"corrections applied: max |t| "
              f"{summary['max_correction_mm']:.1f} mm over "
              f"{summary['n_landmarks_moved']} landmarks")
        if gt_rel is not None:
            gt_xyz = gt_rel[:n, :3, 3]
            print(f"full-trajectory ATE RMSE: "
                  f"raw={ate_rmse(raw_traj, gt_xyz):.1f} mm "
                  f"corrected={ate_rmse(eng.trajectory, gt_xyz):.1f} mm")
    # Trajectory save/compare happens after the backend so --out/--gold see
    # the corrected trajectory when --backend is on (reference save:
    # odometry_test.cpp:348-361).
    full_traj = eng.trajectory
    if prior_traj is not None:
        # Resumed runs compare/save the full prior+new trajectory so --gold
        # aligns frame 0 of the gold file with the true frame 0.
        full_traj = np.concatenate([prior_traj, full_traj], axis=0)
    if args.out:
        from bshot_slam_tpu_torch.parallel import comm

        if comm.is_writer():
            traj_io.save_xyz(args.out, full_traj)
        print(f"trajectory -> {args.out}")
    if args.gold:
        gold = traj_io.load_xyz(args.gold)
        print(f"ATE RMSE vs {args.gold}: {ate_rmse(full_traj, gold):.1f} mm")
        if args.ba:
            from bshot_slam_tpu_torch.parallel.sharded import sharded_ba_solve

            prob = eng.build_ba_problem()
            n_obs = int(prob.obs_mask.sum())
            if n_obs:
                res = (eng.graphs.ba(prob, gn_iterations=8) if mesh is None
                       else sharded_ba_solve(mesh, prob, gn_iterations=8,
                                             graphs=eng.graphs))
                print(f"BA: {prob.poses.shape[0]} keyframes, "
                      f"{prob.landmarks.shape[0]} landmarks, {n_obs} obs; "
                      f"cost {float(res.initial_cost):.1f} -> "
                      f"{float(res.final_cost):.1f}")
            else:
                print("BA: no landmark observations recorded")
    if args.checkpoint:
        from bshot_slam_tpu_torch.checkpoint import (
            load_state, save_backend, save_state,
        )

        all_poses = eng.poses
        if args.resume:
            _, prior_poses = load_state(args.resume, device="cpu")
            if len(prior_poses):
                all_poses = np.concatenate([prior_poses, all_poses], axis=0)
        save_state(args.checkpoint, eng.state, all_poses, mesh=mesh)
        if args.backend:
            save_backend(args.checkpoint, eng)
        print(f"checkpoint -> {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
    sys.exit(main())
