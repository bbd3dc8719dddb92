"""The port's multi-process entry layer on the CPU (gloo).

  * Two processes, each a "host" of one rank, run
    tests/torch_multihost_worker.py: `multihost.initialize`, `host_mesh`,
    `make_global`, one `multihost_odometry_step` and a four-frame engine
    sequence, bit for bit the single-process port's, the map partitioned
    across the processes.
  * `graft_entry.dryrun_multichip(4)` and the collective-cost tool over 4
    CPU ranks (tiny config): both layouts, the calls and payload bytes per
    frame of each call site, from the comm layer's counters.
  * `initialize` raises, rather than pick a backend, when ranks would share
    a card.

Every child process runs under a timeout, so a hung rendezvous fails the
test instead of the run.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from bshot_slam_tpu_torch import graft_entry
from bshot_slam_tpu_torch.parallel import multihost
from bshot_slam_tpu_torch.tools import collective_cost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_multihost_worker.py")


def test_two_process_host_mesh():
    port = multihost.free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("LOCAL_WORLD_SIZE",
                                                             "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen([sys.executable, WORKER, str(i), "2", str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {i} rc={rc}\nstdout:\n{out}\nstderr:\n{err}"
        assert f"MULTIHOST_OK pid={i}" in out, (out, err)


def test_dryrun_multichip_cpu():
    out = graft_entry.dryrun_multichip(4, device="cpu")
    assert out[0]["mesh"] == {"data": 2, "map": 2}
    assert {o["map_rows"] for o in out} == {2048}  # tiny capacity 4096 over 2
    assert out[0]["collectives"] > 0


def test_collective_cost_tool_cpu(tmp_path):
    path = tmp_path / "coll.json"
    assert collective_cost.main(["--cpu", "--ranks", "4", "--frames", "2",
                                 "--out", str(path)]) == 0
    res = json.loads(path.read_text())
    single, multi = res["layouts"]["data_map"], res["layouts"]["hosts_devices"]
    assert single["mesh"] == {"data": 2, "map": 2}
    assert multi["mesh"] == {"hosts": 2, "devices": 2}
    for lay in (single, multi):
        site = lay["per_frame"]
        K = 64  # tiny_config's keypoints
        assert site["C: key min"] == dict(calls=1, bytes=8 * K, syncs=0)
        assert site["D: key min"] == dict(calls=10, bytes=10 * 8 * K, syncs=0)
        assert site["E: flag or"]["calls"] == 1
        assert site["A+B: query rows"]["calls"] == 1
        assert lay["calls_per_frame"] == sum(v["calls"] for v in site.values())
    assert single["per_frame"] == multi["per_frame"]


def test_initialize_names_no_backend_for_shared_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    with pytest.raises(ValueError, match="gloo"):
        multihost.initialize("localhost:1", 2, 0, device="cuda")
