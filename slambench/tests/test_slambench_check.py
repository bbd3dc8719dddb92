"""The correctness check: a sound tiny run reads within what the plain
path allows, and each fault a cell can have, planted underneath the timed
path, and the control turn `correct` false."""

import json

import numpy as np
import pytest
import torch

from bshot_slam_tpu_torch.odometry import engine as engine_mod
from bshot_slam_tpu_torch.odometry import graphs as graphs_mod
from slambench import cell as cell_mod
from slambench import control, harness
from slambench.reference import check as check_mod
from slambench.tests import tiny

SEED = 2**31 + 99


def harness_workloads():
    bench = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
    return [w["name"] for w in bench["workloads"]]


def run(workload="hdl32e.replay", seed=SEED):
    torch.set_num_threads(2)
    return harness.run_cell(tiny.tiny_cell(workload), seed, 1.0, False, 0.0,
                            device="cpu", log=lambda s: None)


def numbers(out):
    return {k: v["value"] for k, v in out["check"].items()}


def failing(out):
    return {k for k, v in out["check"].items() if v["value"] > v["limit"]}


@pytest.fixture(scope="module")
def sound():
    return numbers(run())


def test_sound_run_reads_the_plain_path(sound):
    """The CPU runs the program's plain path: keypoints and map rows agree,
    the clouds differ only in the native library's rounding."""
    assert sound["cloud_gap_pct"] < 0.5
    assert sound["keypoints_gap_pct"] == 0.0 and sound["map_rows_median_gap"] == 0.0
    assert sound["pose_median_gap_mm"] < 0.05


def test_state_left_unchanged_fails(monkeypatch, sound):
    """A step that returns its state unchanged: the map never grows."""
    orig = graphs_mod.Graphs.step

    def step(self, cfg, tile, state, ok, *args, **kwargs):
        before = graphs_mod.clone_tree(state)
        bufs, okb, diag = orig(self, cfg, tile, state, ok, *args, **kwargs)
        for b, s in zip(graphs_mod.leaves(bufs), graphs_mod.leaves(before)):
            b.copy_(s)
        return bufs, okb, diag

    monkeypatch.setattr(graphs_mod.Graphs, "step", step)
    out = run()
    assert not out["correct"] and "map_rows_median_gap" in failing(out)


def test_half_the_cloud_left_out_fails(monkeypatch):
    """Half of each frame's points left out of ingest."""
    orig = engine_mod.host_cloud

    def host_cloud(*args, **kwargs):
        points, nv = orig(*args, **kwargs)
        points = points.copy()
        points[nv // 2:] = 0.0
        return points, nv // 2

    monkeypatch.setattr(engine_mod, "host_cloud", host_cloud)
    out = run()
    assert not out["correct"] and "cloud_gap_pct" in failing(out)


@pytest.mark.parametrize("workload", harness_workloads())
def test_pose_altered_where_produced_fails(monkeypatch, workload):
    """Each record's pose moved by half a metre where the engine makes it."""
    orig = engine_mod.SlamEngine._finalize

    def _finalize(self, diag, pk, *args, **kwargs):
        pk = pk.copy()
        pk[3] += 500.0
        return orig(self, diag, pk, *args, **kwargs)

    monkeypatch.setattr(engine_mod.SlamEngine, "_finalize", _finalize)
    out = run(workload)
    assert not out["correct"] and "pose_median_gap_mm" in failing(out)


def test_control_fails_on_the_cpu():
    """The reference with its cloud in bfloat16 in the program's place (the
    CPU has no TF32: the step stays float32 there)."""
    r = control.readings(tiny.tiny_cell("hdl32e.replay"), [SEED], 1.0, device="cpu")
    limits = tiny.tiny_cell("hdl32e.replay").limits
    prog, ctrl = r["program"][0], r["control"][0]
    assert any(ctrl[n] > limits[n] for n in check_mod.NUMBERS)
    assert ctrl["cloud_gap_pct"] > 10 * max(prog["cloud_gap_pct"], 1.0)


@pytest.mark.cuda
def test_control_fails_on_the_card():
    """The control on the card at the tiny size: the cloud in bfloat16 and
    the step's float32 products in TF32 fail the check."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = tiny.tiny_cell("hdl32e.replay")
    r = control.readings(cell, [SEED, SEED + 1, SEED + 2], 1.0)
    for ctrl in r["control"]:
        assert any(ctrl[n] > cell.limits[n] for n in check_mod.NUMBERS)


def test_median_pose_gap_is_a_median():
    g = check_mod.pose_gap(np.eye(4), np.eye(4))
    assert g == (0.0, 0.0)
    t = np.eye(4)
    t[:3, 3] = (3.0, 4.0, 0.0)
    assert check_mod.pose_gap(t, np.eye(4))[0] == pytest.approx(5.0)
