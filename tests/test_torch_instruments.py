"""The port's instruments on the CPU against the reference's `tools/`: the
stage bench, the feature profile, the BA bench, the reference statistics
and the point picker (`bshot_slam_tpu_torch/tools/`).

At the tiny config (`default_config` patched to `tiny_config`) with one
intra-op thread, as tests/test_torch_tools.py runs the CLIs:
(a) `run_stage_bench --cpu --iters 1` prints the reference tool's stage
    names and JSON keys; kernel A's tile-skip replay (`kept_tiles`) equals a
    brute-force count of the kernel's `block_box` / `separated` test;
(b) `run_feature_profile --cpu --iters 1` prints the reference tool's
    sub-stage names and keys, then the eigen-solves alone (kernel I's rows
    and its plain version's), and the "sum of parts - whole" line;
(c) `run_ba_bench` builds the reference tool's arrays from the seed, and at 8
    keyframes, 256 landmarks and 64 observations a keyframe its cost
    reduction is within rtol 1e-3 of the reference tool's;
(d) `run_reference_stats` carries the reference tool's tables and keys;
(e) `run_pointpicking` writes the reference tool's select lists and picker
    page byte for byte (the arguments of tests/test_tools.py's picker test);
(f) every other tool raises without a card unless given `--cpu`.
"""

import contextlib
import io
import json
import pathlib
import runpy
import sys

import numpy as np
import pytest
import torch

import bshot_slam_tpu_torch.config as tc

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF_TOOLS = ROOT / "tools"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(tc, "default_config", tc.tiny_config)


def _main(mod, *args):
    """(exit code, stdout lines, the JSON line) of a port tool's main."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = mod.main([str(a) for a in args])
    lines = out.getvalue().splitlines()
    return rc, lines, json.loads([ln for ln in lines if ln.startswith("{")][-1])


def _ref_main(name, monkeypatch, *args):
    """(exit code, stdout, module globals) of the reference's tools/<name>.py."""
    monkeypatch.setattr(sys, "argv", [name, *map(str, args)])
    g = runpy.run_path(str(REF_TOOLS / f"{name}.py"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = g["main"]()
    return rc, out.getvalue(), g


def _in_reference_source(name, *keys):
    src = (REF_TOOLS / f"{name}.py").read_text()
    return [k for k in keys if f'"{k}"' not in src]


# -- (a) the stage bench -------------------------------------------------------

STAGE_NAMES = ["features(SR+normals+SHOT+BSHOT)", "match+RANSAC+ICP", "map insert"]
STAGE_KEYS = ["device", "bucket", "n_valid", "prefill", "iters", "stages", "total_ms",
              "sweep_tiles", "model"]
TILE_KEYS = ["executed_pairs", "cursor_live_pairs", "grid_pairs",
             "aabb_prune_rate_of_live", "cursor_prune_rate_of_grid"]


def test_stage_bench_cpu_prints_the_reference_stages(tiny):
    from bshot_slam_tpu_torch.tools import run_stage_bench

    assert not _in_reference_source("run_stage_bench", *STAGE_NAMES, *STAGE_KEYS,
                                    *TILE_KEYS, "ms", "pct", "gflop", "mbytes")
    rc, lines, res = _main(run_stage_bench, "--cpu", "--iters", 1, "--bucket", 2048,
                           "--prefill", 500)
    assert rc == 0
    names = list(res["stages"])
    assert names[0] == "preprocess(host native)" and names[1:] == STAGE_NAMES
    assert all(k in res for k in STAGE_KEYS) and "peaks_f32_flops_hbm" in res
    assert res["device"] == "cpu" and res["peaks_f32_flops_hbm"] is None
    assert all(k in res["sweep_tiles"] for k in TILE_KEYS)
    for name in STAGE_NAMES:
        row = res["stages"][name]
        assert row["ms"] > 0 and row["gflop"] > 0 and row["mbytes"] > 0
        assert row["event_ms"] is None and "sol_frac" not in row  # no card
    assert len(lines) == len(names) + 1  # a line per stage, then the JSON
    st = res["sweep_tiles"]
    assert 0 < st["executed_pairs"] <= st["cursor_live_pairs"] <= st["grid_pairs"]
    assert res["window_rows"] > 0  # the first frame's keypoints are in the map


def _separated(qb, rb, r2):
    """csrc/neighborhood.cu's `separated`, scalar float32."""
    f = np.float32
    if not qb[0] <= qb[3] or not rb[0] <= rb[3]:
        return True
    lim = f(r2 + f(f(f(qb[6] + rb[6]) + r2) * f(2.0 ** -18)))
    for d in range(3):
        gap = max(f(qb[d] - rb[3 + d]), f(rb[d] - qb[3 + d]))
        if gap > 0 and f(gap * gap) > lim:
            return True
    return False


def _box(p, m):
    """csrc/neighborhood.cu's `block_box` of one tile: lo, hi, max |p|^2
    (the FMA chain of common.cuh) over its valid rows."""
    from bshot_slam_tpu_torch.kernels import fma_dot3

    v = p[m]
    if not len(v):
        return [np.inf] * 3 + [-np.inf] * 3 + [0.0]
    n2 = fma_dot3(torch.as_tensor(v), torch.as_tensor(v)).numpy()
    return [*v.min(0), *v.max(0), n2.max()]


def test_prune_replay_equals_brute_force():
    """`kept_tiles` against the kernel's test pair by pair, on clustered
    points whose boxes fall on both sides of the radius, with masked and
    padded rows."""
    from bshot_slam_tpu_torch.kernels.neighborhood import TILE, kept_tiles
    from bshot_slam_tpu_torch.tools.run_stage_bench import tile_stats

    rng = np.random.default_rng(5)
    n = 11 * TILE + 37
    centers = rng.uniform(-2e4, 2e4, (12, 3))
    pts = (centers[np.arange(n) * 12 // n] + rng.normal(0, 400, (n, 3))).astype(np.float32)
    mask = rng.random(n) > 0.1
    mask[3 * TILE:4 * TILE] = False  # a tile with no valid row
    r = 1200.0
    keep, rows = kept_tiles(pts, mask, r)
    nt = -(-n // TILE)
    pad = np.zeros((nt * TILE - n, 3), np.float32)
    p = np.concatenate([pts, pad]).reshape(nt, TILE, 3)
    m = np.concatenate([mask, np.zeros(len(pad), bool)]).reshape(nt, TILE)
    boxes = [_box(p[t], m[t]) for t in range(nt)]
    r2 = np.float32(r * r)
    want = np.array([[not _separated(boxes[q], boxes[t], r2) for t in range(nt)]
                     for q in range(nt)])
    np.testing.assert_array_equal(keep.numpy(), want)
    np.testing.assert_array_equal(rows.numpy(), m.sum(1))
    assert 0 < want.sum() < ((m.sum(1) > 0).sum()) ** 2  # some pairs skipped, some not
    st = tile_stats(pts, mask, r)
    assert st["executed_pairs"] == want.sum() and st["grid_pairs"] == nt * nt
    assert st["radius_tests"] == sum(int(m[q].sum()) * int(m[t].sum())
                                     for q in range(nt) for t in range(nt) if want[q, t])


# -- (b) the feature profile ---------------------------------------------------

PROFILE_NAMES = ["keypoint top-k", "normals(from moments)", "shot: neighbor gather+topk",
                 "shot: LRF only", "shot: full (gather+LRF+hist)", "bshot binarize+pack",
                 "features fused (whole stage)"]


def test_feature_profile_cpu_prints_the_reference_substages(tiny):
    from bshot_slam_tpu_torch.tools import run_feature_profile

    assert not _in_reference_source("run_feature_profile", *PROFILE_NAMES, "device",
                                    "bucket", "n_valid", "iters", "stages_ms")
    rc, lines, res = _main(run_feature_profile, "--cpu", "--iters", 1, "--bucket", 2048)
    assert rc == 0
    names = list(res["stages_ms"])
    assert names[:2] == ["moments(kernel A sweep)", "segratio(kernel B sweep)"]
    assert names[2:-1] == PROFILE_NAMES + list(run_feature_profile.EIG3_STAGES)
    assert names[-1] == "sum of parts - whole"
    assert all(k in res for k in ("device", "bucket", "n_valid", "iters", "stages"))
    assert all(v > 0 for k, v in res["stages_ms"].items() if k != "sum of parts - whole")
    parts = sum(res["stages_ms"][k] for k in run_feature_profile.PARTS)
    assert res["stages_ms"]["sum of parts - whole"] == pytest.approx(
        parts - res["stages_ms"]["features fused (whole stage)"], abs=1e-3)
    # a line per sub-stage, the selection's line, the JSON line
    assert len(lines) == len(names) + 2
    sel = res["selection"]
    assert sel["keypoints"] > 0 and 0 <= sel["saturated_pct"] <= 100
    assert 0 <= sel["mean_in_radius"] <= sel["max_in_radius"]


# -- (c) the BA bench ----------------------------------------------------------

def test_ba_bench_matches_the_reference_tool(monkeypatch):
    import bshot_slam_tpu.backend.ba as jba
    from bshot_slam_tpu_torch.backend.ba import BAProblem, ba_solve
    from bshot_slam_tpu_torch.tools import run_ba_bench

    size = dict(keyframes=8, landmarks=256, obs_per_kf=64)
    seen = {}
    real_problem, real_solve = jba.BAProblem, jba.ba_solve

    def problem(**kw):
        seen["prob"] = {k: np.asarray(v) for k, v in kw.items()}
        return real_problem(**kw)

    def solve(*a, **kw):
        seen["res"] = real_solve(*a, **kw)
        return seen["res"]

    monkeypatch.setattr(jba, "BAProblem", problem)
    monkeypatch.setattr(jba, "ba_solve", solve)
    rc, out, _ = _ref_main("run_ba_bench", monkeypatch, "--cpu",
                           *(f"--{k.replace('_', '-')}={v}" for k, v in size.items()))
    assert rc == 0
    want_line = json.loads(out)

    arrays = run_ba_bench.problem_arrays(*size.values())
    assert arrays.keys() == seen["prob"].keys()
    for k, v in arrays.items():
        assert v.dtype == seen["prob"][k].dtype, k
        np.testing.assert_array_equal(v, seen["prob"][k], err_msg=k)
    res = ba_solve(BAProblem(**{k: torch.as_tensor(v) for k, v in arrays.items()}),
                   gn_iterations=10, cg_iterations=20)
    got = float(res.initial_cost) / float(res.final_cost)
    want = float(seen["res"].initial_cost) / float(seen["res"].final_cost)
    assert got == pytest.approx(want, rel=1e-3)

    rc, _, line = _main(run_ba_bench, "--cpu", "--gn-iters", 2, "--cg-iters", 5,
                        *(f"--{k.replace('_', '-')}={v}" for k, v in size.items()))
    assert rc == 0 and line["device"] == "cpu" and line["value"] > 0
    assert list(line)[:len(want_line)] == list(want_line)
    assert line["metric"] == want_line["metric"] == "ba_gn_iters_per_sec"


# -- (d) the reference statistics ---------------------------------------------

def test_reference_stats_carries_the_reference_tables(tiny, tmp_path, monkeypatch):
    from bshot_slam_tpu_torch.tools import run_reference_stats as rs

    ref = runpy.run_path(str(REF_TOOLS / "run_reference_stats.py"))
    assert rs.REFERENCE == ref["REFERENCE"] and rs.NOTES == ref["NOTES"]
    out = tmp_path / "refstats.json"
    rc, lines, res = _main(rs, "--cpu", "--frames-static", 2, "--frames-drive", 2,
                           "--out", out, "--workdir", tmp_path / "work")
    assert rc == 0 and json.loads(out.read_text()) == res
    assert set(_in_reference_source("run_reference_stats", *res)) == {"device",
                                                                       "power_limit"}
    assert res["device"] == "cpu" and res["platform"] == "cpu"
    assert list(res["metrics"]) == list(ref["REFERENCE"])
    for k, row in res["metrics"].items():
        assert row["ref_range"] == ref["REFERENCE"][k]["ref_range"]
        lo, hi = row["ours_range"]
        assert lo <= hi
    assert sum("ours=" in ln for ln in lines) == len(ref["REFERENCE"])


# -- (e) the point picker ------------------------------------------------------

def _pick(tool, tmp_path, monkeypatch, tag, *args):
    """Run the port's or the reference's picker; return the bytes it wrote."""
    path = tmp_path / f"{tag}.out"
    args = [a.replace("OUT", str(path)) for a in map(str, args)]
    if tool == "port":
        from bshot_slam_tpu_torch.tools import run_pointpicking

        with contextlib.redirect_stdout(io.StringIO()):
            assert run_pointpicking.main(args) == 0
    else:
        assert _ref_main("run_pointpicking", monkeypatch, *args)[0] == 0
    return path.read_bytes()


@pytest.mark.parametrize("mode", ["html", "box", "merge"])
def test_pointpicking_writes_the_reference_bytes(tmp_path, monkeypatch, mode):
    box = ["-5000", "5000", "-5000", "5000", "-3000", "3000"]
    base = ["--synthetic", "1", "--n-azimuth", "256"]
    if mode == "html":
        args = [*base, "--html", "OUT"]
    elif mode == "box":
        args = [*base, "--box", *box, "--out", "OUT"]
    else:
        old = tmp_path / "old.txt"
        old.write_text("1 2 3 40000\n")
        args = ["--synthetic", "2", "--n-azimuth", "256", "--box", *box,
                "--box", "0", "20000", "0", "20000", "-2000", "0", "--invert",
                "--merge", str(old), "--out", "OUT"]
    got = _pick("port", tmp_path, monkeypatch, "port", *args)
    want = _pick("ref", tmp_path, monkeypatch, "ref", *args)
    assert got == want and len(got) > 100


# -- every instrument needs the card unless asked for the CPU ------------------

@pytest.mark.parametrize("name", ["run_stage_bench", "run_feature_profile", "run_ba_bench",
                                  "run_golden", "run_reference_stats"])
def test_tool_raises_without_a_card(name, tmp_path):
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the tool would run on it")
    mod = importlib.import_module(f"bshot_slam_tpu_torch.tools.{name}")
    args = [] if name in ("run_stage_bench", "run_feature_profile", "run_ba_bench") \
        else ["--out", str(tmp_path / "out.json")]
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        mod.main(args)
    assert not (tmp_path / "out.json").exists()
