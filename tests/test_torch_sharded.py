"""The port's sharded step, engine and bundle adjustment on CPU ranks.

Ranks are spawned processes of one gloo process group (one CPU thread each,
`tests/torch_sharded_cases.py`), over `parallel.sharded.make_mesh`:
2 ranks -> ("data", "map") = (1, 2), 4 ranks -> (2, 2).  Held:

  * the sharded step's packed diagnostics and map equal the single-device
    port's (with `mesh_runtime_overrides`) bit for bit, at 2 and 4 ranks;
  * each rank holds C / R rows of every map array, rows r::R of the
    single-device map;
  * against the reference's sharded step on 8 virtual CPU devices (same
    cloud, the reference's features and RANSAC draws injected), its own
    tolerances (tests/test_sharded.py): pose within 1e-3, map_size equal,
    sorted seg ratios equal;
  * the engine through growth, eviction and the backend, synchronous and
    pipelined, and a checkpoint resumed, bit for bit the single-device
    engine's records (2 ranks); the synchronous engine with the device
    preprocess likewise (4 ranks);
  * the sharded bundle adjustment within the reference's tolerances of the
    dense solve (poses rtol 1e-3 / atol 1e-2, landmarks rtol 1e-3 /
    atol 1.0): its sums add in another order;
  * each collective of `parallel.comm` (4 ranks);
  * kernels A and B over a query range aligned to PLAIN_ROWS (as a data
    axis splits) equal the launch over every row, bit for bit (plain
    versions, in this process, at its thread count).
"""

import jax
import numpy as np
import pytest
import torch

from bshot_slam_tpu.config import tiny_config as jax_tiny_config
from bshot_slam_tpu.odometry import pipeline as jpipe
from bshot_slam_tpu.parallel import sharded as jsharded
from bshot_slam_tpu_torch.kernels import neighborhood as nb
from bshot_slam_tpu_torch.odometry.mapstore import ROW_FIELDS
from bshot_slam_tpu_torch.parallel import multihost
from tests import torch_sharded_cases as cases


@pytest.fixture(scope="module")
def reference():
    """The reference's sharded step at 2 and 4 devices: packed row, map, the
    features and draws it used."""
    cfg = jax_tiny_config()
    pts, pmask = cases.step_inputs(cfg)
    key = jax.random.PRNGKey(1)
    out = {}
    for n in (2, 4):
        mesh = jsharded.make_mesh(jax.devices()[:n])
        step, shard = jsharded.sharded_odometry_step(mesh, cfg, tile=cases.TILE)
        s, d = step(shard(jpipe.init_state(cfg)), pts, pmask, key)
        f = d.features
        out[n] = dict(
            packed=np.asarray(d.packed), map_size=int(d.map_size),
            seg=np.sort(np.asarray(s.map.seg_ratios)[np.asarray(s.map.valid)]),
            feats=dict(keypoints=np.asarray(f.keypoints), scores=np.asarray(f.scores),
                       descriptors=np.asarray(f.descriptors).view(np.int32),
                       mask=np.asarray(f.mask)),
            draws=np.asarray(jax.random.uniform(key, (cfg.match.ransac_iterations, 3))))
    return out


def _ba_problem() -> dict:
    from tests.test_backend import _ba_problem as jax_problem

    prob, _, _ = jax_problem(np.random.default_rng(9), M=5, L=30)
    return {k: np.asarray(v) for k, v in prob._asdict().items()}


@pytest.fixture(scope="module")
def spawned(reference, tmp_path_factory):
    """spawned(n): the results of each of n ranks (run once per n)."""
    runs = {}

    def get(n):
        if n not in runs:
            # `single` / `straight`: the rank that runs that reference
            todo = dict(step=dict(single=0),
                        injected=dict(feats=reference[n]["feats"],
                                      draws=reference[n]["draws"], seed=0))
            if n == 2:
                todo.update(engine=dict(single=0, straight=1, ckpt_dir=str(
                    tmp_path_factory.mktemp("ckpt"))),
                            ba=dict(prob=_ba_problem(), single=1))
            else:
                todo.update(comm={}, device_preprocess=dict(single=1))
            runs[n] = multihost.spawn_local(cases.run_cases, n, args=(todo,),
                                            device="cpu", timeout=600)
        return runs[n]

    return get


@pytest.mark.parametrize("n", [2, 4])
def test_step_bit_identical_to_single_device(spawned, n):
    out = spawned(n)
    want = out[0]["step"]
    for r, o in enumerate(out):
        for f, (got, one) in enumerate(zip(o["step"]["packed"], want["single_packed"])):
            assert got.tobytes() == one.tobytes(), (n, r, f)
        for field, v in o["step"]["whole"].items():
            assert v.tobytes() == want["single_map"][field].tobytes(), (n, r, field)
    assert want["single_packed"][1][16] > 5  # the second frame matched


@pytest.mark.parametrize("n", [2, 4])
def test_map_rows_partitioned_cyclically(spawned, n):
    out = spawned(n)
    m = out[0]["mesh"]["map"]
    C = out[0]["step"]["single_map"]["positions"].shape[0]
    assert out[0]["mesh"] == {2: {"data": 1, "map": 2}, 4: {"data": 2, "map": 2}}[n]
    for r, o in enumerate(out):
        assert o["step"]["kind"] == "MapShard"
        for field in ROW_FIELDS:
            local = o["step"]["local"][field]
            assert local.shape[0] == C // m
            np.testing.assert_array_equal(
                local, out[0]["step"]["single_map"][field][r % m::m])


@pytest.mark.parametrize("n", [2, 4])
def test_against_reference_sharded_step(spawned, reference, n):
    out = spawned(n)
    ref = reference[n]
    for o in out:
        got = o["injected"]
        np.testing.assert_allclose(got["packed"][:16], ref["packed"][:16], atol=1e-3)
        whole = got["whole"]
        assert int(whole["valid"].sum()) == ref["map_size"] > 0
        np.testing.assert_array_equal(np.sort(whole["seg_ratios"][whole["valid"]]),
                                      ref["seg"])


def test_engine_records_bit_identical(spawned):
    out = spawned(2)
    want = out[0]["engine"]
    assert want["single_evicted"] > 0 and want["single_kf"] >= 2
    for o in out:
        e = o["engine"]
        assert e["sync"] == want["single"]
        assert e["pipe"] == want["single"]
        assert (e["evicted"], e["kf"]) == (want["single_evicted"], want["single_kf"])
        assert e["kind"] == e["resumed_kind"] == "MapShard"
        assert e["capacity"] == cases.engine_cfg().map.capacity == 2 * e["rows"]


def test_engine_resume_bit_identical(spawned):
    out = spawned(2)
    for o in out:
        assert o["engine"]["resumed"] == out[1]["engine"]["straight"]
        assert len(o["engine"]["resumed"]) == 6


def test_sharded_ba_matches_dense(spawned):
    out = spawned(2)
    dense = out[1]["ba"]["dense"]
    for o in out:
        ba = o["ba"]
        assert ba["final_cost"] < ba["initial_cost"]
        np.testing.assert_allclose(ba["poses"], dense["poses"], rtol=1e-3, atol=1e-2)
        np.testing.assert_allclose(ba["landmarks"], dense["landmarks"], rtol=1e-3,
                                   atol=1.0)


def test_comm_collectives(spawned):
    out = spawned(4)
    for o in out:
        c = o["comm"]
        assert c["min"] == [0, -3, 0] and c["max"] == [3, 0, 30]
        assert c["sum"] == [6, -6, 60]
        assert c["gather"].tobytes() == np.array(
            [[-0.0, r] for r in range(4)], np.float32).tobytes()  # -0.0 kept
        assert c["gather_bool"] == [True, False, True, False]
        assert c["bcast"] == [8]
        assert c["counts"]["t"] == dict(calls=3, bytes=72, syncs=0)
        assert c["backends"] == {"data": "gloo", "map": "gloo"}


def test_device_preprocess_engine_bit_identical(spawned):
    """The synchronous engine with the device preprocess over 4 ranks: the
    single-device records (the pipelined form stays single-device)."""
    out = spawned(4)
    want = out[1]["device_preprocess"]["single"]
    assert len(want) == 3
    for o in out:
        assert o["device_preprocess"]["mesh"] == want


def _cloud(n: int, seed: int = 5):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-6000, 6000, (n, 3)).astype(np.float32)
    mask = rng.uniform(size=n) < 0.9
    return torch.from_numpy(pts), torch.from_numpy(mask)


@pytest.fixture(scope="module")
def full_launch():
    """A cloud and A's and B's (CVS and CVSN) results over every row."""
    n = 2500
    pts, mask = _cloud(n)
    feat = torch.cat([torch.ones((n, 1)), pts], dim=1)
    r2_row = torch.from_numpy(np.random.default_rng(1).uniform(1e5, 9e6, n)
                              .astype(np.float32))
    a = nb.neighborhood_accumulate(pts, mask, feat, 3000.0, r2_row=r2_row, tile=300)
    ctvec = pts - a[:, 1:4] / torch.clamp(a[:, :1], min=1.0)
    b = [nb.segratio_accumulate(pts, mask, ctvec, 3000.0, normalized, tile=300)
         for normalized in (False, True)]
    return pts, mask, feat, r2_row, ctvec, a, b


@pytest.mark.parametrize("rows", [(0, 1024), (1024, 2500), (2048, 2500),
                                  (1024, 2048), (1024, 1024)])
def test_query_range_equals_full_launch(full_launch, rows):
    pts, mask, feat, r2_row, ctvec, full, full_b = full_launch
    q0, q1 = rows
    part = nb.neighborhood_accumulate(pts, mask, feat, 3000.0, r2_row=r2_row,
                                      tile=300, rows=rows)
    assert part.shape == (q1 - q0, 4)
    assert part.numpy().tobytes() == full[q0:q1].numpy().tobytes()
    for normalized, whole in zip((False, True), full_b):
        got = nb.segratio_accumulate(pts, mask, ctvec[q0:q1], 3000.0, normalized,
                                     tile=300, rows=rows)
        assert got.numpy().tobytes() == whole[q0:q1].numpy().tobytes()


@pytest.mark.parametrize("rows", [(64, 256), (0, 200), (256, 128), (0, 1024)])
def test_query_range_rejects_unaligned(rows):
    pts, mask = _cloud(1000)
    with pytest.raises(ValueError, match="query rows"):
        nb.neighborhood_accumulate(pts, mask, torch.ones((1000, 1)), 3000.0, rows=rows)
