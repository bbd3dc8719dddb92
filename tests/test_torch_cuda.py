"""The port's CUDA kernels on the card against their plain versions.

Needs an NVIDIA GPU with nvcc (marker `cuda`); skips elsewhere.  Run on the
card with `python -m pytest tests/test_torch_cuda.py -q -m cuda`.  Integer
outputs must equal the plain version run on CPU copies exactly (the kernels
reproduce its rounding); float sums agree to summation order.  Kernels A
to E also run every edge case of `tests/torch_kernel_cases.py`, twice: the
two runs must be bit-identical.  Map eviction on the card equals the same
call on CPU copies exactly; C and D at the loop-verification shape (600
against 600) equal their plain versions; the pipelined engine with the
backend equals the synchronous one on the card.
"""

import numpy as np
import pytest
import torch

from bshot_slam_tpu_torch import tiny_config
from bshot_slam_tpu_torch.io import synthetic
from bshot_slam_tpu_torch.kernels import mapops as M
from bshot_slam_tpu_torch.kernels import neighborhood as K
from bshot_slam_tpu_torch.odometry import mapstore as tmap
from bshot_slam_tpu_torch.odometry.engine import SlamEngine
from tests.torch_kernel_cases import (
    A_CASES, B_CASES, C_CASES, D_CASES, DEDUP_RADIUS, E_ARGS, E_CASES,
    EVICT_CASES, accumulate_case, dedup_case, euclid_case, evict_case,
    hamming_case, keyframe_pair, segratio_case,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels have no CPU mode)")
    return torch.device("cuda")


def _cloud(n=3000, nv=2421, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.normal(0, 6000, (n, 3)).astype(np.float32)
    pts[nv:] = 0.0
    return torch.tensor(pts), torch.arange(n) < nv


def _to(x, dev):
    return None if x is None else torch.tensor(x).to(dev)


@pytest.mark.parametrize("name", A_CASES)
def test_accumulate_case_on_card(dev, name):
    c = accumulate_case(name)
    want = K.neighborhood_accumulate_plain(
        torch.tensor(c["points"]), torch.tensor(c["mask"]), torch.tensor(c["feat"]),
        c["radius"], None if c["r2_row"] is None else torch.tensor(c["r2_row"]))
    args = (_to(c["points"], dev), _to(c["mask"], dev), _to(c["feat"], dev),
            c["radius"], _to(c["r2_row"], dev))
    got, again = K.neighborhood_accumulate(*args), K.neighborhood_accumulate(*args)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    ones = torch.ones((len(c["mask"]), 1), device=dev)
    cnt = K.neighborhood_accumulate(args[0], args[1], ones, c["radius"], args[4])
    want_cnt = K.neighborhood_accumulate_plain(
        torch.tensor(c["points"]), torch.tensor(c["mask"]), ones.cpu(), c["radius"],
        None if c["r2_row"] is None else torch.tensor(c["r2_row"]))
    torch.testing.assert_close(cnt.cpu(), want_cnt, rtol=0, atol=0)
    live = torch.tensor(c["feat"][c["mask"]])
    top = live.abs().max(dim=0).values if len(live) else torch.zeros(want.shape[1])
    assert ((got.cpu() - want).abs() <= 1e-5 * want_cnt * top[None, :]).all()


@pytest.mark.parametrize("name", B_CASES)
def test_segratio_case_on_card(dev, name):
    c = segratio_case(name)
    pts, mask = torch.tensor(c["points"]), torch.tensor(c["mask"])
    r2_row = None if c["r2_row"] is None else torch.tensor(c["r2_row"])
    x, y, z = pts.unbind(-1)
    mom = K.neighborhood_accumulate_plain(
        pts, mask, torch.stack([torch.ones_like(x), x, y, z], -1), c["radius"], r2_row)
    cnt = mom[:, 0]
    ctvec = (pts - mom[:, 1:4] / cnt.clamp(min=1.0)[:, None] if c["ctvec"] is None
             else torch.tensor(c["ctvec"])).contiguous()
    want = K.segratio_accumulate_plain(pts, mask, ctvec, c["radius"],
                                       c["normalized"], r2_row)
    args = (pts.to(dev), mask.to(dev), ctvec.to(dev), c["radius"], c["normalized"],
            None if r2_row is None else r2_row.to(dev))
    got, again = K.segratio_accumulate(*args), K.segratio_accumulate(*args)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    torch.testing.assert_close(got[:, :2].cpu(), want[:, :2], rtol=0, atol=0)
    tol = (1e-5 * cnt + 1e-3 if c["normalized"]
           else 1e-5 * cnt * torch.linalg.norm(ctvec, dim=-1) * c["radius"] + 1e-2)
    assert ((got[:, 2].cpu() - want[:, 2]).abs() <= tol).all()


@pytest.mark.parametrize("name", C_CASES)
def test_hamming_case_on_card(dev, name):
    c = hamming_case(name)
    words = [torch.tensor(c[k].view(np.int32)) for k in ("a_words", "b_words")]
    cpu = (words[0], torch.tensor(c["a_mask"]), words[1], torch.tensor(c["b_mask"]))
    want = M.hamming_nn_bounded_plain(*cpu, c["n_valid"], c["tail_start"])
    args = [t.to(dev) for t in cpu]
    for nv in (c["n_valid"], torch.tensor(c["n_valid"], dtype=torch.int32, device=dev)):
        got = M.hamming_nn_bounded(*args, nv, c["tail_start"])
        again = M.hamming_nn_bounded(*args, nv, c["tail_start"])
        for g, a, w in zip(got, again, want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
            assert torch.equal(g, a)


@pytest.mark.parametrize("ka,cb", [(0, 700), (5, 0), (0, 0)])
def test_hamming_empty_side_on_card(dev, ka, cb):
    """An empty side launches nothing and reports (3e38, 0) for every row, as
    the plain version does."""
    cpu = (torch.zeros((ka, 11), dtype=torch.int32), torch.ones(ka, dtype=torch.bool),
           torch.zeros((cb, 11), dtype=torch.int32), torch.ones(cb, dtype=torch.bool))
    want = M.hamming_nn_bounded_plain(*cpu, cb, -1)
    before = M.hamming_nn_bounded.launches
    got = M.hamming_nn_bounded(*[t.to(dev) for t in cpu], cb, -1)
    assert M.hamming_nn_bounded.launches == before
    for g, w in zip(got, want):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("name", D_CASES)
def test_euclid_case_on_card(dev, name):
    c = euclid_case(name)
    want = M.euclid_nn_bounded_plain(
        torch.tensor(c["q"]), torch.tensor(c["q_mask"]), torch.tensor(c["ref"]),
        torch.tensor(c["ref_mask"]), c["n_valid"], c["tail_start"])
    args = [_to(c[k], dev) for k in ("q", "q_mask", "ref", "ref_mask")]
    for nv in (c["n_valid"], torch.tensor(c["n_valid"], dtype=torch.int32, device=dev)):
        got = M.euclid_nn_bounded(*args, nv, c["tail_start"])
        again = M.euclid_nn_bounded(*args, nv, c["tail_start"])
        for g, a, w in zip(got, again, want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
            assert torch.equal(g, a)


@pytest.mark.parametrize("name", E_CASES)
def test_dedup_case_on_card(dev, name):
    c = dedup_case(name)
    cpu = [torch.tensor(c[a]) for a in E_ARGS]
    want = M.dedup_blocked_bounded_plain(*cpu, c["n_valid"], DEDUP_RADIUS)
    args = [t.to(dev) for t in cpu]
    for nv in (c["n_valid"], torch.tensor(c["n_valid"], dtype=torch.int32, device=dev)):
        got = M.dedup_blocked_bounded(*args, nv, DEDUP_RADIUS)
        again = M.dedup_blocked_bounded(*args, nv, DEDUP_RADIUS)
        assert got.dtype == torch.bool and got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
        assert torch.equal(got, again)


@pytest.mark.parametrize("k,c", [(0, 700), (5, 0), (0, 0)])
def test_dedup_empty_side_on_card(dev, k, c):
    """No newcomers or no map rows: (k,) False on the card, without a launch."""
    args = (torch.zeros((k, 3)), torch.zeros((k, 3), dtype=torch.int32), torch.zeros(k),
            torch.zeros((c, 3)), torch.zeros((c, 3), dtype=torch.int32), torch.ones(c),
            torch.ones(c, dtype=torch.bool))
    before = M.dedup_blocked_bounded.launches
    got = M.dedup_blocked_bounded(*[t.to(dev) for t in args], c, DEDUP_RADIUS)
    assert M.dedup_blocked_bounded.launches == before
    assert got.device.type == "cuda" and got.dtype == torch.bool
    assert got.shape == (k,) and not got.any()


def test_neighborhood_kernels(dev):
    pts, mask = _cloud()
    x, y, z = pts.unbind(-1)
    feat = torch.stack([torch.ones_like(x), x, y, z, x * x, y * z], -1)
    r2_row = torch.full((pts.shape[0],), 2500.0**2)
    r2_row[::3] = 1800.0**2
    for r2 in (None, r2_row):
        want = K.neighborhood_accumulate(pts, mask, feat, 3000.0, r2_row=r2)
        got = K.neighborhood_accumulate(
            pts.to(dev), mask.to(dev), feat.to(dev), 3000.0,
            r2_row=None if r2 is None else r2.to(dev)).cpu()
        torch.testing.assert_close(got[:, 0], want[:, 0], rtol=0, atol=0)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e3)
    ctvec = (pts - want[:, 1:4] / want[:, :1].clamp(min=1)).contiguous()
    for normalized in (False, True):
        want = K.segratio_accumulate(pts, mask, ctvec, 3000.0, normalized)
        got = K.segratio_accumulate(pts.to(dev), mask.to(dev), ctvec.to(dev),
                                    3000.0, normalized).cpu()
        torch.testing.assert_close(got[:, :2], want[:, :2], rtol=0, atol=0)
        torch.testing.assert_close(got[:, 2], want[:, 2], rtol=1e-4, atol=1.0)


@pytest.mark.parametrize("tail", [-1, 1500])
def test_map_kernels(dev, tail):
    rng = np.random.default_rng(2)
    ka, cb, nv = 300, 1700, 1203
    a = torch.tensor(rng.integers(0, 2**32, (ka, 11), dtype=np.uint64)
                     .astype(np.uint32).view(np.int32))
    b = torch.tensor(rng.integers(0, 2**32, (cb, 11), dtype=np.uint64)
                     .astype(np.uint32).view(np.int32))
    b[[5, 9]] = a[0]
    am = torch.tensor(rng.random(ka) > 0.1)
    bm = torch.tensor(rng.random(cb) > 0.1) & (torch.arange(cb) < nv)
    if tail >= 0:
        bm[tail:] = True
    want = M.hamming_nn_bounded(a, am, b, bm, nv, tail)
    got = M.hamming_nn_bounded(a.to(dev), am.to(dev), b.to(dev), bm.to(dev), nv, tail)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    q = torch.tensor(rng.uniform(-4e4, 4e4, (ka, 3)).astype(np.float32))
    r = torch.tensor(rng.uniform(-1e5, 1e5, (cb, 3)).astype(np.float32))
    want = M.euclid_nn_bounded(q, am, r, bm, nv, tail)
    got = M.euclid_nn_bounded(q.to(dev), am.to(dev), r.to(dev), bm.to(dev), nv, tail)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    pos = torch.trunc(q / 10) * 10
    mpos = r.clone()
    mpos[:ka] = pos + torch.tensor(rng.normal(0, 500, (ka, 3)).astype(np.float32))
    args = (pos, torch.round(pos / 1e4).int(), torch.rand(ka), mpos,
            torch.round(mpos / 1e4).int(), torch.rand(cb), torch.arange(cb) < nv, nv)
    want = M.dedup_blocked_bounded(*args)
    got = M.dedup_blocked_bounded(*[t.to(dev) if isinstance(t, torch.Tensor) else t
                                    for t in args])
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)
    assert 0 < int(want.sum()) < ka


def test_engine_step_on_card(dev):
    cfg = tiny_config()
    sweeps, _ = synthetic.render_sequence(3, cfg.sensor, seed=3,
                                          n_firings=cfg.sensor.n_azimuth)
    draws = [np.random.default_rng(i).random((cfg.match.ransac_iterations, 3))
             for i in range(3)]
    on_card = SlamEngine(cfg, tile=256, draws=draws)
    on_cpu = SlamEngine(cfg, tile=256, device="cpu", draws=draws)
    for sw in sweeps:
        a, b = on_card.process_sweep(sw), on_cpu.process_sweep(sw)
        assert abs(a.map_size - b.map_size) <= 3
        assert np.abs(a.pose[:3, 3] - b.pose[:3, 3]).max() <= 5.0


@pytest.mark.parametrize("case", sorted(EVICT_CASES))
def test_evict_on_card(dev, case):
    """Eviction on the card equals the same call on CPU copies exactly,
    every field (the permutation included), twice."""
    d, n_evict = evict_case(case)
    t = {f: torch.tensor(d[f].view(np.int32) if d[f].dtype == np.uint32 else d[f])
         for f in d}
    want = tmap.evict_keypoints(tmap.MapState(**t), n_evict)
    for _ in range(2):
        got = tmap.evict_keypoints(tmap.MapState(**{f: x.to(dev) for f, x in t.items()}),
                                   n_evict)
        for f, g, w in zip(tmap.MapState._fields, got, want):
            assert torch.equal(g.cpu(), w), f


def test_loop_verification_kernels_on_card(dev):
    """Kernels C and D at the loop-verification shape (600 keypoints against
    600), as `_verify_pair` calls them, equal their plain versions on CPU
    copies, twice."""
    kp_a, desc_a, mask_a, kp_b, desc_b, mask_b = keyframe_pair(1)
    a, b = torch.tensor(desc_a.view(np.int32)), torch.tensor(desc_b.view(np.int32))
    am, bm = torch.tensor(mask_a), torch.tensor(mask_b)
    want = M.hamming_nn_bounded(a, am, b, bm, 600)
    q, r = torch.tensor(kp_a), torch.tensor(kp_b)
    want_d = M.euclid_nn_bounded(q, am, r, bm, 600)
    for _ in range(2):
        got = M.hamming_nn_bounded(a.to(dev), am.to(dev), b.to(dev), bm.to(dev), 600)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        got = M.euclid_nn_bounded(q.to(dev), am.to(dev), r.to(dev), bm.to(dev), 600)
        for g, w in zip(got, want_d):
            assert torch.equal(g.cpu(), w)


def test_pipelined_engine_on_card(dev):
    """The pipelined engine with the backend on the card gives the
    synchronous engine's records, bit for bit (the kernels are
    deterministic)."""
    cfg = tiny_config()
    sweeps, _ = synthetic.render_sequence(6, cfg.sensor, seed=3,
                                          n_firings=cfg.sensor.n_azimuth)
    runs = []
    for pipelined in (False, True):
        eng = SlamEngine(cfg, tile=256, enable_backend=True, backend_every=3,
                         pipelined=pipelined, fetch_every=2)
        for sw in sweeps:
            eng.process_sweep(sw)
        eng.flush()
        runs.append(eng.records)
    for a, b in zip(*runs):
        assert np.array_equal(a.pose, b.pose) and a.map_size == b.map_size
