"""The port's CUDA kernels on the card against their plain versions.

Needs an NVIDIA GPU with nvcc (marker `cuda`); skips elsewhere.  Run on the
card with `python -m pytest tests/test_torch_cuda.py -q -m cuda`.  Integer
outputs must equal the plain version run on CPU copies exactly (the kernels
reproduce its rounding); float sums agree to summation order.  Kernels A
to E also run every edge case of `tests/torch_kernel_cases.py`, twice: the
two runs must be bit-identical.  Map eviction on the card equals the same
call on CPU copies exactly; C and D at the loop-verification shape (600
against 600) equal their plain versions; the pipelined engine with the
backend equals the synchronous one on the card.  Kernel F (the ground
walk) runs its edge cases likewise, classes cell-exact; the pipelined
engine with the device preprocess equals the synchronous one through a
bucket overflow; the evaluation ops (ISS through kernel A, repeatability,
the voxel grid, `mutual_nn(use_matmul=True)`) agree with the CPU.  A and B
over a TILE-aligned range of query rows equal the launch over every row,
bit for bit; at `NARROW_ROWS` rows (every query block listing all 1024
tiles, and a wide cloud) they agree with their plain versions at the start,
the middle and the end of the cloud, and so they do in their wide form at
131,200, 196,608 and 230,400 rows (all 1,800 tiles listed), twice alike; a
graphed frame of the VLS-128 cell at a wide bucket gives the eager frame's
record and launches as many kernels as one at 131,072.  The engine through its CUDA graphs (`odometry.graphs`:
synchronous and pipelined, host and device preprocess, through a window
overflow, with the backend's pair verification) equals `graphs=False` bit
for bit and counts the same kernel launches; through a window overflow the
graphed engine re-runs from the dense step's graph, never eagerly; a map
eviction replayed from its graph equals the eager one; the mesh engine over
one NCCL rank replayed from its graphs equals its eager run, collectives
included, and the sharded bundle adjustment's graph lies within the BA
limits of the eager solve; a capture that meets a host synchronisation
raises, and a capture runs with Python's cyclic collector off.  Two
engines whose configurations differ only in a threshold share one
`Graphs` and each equals its own `graphs=False` run;
the backend's pose graph, keyframe histograms and BA replayed from their
graphs equal the eager calls (BA: within fixed limits of its nearest eager
run, whose `index_add_` adds floats with atomics; a planted fault is not).
Kernel G (the ICP update) on each case of `G_CASES`: its start is the
identity and the source, and each update, given the plain update's points
and correspondences, agrees with it (pair counts exact, rotation entries
within 1e-6, translations within 1e-3 mm, rmse within 1e-5 relative: the
sums run in another order), one device launch a call, bit-identical over
two runs; the whole ICP through G against the plain update's loop on the
card, in step at every iteration within those limits, and free-running
within 1e-5 and 0.01 mm until a correspondence flips, a flip only at a
tie of the expanded d2, the final poses then within a stated gap
(`icp_traces_agree`), 21 launches an ICP of 10 iterations; a graphed frame advances `icp_update.launches` by the
iterations + 1.  Kernel H (SHOT's neighbour selection) on each case of
`H_CASES` (2048 to 131072 rows, 64 and 600 keypoints, 64 and 384
neighbours, and fewer rows than neighbours) and `H_WIDE_CASES` (its wide
form at 131,200 to 230,400 rows, the keypoints' rows past row 2^17;
keypoints with 0, m // 2, m,
m + 1 and over 10 m rows in radius, ties at the cut and over a whole
histogram bin, rows at d2 = r2 and d2 = 0, masked rows and keypoints)
equals its plain version on CPU copies bit for bit, and itself over two
runs; `gather_neighbors`' fields equal the CPU's bit for bit (its `dist`
within an ulp: the card's sqrt); H is two
device launches a call and replays from a CUDA graph; it refuses what it
does not take; a graphed frame advances `shot_neighbors.launches` by one.
Kernel I (the 3x3 symmetric eigen-solve) on each case of `I_CASES`
(random, isotropic and around the isotropic guard, two equal eigenvalues
rotated and on the axes, rank 1, zeros of both signs), on mixed batches of
`I_BATCHES` (1 to 131,072 matrices, a ragged grid among them) and on real
covariances (a frame's moments through the normals' formula and its
keypoints' LRF covariances) equals its plain version on the same CUDA
tensors bit for bit (int32 views, so -0.0 and NaN count), and itself over
two runs; it is one device launch a call, replays from a CUDA graph and
refuses what it does not take; a graphed frame advances `eigh3.launches`
by two.
"""

import numpy as np
import pytest
import torch

from bshot_slam_tpu_torch import tiny_config
from bshot_slam_tpu_torch.geometry import se3
from bshot_slam_tpu_torch.io import synthetic
from bshot_slam_tpu_torch.kernels import eig3 as E
from bshot_slam_tpu_torch.kernels import mapops as M
from bshot_slam_tpu_torch.kernels import neighborhood as K
from bshot_slam_tpu_torch.odometry import mapstore as tmap
from bshot_slam_tpu_torch.odometry.engine import SlamEngine
from tests.torch_kernel_cases import (
    A_CASES, B_CASES, C_CASES, D_CASES, DEDUP_RADIUS, E_ARGS, E_CASES,
    EVICT_CASES, F_CASES, G_CASES, H_CASES, H_WIDE_CASES, I_BATCHES, I_CASES,
    accumulate_case,
    dedup_case, eig3_case, euclid_case, evict_case, hamming_case, icp_case, icp_trace,
    icp_traces_agree, iss_corners, keyframe_pair, moment_features, overflow_sequence,
    segratio_case, select_case, walk_case,
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


@pytest.mark.parametrize("rows", [(0, 128), (128, 1536), (1536, 3000), (2944, 3000),
                                  (256, 256)])
def test_neighborhood_query_range_on_card(dev, rows):
    """A and B over a TILE-aligned range of query rows (the data axis of a
    mesh) equal the launch over every row bit for bit, and launch once."""
    pts, mask = _cloud()
    x, y, z = pts.unbind(-1)
    feat = torch.stack([torch.ones_like(x), x, y, z, x * x, y * z], -1)
    r2_row = torch.full((pts.shape[0],), 2500.0**2)
    r2_row[::3] = 1800.0**2
    q0, q1 = rows
    d = [t.to(dev) for t in (pts, mask, feat, r2_row)]
    full = K.neighborhood_accumulate(d[0], d[1], d[2], 3000.0, r2_row=d[3])
    before = K.neighborhood_accumulate.launches
    part = K.neighborhood_accumulate(d[0], d[1], d[2], 3000.0, r2_row=d[3], rows=rows)
    assert K.neighborhood_accumulate.launches == before + (q1 > q0)
    assert part.shape == (q1 - q0, feat.shape[1])
    assert torch.equal(part.view(torch.int32), full[q0:q1].view(torch.int32))
    ctvec = (d[0] - full[:, 1:4] / full[:, :1].clamp(min=1)).contiguous()
    for normalized in (False, True):
        whole = K.segratio_accumulate(d[0], d[1], ctvec, 3000.0, normalized)
        got = K.segratio_accumulate(d[0], d[1], ctvec[q0:q1].contiguous(), 3000.0,
                                    normalized, rows=rows)
        assert torch.equal(got.view(torch.int32), whole[q0:q1].view(torch.int32))


def _max_rows_cloud(kind: str, n: int = K.NARROW_ROWS):
    """A cloud of n rows: "ball", every point within half the radius of the
    origin, so each query block lists every candidate tile (1024 at
    `K.NARROW_ROWS`); "spread", a wide cloud whose last rows are masked."""
    rng = np.random.default_rng(64)
    if kind == "ball":
        pts = rng.uniform(-860.0, 860.0, (n, 3)).astype(np.float32)
        nv = n
    else:
        pts = rng.normal(0, 9000, (n, 3)).astype(np.float32)
        nv = n - 1000
        pts[nv:] = 0.0
    return torch.tensor(pts), torch.arange(n) < nv


def _max_rows_queries(n: int) -> list:
    """Query blocks of 1024 rows at the start, the middle and the end of n
    rows (TILE-aligned starts)."""
    mid = n // 2 // K.TILE * K.TILE
    end = (n - 1024) // K.TILE * K.TILE
    return [(0, 1024), (mid, mid + 1024), (end, n)]


MAX_ROWS_QUERIES = _max_rows_queries(K.NARROW_ROWS)


def _neighborhood_kernels_at(dev, kind: str, n: int):
    """A and B over n rows, one launch each over every row and twice alike,
    against their plain versions on CPU copies over query blocks at the
    start, the middle and the end: counts exact, sums within the case
    tolerances above."""
    pts, mask = _max_rows_cloud(kind, n)
    feat = torch.tensor(moment_features(pts.numpy()))
    d = [t.to(dev) for t in (pts, mask, feat)]
    got = K.neighborhood_accumulate(d[0], d[1], d[2], 3000.0)
    again = K.neighborhood_accumulate(d[0], d[1], d[2], 3000.0)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    got = got.cpu()
    top = feat[mask].abs().max(dim=0).values
    queries = _max_rows_queries(n)
    for rows in queries:
        want = K.neighborhood_accumulate_plain(pts, mask, feat, 3000.0, rows=rows)
        part = got[rows[0]:rows[1]]
        torch.testing.assert_close(part[:, 0], want[:, 0], rtol=0, atol=0)
        assert ((part - want).abs() <= 1e-5 * want[:, :1] * top[None, :]).all()
    if kind == "ball":
        assert (got[:, 0] == n).all()
    ctvec = (pts - got[:, 1:4] / got[:, :1].clamp(min=1.0)).contiguous()
    for normalized in (False, True):
        gb = K.segratio_accumulate(d[0], d[1], ctvec.to(dev), 3000.0, normalized)
        gb2 = K.segratio_accumulate(d[0], d[1], ctvec.to(dev), 3000.0, normalized)
        assert torch.equal(gb.view(torch.int32), gb2.view(torch.int32))
        gb = gb.cpu()
        for rows in queries:
            q0, q1 = rows
            want = K.segratio_accumulate_plain(pts, mask, ctvec[q0:q1].contiguous(),
                                               3000.0, normalized, rows=rows)
            torch.testing.assert_close(gb[q0:q1, :2], want[:, :2], rtol=0, atol=0)
            cnt = got[q0:q1, 0]
            tol = (1e-5 * cnt + 1e-3 if normalized else
                   1e-5 * cnt * torch.linalg.norm(ctvec[q0:q1], dim=-1) * 3000.0 + 1e-2)
            assert ((gb[q0:q1, 2] - want[:, 2]).abs() <= tol).all()


@pytest.mark.parametrize("kind", ["ball", "spread"])
def test_neighborhood_kernels_at_max_rows(dev, kind):
    """A and B over `K.NARROW_ROWS` rows (the HDL-64E preset's
    `max_points`, the narrow form's limit of 1024 listed tiles)."""
    _neighborhood_kernels_at(dev, kind, K.NARROW_ROWS)


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


@pytest.mark.parametrize("name", F_CASES)
def test_ground_walk_case_on_card(dev, name):
    from bshot_slam_tpu_torch.kernels import preprocess as KF

    cfg = tiny_config().preprocess
    c = walk_case(name)
    cpu = [torch.tensor(c[k]) for k in ("range_mm", "xyz", "p0")]
    args = [x.to(dev) for x in cpu]
    got, again = KF.ground_walk(*args, cfg), KF.ground_walk(*args, cfg)
    assert got.dtype == torch.int32 and torch.equal(got, again)
    assert torch.equal(got, KF.ground_walk_plain(*args, cfg))
    assert torch.equal(got.cpu(), KF.ground_walk_plain(*cpu, cfg))


def test_fused_engine_on_card(dev):
    import dataclasses

    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, cloud_buckets=(512, 1024, 2048)))
    vert = np.deg2rad(np.sort(np.array(cfg.sensor.vertical_angles_deg))).astype(np.float32)
    runs = []
    for pipelined in (False, True):
        eng = SlamEngine(cfg, seed=0, tile=cfg.runtime.point_tile, device=dev,
                         host_preprocess=False, pipelined=pipelined, fetch_every=4)
        for r, az in overflow_sequence(cfg, base=400, spike=1200):
            eng.process_range_image(r, az, vert)
        eng.flush()
        runs.append(eng)
    sync, pipe = runs
    assert pipe.n_redispatched > 0
    assert len(sync.records) == len(pipe.records) == 6
    for a, b in zip(sync.records, pipe.records):
        np.testing.assert_array_equal(a.pose, b.pose)
        assert (a.n_inliers, a.n_mutual, a.map_size) == (b.n_inliers, b.n_mutual, b.map_size)


def test_eval_ops_on_card(dev):
    from bshot_slam_tpu_torch.ops import hamming, keypoints, voxelgrid

    cfg = tiny_config().keypoints
    pts, mask = iss_corners()
    want = keypoints.iss_keypoints(torch.tensor(pts), torch.tensor(mask), cfg, 1024, 256)
    got = keypoints.iss_keypoints(torch.tensor(pts, device=dev),
                                  torch.tensor(mask, device=dev), cfg, 1024, 256)
    n_c, n_g = int(want.mask.sum()), int(got.mask.sum())
    common = np.intersect1d(want.indices[:n_c].numpy(), got.indices[:n_g].cpu().numpy())
    assert n_c > 20 and abs(n_g - n_c) <= 0.1 * n_c and len(common) >= 0.75 * n_c
    flipped = (torch.flip(want.positions, [0]), torch.flip(want.mask, [0]))
    r_c = keypoints.repeatability(want.positions, want.mask, *flipped)
    r_g = keypoints.repeatability(*(x.to(dev) for x in (want.positions, want.mask,
                                                        *flipped)))
    assert float(r_g) == float(r_c) == 1.0
    t, m = torch.tensor(pts, device=dev), torch.tensor(mask, device=dev)
    c1, v1 = voxelgrid.voxel_downsample(t, m, 50.0, 4096)
    c2, v2 = voxelgrid.voxel_downsample(t, m, 50.0, 4096)
    cc, vc = voxelgrid.voxel_downsample(torch.tensor(pts), torch.tensor(mask), 50.0, 4096)
    assert torch.equal(c1, c2) and torch.equal(v1, v2) and torch.equal(v1.cpu(), vc)
    torch.testing.assert_close(c1.cpu(), cc, rtol=0, atol=1e-3)
    rng = np.random.default_rng(6)
    a = torch.tensor(rng.integers(-2**31, 2**31, (300, 11), dtype=np.int64).astype(np.int32))
    b = torch.tensor(rng.integers(-2**31, 2**31, (280, 11), dtype=np.int64).astype(np.int32))
    b[:40] = a[:40]
    am, bm = torch.ones(300, dtype=torch.bool), torch.ones(280, dtype=torch.bool)
    want_m = hamming.mutual_nn(a, am, b, bm, use_matmul=True)
    got_m = hamming.mutual_nn(a.to(dev), am.to(dev), b.to(dev), bm.to(dev), use_matmul=True)
    for x, y in zip(want_m, got_m):
        assert torch.equal(x, y.cpu())


def _graph_drive(dev, graphs: bool, frames=None, **kw):
    """(engine, kernel launches) of a tiny drive on the card."""
    import dataclasses

    from bshot_slam_tpu_torch.odometry.graphs import WRAPPERS

    cfg = tiny_config()
    if kw.get("enable_backend"):  # keyframe every frame, pairs to verify
        cfg = dataclasses.replace(cfg, backend=dataclasses.replace(
            cfg.backend, keyframe_every=1, lc_min_gap=3, lc_max_dist_mm=8000.0,
            lc_min_inliers=8))
    if kw.pop("windowed", False):
        cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, window_cap=256, window_compact=True))
    sweeps, _ = synthetic.render_sequence(frames or 6, cfg.sensor, step_mm=300.0,
                                          seed=3, yaw_rate_rad=2 * np.pi / 6,
                                          n_firings=cfg.sensor.n_azimuth)
    eng = SlamEngine(cfg, seed=0, tile=256, device=dev, graphs=graphs, **kw)
    if cfg.runtime.window_cap == 256:  # landmarks in every frame's window
        rng = np.random.default_rng(3)
        n, m = 400, eng.state.map
        pos = np.trunc(rng.uniform(-20000, 20000, (n, 3)) / cfg.map.snap_mm) * cfg.map.snap_mm
        rows = dict(positions=pos.astype(np.float32),
                    descriptors=rng.integers(-2**31, 2**31, (n, 11)).astype(np.int32),
                    seg_ratios=rng.uniform(0, 1, n).astype(np.float32),
                    blocks=np.round(pos / cfg.map.block_size_mm).astype(np.int32),
                    valid=np.ones(n, bool), frame_born=np.zeros(n, np.int32))
        full = {f: getattr(m, f).clone() for f in m._fields}
        for f, v in rows.items():
            full[f][:n] = torch.tensor(v, device=dev)
        full["cursor"] = torch.tensor(n, dtype=torch.int32, device=dev)
        eng.state = eng.state._replace(map=tmap.MapState(**full))
    eng.dense_reruns = 0
    run_dense = eng._run_dense

    def counting(*a):
        eng.dense_reruns += 1
        return run_dense(*a)

    eng._run_dense = counting
    for w in WRAPPERS:
        w.launches = 0
    for sw in sweeps:
        eng.process_sweep(sw)
    eng.flush()
    torch.cuda.synchronize()
    return eng, [w.launches for w in WRAPPERS]


def _record_bits(eng):
    return [(r.pose.tobytes(), r.n_inliers, r.n_mutual, r.gated, r.map_size,
             np.float64(r.icp_rmse).tobytes(), r.corr_stats.tobytes(), r.n_dropped)
            for r in eng.records]


@pytest.mark.parametrize("mode", [
    dict(), dict(pipelined=True, fetch_every=4), dict(host_preprocess=False),
    dict(host_preprocess=False, pipelined=True, fetch_every=4),
    dict(pipelined=True, fetch_every=2, enable_backend=True, backend_every=3,
         keep_corr=True)], ids=["sync", "pipelined", "fused_sync", "fused_pipelined",
                                "backend"])
def test_graphed_engine_matches_eager_on_card(dev, mode):
    """Replayed graphs give the eager engine's records bit for bit (and its
    keyframes and loop edges), with the same kernel launches counted."""
    (g, g_launch), (e, e_launch) = (_graph_drive(dev, flag, **dict(mode))
                                    for flag in (True, False))
    assert e.graphs.eager and g.graphs.captures == len(g.graphs._graphs) >= 1
    assert _record_bits(g) == _record_bits(e) and len(g.records) == 6
    from bshot_slam_tpu_torch.odometry.graphs import WRAPPERS

    assert g_launch == e_launch and g_launch[0] > 0
    icp = g_launch[WRAPPERS.index(M.icp_update)]  # kernel G
    per_frame = g.cfg.match.icp_iterations + 1
    assert icp == 6 * per_frame if not mode.get("enable_backend") else icp > 6 * per_frame
    assert g_launch[WRAPPERS.index(K.shot_neighbors)] == 6  # kernel H, once a step
    assert g_launch[WRAPPERS.index(E.eigh3)] == 12  # kernel I, twice a step
    if mode.get("enable_backend"):
        assert [(x.kf_i, x.kf_j, x.n_inliers, x.z.tobytes()) for x in g.loop_edges] == \
            [(x.kf_i, x.kf_j, x.n_inliers, x.z.tobytes()) for x in e.loop_edges]
        assert {"pair", "bow", "posegraph", "corr", "kf_add"} <= {
            k[0] for k in g.graphs._graphs}


@pytest.mark.parametrize("pipelined", [False, True])
def test_graphed_window_overflow_on_card(dev, pipelined):
    """A 256-row window over the growing map: the graphed step aborts on the
    device; the synchronous engine replays the dense step's graph for the
    frame, the pipelined one drains and re-runs the stalled frames through
    it; the eager engine re-runs the same frames through the same dense
    body; records as eager."""
    (g, _), (e, _) = (_graph_drive(dev, flag, windowed=True, pipelined=pipelined,
                                   fetch_every=3, frames=6) for flag in (True, False))
    assert _record_bits(g) == _record_bits(e)
    assert g.dense_reruns == e.dense_reruns > 0
    assert "dense" in {k[0] for k in g.graphs._graphs}
    assert not pipelined or g.dense_reruns == g.n_redispatched


@pytest.mark.parametrize("case", sorted(EVICT_CASES))
def test_graphed_eviction_on_card(dev, case):
    """A map eviction replayed from its graph on the state buffers equals
    `evict_keypoints` on CPU copies, every field, twice."""
    from bshot_slam_tpu_torch.odometry import pipeline
    from bshot_slam_tpu_torch.odometry.graphs import Graphs

    d, n_evict = evict_case(case)
    t = {f: torch.tensor(d[f].view(np.int32) if d[f].dtype == np.uint32 else d[f])
         for f in d}
    want = tmap.evict_keypoints(tmap.MapState(**t), n_evict)
    cfg = tiny_config()
    state = pipeline.init_state(cfg, device=dev)._replace(
        map=tmap.MapState(**{f: x.to(dev) for f, x in t.items()}))
    graphs = Graphs(dev)
    for _ in range(2):  # the first captures, the second replays
        got = graphs.evict(state, n_evict)
        for f, g, w in zip(tmap.MapState._fields, got.map, want):
            assert torch.equal(g.cpu(), w), f
    assert graphs.captures == 1


def _mesh_rank(rank: int) -> dict:
    """A tiny mesh engine over one NCCL rank, graphed and eager; the
    sharded bundle adjustment graphed and eager (as numpy: a tensor would
    cross to the parent as a shared-memory handle that the rank's exit
    closes)."""
    from bshot_slam_tpu_torch.backend.ba import BAProblem
    from bshot_slam_tpu_torch.odometry.graphs import Graphs
    from bshot_slam_tpu_torch.parallel import comm, sharded
    from tests.torch_sharded_cases import engine_cfg

    mesh = sharded.make_mesh()
    cfg = engine_cfg()
    sweeps, _ = synthetic.render_sequence(  # the CPU case's drive: it evicts
        10, cfg.sensor, step_mm=350.0, noise_mm=10.0, seed=13,
        n_firings=cfg.sensor.n_azimuth, yaw_rate_rad=2 * np.pi / 30)
    out = {}
    for graphs in (True, False):
        comm.reset_counts()
        eng = SlamEngine(cfg, seed=0, tile=256, mesh=mesh, graphs=graphs,
                         enable_backend=True, backend_every=8)
        for sw in sweeps:
            eng.process_sweep(sw)
        out[graphs] = dict(records=_record_bits(eng), counts=comm.counts(),
                           eager=eng.graphs.eager, captures=eng.graphs.captures,
                           evicted=eng.n_evicted,
                           keys={k[0] for k in eng.graphs._graphs})
    rng = np.random.default_rng(9)
    M, L = 4, 30
    poses = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    poses[:, 0, 3] = np.arange(M) * 1000.0
    lm = rng.uniform(-5000, 5000, (L, 3)).astype(np.float32)
    kf, li = np.repeat(np.arange(M), L), np.tile(np.arange(L), M)
    obs = (lm[li] - poses[kf, :3, 3] + rng.normal(0, 5, (M * L, 3))).astype(np.float32)
    dev = sharded.mesh_device(mesh)
    prob = BAProblem(*[torch.as_tensor(a, device=dev) for a in (
        poses, lm + 50.0, kf.astype(np.int32), li.astype(np.int32), obs,
        np.ones(M * L, bool))])
    out["ba"] = [[t.cpu().numpy() for t in sharded.sharded_ba_solve(mesh, prob, 3, 15,
                                                                    graphs=g)]
                 for g in (None, None, Graphs(dev, eager=True))]
    out["ba_captures"] = sharded.ba_graphs(mesh).captures
    return out


def test_graphed_mesh_on_card(dev):
    """One NCCL rank: the mesh engine replayed from its graphs (eviction
    included) gives the eager mesh engine's records bit for bit and counts
    the same collectives; the sharded bundle adjustment replayed from its
    graph lies within `BA_LIMITS` of the eager one."""
    from bshot_slam_tpu_torch.parallel import multihost
    from tests.torch_kernel_cases import ba_within

    out, = multihost.spawn_local(_mesh_rank, 1, backend="nccl", device="cuda",
                                 timeout=300)
    g, e = out[True], out[False]
    assert not g["eager"] and e["eager"] and g["captures"] >= 2
    assert g["records"] == e["records"] and g["counts"] == e["counts"]
    assert g["evicted"] == e["evicted"] > 0 and {"compact", "evict"} <= g["keys"]
    graphed, again, eager = ([torch.from_numpy(a) for a in r] for r in out["ba"])
    for r in (graphed, again):
        assert ba_within(r, [eager])[1]
    assert out["ba_captures"] == 1 and float(eager[3]) < float(eager[2])


def test_graphed_loop_pair_on_card(dev):
    """`_verify_pair` replayed from its graph equals the eager call on the
    card bit for bit, for two pairs through one graph."""
    from bshot_slam_tpu_torch.backend import loop_closure as lc
    from bshot_slam_tpu_torch.odometry.graphs import Graphs

    graphs = Graphs(dev)
    for seed in (1, 2):
        args = [torch.tensor(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)
                for a in keyframe_pair(seed)]
        draws = torch.tensor(np.random.default_rng(seed).random((512, 3)),
                             dtype=torch.float32, device=dev)
        got = graphs.verify_pair(draws, *args, 300.0, 512, 10)
        want = lc._verify_pair(draws, *args, 300.0, 512, 10)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert graphs.captures == 1


def test_capture_with_host_sync_raises(dev):
    """A body that reads a device value on the host cannot be captured: the
    capture raises, and nothing runs it eagerly instead."""
    from bshot_slam_tpu_torch.odometry.graphs import Graphs

    graphs = Graphs(dev)
    x = torch.arange(8, dtype=torch.float32, device=dev)
    with pytest.raises(RuntimeError):
        graphs.run("sync", lambda t: ((t * float(t.sum()),), []), (x,))
    assert graphs.captures == 0 and not graphs._graphs
    torch.cuda.synchronize()


def test_capture_holds_off_the_cyclic_collector_on_card(dev):
    """A capture runs with Python's cyclic collector off (on again after):
    a collection then could free an unreachable CUDA graph, an engine's
    left in a reference cycle, whose destroy a capture does not permit."""
    import gc

    from bshot_slam_tpu_torch.odometry.graphs import Graphs

    seen = []

    def body(x):
        seen.append(gc.isenabled())
        return x + 1.0, ()

    graphs, x = Graphs(dev), torch.zeros(4, device=dev)
    graphs.run("k", body, (x,))
    assert torch.equal(graphs.run("k", body, (x,)), x + 1.0)
    assert seen == [True, False] and gc.isenabled() and graphs.captures == 1


def test_shared_graphs_key_the_config_on_card(dev):
    """Engines of two configurations that differ only in the RANSAC inlier
    threshold replay from one `Graphs`, one after the other (engines that
    share a `Graphs` share its state buffers, so they do not step in turns):
    each one's records equal its own eager run's (a key without the
    configuration would replay the first engine's threshold)."""
    import dataclasses

    from bshot_slam_tpu_torch.odometry.graphs import Graphs

    base = tiny_config()
    other = dataclasses.replace(base, match=dataclasses.replace(
        base.match, ransac_inlier_th_mm=0.5 * base.match.ransac_inlier_th_mm))
    sweeps, _ = synthetic.render_sequence(5, base.sensor, step_mm=300.0, seed=3,
                                          yaw_rate_rad=2 * np.pi / 6,
                                          n_firings=base.sensor.n_azimuth)
    shared = Graphs(dev)
    engines = {(c, g): SlamEngine(c, seed=0, tile=256, device=dev, graphs=g)
               for c in (base, other) for g in (shared, False)}
    for eng in engines.values():
        for sw in sweeps:
            eng.process_sweep(sw)
    torch.cuda.synchronize()
    for c in (base, other):
        assert _record_bits(engines[c, shared]) == _record_bits(engines[c, False])
    assert _record_bits(engines[base, False]) != _record_bits(engines[other, False])
    assert len({k[-1] for k in shared._graphs}) == 2


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("M,n_loops", [(16, 0), (128, 7)])
def test_graphed_pose_graph_on_card(dev, M, n_loops):
    """The LM pose graph replayed from its graph equals the eager solve bit
    for bit, for three graphs through one key."""
    from bshot_slam_tpu_torch.backend import posegraph
    from bshot_slam_tpu_torch.odometry.graphs import Graphs
    from tests.torch_kernel_cases import pose_graph_case

    graphs = Graphs(dev)
    for seed in (1, 2, 3):  # the first captures, the others replay
        g = posegraph.PoseGraph(**{k: torch.as_tensor(v, device=dev) for k, v in
                                   pose_graph_case(M, n_loops, seed).items()})
        got = graphs.pose_graph(g, iterations=10)
        want = posegraph.optimize_pose_graph(g, iterations=10)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))
    assert graphs.captures == 1 and float(want.final_cost) <= float(want.initial_cost)


def test_graphed_bow_on_card(dev):
    """The keyframe histograms of a whole store replayed from their graph
    equal the eager call bit for bit.  Its first n rows equal the n-row call
    to float32 rounding only: on the card a reduction's launch shape
    depends on the row count, so the sums may round differently (on the CPU
    they are bit-equal, tests/test_torch_backend_graphs.py)."""
    from bshot_slam_tpu_torch.backend import keyframes, loop_closure
    from bshot_slam_tpu_torch.odometry.graphs import Graphs

    cfg = tiny_config()
    rng = np.random.default_rng(4)
    store = keyframes.init_keyframes(cfg, device=dev)
    graphs = Graphs(dev)
    for n in (5, 11):  # the first captures, the second replays
        words = rng.integers(-2**31, 2**31, store.descriptors.shape).astype(np.int32)
        mask = (np.arange(store.kp_mask.shape[0])[:, None] < n) & (
            rng.random(store.kp_mask.shape) < 0.8)
        store = store._replace(descriptors=torch.as_tensor(words, device=dev),
                               kp_mask=torch.as_tensor(mask, device=dev))
        got, want = graphs.bow(store), loop_closure.keyframe_bow(store)
        assert torch.equal(_bits(got), _bits(want))
        torch.testing.assert_close(want[:n], loop_closure.keyframe_bow(store, n),
                                   rtol=0, atol=1e-6)
    assert graphs.captures == 1


def test_graphed_ba_on_card(dev):
    """BA replayed from its graph: each field within its fixed limit
    (`torch_kernel_cases.BA_LIMITS`) of the nearest eager solve (eager
    solves differ in the last bits: `index_add_` adds with atomics); the
    eager solves' spread lies within the limits, and the problem with one
    observation dropped does not."""
    from bshot_slam_tpu_torch.backend import ba
    from bshot_slam_tpu_torch.odometry.graphs import Graphs
    from bshot_slam_tpu_torch.tools.run_ba_bench import problem_arrays
    from tests.torch_kernel_cases import (BA_CASE, BA_LIMITS, ba_distance, ba_dropped,
                                          ba_within)

    arrays = problem_arrays(*BA_CASE)
    prob, dropped = (ba.BAProblem(**{k: torch.as_tensor(v, device=dev) for k, v in a.items()})
                     for a in (arrays, ba_dropped(arrays)))
    eager = [ba.ba_solve(prob) for _ in range(5)]
    graphs = Graphs(dev)
    graphed = [graphs.ba(prob) for _ in range(3)]  # the first captures
    for g in graphed:
        near, within = ba_within(g, eager)
        assert within, (near, BA_LIMITS)
    for i, a in enumerate(eager):
        for b in eager[i + 1:]:
            assert all(d <= lim for d, lim in zip(ba_distance(a, b), BA_LIMITS))
    assert not ba_within(ba.ba_solve(dropped), eager)[1]
    assert graphs.captures == 1
    assert float(eager[0].final_cost) < float(eager[0].initial_cost)


def _icp_on(c, dev):
    return [torch.tensor(c[k]).to(dev) for k in ("src", "src_mask", "dst", "dst_mask")]


def _icp_bits(x):
    return [t.clone() for t in x]


@pytest.mark.parametrize("name", G_CASES)
def test_icp_update_case_on_card(dev, name):
    """G's start, then two updates, each against the plain update on the
    card given the same transform, points and correspondences (D's, once):
    pair counts exact, rotation entries within 1e-6, translations within
    1e-3 mm, rmse within 1e-5 relative (the sums run in another order);
    the moved source within 1e-3 mm of the plain apply of G's transform;
    the candidates gathered already (`nn` None, as on a mesh) bit-identical
    to the indexed ones; one device launch a call; two runs bit-identical."""
    from bshot_slam_tpu_torch.utils.profiling import device_profile

    c = icp_case(name)
    src, sm, dst, dm = _icp_on(c, dev)
    mcd = c["max_corr_dist"]
    eye = torch.eye(4, device=dev)
    runs = []
    for _ in range(2):
        st = M.icp_update(src, sm, dst)
        assert torch.equal(st.transform, eye) and torch.equal(st.cur, src)
        assert float(st.rmse) == 0.0 and int(st.n_pairs) == 0
        bits = []
        for _ in range(2):
            T0, cur0 = st.transform.clone(), st.cur.clone()
            d2, nn = M.euclid_nn_bounded(cur0, sm, dst, dm, c["n_valid"], c["tail_start"])
            T, rmse, n = M.icp_update_plain(T0, cur0, dst[nn.long()], d2, sm, mcd, eye)
            st = M.icp_update(src, sm, dst, d2, nn, mcd, st)
            assert int(st.n_pairs) == int(n)
            assert float((st.transform[:3, :3] - T[:3, :3]).abs().max()) <= 1e-6
            assert float((st.transform[:3, 3] - T[:3, 3]).abs().max()) <= 1e-3
            assert torch.equal(st.transform[3], eye[3])
            assert abs(float(st.rmse) - float(rmse)) <= 1e-5 * float(rmse)
            moved = se3.apply(st.transform, src)
            assert float((st.cur - moved).abs().max()) <= 1e-3
            bits += _icp_bits(st)
        runs.append(bits)
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    d2, nn = M.euclid_nn_bounded(st.cur, sm, dst, dm, c["n_valid"], c["tail_start"])
    indexed = M.icp_update(src, sm, dst, d2, nn, mcd, M.IcpState(*_icp_bits(st)))
    gathered = M.icp_update(src, sm, dst[nn.long()].contiguous(), d2, None, mcd,
                            M.IcpState(*_icp_bits(st)))
    assert all(torch.equal(a, b) for a, b in zip(indexed, gathered))
    assert device_profile(lambda: M.icp_update(src, sm, dst, d2, nn, mcd, st))[1] == 1
    assert device_profile(lambda: M.icp_update(src, sm, dst))[1] == 1


@pytest.mark.parametrize("name", G_CASES)
def test_icp_case_on_card(dev, name):
    """The whole ICP through G (`icp_point_to_point` on card tensors)
    against the plain update's loop on the card (`icp_trace`).  In step:
    at each of the 10 iterations G is given the plain loop's transform,
    points and D's output for them, and its update agrees with the plain
    one (pairs exact, rotation entries within 1e-6, translations within
    1e-3 mm, rmse within 1e-5 relative, the moved source within 1e-3 mm of
    the plain apply of G's transform).  Free-running, iteration by
    iteration: within 1e-5 and 0.01 mm until a correspondence flips, a
    flip only at a tie of the expanded d2, and the final poses after a
    flip within `ICP_FLIP_ROT` and `ICP_FLIP_MM` (`icp_traces_agree`;
    which cases flip, and where, PERF.md records).  The recorded G loop
    is `icp_point_to_point`'s bit for bit; two runs bit-identical; 11 G
    and 10 D launches an ICP."""
    from bshot_slam_tpu_torch.ops import icp

    c = icp_case(name)
    args = _icp_on(c, dev)
    src, sm, dst, dm = args
    mcd = c["max_corr_dist"]
    kw = (10, mcd, c["n_valid"], c["tail_start"])
    g, p = icp_trace(c, dev, True), icp_trace(c, dev, False)
    eye = torch.eye(4, device=dev)
    for it, (cur, nn_p, T, n, rmse) in enumerate(p):
        T0 = eye if it == 0 else torch.tensor(p[it - 1][2], device=dev)
        cur = torch.tensor(cur, device=dev)
        d2, nn = M.euclid_nn_bounded(cur, sm, dst, dm, c["n_valid"], c["tail_start"])
        assert np.array_equal(nn.cpu().numpy(), nn_p)
        st = M.IcpState(T0.clone(), cur.clone(), torch.zeros((), device=dev),
                        torch.zeros((), dtype=torch.int32, device=dev))
        st = M.icp_update(src, sm, dst, d2, nn, mcd, st)
        got_T = st.transform.cpu().numpy()
        assert int(st.n_pairs) == int(n), f"iteration {it}: pairs"
        assert np.abs(got_T[:3, :3] - T[:3, :3]).max() <= 1e-6, f"iteration {it}: rotation"
        assert np.abs(got_T[:3, 3] - T[:3, 3]).max() <= 1e-3, f"iteration {it}: translation"
        assert abs(float(st.rmse) - float(rmse)) <= 1e-5 * float(rmse), f"iteration {it}: rmse"
        moved = se3.apply(st.transform, src)
        assert float((st.cur - moved).abs().max()) <= 1e-3, f"iteration {it}: points"
    n_g, n_d = M.icp_update.launches, M.euclid_nn_bounded.launches
    got = icp.icp_point_to_point(*args, *kw)
    assert (M.icp_update.launches - n_g, M.euclid_nn_bounded.launches - n_d) == (11, 10)
    again = icp.icp_point_to_point(*args, *kw)
    T, n, rmse = g[-1][2:]
    for result in (got, again):
        assert np.array_equal(result.transform.cpu().numpy(), T)
        assert (int(result.n_pairs), float(result.rmse)) == (int(n), float(rmse))
    icp_traces_agree(g, p, c["dst"], c["src_mask"])


def test_icp_launches_on_card(dev):
    """An ICP of 10 iterations is 21 device launches: G's start, then D and
    G an iteration."""
    from bshot_slam_tpu_torch.ops import icp
    from bshot_slam_tpu_torch.utils.profiling import device_profile

    c = icp_case("k600_tail")
    args = _icp_on(c, dev)
    kw = (10, c["max_corr_dist"], c["n_valid"], c["tail_start"])
    assert device_profile(lambda: icp.icp_point_to_point(*args, *kw))[1] == 21


def _select_args(c, dev=None):
    args = [torch.tensor(c[x]) for x in ("keypoints", "kp_mask", "points", "mask")]
    if dev is not None:
        args = [a.to(dev) for a in args]
    return (*args, c["radius"], c["max_neighbors"])


@pytest.mark.parametrize("n,k,m", H_CASES)
def test_shot_neighbors_case_on_card(dev, n, k, m):
    c = select_case(n, k, m)
    want = K.shot_neighbors_plain(*_select_args(c))
    before = K.shot_neighbors.launches
    got = K.shot_neighbors(*_select_args(c, dev))
    again = K.shot_neighbors(*_select_args(c, dev))
    assert K.shot_neighbors.launches == before + 2
    assert got.dtype == torch.int64 and got.shape == want.shape == (k, min(m, n))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(again, got)


def test_gather_neighbors_on_card(dev):
    """`gather_neighbors` on the card (kernel H, then the gather) against
    the CPU's (the plain selection): `rel`, `normals` and `nmask` bit for
    bit; `dist` is the card's square root of the same squared distances,
    within an ulp of the CPU's (the two sqrt kernels round apart on some
    inputs)."""
    from bshot_slam_tpu_torch.kernels import fma_dot3
    from bshot_slam_tpu_torch.ops import shot

    c = select_case(16384, 600, 384)
    normals = torch.tensor(np.random.default_rng(5).normal(
        size=(16384, 3)).astype(np.float32))
    args = _select_args(c)
    want = shot.gather_neighbors(*args[:4], normals, args[4], args[5])
    got = shot.gather_neighbors(*_select_args(c, dev)[:4], normals.to(dev), args[4],
                                args[5])
    for name in ("rel", "normals", "nmask"):
        a, b = getattr(want, name), getattr(got, name).cpu()
        assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    sq = torch.where(want.nmask, fma_dot3(want.rel, want.rel), 0.0).to(dev)
    assert torch.equal(got.dist, torch.sqrt(sq))
    ulps = (got.dist.cpu().view(torch.int32) - want.dist.view(torch.int32)).abs()
    assert int(ulps.max()) <= 1


def test_shot_neighbors_graph_and_launches_on_card(dev):
    """Two device launches a call; captured in a CUDA graph and replayed on
    new keypoints, the same rows as an eager call."""
    from bshot_slam_tpu_torch.utils.profiling import device_profile

    c = select_case(16384, 600, 384)
    args = _select_args(c, dev)
    assert device_profile(lambda: K.shot_neighbors(*args))[1] == 2
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # warm up: the scratch on this stream
        K.shot_neighbors(*args)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = K.shot_neighbors(*args)
    moved = args[0] + torch.tensor([300.0, -200.0, 100.0], device=dev)
    args[0].copy_(moved)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, K.shot_neighbors(moved, *args[1:]))
    assert torch.equal(out.cpu(), K.shot_neighbors_plain(moved.cpu(), *[
        a.cpu() for a in args[1:4]], *args[4:]))


def test_shot_neighbors_refusals_on_card(dev):
    kps = torch.zeros((4, 3), device=dev)
    km = torch.ones(4, dtype=torch.bool, device=dev)
    big = torch.zeros((K.MAX_ROWS + 1, 3), device=dev)
    pts, mask = big[:100], torch.ones(100, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):
        K.shot_neighbors(kps, km, big, torch.ones(len(big), dtype=torch.bool,
                                                   device=dev), 1000.0, 64)
    with pytest.raises(ValueError):
        K.shot_neighbors(kps, km, pts, mask, 1000.0, K.SHOT_MAX_NEIGHBORS + 1)
    with pytest.raises(ValueError):
        K.shot_neighbors(kps, km, pts, mask, float("inf"), 64)
    with pytest.raises(ValueError):
        K.shot_neighbors(kps, km.cpu(), pts, mask, 1000.0, 64)
    assert K.shot_neighbors(kps, km, pts, mask, 1000.0, K.SHOT_MAX_NEIGHBORS).shape \
        == (4, 100)


def _eig3_equal(A, what=""):
    """Kernel I on `A` (on the card) twice against its plain version on the
    same tensor: bit for bit, two launches counted."""
    before = E.eigh3.launches
    got, again = E.eigh3(A), E.eigh3(A)
    want = E.eigh3_plain(A)
    assert E.eigh3.launches == before + 2
    n = A.numel() // 9
    for g, a, w, name in zip(got, again, want, ("evals", "evecs")):
        assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
        gb, ab, wb = (x.reshape(n, -1).view(torch.int32) for x in (g, a, w))
        assert torch.equal(ab, gb), f"{what} {name}: two runs differ"
        bad = (gb != wb).any(1).nonzero().flatten()
        assert len(bad) == 0, (
            f"{what} {name}: {len(bad)} of {n} matrices differ from the plain "
            f"version; first {int(bad[0])}: A {A.reshape(n, 9)[bad[0]].tolist()} "
            f"kernel {g.reshape(n, -1)[bad[0]].tolist()} plain "
            f"{w.reshape(n, -1)[bad[0]].tolist()}")


@pytest.mark.parametrize("name", I_CASES)
def test_eigh3_case_on_card(dev, name):
    _eig3_equal(torch.tensor(eig3_case(name)["A"], device=dev), name)


@pytest.mark.parametrize("n", I_BATCHES)
def test_eigh3_batch_on_card(dev, n):
    _eig3_equal(torch.tensor(eig3_case("mixed", n)["A"], device=dev), f"mixed {n}")


def test_eigh3_real_covariances_on_card(dev):
    """The step's two inputs of I at mm scale: the bench frame's moments
    (kernel A) through the normals' formula, every row of bucket 16,384,
    and its 600 keypoints' LRF covariances (SHOT's gather and einsum)."""
    from bshot_slam_tpu_torch.config import default_config
    from bshot_slam_tpu_torch.ops import keypoints as kp
    from bshot_slam_tpu_torch.ops import shot
    from bshot_slam_tpu_torch.ops.normals import moment_covariances, normals_from_moments
    from bshot_slam_tpu_torch.tools.run_stage_bench import bench_frame

    cfg = default_config()
    kc, dc = cfg.keypoints, cfg.descriptor
    _, pts, pmask, _, _, _ = bench_frame(cfg, 16384)
    p, m = torch.tensor(pts, device=dev), torch.tensor(pmask, device=dev)
    cnt, psum, outer = kp.neighborhood_moments(p, m, kc.radius_mm, 2048)
    cov = moment_covariances(cnt, psum, outer)
    _eig3_equal(cov, "normals' covariances")
    scores = kp.seg_ratio_scores(p, m, kc, 2048, moments=(cnt, psum))
    top_scores, top_idx = kp.top_k(scores, kc.top_k)
    kps = kp.keypoints_from_scores(p, top_scores, top_idx)
    normals = normals_from_moments(p, m, cnt, psum, outer)[0]
    g = shot.gather_neighbors(kps.positions, kps.mask, p, m, normals,
                              dc.shot_radius_mm, dc.max_neighbors)
    lrf, valid = shot.lrf_covariances(g, dc.shot_radius_mm)
    assert lrf.shape == (kc.top_k, 3, 3) and lrf.is_contiguous() and bool(valid.any())
    _eig3_equal(lrf, "LRF covariances")


def test_eigh3_graph_launches_and_refusals_on_card(dev):
    """One device launch a call; captured in a CUDA graph and replayed on
    new matrices, the plain version's outputs; refuses float64,
    non-contiguous and non-(3, 3) inputs."""
    from bshot_slam_tpu_torch.utils.profiling import device_profile

    A = torch.tensor(eig3_case("mixed", 16391)["A"], device=dev)
    assert device_profile(lambda: E.eigh3(A))[1] == 1
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = E.eigh3(A)
    B = torch.tensor(eig3_case("random", 16391)["A"], device=dev)
    A.copy_(B)
    graph.replay()
    torch.cuda.synchronize()
    for g, w in zip(out, E.eigh3_plain(B)):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    for bad, err in ((A.double(), TypeError), (A.transpose(-1, -2), ValueError),
                     (A.reshape(-1, 9), ValueError)):
        with pytest.raises(err):
            E.eigh3(bad)
    assert [x.shape for x in E.eigh3(A[:0])] == [(0, 3), (0, 3, 3)]


# -- kernels A, B and H in their wide form (last: they are long) ----------------


@pytest.mark.parametrize("n,k,m,balls_last", H_WIDE_CASES)
def test_shot_neighbors_wide_case_on_card(dev, n, k, m, balls_last):
    """H in its wide form: its rows, past row 2^17 among them, equal the
    plain version's on CPU copies bit for bit, and itself over two runs."""
    c = select_case(n, k, m, balls_last)
    want = K.shot_neighbors_plain(*_select_args(c))
    got = K.shot_neighbors(*_select_args(c, dev))
    again = K.shot_neighbors(*_select_args(c, dev))
    assert got.dtype == torch.int64 and got.shape == want.shape == (k, m)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(again, got)
    if balls_last:
        assert bool((want >= K.NARROW_ROWS).any())  # 18-bit rows selected


@pytest.mark.parametrize("n", [131200, 196608, 230400])
@pytest.mark.parametrize("kind", ["ball", "spread"])
def test_neighborhood_kernels_wide(dev, kind, n):
    """A and B in their wide form, past `K.NARROW_ROWS` up to the VLS-128
    preset's 230,400 rows (1,800 tiles, all listed by every query block of
    the ball)."""
    _neighborhood_kernels_at(dev, kind, n)


def _vls128_frames(dev):
    """(config, two consecutive sweeps of the VLS-128 cell's lap whose
    clouds take bucket 131072, two whose clouds take a wide bucket)."""
    from bshot_slam_tpu_torch.odometry.engine import host_cloud, pick_bucket
    from bshot_slam_tpu_torch.ops.rangeimage import build_range_image
    from slambench import cell as cell_mod
    from slambench import harness

    cell = cell_mod.load("vls128.replay")
    cfg = cell_mod.slam_config(cell.config)
    sweeps = harness.drive(cell, dev, {"start": 0})
    buckets = []
    for sw in sweeps:
        ri = build_range_image(sw, cfg.sensor)
        buckets.append(pick_bucket(host_cloud(ri.range_mm, ri.azimuth_rad, ri.vert_rad,
                                              None, cfg)[1], cfg))
    pairs = {}
    for i in range(len(sweeps) - 1):
        b = buckets[i]
        key = "narrow" if b == K.NARROW_ROWS else "wide" if b > K.NARROW_ROWS else None
        if key and buckets[i + 1] == b:
            pairs.setdefault(key, (sweeps[i], sweeps[i + 1]))
    return cfg, pairs["narrow"], pairs["wide"]


def _replayed_launches(cfg, pair, dev, graphs=True):
    """(engine, device launches of its second frame): a fresh engine takes
    the pair's first sweep (capturing the step at its bucket), then the
    second, replayed, under the profiler."""
    from bshot_slam_tpu_torch.utils.profiling import profiled

    eng = SlamEngine(cfg, seed=0, device=dev, graphs=graphs)
    eng.process_sweep(pair[0])
    on_card = profiled(torch.cuda.synchronize, lambda: eng.process_sweep(pair[1]))
    torch.cuda.synchronize()
    return eng, sum(e.count for e in on_card)


# Counted in a fresh process: `torch.profiler` loses the edges of short
# windows late in a process.
WIDE_LAUNCHES = """
import json, sys
sys.path.insert(0, %r)
import torch
from tests.test_torch_cuda import _replayed_launches, _vls128_frames
dev = torch.device("cuda")
cfg, narrow, wide = _vls128_frames(dev)
print(json.dumps([_replayed_launches(cfg, p, dev)[1] for p in (narrow, wide)]))
"""


def test_graphed_frame_at_a_wide_bucket_on_card(dev):
    """Two frames of the VLS-128 cell at a wide bucket (kernels A, B and H
    in their wide form): the graphed engine's records are the eager one's
    bit for bit, and its second frame, replayed, launches as many kernels
    as the second of two frames at bucket 131072."""
    import json
    import pathlib
    import subprocess
    import sys

    cfg, _, wide = _vls128_frames(dev)
    g, e = (_replayed_launches(cfg, wide, dev, graphs)[0] for graphs in (True, False))
    assert e.graphs.eager and g.graphs.captures >= 1
    assert _record_bits(g) == _record_bits(e) and len(g.records) == 2
    root = pathlib.Path(__file__).resolve().parents[1]
    p = subprocess.run([sys.executable, "-c", WIDE_LAUNCHES % str(root)],
                       capture_output=True, text=True, timeout=600, cwd=root)
    assert p.returncode == 0, p.stderr[-2000:]
    narrow_launches, wide_launches = json.loads(p.stdout.strip().splitlines()[-1])
    assert wide_launches == narrow_launches > 1000
