"""Seeded edge cases for the port's kernels A to I, map eviction and loop
verification (numpy only; `icp_trace` imports torch when it is called).

`tests/test_torch_kernel_cases.py`, `tests/test_torch_backend.py` and (for
F, the ground walk) `tests/test_torch_preprocess.py` run them through the
port's plain versions against the reference on the CPU (G, the ICP update,
through the port's ICP loop with G's plain version, `icp_trace`);
`tests/test_torch_cuda.py` runs the CUDA kernels (and eviction on the card)
against the plain versions (H, SHOT's neighbour selection: `select_case` on
the card, `select_int_case` against the reference in
`tests/test_torch_shot_select.py`; I, the 3x3 eigen-solve: `eig3_case`
through the wrapper's plain version in `tests/test_torch_eig3.py`, and on
the card).  A case is a dict of numpy arrays and
scalars, made from a fixed seed by name.
"""

import numpy as np

RADIUS = 3000.0

A_CASES = (
    "n1", "n127", "n128", "n129", "n3000", "all_masked", "one_valid", "cap",
    "nf1", "nf10", "nf16", "far_clusters", "shell",
)
# B runs on A's clouds: CV and CVS read one call (`normalized=False`), the
# `_cvsn` cases the other; `ctvec` is None where a test derives it from the
# cloud's own moments (point minus centroid of its neighbourhood).
B_CLOUDS = ("n1", "n127", "n128", "n129", "n3000", "all_masked", "one_valid",
            "cap", "far_clusters", "shell")
B_CASES = B_CLOUDS + ("n129_cvsn", "n3000_cvsn", "cap_cvsn", "shell_cvsn",
                      "dots_zero", "coincident", "coincident_cvsn")
C_CASES = (
    "ka1", "ka600", "ka601", "nv0", "nv0_tail", "nv_odd_tail", "nv_full",
    "a_all_masked", "b_all_masked", "live_by_index", "dup_candidates",
    "dup_sources", "dense",
)
D_CASES = (
    "kq1", "kq600", "kq601", "nv0", "nv0_tail", "nv_odd", "nv_odd_tail",
    "nv_full", "nv_full_tail", "all_masked", "duplicates", "live_by_index",
)
E_CASES = (
    "k1", "k600", "k601", "nv0", "nv_odd", "nv_full", "c0", "all_masked",
    "valid_past_nv", "collisions", "on_radius", "straddle", "negative_blocks",
    "dense",
)
# Kernel G, the ICP update: 600 keypoints with and without the previous
# frame's tail, ragged counts (over one block's 1024 threads, and small),
# most sources masked, fewer than 3 pairs (the identity step), none, and a
# finite correspondence distance that cuts pairs.
G_CASES = ("k600", "k600_tail", "k1100", "k37", "masked", "few_pairs",
           "no_pairs", "max_corr")
# Kernel H, SHOT's neighbour selection: (rows, keypoints, neighbours) of
# each case on the card; the last has fewer rows than neighbours.
H_CASES = ((2048, 64, 64), (2048, 64, 384), (2048, 600, 64), (2048, 600, 384),
           (16384, 64, 64), (16384, 64, 384), (16384, 600, 64), (16384, 600, 384),
           (131072, 64, 64), (131072, 64, 384), (131072, 600, 64),
           (131072, 600, 384), (300, 64, 384))
H_RADIUS = 1000.0
# Integer clouds whose every d2 is exact in float32 (the selection against
# the reference on the CPU): (rows, keypoints, neighbours, seed).
H_INT_CASES = ((700, 48, 40, 1), (700, 48, 16, 2), (1500, 96, 64, 3),
               (30, 12, 40, 4), (400, 32, 1, 5))
# Kernel E's tensor arguments, in order (n_valid follows them).
E_ARGS = ("pos", "blk", "seg", "map_pos", "map_blk", "map_seg", "map_valid")
DEDUP_RADIUS = 800.0
BLOCK_MM = 10000.0


def moment_features(pts: np.ndarray) -> np.ndarray:
    """The ten columns the pipeline sums: 1, p, and the upper outer product."""
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    return np.stack([np.ones_like(x), x, y, z, x * x, x * y, x * z, y * y,
                     y * z, z * z], axis=-1).astype(np.float32)


def _cloud(rng, n, sigma=4000.0, valid=0.9):
    pts = rng.normal(0, sigma, (n, 3)).astype(np.float32)
    mask = rng.random(n) < valid
    return pts, mask


def _shell(rng):
    """40 base points 8 m apart near 1e5 mm, each with six partners whose
    true distance is the radius to within one grid step of float32 there
    (2^-7 mm): the rounding of the expanded d2, whose terms are ~3e10 with
    an ulp of 2048 mm^2, decides each membership."""
    offsets = np.array([[3000, 0, 0], [0, 3000, 0], [1800, 2400, 0],
                        [0, 1800, 2400], [2000, 2000, 1000], [2000, 1000, 2000]],
                       np.float64)
    grid = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(3),
                                indexing="ij"), -1).reshape(-1, 3)[:40]
    base = 9.0e4 + 8000.0 * grid + np.round(rng.uniform(0, 500, (40, 3)))
    rows = [base]
    for k, off in enumerate(offsets):
        step = (k % 3 - 1) * 2.0 ** -7  # one grid step inside, on, outside
        rows.append(base + off * (1.0 + step / 3000.0))
    pts = np.concatenate(rows).astype(np.float32)
    return pts, np.ones(len(pts), bool)


def accumulate_case(name: str) -> dict:
    """Inputs of `neighborhood_accumulate`: points, mask, feat, radius,
    r2_row (or None)."""
    rng = np.random.default_rng(1000 + A_CASES.index(name))
    radius, r2_row, feat = RADIUS, None, None
    if name.startswith("n") and name[1:].isdigit():
        n = int(name[1:])
        pts, mask = _cloud(rng, n, sigma=6000.0 if n > 1000 else 2500.0)
        mask[0] = True
    elif name == "all_masked":
        pts, _ = _cloud(rng, 300)
        mask = np.zeros(300, bool)
    elif name == "one_valid":
        pts, _ = _cloud(rng, 300)
        mask = np.zeros(300, bool)
        mask[137] = True
    elif name == "cap":
        pts, mask = _cloud(rng, 700)
        r2_row = (rng.uniform(0.3, 1.0, 700) * radius * radius).astype(np.float32)
    elif name in ("nf1", "nf10", "nf16"):
        pts, mask = _cloud(rng, 500)
        feat = rng.normal(0, 100.0, (500, int(name[2:]))).astype(np.float32)
    elif name == "far_clusters":
        n, radius = 1536, 800.0
        pts = np.zeros((n, 3), np.float32)
        pts[: n // 2] = rng.uniform(0, 2000, (n // 2, 3))
        pts[n // 2:] = rng.uniform(50000, 52000, (n // 2, 3))
        mask = np.ones(n, bool)
        mask[rng.integers(0, n, 100)] = False
    elif name == "shell":
        pts, mask = _shell(rng)
    else:
        raise KeyError(name)
    pts[~mask] = 0.0
    if feat is None:
        feat = moment_features(pts)
    return dict(points=pts, mask=mask, feat=feat, radius=radius, r2_row=r2_row)


def euclid_case(name: str) -> dict:
    """Inputs of `euclid_nn_bounded`: q, q_mask, ref, ref_mask, n_valid,
    tail_start.  The window holds W = 2048 rows, then a live tail."""
    rng = np.random.default_rng(2000 + D_CASES.index(name))
    W, cr = 2048, 2100
    kq = {"kq1": 1, "kq600": 600, "kq601": 601}.get(name, 29)
    nv = {"nv0": 0, "nv0_tail": 0, "nv_full": cr, "nv_full_tail": cr}.get(name, 1031)
    tail = -1 if name in ("nv0", "nv_odd", "nv_full", "duplicates") else W
    q = rng.normal(0, 5000, (kq, 3)).astype(np.float32)
    ref = rng.normal(0, 5000, (cr, 3)).astype(np.float32)
    qm = rng.random(kq) > 0.1
    qm[0] = True
    rm = np.zeros(cr, bool)
    rm[:nv] = rng.random(nv) > 0.1
    if tail >= 0:
        rm[tail:] = rng.random(cr - tail) > 0.1
    if name == "all_masked":
        rm[:] = False
    if name == "live_by_index":  # set flags on dead rows must not count
        rm[:] = rng.random(cr) > 0.1
    if name == "duplicates":
        # The nearest row of query k appears again 128 * (k + 1) rows later:
        # a tie across chunks and blocks, which goes to the lowest index.
        nv = 1700
        rm[:nv] = True
        for k in range(8):
            j = 5 + 17 * k
            ref[j] = q[k] + np.float32(30.0)
            ref[j + 128 * (k + 1)] = ref[j]
            qm[k] = True
    return dict(q=q, q_mask=qm, ref=ref, ref_mask=rm, n_valid=nv, tail_start=tail)


def icp_case(name: str) -> dict:
    """Inputs of `icp_point_to_point`: src, src_mask, dst, dst_mask,
    n_valid, tail_start, max_corr_dist.  The source is K keypoints; the
    target a 2048-row map window whose first 1531 rows are live (dead rows
    masked), holding 70% of the source moved by a rigid transform plus
    40 mm noise among outliers, then, in the tail cases, K rows of a
    previous frame near the moved source."""
    rng = np.random.default_rng(3000 + G_CASES.index(name))
    K = {"k1100": 1100, "k37": 37}.get(name, 600)
    W, nv = 2048, 1531
    src = rng.uniform(-2e4, 2e4, (K, 3)).astype(np.float32)
    th = 0.02
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    moved = src @ R.T + np.array([300.0, -200.0, 30.0])
    dst = rng.uniform(-2e4, 2e4, (W, 3))
    rows = rng.choice(nv, int(0.7 * min(K, nv)), replace=False)
    dst[rows] = moved[:len(rows)] + rng.normal(0, 40, (len(rows), 3))
    dst[nv:] = 0.0
    dst_mask = np.zeros(W, bool)
    dst_mask[:nv] = rng.random(nv) > 0.05
    tail = -1
    if name == "k600_tail":
        tail = W
        dst = np.concatenate([dst, moved + rng.normal(0, 20, (K, 3))])
        dst_mask = np.concatenate([dst_mask, rng.random(K) > 0.1])
    src_mask = rng.random(K) > (0.6 if name == "masked" else 0.05)
    if name in ("few_pairs", "no_pairs"):
        src_mask[:] = False
        src_mask[[3, 17]] = name == "few_pairs"
    return dict(src=src, src_mask=src_mask, dst=dst.astype(np.float32),
                dst_mask=dst_mask, n_valid=nv, tail_start=tail,
                max_corr_dist=150.0 if name == "max_corr" else 1.0e9)


# After a tied correspondence flips, how far the two runs' final poses may
# part: a flipped pair moves the targets' weighted mean by |c_a - c_b| / n,
# tens of mm over hundreds of pairs.  Reading: 3.44e-6 and 0.0764 mm on
# k600_tail, the port's loop against the reference's and G against the
# plain update alike (PERF.md, PR 19).
ICP_FLIP_ROT = 1e-5
ICP_FLIP_MM = 0.25


def icp_flip_is_tie(p_a, p_b, cand_a, cand_b, ulps: int = 4) -> np.ndarray:
    """Per row, whether candidates cand_a (the nearest to point p_a) and
    cand_b (the nearest to p_b) tie in kernel D's expanded squared
    distance at both points: their exact squared distances from the point
    differ by at most `ulps` units in the last place of the expansion's
    terms, |p|^2 + |c|^2 in float32, at p_a and at p_b.  At mm-scale
    coordinates that unit is ~100-1000 mm^2, so two candidates a few mm
    apart in distance can round alike, and points moved by a rounding
    difference pick either."""
    def tied(p, a, b):
        p, a, b = (np.asarray(x, np.float64) for x in (p, a, b))
        da, db = ((p - a) ** 2).sum(-1), ((p - b) ** 2).sum(-1)
        terms = np.float32((p * p).sum(-1) + np.maximum((a * a).sum(-1), (b * b).sum(-1)))
        return np.abs(da - db) <= ulps * np.spacing(terms)

    return tied(p_a, cand_a, cand_b) & tied(p_b, cand_a, cand_b)


def icp_trace(c: dict, device, kernel: bool) -> list:
    """An ICP of 10 iterations of case `c` on `device`, through kernel G's
    start and updates (`kernel`; G's plain branch on the CPU: the loop of
    `icp_point_to_point`) or the plain update `icp_update_plain`,
    recording each iteration as `icp_traces_agree` takes it (the points
    searched, their nearest candidates, the transform, n_pairs, rmse), as
    numpy."""
    import torch

    from bshot_slam_tpu_torch.geometry import se3
    from bshot_slam_tpu_torch.kernels import mapops as M

    src, sm, dst, dm = (torch.tensor(c[k]).to(device)
                        for k in ("src", "src_mask", "dst", "dst_mask"))
    eye = torch.eye(4, device=device)
    st = M.icp_update(src, sm, dst) if kernel else None
    T, out = eye, []
    for _ in range(10):
        cur = st.cur.clone() if kernel else se3.apply(T, src)
        d2, nn = M.euclid_nn_bounded(cur, sm, dst, dm, c["n_valid"], c["tail_start"])
        if kernel:
            st = M.icp_update(src, sm, dst, d2, nn, c["max_corr_dist"], st)
            T, rmse, n = st.transform, st.rmse, st.n_pairs
        else:
            T, rmse, n = M.icp_update_plain(T, cur, dst[nn.long()], d2, sm,
                                            c["max_corr_dist"], eye)
        out.append(tuple(t.cpu().numpy() for t in (cur, nn, T, n, rmse)))
    return out


def icp_traces_agree(a: list, b: list, dst: np.ndarray, src_mask: np.ndarray,
                     rot: float = 1e-5, mm: float = 0.01):
    """Compare two ICP runs, each a list of per-iteration records (cur
    (K, 3) the points searched, nn (K,) their nearest candidates, T (4, 4)
    after the iteration, n_pairs, rmse), as numpy.  Up to the first
    iteration whose correspondences differ (of valid sources: a masked
    one's is never used; every iteration if none do),
    the pair counts are equal and the transforms and points agree within
    `rot` (rotation entries) and `mm` (translations, points), the rmse
    within 1e-5 relative where both searched the same points and 1e-3
    where the points differ (each pair's d2 moves by up to a unit of the
    expansion's terms, ~100-1000 mm^2, as its point moves); at that iteration every row whose nearest candidate differs
    is a tie (`icp_flip_is_tie`), after which the two runs are two answers
    to a tied problem, whose final transforms still agree within
    `ICP_FLIP_ROT` and `ICP_FLIP_MM`.  Returns (the iteration of the first
    flip or None, the rows that flipped there)."""
    assert len(a) == len(b)
    for it, (ra, rb) in enumerate(zip(a, b)):
        cur_a, nn_a, T_a, n_a, rmse_a = ra
        cur_b, nn_b, T_b, n_b, rmse_b = rb
        assert np.abs(cur_a - cur_b).max(initial=0.0) <= mm, f"iteration {it}: points"
        rows = np.flatnonzero((nn_a != nn_b) & src_mask)
        if len(rows):
            tie = icp_flip_is_tie(cur_a[rows], cur_b[rows], dst[nn_a[rows]],
                                  dst[nn_b[rows]])
            assert tie.all(), f"iteration {it}: rows {rows[~tie]} flipped without a tie"
            T_a, T_b = a[-1][2], b[-1][2]
            assert np.abs(T_a[:3, :3] - T_b[:3, :3]).max() <= ICP_FLIP_ROT, \
                f"flip at iteration {it}: final rotation"
            assert np.abs(T_a[:3, 3] - T_b[:3, 3]).max() <= ICP_FLIP_MM, \
                f"flip at iteration {it}: final translation"
            return it, rows
        assert int(n_a) == int(n_b), f"iteration {it}: pairs {n_a} against {n_b}"
        assert np.abs(T_a[:3, :3] - T_b[:3, :3]).max() <= rot, f"iteration {it}: rotation"
        assert np.abs(T_a[:3, 3] - T_b[:3, 3]).max() <= mm, f"iteration {it}: translation"
        rtol = 1e-5 if np.array_equal(cur_a, cur_b) else 1e-3
        assert abs(float(rmse_a) - float(rmse_b)) <= rtol * abs(float(rmse_b)), \
            f"iteration {it}: rmse {rmse_a} against {rmse_b}"
    return None, np.zeros(0, np.int64)


def segratio_case(name: str) -> dict:
    """Inputs of `segratio_accumulate`: points, mask, ctvec (or None: point
    minus the centroid of its neighbourhood), radius, normalized, r2_row."""
    normalized = name.endswith("_cvsn")
    base = name[:-5] if normalized else name
    ctvec = None
    if base in B_CLOUDS:
        c = accumulate_case(base)
        pts, mask, radius, r2_row = c["points"], c["mask"], c["radius"], c["r2_row"]
    else:
        rng = np.random.default_rng(3000 + B_CASES.index(name))
        n, radius, r2_row = 400, RADIUS, None
        mask = rng.random(n) < 0.9
        if base == "dots_zero":
            # Three z-planes and ctvec along z: v.p - v.q is exactly 0 for
            # every pair within a plane, which counts as neither sign.
            pts = np.round(rng.uniform(-2500, 2500, (n, 3))).astype(np.float32)
            pts[:, 2] = 500.0 * rng.integers(0, 3, n)
            ctvec = np.tile(np.float32([0.0, 0.0, 700.0]), (n, 1))
        elif base == "coincident":
            # Every point of the second half repeats one of the first: d2 is
            # exactly 0 there, and such a pair adds nothing to the sum.
            pts = rng.normal(0, 2500.0, (n, 3)).astype(np.float32)
            pts[n // 2:] = pts[: n // 2]
            mask[:] = True
            ctvec = rng.normal(0, 600.0, (n, 3)).astype(np.float32)
        else:
            raise KeyError(name)
        pts[~mask] = 0.0
    return dict(points=pts, mask=mask, ctvec=ctvec, radius=radius,
                normalized=normalized, r2_row=r2_row)


def _words(rng, n):
    return rng.integers(0, 2**32, (n, 11), dtype=np.uint64).astype(np.uint32)


def live_rows(n_rows: int, n_valid: int, tail_start: int) -> np.ndarray:
    rows = np.arange(n_rows)
    live = rows < n_valid
    if tail_start >= 0:
        live |= rows >= tail_start
    return live


def hamming_case(name: str) -> dict:
    """Inputs of `hamming_nn_bounded`: a_words, a_mask, b_words, b_mask
    (words as uint32), n_valid, tail_start.  The window holds W = 2048 rows,
    then a live tail; `dense` is the overflow fallback's shape."""
    rng = np.random.default_rng(4000 + C_CASES.index(name))
    W, cb = 2048, 2100
    if name == "dense":
        W, cb = 131072, 131672
    ka = {"ka1": 1, "ka600": 600, "ka601": 601, "dense": 8}.get(name, 37)
    nv = {"nv0": 0, "nv0_tail": 0, "nv_full": cb, "dense": 70001}.get(name, 1031)
    tail = -1 if name in ("nv0", "nv_full", "dup_candidates") else W
    a, b = _words(rng, ka), _words(rng, cb)
    am = rng.random(ka) > 0.1
    am[0] = True
    bm = np.zeros(cb, bool)
    bm[:nv] = rng.random(nv) > 0.1
    if tail >= 0:
        bm[tail:] = rng.random(cb - tail) > 0.1
    # Near matches, so that the minima are not all ~140 bits of noise: row
    # 3 + 7k is source k with k bits flipped (a source can have several).
    for k in range(0 if name == "dup_candidates" else min(ka, 24)):
        j = (3 + 7 * k) % max(nv, 1) if nv else cb - 1 - k
        b[j] = a[k % ka]
        b[j, k % 11] ^= np.uint32((1 << (k % 9)) - 1)
    if name == "a_all_masked":
        am[:] = False
    if name == "b_all_masked":
        bm[:] = False
    if name == "live_by_index":  # set flags on dead rows must not count
        bm[:] = rng.random(cb) > 0.1
        b[nv + 5] = a[0]  # a dead exact match
    if name == "dup_candidates":
        # The nearest row of source k appears again 128 * (k + 1) rows later:
        # a tie across warps, blocks and splits, which goes to the lowest index.
        nv = 1700
        bm[:nv] = True
        for k in range(8):
            j = 5 + 17 * k
            b[j] = a[k]
            b[j + 128 * (k + 1)] = a[k]
            am[k] = True
    if name == "dup_sources":
        # Identical sources: a candidate takes the lowest source index.
        a[9] = a[20] = a[36] = a[5]
        am[[5, 9, 20, 36]] = True
        b[[40, 900, W + 3]] = a[5]
        bm[[40, 900, W + 3]] = True
    if name == "dense":
        b[[65000, 131072 + 17]] = a[1]  # far apart in the run: a tie across splits
        bm[[65000, 131072 + 17]] = True
        am[1] = True
    return dict(a_words=a, a_mask=am, b_words=b, b_mask=bm, n_valid=nv,
                tail_start=tail)


def _snap(x):
    return (np.trunc(x / 10.0) * 10.0).astype(np.float32)


def _grid_newcomers(k: int, side: int):
    """k newcomers 2 m apart in voxel block (0, 0, 0), on a cube of `side`
    points a side centred on 0.  At side 3 the coordinates are small enough
    (|x| <= 2800 mm with partners within 800 mm) that every term of the
    expanded d2 is an exact float32: d2 of 800^2 is exactly r^2."""
    g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    return (2000.0 * (g[:k] - (side - 1) // 2)).astype(np.float32)


def _straddle_newcomers():
    """24 newcomers 10 mm inside a block face (x = +-4990 rounds to block 0),
    each on its own axis and side, 2.5 m apart along another axis."""
    pos = np.zeros((24, 3), np.float32)
    for i in range(24):
        axis, sgn, t = i % 3, (1.0, -1.0)[(i // 3) % 2], i // 6
        pos[i, axis] = sgn * 4990.0
        pos[i, (axis + 1) % 3] = 2500.0 * t - 3750.0
    return pos


def dedup_case(name: str) -> dict:
    """Inputs of `dedup_blocked_bounded` (`E_ARGS` and n_valid), and
    `expect`: the flags by construction, or None where only the reference
    decides.  The map holds 3000 rows (three of the kernel's splits); row
    3i lies near newcomer i.  Positions are on the 10 mm snap grid, blocks
    are round(pos / 10 m)."""
    rng = np.random.default_rng(5000 + E_CASES.index(name))
    c = 0 if name == "c0" else 3000
    k = {"k1": 1, "k600": 600, "k601": 601, "on_radius": 27, "straddle": 24}.get(name, 97)
    nv = {"nv0": 0, "nv_full": c, "all_masked": c, "c0": 0}.get(name, 1777)
    shift = -30000.0 if name == "negative_blocks" else 0.0
    pos = _snap(rng.uniform(-12000, 12000, (k, 3)) + shift)
    seg = rng.random(k).astype(np.float32)
    mpos = _snap(rng.uniform(-12000, 12000, (c, 3)) + shift)
    mseg = rng.random(c).astype(np.float32)
    mvalid = rng.random(c) > 0.1
    near = np.arange(min(k, c // 3))
    spread = 150.0 if name == "dense" else 500.0
    mpos[3 * near] = _snap(pos[near] + rng.normal(0, spread, (len(near), 3)))
    expect = None
    if name == "dense":  # a live, valid, higher-ranked row beside every newcomer
        mseg[3 * near] = np.maximum(mseg[3 * near], seg[near])
        mvalid[3 * near] = True
    if name == "all_masked":
        mvalid[:] = False
    if name == "valid_past_nv":  # exact copies with seg 1 past the cursor
        mvalid[nv:] = True
        mpos[nv:nv + k] = pos
        mseg[nv:] = 1.0
    if name in ("collisions", "on_radius", "straddle"):
        # Every other row is far away (voxel blocks 5 and 6): each newcomer
        # can be blocked by its own partner, row 3i, and by nothing else.
        if name == "collisions":
            pos = _grid_newcomers(k, 5)
        elif name == "on_radius":
            pos = _grid_newcomers(k, 3)
        elif name == "straddle":
            pos = _straddle_newcomers()
        mpos = _snap(rng.uniform(50000, 60000, (c, 3)))
        mvalid[:] = True
        expect = np.zeros(k, bool)
        for i in range(k):
            j = 3 * i
            if name == "collisions":
                # Same position; seg one ulp above, equal, one ulp below.
                mpos[j] = pos[i]
                mseg[j] = (np.nextafter(seg[i], np.float32(2)), seg[i],
                           np.nextafter(seg[i], np.float32(-1)))[i % 3]
                expect[i] = i % 3 != 2
                mpos[nv + i], mseg[nv + i] = pos[i], 1.0  # past the cursor
            elif name == "on_radius":
                # |offset| exactly 800 (not blocked: d2 < r^2 is strict),
                # 794.0 or 790 (blocked), 806.0 (not).
                off = ((480, 640, 0), (0, 0, 800), (-640, 0, -480), (470, 640, 0),
                       (0, -790, 0), (490, 640, 0))[i % 6]
                mpos[j] = pos[i] + np.float32(off)
                mseg[j] = 1.0
                expect[i] = i % 6 in (3, 4)
            else:
                # 20 mm away across the face (another block), or 20 mm
                # inward (the same block) for every other group of six.
                axis = i % 3
                inward = (i // 6) % 2 == 1
                mpos[j] = pos[i]
                mpos[j, axis] += np.sign(pos[i, axis]) * (-20.0 if inward else 20.0)
                mseg[j] = 1.0
                expect[i] = inward
    if name in ("nv0", "c0", "all_masked"):
        expect = np.zeros(k, bool)
    blk = np.round(pos / BLOCK_MM).astype(np.int32)
    mblk = np.round(mpos / BLOCK_MM).astype(np.int32)
    return dict(pos=pos, blk=blk, seg=seg, map_pos=mpos, map_blk=mblk, map_seg=mseg,
                map_valid=mvalid, n_valid=nv, expect=expect)


# Map eviction: (capacity, valid rows, voxel blocks, seg-ratio levels,
# n_evict).  "ties": few blocks and levels, so scores tie; the full 131072-row
# map's float32 scores pass 2^24 and round into ties; n_evict above the
# valid rows; an empty map.
EVICT_CASES = {
    "ties": (4096, 3000, 6, 4, 1200),
    "full_capacity_rounding": (131072, 131072, 40, 1000, 1200),
    "more_than_valid": (1024, 100, 3, 8, 512),
    "empty": (1024, 0, 3, 8, 64),
}


def evict_case(name: str) -> tuple[dict, int]:
    """(MapState fields as numpy arrays, n_evict): valid rows spread over a
    few voxel blocks, seg ratios from a few levels (ties), each valid row's
    frame_born its row number (so the result shows where rows went)."""
    C, n_valid, n_blocks, seg_levels, n_evict = EVICT_CASES[name]
    rng = np.random.default_rng(len(name))
    blocks = rng.integers(-3, 3, (n_blocks, 3))
    which = rng.integers(0, n_blocks, C)
    pos = (blocks[which] * BLOCK_MM
           + rng.uniform(-4000, 4000, (C, 3))).astype(np.float32)
    pos = _snap(pos)
    valid = np.arange(C) < n_valid
    seg = rng.integers(0, seg_levels, C).astype(np.float32) / seg_levels
    return dict(
        positions=np.where(valid[:, None], pos, 0).astype(np.float32),
        descriptors=_words(rng, C),
        seg_ratios=np.where(valid, seg, 0).astype(np.float32),
        blocks=np.where(valid[:, None], np.round(pos / BLOCK_MM), 0).astype(np.int32),
        valid=valid,
        cursor=np.int32(n_valid),
        frame_born=np.where(valid, np.arange(C), -1).astype(np.int32),
        n_dropped=np.int32(5),
    ), n_evict


def keyframe_pair(seed: int, K: int = 600) -> tuple:
    """Two keyframes of one place, (kp, desc, mask) of each: b sees a's
    keypoints moved by a rigid transform plus 40 mm noise, 30% replaced by
    outliers, descriptors with three flipped bits, rows shuffled."""
    rng = np.random.default_rng(seed)
    kp_a = rng.uniform(-2e4, 2e4, (K, 3)).astype(np.float32)
    desc_a = _words(rng, K)
    th = 0.2
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    kp_b = (kp_a @ R.T + np.array([1500.0, -800.0, 30.0])
            + rng.normal(0, 40, (K, 3))).astype(np.float32)
    desc_b = desc_a.copy()
    for _ in range(3):
        col = rng.integers(0, 11, K)
        desc_b[np.arange(K), col] ^= (1 << rng.integers(0, 32, K)).astype(np.uint32)
    out = rng.random(K) < 0.3
    kp_b[out] = rng.uniform(-2e4, 2e4, (out.sum(), 3))
    desc_b[out] = _words(rng, int(out.sum()))
    perm = rng.permutation(K)
    mask_a, mask_b = rng.random(K) > 0.05, rng.random(K) > 0.05
    return kp_a, desc_a, mask_a, kp_b[perm], desc_b[perm], mask_b


# Kernel F, the ground walk: a rendered sweep and synthetic column profiles.
# "tall_ragged": more rings than kernel F stages at once (csrc/preprocess.cu
# kRings, 32) and a last block of columns that is not full (kCols, 32).
F_CASES = ("drive", "random", "lost_runs", "zero_columns", "selfcar", "restart",
           "tall_ragged")
HDL32E_RINGS = 32


def _p0(azimuth_rad: np.ndarray, vert_init: float = -0.6,
        height: float = 2450.0) -> np.ndarray:
    """The walk's virtual ground point per column, at row 0's azimuth."""
    h = np.float32(height)
    horiz0 = -h / np.tan(np.float32(vert_init))
    az0 = azimuth_rad[0]
    return np.stack([horiz0 * np.sin(az0), horiz0 * np.cos(az0),
                     np.full_like(az0, -h)], axis=-1).astype(np.float32)


def _profiles(rng, R: int, A: int, curbs: float, walls: float):
    """Columns walking outward over flat ground (z = -2450 mm) with random
    curbs (100-450 mm up: the walk sets a threshold point there, and the
    ground behind a curb restarts) and walls (1-3 m up)."""
    az = np.broadcast_to(np.linspace(0, 2 * np.pi, A, endpoint=False), (R, A))
    horiz = 3000.0 + np.cumsum(rng.uniform(300, 1500, (R, A)), axis=0)
    z = -2450.0 + rng.normal(0, 10, (R, A))
    u = rng.random((R, A))
    z = np.where(u < curbs, z + rng.uniform(100, 450, (R, A)), z)
    z = np.where(u > 1 - walls, z + rng.uniform(1000, 3000, (R, A)), z)
    return az, horiz, z


def walk_case(name: str) -> dict:
    """Inputs of kernel F (`ground_walk`) and of `_ground_scan`: range_mm
    (R, A), azimuth_rad (R, A), vert_rad (R,) and xyz (R, A, 3), float32,
    and p0 (A, 3), the virtual ground point of each column.  The synthetic
    profiles give points directly (the walk reads xyz as given) and their
    norms as ranges."""
    rng = np.random.default_rng(sum(map(ord, name)))
    R, A = (72, 250) if name == "tall_ragged" else (HDL32E_RINGS, 256)
    vert = np.deg2rad(np.linspace(-30.67, 10.67, R)).astype(np.float32)
    if name == "drive":
        from bshot_slam_tpu_torch.config import SensorConfig
        from bshot_slam_tpu_torch.io import synthetic
        from bshot_slam_tpu_torch.ops.preprocess_host import polar_to_xyz_host
        from bshot_slam_tpu_torch.ops.rangeimage import build_range_image

        sensor = SensorConfig(n_azimuth=A)
        sweeps, _ = synthetic.render_sequence(1, sensor, noise_mm=20.0, seed=3,
                                              n_firings=A, adversarial=True)
        ri = build_range_image(sweeps[0], sensor)
        r, az, vert = ri.range_mm, ri.azimuth_rad, ri.vert_rad
        xyz = polar_to_xyz_host(r, az, vert)
    elif name == "random":  # dropouts and extreme ranges on the rays
        from bshot_slam_tpu_torch.ops.preprocess_host import polar_to_xyz_host

        r = rng.uniform(0, 40000, (R, A)).astype(np.float32)
        r[rng.random((R, A)) < 0.3] = 0.0
        az = np.broadcast_to(np.linspace(0, 2 * np.pi, A, endpoint=False,
                                         dtype=np.float32), (R, A)).copy()
        xyz = polar_to_xyz_host(r, az, vert)
    else:
        az, horiz, z = _profiles(rng, R, A, curbs=0.15 if name == "restart" else 0.05,
                                 walls=0.05)
        if name == "selfcar":  # returns off the car's own body: in the crop box
            car = rng.random((R, A)) < 0.2
            horiz = np.where(car, rng.uniform(0, 800, (R, A)), horiz)
            z = np.where(car, rng.uniform(-2000, 100, (R, A)), z)
        xyz = np.stack([horiz * np.sin(az), horiz * np.cos(az), z], axis=-1)
        lost = np.zeros((R, A), bool)
        if name == "lost_runs":  # runs of lost returns, from the ground up too
            for a in range(A):
                start = rng.integers(0, R)
                lost[start:start + rng.integers(1, 6), a] = True
            lost[0, ::7] = True
            lost[-3:, ::5] = True
        if name == "tall_ragged":  # lost cells on every chunk of rings
            lost |= rng.random((R, A)) < 0.05
        if name == "zero_columns":  # whole columns without a return
            lost[:, rng.choice(A, 12, replace=False)] = True
            lost |= rng.random((R, A)) < 0.1
        xyz[lost] = 0.0
        r = np.sqrt(np.sum(xyz.astype(np.float32) ** 2, axis=-1))
    az = np.asarray(az, np.float32)
    return dict(range_mm=np.asarray(r, np.float32), azimuth_rad=az,
                vert_rad=np.asarray(vert, np.float32),
                xyz=np.ascontiguousarray(xyz, np.float32), p0=_p0(az))


def overflow_sequence(cfg, base: int, spike: int, n_frames: int = 6, spike_at: int = 3):
    """tests/test_odometry_e2e.py's range images for a kept-count spike:
    `base` wall returns on the upper rings in every frame and `spike` at
    frame `spike_at`; every frame has `spike` returns (the others pad with
    returns inside the self-car box, classified out before extraction), so
    the spike comes from the classes alone.  Returns [(range_mm,
    azimuth_rad)] for a config's (rings, azimuth bins)."""
    rng = np.random.default_rng(7)
    R, A = cfg.sensor.n_rings, cfg.sensor.n_azimuth
    az = np.broadcast_to(np.linspace(0, 2 * np.pi, A, endpoint=False,
                                     dtype=np.float32), (R, A)).copy()
    hi_rings = np.arange(23 * R // 32, R)
    lo_rings = np.arange(0, 8)
    frames = []
    for f in range(n_frames):
        n_wall = spike if f == spike_at else base
        r = np.zeros((R, A), np.float32)
        cells = rng.choice(len(hi_rings) * A, n_wall, replace=False)
        ring, col = hi_rings[cells // A], cells % A
        rr = 20000.0 + 8000.0 * np.sin(col * 0.37) + rng.normal(0, 5, n_wall)
        r[ring, col] = rr.astype(np.float32)
        if f != spike_at:
            ccells = rng.choice(len(lo_rings) * A, spike - n_wall, replace=False)
            r[lo_rings[ccells // A], ccells % A] = 800.0
        frames.append((r, az))
    return frames


def iss_corners(seed: int = 1, n: int = 8, side: float = 400.0, step: float = 20.0):
    """A cloud for the ISS detector: n noisy corners (three orthogonal
    planes of `side` mm on a `step` mm grid, 2 mm noise) at random
    orientations within 1.5 m of the origin; (points, mask with 5% masked)."""
    rng = np.random.default_rng(seed)
    g = np.arange(0, side + 1e-3, step)
    a, b = (x.ravel() for x in np.meshgrid(g, g, indexing="ij"))
    z = np.zeros_like(a)
    one = np.concatenate([np.stack([a, b, z], 1), np.stack([a, z, b], 1),
                          np.stack([z, a, b], 1)])
    parts = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        parts.append(one @ q.T + rng.uniform(-1500, 1500, 3))
    pts = np.concatenate(parts).astype(np.float32)
    pts += rng.normal(0, 2.0, pts.shape).astype(np.float32)
    return pts, rng.random(len(pts)) > 0.05


def _rot(axis_angle: np.ndarray) -> np.ndarray:
    """Rodrigues' rotation of an axis-angle vector."""
    th = np.linalg.norm(axis_angle)
    if th < 1e-12:
        return np.eye(3)
    k = axis_angle / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def pose_graph_case(M: int, n_loops: int, seed: int, radius: float = 20000.0,
                    weight: float = 400.0, loop_weight: float = 44.4) -> dict:
    """A pose graph as the engine builds one: M nodes around a circle with
    noisy odometry (drift), the chain edges measured from the drifted
    poses, and n_loops loop edges between nodes at least M/4 apart measured
    from the true poses, padded to a multiple of 4 with masked identity
    edges.  The `PoseGraph` fields as numpy arrays (indices int64)."""
    rng = np.random.default_rng(seed)
    th = 2 * np.pi * np.arange(M) / M
    gt = np.tile(np.eye(4), (M, 1, 1))
    gt[:, 0, 0], gt[:, 0, 1], gt[:, 1, 0], gt[:, 1, 1] = (np.cos(th), -np.sin(th),
                                                          np.sin(th), np.cos(th))
    gt[:, 0, 3], gt[:, 1, 3] = radius * (1 - np.cos(th)), radius * np.sin(th)
    drift = [gt[0]]
    for i in range(1, M):
        dz = np.linalg.inv(gt[i - 1]) @ gt[i]
        noise = np.eye(4)
        noise[:3, :3] = _rot(rng.normal(0, 0.005, 3))
        noise[:3, 3] = rng.normal(0, 40.0, 3)
        drift.append(drift[-1] @ dz @ noise)
    poses = np.stack(drift)
    i = np.arange(M - 1)
    edge_i, edge_j = list(i), list(i + 1)
    edge_z = list(np.linalg.inv(poses[i]) @ poses[i + 1])
    edge_w = [weight] * (M - 1)
    for _ in range(n_loops):
        a = int(rng.integers(0, M))
        b = (a + int(rng.integers(M // 4, M - M // 4 + 1))) % M
        edge_i.append(b)
        edge_j.append(a)
        edge_z.append(np.linalg.inv(gt[b]) @ gt[a])
        edge_w.append(loop_weight)
    pad = (-n_loops) % 4 if n_loops else 0
    E = len(edge_i) + pad
    return dict(
        poses0=poses.astype(np.float32),
        edge_i=np.asarray(edge_i + [0] * pad, np.int64),
        edge_j=np.asarray(edge_j + [0] * pad, np.int64),
        edge_z=np.asarray(edge_z + [np.eye(4)] * pad, np.float32),
        edge_weight=np.asarray(edge_w + [0.0] * pad, np.float32),
        edge_mask=np.arange(E) < E - pad,
    )


# BA replayed from its graph against eager solves on the card, where
# `index_add_` adds floats with atomics and two eager solves of one problem
# may differ in the last bits.  BA_CASE is the (keyframes, landmarks,
# observations a keyframe) of the problem (`tools/run_ba_bench.py`'s
# `problem_arrays`); BA_LIMITS the largest distance, per `BAResult` field
# (poses, landmarks in mm; initial and final cost), a graphed solve may lie
# from its nearest eager solve.  Fixed, and set between the eager solves'
# spread on the card and the reading of a planted fault (`ba_dropped`: one
# observation dropped), both of which `chip_smoke.py` [12] prints: the
# initial cost is a plain sum (0 allowed); the final cost moves less under
# the fault than the landmarks do, so its limit only bounds gross errors.
BA_CASE = (64, 4096, 512)
BA_LIMITS = (0.02, 0.1, 0.0, 1e-4)


def ba_dropped(arrays: dict, k: int = 0) -> dict:
    """`problem_arrays`' problem with observation k dropped: the planted
    fault the BA limits must catch."""
    mask = arrays["obs_mask"].copy()
    mask[k] = False
    return dict(arrays, obs_mask=mask)


def ba_distance(a: tuple, b: tuple) -> list:
    """Each field's largest absolute difference between two BA results
    (tuples of arrays or tensors with `.double()`)."""
    return [float(abs(x.double() - y.double()).max()) for x, y in zip(a, b)]


def ba_within(result: tuple, eager: list) -> tuple[list, bool]:
    """(each field's distance from `result` to its nearest eager result,
    whether every one is within BA_LIMITS)."""
    near = [min(d) for d in zip(*[ba_distance(result, e) for e in eager])]
    return near, all(d <= lim for d, lim in zip(near, BA_LIMITS))


def _ball(rng, centre, t, radius):
    """t points uniform in the ball of `radius` around centre (float64)."""
    d = rng.normal(size=(t, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return centre + d * (radius * rng.uniform(0.05, 1.0, (t, 1)) ** (1 / 3))


def select_case(n: int, k: int, m: int) -> dict:
    """Inputs of `shot_neighbors` (keypoints, kp_mask, points, mask, radius,
    max_neighbors) and `counts`, each keypoint's in-radius rows by design
    (-1 where the rounding decides them).  Keypoints lie 2.5 radii apart;
    each has a ball of its own, drawn until the rows run out (every row
    past the balls is far below every keypoint), in this order:
      0: small integer coordinates: m // 2 rows, three at exactly d2 = r2
         (in), one at r2 + 1 (out), two copies of the keypoint (d2 = 0) and
         a masked row;
      1: kp_mask False over m + 1 rows; 2: none in radius (a masked row and
         a copy of the keypoint only); 3, 4, 5: m // 2, m, m + 1 rows;
      6: over 10 m and over 4096 distinct rows (the kernel's selection),
         or 10 m + 7 where they do not fit;
      7: as many at three places, 60% at the nearest (ties over a whole
         histogram bin past the kernel's 2048 keys: its refinement);
      8: m + 9 rows at five places (ties at the cut);
      9: near 1e5 mm, rows one float32 step inside, on and outside the
         radius (the expanded d2's rounding decides);
    then 0 to m // 3 rows each; every 17th keypoint after 9 is masked.
    Masked rows keep their coordinates.  The balls' rows come first,
    shuffled, then the far rows sorted along x (whole tiles out of reach)."""
    rng = np.random.default_rng(n + 7 * k + 13 * m)
    mm = min(m, n)
    R = H_RADIUS
    grid = np.stack(np.meshgrid(np.arange(10), np.arange(10), np.arange(6),
                                indexing="ij"), -1).reshape(-1, 3)[:k]
    kps = 4000.0 + 2500.0 * grid + rng.uniform(-200, 200, (k, 3))
    kps[0] = (16.0, 32.0, 8.0)
    if k > 9:
        kps[9] = (1.0e5, 1.0e5, 1.0e5)
    kmask = np.ones(k, bool)
    kmask[10::17] = False
    if k > 1:
        kmask[1] = False
    counts = np.zeros(k, np.int64)
    rows, masked = [], []
    budget = n

    def put(pts, live=True):
        nonlocal budget
        rows.append(np.asarray(pts, np.float64).reshape(-1, 3))
        masked.append(np.full(len(rows[-1]), not live))
        budget -= len(rows[-1])

    many = max(10 * mm + 7, 4100)
    plan = {1: mm + 1, 3: mm // 2, 4: mm, 5: mm + 1, 6: many, 7: many, 8: mm + 9}
    for i in range(k):
        c = kps[i]
        if i == 0:
            exact = c + np.array([[600, 800, 0], [0, 0, 1000], [-1000, 0, 0]], float)
            extra = 9
            if budget < mm // 2 + extra:
                continue
            t = max(0, mm // 2 - 3)
            inner = np.round(_ball(rng, c, t, 0.9 * R))
            put(np.concatenate([inner, exact]))
            put(c + np.array([600.0, 800.0, 1.0]))  # d2 = r2 + 1
            put(np.stack([c, c]))  # d2 = 0
            put(c + 100.0, live=False)
            counts[0] = t + 3
        elif i == 2:
            if budget >= 2:
                put(c)
                put(c + 50.0, live=False)
        elif i == 9:
            dirs = np.array([[1, 0, 0], [0, 1, 0], [0.6, 0.8, 0], [0, 0.6, 0.8],
                             [2 / 3, 2 / 3, 1 / 3], [2 / 3, 1 / 3, 2 / 3]])
            shell = [c + dirs * (R + s * 2.0 ** -7) for s in (-1, 0, 1)]
            if budget >= 18:
                put(np.concatenate(shell))
                counts[9] = -1
        else:
            t = plan.get(i, int(rng.integers(0, mm // 3 + 1)))
            if t == many and t > budget:
                t = 10 * mm + 7
            if t > budget or (i > 9 and budget - t < n // 8):
                continue
            if i in (7, 8):  # a few places, repeated
                places = _ball(rng, c, 3 if i == 7 else 5, 0.9 * R)
                places = places[np.argsort(np.linalg.norm(places - c, axis=1))]
                w = [0.6, 0.2, 0.2] if i == 7 else [0.2] * 5
                put(places[rng.choice(len(places), t, p=w)])
            else:
                put(_ball(rng, c, t, 0.9 * R))
            if budget >= 1:
                put(c + rng.uniform(-300, 300, 3), live=False)
            counts[i] = t
    counts[~kmask] = 0
    far = np.column_stack([rng.uniform(-9e4, 9e4, (budget, 2)),
                           rng.uniform(-9e4, -6e4, budget)])
    put(far)
    pts = np.concatenate(rows).astype(np.float32)
    mask = ~np.concatenate(masked)
    mask[len(pts) - len(far):] = rng.random(len(far)) > 0.05
    nb = n - len(far)
    order = np.concatenate([rng.permutation(nb), nb + np.argsort(far[:, 0])])
    return dict(keypoints=kps.astype(np.float32), kp_mask=kmask,
                points=pts[order], mask=mask[order], radius=R, max_neighbors=m,
                counts=counts)


def select_int_case(n: int, k: int, m: int, seed: int) -> dict:
    """An integer cloud for SHOT's neighbour selection whose every d2 is an
    exact float32 (coordinates within 40 of the origin, radius 25): many
    rows at one distance, repeated rows, keypoints on cloud rows (d2 = 0),
    three keypoints far from every row (none in radius: the rows that are
    not in radius fill theirs by index), masked rows and masked keypoints;
    `normals` random."""
    rng = np.random.default_rng(seed)
    pts = rng.integers(-30, 31, (n, 3)).astype(np.float32)
    pts[rng.integers(0, n, n // 5)] = pts[rng.integers(0, n, n // 5)]
    kps = pts[rng.integers(0, n, k)].copy()
    kps[: min(3, k)] = 400.0
    kmask = rng.random(k) > 0.15
    mask = rng.random(n) > 0.1
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    return dict(keypoints=kps, kp_mask=kmask, points=pts, mask=mask,
                normals=normals, radius=25.0, max_neighbors=m)


# Kernel I, the 3x3 symmetric eigen-solve: 600 matrices of each kind, and
# mixed batches of every kind at sizes around one block (128 threads), a
# ragged grid and the largest bucket.
I_CASES = ("random", "iso", "near_iso", "plane", "line", "plane_axis",
           "line_axis", "rank1", "zero", "neg_zero")
I_BATCHES = (1, 600, 16391, 131072)


def _rotations(rng, n: int) -> np.ndarray:
    """n random rotations (float64), from QR of Gaussian matrices."""
    q, r = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    q *= np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    return q


def _spectral(rng, evals: np.ndarray, rotate: bool) -> np.ndarray:
    """R diag(evals) R^T (R the identity unless `rotate`), symmetrised."""
    n = len(evals)
    R = _rotations(rng, n) if rotate else np.broadcast_to(np.eye(3), (n, 3, 3))
    A = np.einsum("nij,nj,nkj->nik", R, evals, R)
    return 0.5 * (A + np.swapaxes(A, 1, 2))


def _eig3_kind(rng, kind: str, n: int) -> np.ndarray:
    scale = 10.0 ** rng.uniform(-3, 7, (n, 1))  # mm^2 covariances reach ~1e7
    if kind == "random":
        A = rng.normal(size=(n, 3, 3)) * scale[:, :, None]
        A = 0.5 * (A + np.swapaxes(A, 1, 2))
    elif kind == "iso":  # s I: p2 = 0, under the guard
        A = np.eye(3)[None] * (scale[:, :, None] * rng.choice([-1.0, 1.0], (n, 1, 1)))
    elif kind == "near_iso":
        # s I plus off-diagonals e: p2 ~ e^2 against the guard's
        # 1e-10 max(s^2, 1); e from a third to three times its edge.
        s = scale[:, 0] * rng.choice([1e-6, 1.0], n)
        e = np.sqrt(1e-10 * np.maximum(s * s, 1.0)) * 10.0 ** rng.uniform(-0.5, 0.5, n)
        A = np.eye(3)[None] * s[:, None, None]
        off = e[:, None] * rng.choice([-1.0, 1.0], (n, 3))
        A[:, 0, 1] = A[:, 1, 0] = off[:, 0]
        A[:, 1, 2] = A[:, 2, 1] = off[:, 1]
        A[:, 0, 2] = A[:, 2, 0] = off[:, 2]
    elif kind in ("plane", "plane_axis", "line", "line_axis"):
        # Two equal eigenvalues: a plane (two large, one small) or a line
        # (one large, two small); rotated, or on the axes, where they stay
        # equal in float32.
        small = scale[:, 0] * 10.0 ** rng.uniform(-6, -1, n) * rng.choice([0.0, 1.0], n)
        big = scale[:, 0]
        ev = (np.stack([small, big, big], 1) if kind.startswith("plane")
              else np.stack([small, small, big], 1))
        A = _spectral(rng, rng.permuted(ev, axis=1), not kind.endswith("_axis"))
    elif kind == "rank1":
        v = rng.normal(size=(n, 3))
        A = scale[:, :, None] * v[:, :, None] * v[:, None, :]
    elif kind in ("zero", "neg_zero"):  # the padding rows' covariances
        A = np.zeros((n, 3, 3)) * (-1.0 if kind == "neg_zero" else 1.0)
    else:
        raise KeyError(kind)
    return A.astype(np.float32)


def eig3_case(name: str, n: int = 600) -> dict:
    """(n, 3, 3) float32 symmetric matrices of kind `name` ("mixed": every
    kind of I_CASES in turn, shuffled)."""
    rng = np.random.default_rng(sum(map(ord, name)) + n)
    if name != "mixed":
        return dict(A=_eig3_kind(rng, name, n))
    per = -(-n // len(I_CASES))
    A = np.concatenate([_eig3_kind(rng, k, per) for k in I_CASES])
    return dict(A=A[rng.permutation(len(A))[:n]])
