"""Port parity: the feature stage (keypoints, normals, SHOT, B-SHOT).

`compute_features` of both packages on one tiny-config synthetic cloud
(CPU).  Keypoint selection is exact: the seg-ratio counts come from radius
tests that the port rounds exactly as the reference's compiled program does,
so the CV scores, their ties and the top-k agree bit for bit.

The descriptors part ways in the two 3x3 eigen-solves, the surface normals
(eigh3 of the neighbourhood covariance) and the SHOT local reference frame
(eigh3 of the weighted neighbour covariance).  The reference's compiled
eigh3 contracts multiply-adds into FMAs, rewrites a division by a constant
as a product with its rounded reciprocal, computes acos as
atan2(sqrt((1-x)(1+x)), x), and evaluates atan2 and cos with XLA's own
approximations, which round differently from PyTorch's in some percent of
inputs.  Near-degenerate neighbourhoods turn those ulps into a different
frame for a few keypoints.  Run this file as a script for the stage-by-stage
count of differing rows.

Held here:
  * keypoints, scores and masks exactly equal;
  * with the reference's normals and frames given to both packages,
    everything else in the stage (neighbour gather, soft binning,
    normalisation, binarisation, packing) gives bit-equal B-SHOT words;
  * end to end, B-SHOT agreement measured at 72-84% bit-equal descriptors
    and 2.7-5.4 differing bits of 352 on average over six tiny-config
    frames: held at >= 60% bit-equal and a mean of <= 10 bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bshot_slam_tpu import config as jcfg
from bshot_slam_tpu.io import synthetic as jsyn
from bshot_slam_tpu.odometry import pipeline as jpipe
from bshot_slam_tpu.ops import bshot as jb
from bshot_slam_tpu.ops import keypoints as jk
from bshot_slam_tpu.ops import normals as jn
from bshot_slam_tpu.ops import shot as js
from bshot_slam_tpu_torch import config as tcfg
from bshot_slam_tpu_torch.odometry import pipeline as tpipe
from bshot_slam_tpu_torch.odometry.engine import pick_bucket
from bshot_slam_tpu_torch.ops import bshot as tb
from bshot_slam_tpu_torch.ops import preprocess_host as ph
from bshot_slam_tpu_torch.ops import shot as ts
from bshot_slam_tpu_torch.ops.rangeimage import build_range_image


def _t(x) -> torch.Tensor:
    return torch.tensor(np.asarray(x))


def frame_cloud(tc):
    sweeps, _ = jsyn.render_sequence(2, tc.sensor, step_mm=300.0, noise_mm=10.0,
                                     seed=0, n_firings=tc.sensor.n_azimuth)
    ri = build_range_image(sweeps[1], tc.sensor)
    cl, xyz, valid = ph.preprocess_host(ri.range_mm, ri.azimuth_rad, ri.vert_rad,
                                        tc.preprocess)
    pts, nv = ph.extract_cloud_host(cl, xyz, valid, None, tc.preprocess.max_points)
    P = np.zeros((pick_bucket(nv, tc), 3), np.float32)
    P[:nv] = pts
    return P, np.arange(P.shape[0]) < nv


@pytest.fixture(scope="module")
def both():
    cfg, tc = jcfg.tiny_config(), tcfg.tiny_config()
    P, mask = frame_cloud(tc)
    tile = tc.runtime.point_tile
    fj = jax.jit(jpipe.compute_features, static_argnames=("cfg", "tile"))(
        jnp.asarray(P), jnp.asarray(mask), cfg=cfg, tile=tile)
    ft = tpipe.compute_features(torch.tensor(P), torch.tensor(mask), tc, tile)
    return cfg, tc, P, mask, fj, ft


def test_keypoints_exact(both):
    *_, fj, ft = both
    np.testing.assert_array_equal(ft.keypoints.numpy(), np.asarray(fj.keypoints))
    np.testing.assert_array_equal(ft.scores.numpy(), np.asarray(fj.scores))
    np.testing.assert_array_equal(ft.mask.numpy(), np.asarray(fj.mask))
    assert ft.mask.sum() > 32


def reference_normals(cfg, P, mask, tile):
    moments = jax.jit(jk.neighborhood_moments, static_argnames=("radius", "tile"))(
        jnp.asarray(P), jnp.asarray(mask), radius=cfg.keypoints.radius_mm, tile=tile)
    return jax.jit(jn.normals_from_moments)(jnp.asarray(P), jnp.asarray(mask),
                                            *moments)[0]


def test_bshot_exact_given_reference_frames(both, monkeypatch):
    """Both packages get the reference's normals and local frames: the
    B-SHOT words agree bit for bit on every keypoint."""
    cfg, tc, P, mask, fj, _ = both
    dc = cfg.descriptor
    kp, km = fj.keypoints, jnp.asarray(np.asarray(fj.keypoints).any(axis=1))
    normals = reference_normals(cfg, P, mask, tc.runtime.point_tile)
    g = jax.jit(js.gather_neighbors,
                static_argnames=("radius", "max_neighbors", "exact", "topk_chunks"))(
        kp, km, jnp.asarray(P), jnp.asarray(mask), normals,
        radius=dc.shot_radius_mm, max_neighbors=dc.max_neighbors, exact=True)
    frames, fvalid = jax.jit(js.local_reference_frames, static_argnames=("radius",))(
        g, radius=dc.shot_radius_mm)

    monkeypatch.setattr(js, "local_reference_frames", lambda g, radius: (frames, fvalid))
    shot_j = jax.jit(js.shot_descriptors.__wrapped__,
                     static_argnames=("cfg", "exact_topk", "topk_chunks"))
    desc_j, _ = shot_j(kp, km, jnp.asarray(P), jnp.asarray(mask), normals, dc,
                       exact_topk=True)
    words_j = np.asarray(jb.bshot_from_shot(desc_j, cfg=dc)).view(np.int32)

    monkeypatch.setattr(ts, "local_reference_frames",
                        lambda g, radius: (_t(frames), _t(fvalid)))
    desc_t, _ = ts.shot_descriptors(_t(kp), _t(km), _t(P), _t(mask), _t(normals), tc.descriptor)
    np.testing.assert_array_equal(tb.bshot_from_shot(desc_t, tc.descriptor).numpy(), words_j)
    # binarisation and packing alone, on the reference's own SHOT floats
    np.testing.assert_array_equal(tb.bshot_from_shot(_t(desc_j), tc.descriptor).numpy(),
                                  words_j)
    assert int(km.sum()) > 32


def bits_differing(fj, ft) -> np.ndarray:
    dj = np.asarray(fj.descriptors)
    dt = ft.descriptors.numpy().view(np.uint32)
    ham = np.unpackbits((dj ^ dt).view(np.uint8).reshape(dj.shape[0], -1), axis=1).sum(1)
    return ham[np.asarray(fj.mask)]


def test_descriptors_close(both):
    *_, fj, ft = both
    ham = bits_differing(fj, ft)
    assert (ham == 0).mean() >= 0.6, ham
    assert ham.mean() <= 10.0, ham


# ---------------------------------------------------------------------------
# Stage-by-stage report:
#   JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_features.py

_EIG_NO_FMA = r"""
import sys, numpy as np, jax, jax.numpy as jnp, torch
from bshot_slam_tpu.geometry import eig3 as je
from bshot_slam_tpu_torch.geometry import eig3 as te
cov = np.load(sys.argv[1])
a = np.asarray(jax.jit(je.eigvalsh3)(jnp.asarray(cov)))
b = te.eigvalsh3(torch.tensor(cov)).numpy()
print(int((a.view(np.uint32) != b.view(np.uint32)).any(1).sum()))
"""


def _rows_differ(a, b, rows=None) -> str:
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    ne = (a.view(np.uint32) != b.view(np.uint32)) if a.dtype == np.float32 else a != b
    ne = ne.reshape(ne.shape[0], -1).any(1)
    ne = ne if rows is None else ne[rows]
    return f"{int(ne.sum())} of {ne.size}"


def _ulp_off(approx, exact64) -> float:
    """Share of float32 results that are not the correctly rounded value."""
    a = np.asarray(approx, np.float32)
    return float((a.view(np.uint32) != exact64.astype(np.float32).view(np.uint32)).mean())


def report() -> None:
    import os
    import pathlib
    import subprocess
    import sys
    import tempfile

    from bshot_slam_tpu.geometry import eig3 as je
    from bshot_slam_tpu_torch.geometry import eig3 as te
    from bshot_slam_tpu_torch.ops import keypoints as tk
    from bshot_slam_tpu_torch.ops import normals as tn

    cfg, tc = jcfg.tiny_config(), tcfg.tiny_config()
    P, mask = frame_cloud(tc)
    tile, r = tc.runtime.point_tile, cfg.keypoints.radius_mm
    jP, jm = jnp.asarray(P), jnp.asarray(mask)
    mj = jax.jit(jk.neighborhood_moments, static_argnames=("radius", "tile"))(
        jP, jm, radius=r, tile=tile)
    mt = tk.neighborhood_moments(_t(P), _t(mask), r, tile)
    for name, a, b in zip(("count", "sum p", "sum p p^T"), mj, mt):
        print(f"moments {name}, same cloud: {_rows_differ(a, b)} rows differ")
    nj = jax.jit(jn.normals_from_moments)(jP, jm, *mj)[0]
    nt = tn.normals_from_moments(_t(P), _t(mask), *[_t(x) for x in mj])[0]
    print(f"normals, same moments: {_rows_differ(nj, nt, mask)} valid rows differ")

    def cov_of(cnt, psum, outer):
        safe = jnp.maximum(cnt, 1.0)
        mean = psum / safe[:, None]
        return outer / safe[:, None, None] - mean[:, :, None] * mean[:, None, :]

    ok = mask & (np.asarray(mj[0]) >= 3)
    cov = np.asarray(jax.jit(cov_of)(*mj))[ok]
    cnt, psum, outer = [_t(x) for x in mj]
    safe = torch.clamp(cnt, min=1.0)
    mean, scaled = psum / safe[:, None], outer / safe[:, None, None]
    stepwise = scaled - mean[:, :, None] * mean[:, None, :]  # as the port rounds it
    m64 = mean.double()  # one rounding per fma, the products exact in float64
    fma = (scaled.double() - m64[:, :, None] * m64[:, None, :]).float()
    sel = torch.tensor(ok)
    print(f"normal covariance, same moments: step by step "
          f"{_rows_differ(cov, stepwise[sel])} rows differ; as "
          f"fma(-mean_i, mean_j, outer/n) {_rows_differ(cov, fma[sel])}")
    vj = jax.jit(je.eigvalsh3)(jnp.asarray(cov))
    vt = te.eigvalsh3(torch.tensor(cov))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cov.npy")
        np.save(path, cov)
        env = dict(os.environ, XLA_FLAGS="--xla_cpu_max_isa=SSE4_2", JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(pathlib.Path(__file__).resolve().parents[1]))
        no_fma = subprocess.run([sys.executable, "-c", _EIG_NO_FMA, path], env=env,
                                capture_output=True, text=True, check=True).stdout.strip()
    print(f"eigenvalues, same covariances: {_rows_differ(vj, vt)} rows differ; "
          f"{no_fma} when the reference is compiled without FMA "
          f"(XLA_FLAGS=--xla_cpu_max_isa=SSE4_2)")

    x = np.linspace(-1.0, 1.0, 200001, dtype=np.float32)
    y = np.sqrt((1.0 - x) * (1.0 + x)).astype(np.float32)
    c = x * np.float32(3.0)
    x64, y64, c64 = x.astype(np.float64), y.astype(np.float64), c.astype(np.float64)
    print("not correctly rounded, reference (XLA CPU) / PyTorch (CPU): "
          f"atan2 {_ulp_off(jax.jit(jnp.arctan2)(y, x), np.arctan2(y64, x64)):.4f} / "
          f"{_ulp_off(torch.atan2(_t(y), _t(x)), np.arctan2(y64, x64)):.4f}, "
          f"cos {_ulp_off(jax.jit(jnp.cos)(c), np.cos(c64)):.4f} / "
          f"{_ulp_off(torch.cos(_t(c)), np.cos(c64)):.4f}, "
          f"sqrt {_ulp_off(jax.jit(jnp.sqrt)(np.abs(x)), np.sqrt(np.abs(x64))):.4f} / "
          f"{_ulp_off(torch.sqrt(_t(np.abs(x))), np.sqrt(np.abs(x64))):.4f} "
          "of inputs in [-1, 1] (cos: [-3, 3])")

    dc = cfg.descriptor
    fj = jax.jit(jpipe.compute_features, static_argnames=("cfg", "tile"))(
        jP, jm, cfg=cfg, tile=tile)
    kp, km = fj.keypoints, jnp.asarray(np.asarray(fj.keypoints).any(axis=1))
    g = jax.jit(js.gather_neighbors,
                static_argnames=("radius", "max_neighbors", "exact", "topk_chunks"))(
        kp, km, jP, jm, nj, radius=dc.shot_radius_mm, max_neighbors=dc.max_neighbors,
        exact=True)
    gt = ts.gather_neighbors(_t(kp), _t(km), _t(P), _t(mask), _t(nj),
                             dc.shot_radius_mm, dc.max_neighbors)
    print("neighbour gather, same keypoints and normals: "
          + ", ".join(f"{f} {_rows_differ(getattr(g, f), getattr(gt, f))}"
                      for f in g._fields) + " rows differ")
    fr = jax.jit(js.local_reference_frames, static_argnames=("radius",))(
        g, radius=dc.shot_radius_mm)[0]
    frt = ts.local_reference_frames(ts.NeighborGather(*[_t(x) for x in g]),
                                    dc.shot_radius_mm)[0]
    print(f"local frames, same gather: {_rows_differ(fr, frt, np.asarray(km))} "
          "keypoints differ")
    ft = tpipe.compute_features(_t(P), _t(mask), tc, tile)
    ham = bits_differing(fj, ft)
    print(f"B-SHOT end to end: {(ham == 0).mean():.4f} of descriptors bit-equal, "
          f"{ham.mean():.2f} of 352 bits differ on average")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    report()
