"""Kernel I (the 3x3 symmetric eigen-solve) on the CPU.

`kernels.eig3.eigh3` dispatches by the tensor's device: on CPU tensors it
is `geometry.eig3.eigh3` (its plain version) bit for bit, on a batch of
every kind of `tests/torch_kernel_cases.py:I_CASES`, and never loads the
kernel's library; on the CUDA route it refuses float64, non-contiguous and
non-(3, 3) inputs before any launch.  The step's two eigen-solves (the
normals from the moments and the SHOT frames) reach the wrapper, once each
per `compute_features`, as does `surface_normals`; a graph's replay
advances I's launch count as it does the other kernels'.  The kernel
against its plain version on the card: `tests/test_torch_cuda.py`.
"""

import numpy as np
import pytest
import torch

from bshot_slam_tpu_torch import tiny_config
from bshot_slam_tpu_torch.geometry import eig3 as G
from bshot_slam_tpu_torch.kernels import _build
from bshot_slam_tpu_torch.kernels import eig3 as E
from tests.torch_kernel_cases import eig3_case


@pytest.fixture
def no_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("kernel I's library was loaded")

    monkeypatch.setattr(_build, "library", refuse)
    monkeypatch.setattr(_build, "bind", refuse)


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_eigh3_on_cpu_is_the_plain_version(no_library):
    """The mixed batch holds every kind of I_CASES; on the CPU the wrapper
    is the plain version itself, so one batch shows the dispatch."""
    A = torch.tensor(eig3_case("mixed")["A"])
    before = E.eigh3.launches
    lam, V = E.eigh3(A)
    want_lam, want_V = G.eigh3(A)
    assert lam.shape == (600, 3) and V.shape == (600, 3, 3)
    assert torch.equal(_bits(lam), _bits(want_lam)) and torch.equal(_bits(V), _bits(want_V))
    lam2, V2 = E.eigh3(A.reshape(20, 30, 3, 3))  # any batch shape
    assert torch.equal(_bits(lam2.reshape(600, 3)), _bits(want_lam))
    assert torch.equal(_bits(V2.reshape(600, 3, 3)), _bits(want_V))
    assert E.eigh3.launches == before
    assert E.eigh3_plain is G.eigh3


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "shape"])
def test_eigh3_refuses_what_kernel_i_does_not_take(monkeypatch, no_library, bad):
    """On the CUDA route (here faked: `on_cpu` says no) the wrapper checks
    its input before it binds or launches anything."""
    monkeypatch.setattr(E, "on_cpu", lambda *t: False)
    A = torch.tensor(eig3_case("random", 8)["A"])
    A = {"float64": A.double(), "non_contiguous": A.transpose(-1, -2),
         "shape": A.reshape(8, 9)}[bad]
    with pytest.raises(TypeError if bad == "float64" else ValueError):
        E.eigh3(A)


def _cloud(n=600, seed=3):
    """A few noisy planes and a pole, mm, with some rows masked."""
    rng = np.random.default_rng(seed)
    u, v = rng.uniform(-3000, 3000, (2, n))
    kind = rng.integers(0, 3, n)
    pts = np.stack([np.where(kind == 0, u, np.where(kind == 1, 2000.0, 300.0)),
                    np.where(kind == 0, v, np.where(kind == 1, u, 300.0)),
                    np.where(kind == 0, -1500.0, v)], 1)
    pts = pts + rng.normal(0, 20.0, (n, 3))
    return (torch.tensor(pts.astype(np.float32)),
            torch.tensor(rng.random(n) > 0.05))


def test_step_eigen_solves_reach_kernel_i(monkeypatch):
    """`compute_features` (the step's shared-moments path) solves twice
    through the wrapper: every cloud row's covariance, then the keypoints'
    LRF covariances; `surface_normals` (the unshared path) once."""
    from bshot_slam_tpu_torch.odometry import pipeline
    from bshot_slam_tpu_torch.ops import normals, shot

    assert normals.eigh3 is E.eigh3 and shot.eigh3 is E.eigh3
    calls = []

    def spy(A):
        calls.append(tuple(A.shape))
        return E.eigh3(A)

    monkeypatch.setattr(normals, "eigh3", spy)
    monkeypatch.setattr(shot, "eigh3", spy)
    cfg = tiny_config()
    pts, mask = _cloud()
    pipeline.compute_features(pts, mask, cfg, 256)
    assert calls == [(600, 3, 3), (cfg.keypoints.top_k, 3, 3)]
    calls.clear()
    normals.surface_normals(pts, mask, cfg.descriptor.normal_radius_mm, 256)
    assert calls == [(600, 3, 3)]


def test_graph_replay_advances_eigh3_launches():
    """`graphs.WRAPPERS` holds I's wrapper, so a replay adds the launches
    its capture counted to `eigh3.launches`: two a step."""
    from bshot_slam_tpu_torch.odometry import graphs

    assert E.eigh3 in graphs.WRAPPERS
    n = [0] * len(graphs.WRAPPERS)
    n[graphs.WRAPPERS.index(E.eigh3)] = 2

    class Replay:
        def replay(self):
            pass

    g = graphs.Graphs("cpu")
    g._graphs["k"] = graphs._Graph((torch.zeros(3),), "out", Replay(), tuple(n), {})
    before = E.eigh3.launches
    assert g.run("k", None, (torch.ones(3),)) == "out"
    assert E.eigh3.launches == before + 2
