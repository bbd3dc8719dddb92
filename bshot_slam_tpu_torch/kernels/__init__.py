"""Hand-written CUDA kernels (csrc/*.cu) with their plain PyTorch versions.

Every wrapper dispatches on the device of the tensors it is given: on the
CPU it runs the plain version, on a CUDA tensor it launches the kernel (or
raises).  Each wrapper counts its kernel launches in `wrapper.launches`.
"""

import torch

from bshot_slam_tpu_torch.kernels import _build

BIG = 3.0e38  # "no candidate" distance, as in the reference kernels


def fma_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise a.b over a last axis of 3 as the FMA chain
    fma(a2, b2, fma(a1, b1, a0*b0)), each step rounded once to float32.

    This is how the reference's compiled programs reduce every K=3 product
    (sums of squares included), and what csrc/common.cuh computes; the
    steps run in float64, where each product is exact, and round to
    float32 after each step."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    acc = (a[..., 0] * b[..., 0]).to(torch.float32)
    acc = (a[..., 1] * b[..., 1] + acc).to(torch.float32)
    return (a[..., 2] * b[..., 2] + acc).to(torch.float32)


def pair_d2(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Squared distances (Q, P) by the expansion (|q|^2 + |p|^2) - 2 q.p,
    clamped at 0, rounded as the reference rounds it: FMA-chain norms and
    cross term (a K=3 float32 matmul is one on the CPU), so radius
    memberships agree bit for bit with it and with the kernels."""
    cross = q @ p.T
    return torch.clamp(fma_dot3(q, q)[:, None] + fma_dot3(p, p)[None, :]
                       - 2.0 * cross, min=0.0)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain path); raises on a
    mix of devices or on a device that is neither CPU nor CUDA."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"kernel inputs must lie all on the CPU or all on one "
                     f"CUDA device, got {sorted(kinds)}")


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape) -> None:
    """Check a CUDA kernel argument: device, dtype, shape, contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_COUNTS: dict[tuple, torch.Tensor] = {}


def device_count_arg(n, device: torch.device) -> torch.Tensor:
    """A row bound (int or 0-d tensor) as a one-element int32 tensor on
    `device`, which the kernels read, so a device-side bound costs no host
    sync.  An int's tensor is made once per device and value and kept (the
    kernels only read it): no copy from the host, which would synchronise,
    and no fill launch per call."""
    if isinstance(n, torch.Tensor):
        if n.dtype == torch.int32 and n.device == device and n.numel() == 1:
            return n
        return n.to(device=device, dtype=torch.int32).reshape(1).contiguous()
    key = (device.index, int(n))
    t = _COUNTS.get(key)
    if t is None:
        t = _COUNTS[key] = torch.full((1,), int(n), dtype=torch.int32,
                                      device=device)
    return t


def stream_arg(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_SCRATCH: dict[tuple, object] = {}


def scratch(device: torch.device, stream: int, shape_key: tuple, make):
    """Scratch buffers of a kernel, made by `make()` once per device, stream
    and shape and kept: calls on one stream run in order, so they can share
    them, and a counter a kernel leaves at zero stays usable."""
    key = (device.index, stream, shape_key)
    bufs = _SCRATCH.get(key)
    if bufs is None:
        bufs = _SCRATCH[key] = make()
    return bufs


def ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def build_all() -> float:
    """Build every kernel library (in parallel); returns seconds."""
    return _build.build_all()
