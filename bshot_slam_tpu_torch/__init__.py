"""bshot_slam_tpu_torch — the B-SHOT LiDAR SLAM engine on PyTorch and CUDA.

A port of `bshot_slam_tpu` (JAX on a TPU, kept as the reference) to one
NVIDIA H100: the same modules, names and outputs, with every Pallas kernel
of the reference rewritten as a CUDA kernel for `sm_90a` under
`csrc/`.  Kernels build at first use on a CUDA tensor; on CPU tensors each
kernel wrapper runs its plain PyTorch version instead.
"""

from bshot_slam_tpu_torch import _precision  # noqa: F401
from bshot_slam_tpu_torch.config import (  # noqa: F401
    SlamConfig,
    default_config,
    tiny_config,
)

__version__ = "0.1.0"
