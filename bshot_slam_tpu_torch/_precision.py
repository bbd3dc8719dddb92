"""Float32 precision settings for the whole port, set once on import.

Coordinates are mm-scale float32 (up to ~1e5 mm in a sweep), and every
radius, dedup and sign test compares a small difference of ~1e9-sized
terms.  TF32 keeps about three decimal digits, which scrambles those tests,
so matrix products and convolutions run in full float32 everywhere.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")
