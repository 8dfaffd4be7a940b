"""Full-float32 pinning for geometry contractions.

The reference requests `Precision.HIGHEST` for every SMPL/LBS contraction
(models/smpl.py `_HI`): geometry must not lose digits to reduced-precision
matrix units. On an NVIDIA card the float32 equivalent of that hazard is
TF32, which cuBLAS uses for float32 products when
`torch.backends.cuda.matmul.allow_tf32` is set. `full_f32()` clears that
flag (and cuDNN's) for the duration of a block and restores the caller's
setting afterwards, so geometry stays in IEEE float32 whatever the process
chose for its encoder.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def disable_tf32() -> None:
    """Process-wide: float32 matmuls and convolutions in full IEEE float32.

    The serving path and `chip_smoke.py` call this so every float32 number
    the port produces on the card is comparable with the reference's.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
