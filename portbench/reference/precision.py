"""The arithmetic of the plain reference, and of its lower-precision control.

The configurations state two precisions: the encoder's convolutions in
bfloat16 and the geometry (SMPL, projection, IEF, the soft raster) in IEEE
float32 with TF32 off. `Precision()` is that. The control of the output
check lowers each by one step, as a later change might:

- encoder 'fp8': every convolution's operands rounded to float8 e4m3 with a
  per-tensor scale (sums in float32, output in bfloat16);
- geometry 'tf32': every float32 product's operands rounded to TF32 (10
  mantissa bits, round to nearest even), sums in float32.

Both are rounded explicitly here rather than left to the card's TF32 mode,
so the control computes the same numbers on the CPU and on the card.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as F

ENCODER = ("bf16", "fp8")
GEOMETRY = ("fp32", "tf32")
_FP8_MAX = 448.0  # largest finite float8 e4m3fn


@dataclasses.dataclass(frozen=True)
class Precision:
    encoder: str = "bf16"
    geometry: str = "fp32"
    # Relative noise on every convolution's input (0: none): a look at how
    # far rounding alone moves the compared numbers, never a control.
    jitter: float = 0.0

    def __post_init__(self):
        if self.encoder not in ENCODER or self.geometry not in GEOMETRY:
            raise ValueError(f"precision {self} not in {ENCODER} x {GEOMETRY}")

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """float32 a @ b (broadcast batch dims) at the geometry precision."""
        if self.geometry == "tf32":
            a, b = round_tf32(a), round_tf32(b)
        return torch.matmul(a, b)

    def conv(self, x: torch.Tensor, w: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
        """bfloat16 x, float32 w -> bfloat16 conv2d at the encoder precision."""
        if self.jitter:
            x = (x.float() * (1.0 + self.jitter * torch.randn_like(x, dtype=torch.float32))).to(x.dtype)
        if self.encoder == "fp8":
            xq, sx = round_fp8(x)
            wq, sw = round_fp8(w)
            y = F.conv2d(xq, wq, stride=stride, padding=padding)
            return (y.float() * (sx * sw)).to(torch.bfloat16)
        return F.conv2d(x, w.to(torch.bfloat16), stride=stride, padding=padding)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties to even), as float32. The
    gradient passes straight through."""
    bits = x.detach().contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = ((bits + 0x0FFF + lsb) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def round_fp8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x -> (bfloat16 tensor of float8 e4m3 values, float32 scale) with
    x ~ values * scale, the scale mapping |x|'s maximum onto e4m3's. The
    gradient passes straight through to x / scale."""
    scale = (x.detach().abs().amax().float() / _FP8_MAX).clamp_min(1e-30)
    y = x.float() / scale
    q = y.detach().to(torch.float8_e4m3fn).float()
    return (y + (q - y).detach()).to(torch.bfloat16), scale


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
