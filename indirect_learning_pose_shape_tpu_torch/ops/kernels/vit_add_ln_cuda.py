"""Residual add, drop-path scale, LayerNorm and cast of the ViT blocks:
wrapper of the CUDA kernels `csrc/vit_add_ln.cu`, and their plain twin.

`add_layer_norm(x, y, s, norm, dtype)` returns (x', h) for the float32
residual stream x [B, N, D], a branch y [B, N, D] and each sample's
drop-path scale s [B]:

    x' = x + y.float() * s          (s None: x + y.float(); y None: x' = x)
    h  = LayerNorm(x'; norm).to(dtype)

in one pass, and its backward in one pass (and a small reduction of the
γ/β partial sums): g = dres + LNᵀ(dh) for x''s gradient dres from its next
residual use, dx = g, dy = (g · s).to(y.dtype). x' is bitwise the eager sum;
only the LayerNorm's reductions run in another order. The scale is taken as
a constant (drop path's factors need no gradient).

Routing, by device alone, as the repo's other kernel wrappers: CUDA tensors
run the kernels, CPU tensors the twin (`add_ln_torch`, `add_ln_bwd_torch`),
the same arithmetic in plain PyTorch, which the card tests hold the kernels
to. Nothing falls back: a CUDA call the kernels do not take (rows not
contiguous and 16-byte aligned, a width not a multiple of 8 or above
`MAX_WIDTH`, x not float32, y or h not bfloat16, a LayerNorm without bias)
raises the ValueError of `refusal`. Each call counts the rows it normalises,
`vit.tokens.add_ln.kernel` or `vit.tokens.add_ln.eager` (`utils/tracing.py`),
and each launch its kernel (`_build.count`: `vit_add_ln_fwd`,
`vit_add_ln_bwd`, `vit_add_ln_bwd_reduce`).

Conventions of `raster_hard_cuda.py`: the launch functions check their
inputs and raise on anything else; the outputs and the partials' scratch are
allocated here, the kernels allocate nothing; they launch on the current
stream, and a refused launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import nn

from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build
from indirect_learning_pose_shape_tpu_torch.utils import tracing

MAX_WIDTH = 1536  # csrc/vit_add_ln.cu kMaxD
# The backward grid (csrc/vit_add_ln.cu kBwdWarps warps a block): at most
# BWD_BLOCKS blocks, four per SM of an H100, fixed so that the γ/β partials
# are summed in the same order on every call.
BWD_WARPS = 4
BWD_BLOCKS = 528
COUNTER = "vit.tokens.add_ln."
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def refusal(x: torch.Tensor, y: Optional[torch.Tensor], s: Optional[torch.Tensor], weight: torch.Tensor,
            bias: torch.Tensor, dtype: torch.dtype) -> Optional[str]:
    """Why the kernels do not take this call, or None where they do. The
    shape, layout and type are checked before the device."""
    D = x.shape[-1]
    if x.dim() != 3 or D % 8 or D > MAX_WIDTH or x.numel() == 0:
        return f"x must be [B, N, D] with D a multiple of 8 up to {MAX_WIDTH}, got {tuple(x.shape)}"
    if y is not None and y.shape != x.shape:
        return f"y {tuple(y.shape)} is not x's shape {tuple(x.shape)}"
    if s is not None and tuple(s.shape) != (x.shape[0],):
        return f"s must be [B] = [{x.shape[0]}], got {tuple(s.shape)}"
    for name, t in (("x", x), ("y", y)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            return f"{name}'s rows are not contiguous and 16-byte aligned"
    if x.dtype != torch.float32 or dtype != torch.bfloat16 or (y is not None and y.dtype != torch.bfloat16):
        return f"x must be float32, y and h bfloat16: got x {x.dtype}, y {None if y is None else y.dtype}, h {dtype}"
    w, b = weight, bias
    if w is None or b is None or w.dtype != torch.float32 or b.dtype != torch.float32 or w.shape != (D,) \
            or b.shape != (D,) or not (w.is_contiguous() and b.is_contiguous()) or w.data_ptr() % 16 \
            or b.data_ptr() % 16:
        return "the LayerNorm must have contiguous, 16-byte aligned float32 weight and bias of the width"
    if s is not None and s.dtype != torch.float32:
        return f"s must be float32, got {s.dtype}"
    for t in (x, y, s, w, b):
        if t is not None and (not t.is_cuda or t.device != x.device):
            return "not CUDA tensors on one device"
    return None


def add_ln_torch(x, y, s, weight, bias, eps: float, dtype):
    """The twin's forward: (x', h, mean [B, N], rstd [B, N])."""
    if y is not None:
        y = y.float()
        x = x + (y if s is None else y * s[:, None, None])
    mean = x.mean(-1)
    xc = x - mean[..., None]
    rstd = torch.rsqrt((xc * xc).mean(-1) + eps)
    h = (xc * rstd[..., None] * weight + bias).to(dtype)
    return x, h, mean, rstd


def add_ln_bwd_torch(dh, dres, xo, mean, rstd, weight, s, y_dtype):
    """The twin's backward: (dx, dy or None without y, dγ, dβ)."""
    g = dh.float()
    xhat = (xo - mean[..., None]) * rstd[..., None]
    a = g * weight
    dx = rstd[..., None] * (a - a.mean(-1, keepdim=True) - xhat * (a * xhat).mean(-1, keepdim=True))
    if dres is not None:
        dx = dres + dx
    dy = None if y_dtype is None else (dx if s is None else dx * s[:, None, None]).to(y_dtype)
    return dx, dy, (g * xhat).sum((0, 1)), g.sum((0, 1))


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def add_ln_cuda(x, y, s, weight, bias, eps: float, dtype):
    """The forward kernel, at the twin's interface. Raises ValueError on
    what the kernel does not take (`refusal`)."""
    why = refusal(x, y, s, weight, bias, dtype)
    if why:
        raise ValueError(f"vit add+LayerNorm kernel: {why}")
    B, N, D = x.shape
    dev = x.device
    xo = x if y is None else torch.empty_like(x)
    h = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
    mean = torch.empty((B, N), dtype=torch.float32, device=dev)
    rstd = torch.empty_like(mean)
    with torch.cuda.device(dev):
        _build.launch(
            "ilps_vit_add_ln_fwd",
            (_P, x.data_ptr()), (_P, _ptr(y)), (_P, _ptr(s)), (_I, 0 if s is None else s.stride(0)), (_I, N),
            (_P, weight.data_ptr()), (_P, bias.data_ptr()), (_P, None if y is None else xo.data_ptr()),
            (_P, h.data_ptr()), (_P, mean.data_ptr()), (_P, rstd.data_ptr()), (_I, B * N), (_I, D),
            (_F, eps), (_P, _stream(x)),
        )
    _build.count("vit_add_ln_fwd")
    return xo, h, mean, rstd


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a contiguous copy where its rows are not contiguous and 16-byte
    aligned (a gradient autograd hands over as a view)."""
    return t if t.is_contiguous() and t.data_ptr() % 16 == 0 else t.clone(memory_format=torch.contiguous_format)


def _check(name: str, t: torch.Tensor, shape: tuple, dtype, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous() or t.data_ptr() % 16 \
            or t.device != device:
        raise ValueError(f"vit add+LayerNorm kernel: {name} must be contiguous, 16-byte aligned {dtype} {shape} on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})")


def add_ln_bwd_cuda(dh, dres, xo, mean, rstd, weight, s, y_dtype):
    """The backward kernels, at the twin's interface."""
    B, N, D = xo.shape
    dev, f32 = xo.device, torch.float32
    _check("dh", dh, (B, N, D), torch.bfloat16, dev)
    if dres is not None:
        _check("dres", dres, (B, N, D), f32, dev)
    _check("x'", xo, (B, N, D), f32, dev)
    _check("mean", mean, (B, N), f32, dev)
    _check("rstd", rstd, (B, N), f32, dev)
    _check("weight", weight, (D,), f32, dev)
    if y_dtype not in (None, torch.bfloat16):
        raise ValueError(f"vit add+LayerNorm kernel: dy must be bfloat16, got {y_dtype}")
    R = B * N
    blocks = min(-(-R // BWD_WARPS), BWD_BLOCKS)
    dx = torch.empty_like(xo)
    dy = None if y_dtype is None else torch.empty((B, N, D), dtype=torch.bfloat16, device=dev)
    part = torch.empty((blocks, 2, D), dtype=f32, device=dev)
    dgamma = torch.empty(D, dtype=f32, device=dev)
    dbeta = torch.empty(D, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "ilps_vit_add_ln_bwd",
            (_P, dh.data_ptr()), (_P, _ptr(dres)), (_P, xo.data_ptr()), (_P, mean.data_ptr()),
            (_P, rstd.data_ptr()), (_P, weight.data_ptr()), (_P, _ptr(s)), (_I, 0 if s is None else s.stride(0)),
            (_I, N), (_P, dx.data_ptr()), (_P, _ptr(dy)), (_P, part.data_ptr()), (_P, dgamma.data_ptr()),
            (_P, dbeta.data_ptr()), (_I, blocks), (_I, R), (_I, D), (_P, _stream(xo)),
        )
    _build.count("vit_add_ln_bwd")
    _build.count("vit_add_ln_bwd_reduce")
    return dx, dy, dgamma, dbeta


class _AddLayerNorm(torch.autograd.Function):
    """(x', h), or h alone without y (x' is x), by the kernels or the twin."""

    @staticmethod
    def forward(ctx, x, y, s, weight, bias, eps, dtype, kernel):
        xo, h, mean, rstd = (add_ln_cuda if kernel else add_ln_torch)(x, y, s, weight, bias, eps, dtype)
        ctx.save_for_backward(xo, mean, rstd, weight, s)
        ctx.kernel, ctx.y_dtype = kernel, None if y is None else y.dtype
        return h if y is None else (xo, h)

    @staticmethod
    def backward(ctx, *grads):
        dres, dh = (None, grads[0]) if ctx.y_dtype is None else grads
        xo, mean, rstd, weight, s = ctx.saved_tensors
        if ctx.kernel:
            dx, dy, dw, db = add_ln_bwd_cuda(_aligned(dh), None if dres is None else _aligned(dres), xo, mean, rstd,
                                             weight, s, ctx.y_dtype)
        else:
            dx, dy, dw, db = add_ln_bwd_torch(dh, dres, xo, mean, rstd, weight, s, ctx.y_dtype)
        return dx, dy, None, dw, db, None, None, None


def add_layer_norm(x: torch.Tensor, y: Optional[torch.Tensor], s: Optional[torch.Tensor], norm: nn.LayerNorm,
                   dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + y.float()·s, LayerNorm of it in float32 cast to `dtype`): the
    kernels for CUDA tensors, which raise on what they do not take, the twin
    for CPU tensors."""
    kernel = x.is_cuda
    out = _AddLayerNorm.apply(x, y, s, norm.weight, norm.bias, norm.eps, dtype, kernel)
    tracing.count(COUNTER + ("kernel" if kernel else "eager"), x.numel() // x.shape[-1])
    return (x, out) if y is None else out
