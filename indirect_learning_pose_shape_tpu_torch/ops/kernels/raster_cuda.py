"""Culled soft-raster scores and their vertex gradient: wrappers of the CUDA
kernels `csrc/raster_fwd.cu` and `csrc/raster_bwd.cu`.

Port of the reference's Pallas pair (ops/kernels/raster_pallas.py
`_fwd_kernel` and `_bwd_kernel`, driven by `_block_bboxes`, the `_scores4`
custom VJP and `raster_scores_pallas`): per-class sums of Gaussians over the
class-sorted, sentinel-padded vertex slots, with every 128-slot block whose
bounding box lies beyond `cutoff_sigmas·σ` of a pixel tile skipped; and the
vertex-major VJP, where each 128-slot block sums `g·e·(p − v)` over the
pixels inside its box ± the cutoff and writes its gradient once.

`raster_scores4` is the differentiable entry: an autograd Function whose
forward is the forward kernel and whose backward is the backward kernel. It
saves only the slot positions, as the reference's residual does, and the
per-block boxes are plain torch `amin`/`amax` under `no_grad`, recomputed in
the backward, as `_block_bboxes` sat outside the Pallas bodies. For CPU
tensors, or with `impl='torch'`, the same Function runs the plain versions
(`raster_lib.pairwise_scores` and `raster_scores_bwd_torch`). A CUDA tensor
with `impl='kernel'` launches the kernels or raises; nothing falls back.

The kernels take any H, W and S (they mask the edges themselves), so the
reference's fallback for untileable shapes does not carry over.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from indirect_learning_pose_shape_tpu_torch.ops import raster as raster_lib
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build

KERNEL = "raster_fwd"
KERNEL_BWD = "raster_bwd"
KV = 128  # slots per culling block (csrc/raster_*.cu kKV)
MAX_WIDTH = 2048  # csrc/raster_bwd.cu kStage: one image row must fit a strip
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def block_bboxes(verts_t: torch.Tensor, num_parts: int, seg_size: int) -> torch.Tensor:
    """[B, 2, C*S] -> per-(class, 128-slot block) (minx, maxx, miny, maxy):
    [B, C*ceil(S/128), 4]. A class's last, partial block is padded with its
    own last slot, which leaves the box unchanged."""
    B = verts_t.shape[0]
    nb = -(-seg_size // KV)
    with torch.no_grad():
        v = verts_t.reshape(B * 2, num_parts, seg_size)
        if nb * KV != seg_size:
            v = F.pad(v, (0, nb * KV - seg_size), mode="replicate")
        v = v.reshape(B, 2, num_parts * nb, KV)
        lo, hi = v.amin(dim=-1), v.amax(dim=-1)
        return torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], dim=-1).contiguous()


def _check(name: str, x: torch.Tensor, shape: tuple) -> None:
    if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"raster kernel: {name} must be contiguous float32 {shape}, got "
            f"{x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )


def _cuda_args(cfg):
    s2 = cfg.sigma * cfg.sigma
    return 1.0 / (2.0 * s2), 1.0 / s2, cfg.cutoff_sigmas * cfg.sigma


def raster_fwd_cuda(verts_t: torch.Tensor, num_parts: int, seg_size: int, cfg) -> torch.Tensor:
    """Forward kernel: verts_t [B, 2, C*S] -> scores [B, C, H, W] float32."""
    B, _, N = verts_t.shape
    H = W = cfg.image_size
    _check("verts_t", verts_t, (B, 2, num_parts * seg_size))
    bbox = block_bboxes(verts_t, num_parts, seg_size)
    out = torch.empty((B, num_parts, H, W), dtype=torch.float32, device=verts_t.device)
    inv2s2, _, cutoff = _cuda_args(cfg)
    with torch.cuda.device(verts_t.device):
        stream = torch.cuda.current_stream(verts_t.device).cuda_stream
        _build.launch(
            "ilps_raster_fwd",
            (_P, verts_t.data_ptr()), (_P, bbox.data_ptr()), (_P, out.data_ptr()),
            (_I, B), (_I, num_parts), (_I, seg_size), (_I, H), (_I, W),
            (_F, inv2s2), (_F, cutoff), (_P, stream),
        )
    _build.count(KERNEL)
    return out


def raster_bwd_cuda(
    verts_t: torch.Tensor, g: torch.Tensor, num_parts: int, seg_size: int, cfg
) -> torch.Tensor:
    """Backward kernel: verts_t [B, 2, C*S], g = d scores [B, C, H, W] ->
    d verts_t [B, 2, C*S] float32."""
    B, _, N = verts_t.shape
    H = W = cfg.image_size
    _check("verts_t", verts_t, (B, 2, num_parts * seg_size))
    _check("g", g, (B, num_parts, H, W))
    if g.device != verts_t.device:
        raise ValueError(f"raster kernel: g on {g.device}, verts_t on {verts_t.device}")
    if W > MAX_WIDTH:
        raise ValueError(f"raster backward kernel: image width {W} > {MAX_WIDTH}")
    bbox = block_bboxes(verts_t, num_parts, seg_size)
    dv = torch.empty_like(verts_t)
    inv2s2, inv_s2, cutoff = _cuda_args(cfg)
    with torch.cuda.device(verts_t.device):
        stream = torch.cuda.current_stream(verts_t.device).cuda_stream
        _build.launch(
            "ilps_raster_bwd",
            (_P, verts_t.data_ptr()), (_P, bbox.data_ptr()), (_P, g.data_ptr()),
            (_P, dv.data_ptr()),
            (_I, B), (_I, num_parts), (_I, seg_size), (_I, H), (_I, W),
            (_F, inv2s2), (_F, inv_s2), (_F, cutoff), (_P, stream),
        )
    _build.count(KERNEL_BWD)
    return dv


def raster_scores_bwd_torch(
    vx: torch.Tensor, g: torch.Tensor, num_parts: int, seg_size: int, cfg
) -> torch.Tensor:
    """Plain version of the backward kernel: every pixel against every slot.

    vx [B, C*S, 2] class-sorted slots, g = d scores [B, C, H, W] ->
    dv [B, 2, C*S] = (1/σ²)·Σ_p g[class]·e·(p − v), pixels in chunks so the
    [B, chunk, C*S] temporaries stay bounded (the forward twin's budget).
    """
    B, N, _ = vx.shape
    C, S = num_parts, seg_size
    pix = raster_lib.pixel_grid(cfg.image_size, vx.dtype, vx.device)
    pc = max(1, raster_lib._PAIRWISE_BUDGET // max(1, B * N))
    inv2s2, inv_s2, _ = _cuda_args(cfg)
    vxx, vyy = vx[:, None, :, 0], vx[:, None, :, 1]
    gp = g.reshape(B, C, -1)
    ax = vx.new_zeros(B, C, S)
    ay = vx.new_zeros(B, C, S)
    for i in range(0, pix.shape[0], pc):
        p = pix[i : i + pc]
        dx = p[None, :, None, 0] - vxx  # [B, pc, N]
        dy = p[None, :, None, 1] - vyy
        e = torch.exp(-(dx * dx + dy * dy) * inv2s2)
        ge = e.reshape(B, -1, C, S) * gp[:, :, i : i + pc].transpose(1, 2)[..., None]
        ax += (ge * dx.reshape(B, -1, C, S)).sum(dim=1)
        ay += (ge * dy.reshape(B, -1, C, S)).sum(dim=1)
    return torch.stack([ax.reshape(B, N), ay.reshape(B, N)], dim=1) * inv_s2


class _RasterScores4(torch.autograd.Function):
    """verts_t [B, 2, C*S] -> scores [B, C, H, W]; saves only verts_t."""

    @staticmethod
    def forward(ctx, verts_t, num_parts, seg_size, cfg, use_kernel):
        ctx.save_for_backward(verts_t)
        ctx.meta = (num_parts, seg_size, cfg, use_kernel)
        if use_kernel:
            return raster_fwd_cuda(verts_t, num_parts, seg_size, cfg)
        B, size = verts_t.shape[0], cfg.image_size
        bpc = raster_lib.pairwise_scores(verts_t.transpose(1, 2), num_parts, seg_size, cfg)
        return bpc.transpose(1, 2).reshape(B, num_parts, size, size)

    @staticmethod
    def backward(ctx, g):
        (verts_t,) = ctx.saved_tensors
        num_parts, seg_size, cfg, use_kernel = ctx.meta
        g = g.contiguous()  # arrives strided after the [B, H*W, C] views
        if use_kernel:
            dv = raster_bwd_cuda(verts_t, g, num_parts, seg_size, cfg)
        else:
            dv = raster_scores_bwd_torch(verts_t.transpose(1, 2), g, num_parts, seg_size, cfg)
        return dv, None, None, None, None


def raster_scores4(
    vx: torch.Tensor, num_parts: int, seg_size: int, cfg, impl: str = "kernel"
) -> torch.Tensor:
    """vx [B, C*S, 2] class-sorted slots (pixels) -> scores [B, C, H, W].

    Differentiable in vx. impl='kernel': the CUDA kernels for CUDA tensors,
    the plain versions for CPU tensors; impl='torch': the plain versions.
    """
    B, N, two = vx.shape
    if two != 2 or N != num_parts * seg_size or vx.dtype != torch.float32:
        raise ValueError(
            f"raster kernel: expected float32 [B, {num_parts * seg_size}, 2], got "
            f"{vx.dtype} {tuple(vx.shape)}"
        )
    if impl not in ("kernel", "torch"):
        raise ValueError(f"raster impl must be 'kernel' | 'torch', got {impl!r}")
    if vx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"raster kernel: unsupported device {vx.device}")
    use_kernel = impl == "kernel" and vx.is_cuda
    verts_t = vx.transpose(1, 2).contiguous()  # [B, 2, N]
    return _RasterScores4.apply(verts_t, num_parts, seg_size, cfg, use_kernel)

