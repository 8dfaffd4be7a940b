"""Culled soft-raster scores and their vertex gradient: wrappers of the CUDA
kernels `csrc/raster_fwd.cu` and `csrc/raster_bwd.cu`.

Port of the reference's Pallas pair (ops/kernels/raster_pallas.py
`_fwd_kernel` and `_bwd_kernel`, driven by `_block_bboxes`, the `_scores4`
custom VJP and `raster_scores_pallas`): per-class sums of Gaussians over the
class-sorted, sentinel-padded vertex slots, with every 128-slot block whose
bounding box lies beyond `cutoff_sigmas·σ` of a 32x8 pixel tile skipped; and
the vertex-major VJP, where each 128-slot block sums `g·e·(p − v)` over the
tiles the forward summed it into and writes its gradient once.

The culled function is defined over real slots. `real` [C] int32 holds each
class's number of real slots, which come first in its segment
(`raster.PartLayout.real`); the rest is padding. A block's box is the min/max
over its real slots (`block_bboxes`), a block with none reaches no tile, and
both kernels read only real slots: padding scores nothing and gets a zero
gradient, whatever its coordinate. The reference's `_block_bboxes` keeps the
sentinel padding in the box, which stretches the box of a partly filled
block to the canvas edge; its culled sum therefore keeps, in such blocks,
Gaussian tails (each below e^-18 of its peak) that this one drops.

`raster_scores4` is the differentiable entry: an autograd Function whose
forward is the forward kernel and whose backward is the backward kernel. It
saves only the slot positions, as the reference's residual does, and the
per-block boxes are plain torch reductions under `no_grad`, recomputed in the
backward, as `_block_bboxes` sat outside the Pallas bodies. For CPU tensors,
or with `impl='torch'`, the same Function runs the exact plain versions
(`raster_lib.pairwise_scores` and `raster_scores_bwd_torch`, every pixel
against every slot). A CUDA tensor with `impl='kernel'` launches the kernels
or raises; nothing falls back. `raster_scores_culled_torch` and
`raster_scores_bwd_culled_torch` are plain versions of the culled function
itself, for tests and `chip_smoke.py`.

The kernels take any H, W and S (they mask the edges themselves), so the
reference's fallback for untileable shapes does not carry over.
"""

from __future__ import annotations

import ctypes

import torch

from indirect_learning_pose_shape_tpu_torch.ops import raster as raster_lib
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build

KERNEL = "raster_fwd"
KERNEL_BWD = "raster_bwd"
KV = 128  # slots per culling block (csrc/raster_common.cuh kKV)
TW, TH = 32, 8  # pixel tile of the culling test (csrc/raster_common.cuh kTW, kTH)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _real_mask(real: torch.Tensor, seg_size: int) -> torch.Tensor:
    """[C] real counts -> [C, S] bool, True on each class's real slots."""
    return torch.arange(seg_size, device=real.device) < real[:, None]


def block_bboxes(
    verts_t: torch.Tensor, real: torch.Tensor, num_parts: int, seg_size: int
) -> torch.Tensor:
    """[B, 2, C*S] -> per-(class, 128-slot block) (minx, maxx, miny, maxy)
    over the block's real slots: [B, C*ceil(S/128), 4]. A block without a
    real slot gets (+inf, -inf, +inf, -inf), which meets no tile."""
    B = verts_t.shape[0]
    nb = -(-seg_size // KV)
    pad = nb * KV - seg_size
    with torch.no_grad():
        keep = _real_mask(real, seg_size)
        v = verts_t.reshape(B, 2, num_parts, seg_size)
        lo = torch.where(keep, v, torch.inf)
        hi = torch.where(keep, v, -torch.inf)
        if pad:
            lo = torch.nn.functional.pad(lo, (0, pad), value=torch.inf)
            hi = torch.nn.functional.pad(hi, (0, pad), value=-torch.inf)
        lo = lo.reshape(B, 2, num_parts * nb, KV).amin(dim=-1)
        hi = hi.reshape(B, 2, num_parts * nb, KV).amax(dim=-1)
        return torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], dim=-1).contiguous()


def tile_hits(bbox: torch.Tensor, height: int, width: int, cutoff: float):
    """The kernels' culling test (csrc/raster_common.cuh) for every tile:
    bbox [B, nblk, 4] -> (x hits [B, nblk, ceil(W/32)], y hits
    [B, nblk, ceil(H/8)]); block k is summed into tile (tx, ty) iff both hold.
    Evaluated in float32 as the kernels do."""
    cut = torch.tensor(cutoff, dtype=torch.float32, device=bbox.device)
    x0 = torch.arange(0, width, TW, device=bbox.device).float()
    y0 = torch.arange(0, height, TH, device=bbox.device).float()
    b = bbox[..., None]
    xh = (b[:, :, 0] <= x0 + (TW - 1) + cut) & (b[:, :, 1] >= x0 - cut)
    yh = (b[:, :, 2] <= y0 + (TH - 1) + cut) & (b[:, :, 3] >= y0 - cut)
    return xh, yh


def _check(name: str, x: torch.Tensor, shape: tuple, dtype=torch.float32) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        want = str(dtype).removeprefix("torch.")
        raise ValueError(
            f"raster kernel: {name} must be contiguous {want} {shape}, got "
            f"{x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )


def _check_inputs(verts_t, real, num_parts, seg_size, *others) -> None:
    B = verts_t.shape[0]
    _check("verts_t", verts_t, (B, 2, num_parts * seg_size))
    _check("real", real, (num_parts,), torch.int32)
    for name, x in others:
        if x.device != verts_t.device:
            raise ValueError(f"raster kernel: {name} on {x.device}, verts_t on {verts_t.device}")


def _cuda_args(cfg):
    s2 = cfg.sigma * cfg.sigma
    return 1.0 / (2.0 * s2), 1.0 / s2, cfg.cutoff_sigmas * cfg.sigma


def raster_fwd_cuda(
    verts_t: torch.Tensor, real: torch.Tensor, num_parts: int, seg_size: int, cfg
) -> torch.Tensor:
    """Forward kernel: verts_t [B, 2, C*S], real [C] int32 -> scores
    [B, C, H, W] float32."""
    _check_inputs(verts_t, real, num_parts, seg_size, ("real", real))
    B = verts_t.shape[0]
    H = W = cfg.image_size
    bbox = block_bboxes(verts_t, real, num_parts, seg_size)
    out = torch.empty((B, num_parts, H, W), dtype=torch.float32, device=verts_t.device)
    inv2s2, _, cutoff = _cuda_args(cfg)
    with torch.cuda.device(verts_t.device):
        stream = torch.cuda.current_stream(verts_t.device).cuda_stream
        _build.launch(
            "ilps_raster_fwd",
            (_P, verts_t.data_ptr()), (_P, real.data_ptr()), (_P, bbox.data_ptr()),
            (_P, out.data_ptr()),
            (_I, B), (_I, num_parts), (_I, seg_size), (_I, H), (_I, W),
            (_F, inv2s2), (_F, cutoff), (_P, stream),
        )
    _build.count(KERNEL)
    return out


def raster_bwd_cuda(
    verts_t: torch.Tensor, g: torch.Tensor, real: torch.Tensor, num_parts: int, seg_size: int, cfg
) -> torch.Tensor:
    """Backward kernel: verts_t [B, 2, C*S], g = d scores [B, C, H, W],
    real [C] int32 -> d verts_t [B, 2, C*S] float32 (0 on padding slots)."""
    _check_inputs(verts_t, real, num_parts, seg_size, ("real", real), ("g", g))
    B = verts_t.shape[0]
    H = W = cfg.image_size
    _check("g", g, (B, num_parts, H, W))
    bbox = block_bboxes(verts_t, real, num_parts, seg_size)
    dv = torch.empty_like(verts_t)
    inv2s2, inv_s2, cutoff = _cuda_args(cfg)
    with torch.cuda.device(verts_t.device):
        stream = torch.cuda.current_stream(verts_t.device).cuda_stream
        _build.launch(
            "ilps_raster_bwd",
            (_P, verts_t.data_ptr()), (_P, real.data_ptr()), (_P, bbox.data_ptr()),
            (_P, g.data_ptr()), (_P, dv.data_ptr()),
            (_I, B), (_I, num_parts), (_I, seg_size), (_I, H), (_I, W),
            (_F, inv2s2), (_F, inv_s2), (_F, cutoff), (_P, stream),
        )
    _build.count(KERNEL_BWD)
    return dv


def raster_scores_bwd_torch(
    vx: torch.Tensor, g: torch.Tensor, num_parts: int, seg_size: int, cfg, keep=None
) -> torch.Tensor:
    """Plain version of the backward kernel: every pixel against every slot.

    vx [B, C*S, 2] class-sorted slots, g = d scores [B, C, H, W] ->
    dv [B, 2, C*S] = (1/σ²)·Σ_p g[class]·e·(p − v), pixels in chunks so the
    [B, chunk, C*S] temporaries stay bounded (the forward twin's budget).
    `keep` masks the pairs as in `raster_lib.pairwise_scores`.
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
        if keep is not None:
            e = torch.where(keep(i, i + p.shape[0]), e, 0.0)
        ge = e.reshape(B, -1, C, S) * gp[:, :, i : i + pc].transpose(1, 2)[..., None]
        ax += (ge * dx.reshape(B, -1, C, S)).sum(dim=1)
        ay += (ge * dy.reshape(B, -1, C, S)).sum(dim=1)
    return torch.stack([ax.reshape(B, N), ay.reshape(B, N)], dim=1) * inv_s2


def _culled_pairs(vx: torch.Tensor, real: torch.Tensor, num_parts: int, seg_size: int, cfg):
    """`keep(i, j)` for the plain versions: the (pixel, slot) pairs the
    kernels sum, for row-major pixels i..j-1: the slot is real and its
    block passes the tile test of the pixel's 32x8 tile."""
    B, N, _ = vx.shape
    C, S, H = num_parts, seg_size, cfg.image_size
    nb = -(-S // KV)
    bbox = block_bboxes(vx.transpose(1, 2).contiguous(), real, C, S)
    xh, yh = tile_hits(bbox, H, H, _cuda_args(cfg)[2])
    slot = torch.arange(S, device=vx.device)
    blk = (torch.arange(C, device=vx.device)[:, None] * nb + slot // KV).reshape(N)
    xh, yh = xh[:, blk], yh[:, blk]  # [B, N, tiles]
    is_real = _real_mask(real, S).reshape(N)
    pix = torch.arange(H * H, device=vx.device)
    tx, ty = (pix % H) // TW, (pix // H) // TH

    def keep(i: int, j: int) -> torch.Tensor:
        k = xh[:, :, tx[i:j]] & yh[:, :, ty[i:j]] & is_real[None, :, None]
        return k.transpose(1, 2)  # [B, j - i, N]

    return keep


def raster_scores_culled_torch(
    vx: torch.Tensor, real: torch.Tensor, num_parts: int, seg_size: int, cfg
) -> torch.Tensor:
    """Plain version of the culled function the forward kernel computes:
    vx [B, C*S, 2] -> scores [B, C, H, W], each pair summed iff the kernel
    sums it (real slot, its block's box over real slots meets the pixel's
    tile). For tests and chip_smoke.py."""
    B, size = vx.shape[0], cfg.image_size
    keep = _culled_pairs(vx, real, num_parts, seg_size, cfg)
    bpc = raster_lib.pairwise_scores(vx, num_parts, seg_size, cfg, keep=keep)
    return bpc.transpose(1, 2).reshape(B, num_parts, size, size)


def raster_scores_bwd_culled_torch(
    vx: torch.Tensor, g: torch.Tensor, real: torch.Tensor, num_parts: int, seg_size: int, cfg
) -> torch.Tensor:
    """Plain version of the backward kernel's culled gradient: dv
    [B, 2, C*S] over the pairs `raster_scores_culled_torch` sums."""
    keep = _culled_pairs(vx, real, num_parts, seg_size, cfg)
    return raster_scores_bwd_torch(vx, g, num_parts, seg_size, cfg, keep=keep)


class _RasterScores4(torch.autograd.Function):
    """verts_t [B, 2, C*S] -> scores [B, C, H, W]; saves only verts_t."""

    @staticmethod
    def forward(ctx, verts_t, real, num_parts, seg_size, cfg, use_kernel):
        ctx.save_for_backward(verts_t, real)
        ctx.meta = (num_parts, seg_size, cfg, use_kernel)
        if use_kernel:
            return raster_fwd_cuda(verts_t, real, num_parts, seg_size, cfg)
        B, size = verts_t.shape[0], cfg.image_size
        bpc = raster_lib.pairwise_scores(verts_t.transpose(1, 2), num_parts, seg_size, cfg)
        return bpc.transpose(1, 2).reshape(B, num_parts, size, size)

    @staticmethod
    def backward(ctx, g):
        verts_t, real = ctx.saved_tensors
        num_parts, seg_size, cfg, use_kernel = ctx.meta
        g = g.contiguous()  # arrives strided after the [B, H*W, C] views
        if use_kernel:
            dv = raster_bwd_cuda(verts_t, g, real, num_parts, seg_size, cfg)
        else:
            dv = raster_scores_bwd_torch(verts_t.transpose(1, 2), g, num_parts, seg_size, cfg)
        return dv, None, None, None, None, None


def raster_scores4(
    vx: torch.Tensor, real: torch.Tensor, num_parts: int, seg_size: int, cfg, impl: str = "kernel"
) -> torch.Tensor:
    """vx [B, C*S, 2] class-sorted slots (pixels), real [C] int32 real
    slots per class -> scores [B, C, H, W].

    Differentiable in vx. impl='kernel': the CUDA kernels for CUDA tensors,
    the exact plain versions for CPU tensors; impl='torch': the exact plain
    versions.
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
    return _RasterScores4.apply(verts_t, real, num_parts, seg_size, cfg, use_kernel)
