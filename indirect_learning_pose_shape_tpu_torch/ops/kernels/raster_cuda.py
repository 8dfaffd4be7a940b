"""Culled soft-raster scores, forward: wrapper of the CUDA kernel
`csrc/raster_fwd.cu`.

Port of the reference's Pallas forward (ops/kernels/raster_pallas.py
`_fwd_kernel`, driven by `_block_bboxes`, `_scores4_impl` and
`raster_scores_pallas`): per-class sums of Gaussians over the class-sorted,
sentinel-padded vertex slots, with every 128-slot block whose bounding box
lies beyond `cutoff_sigmas·σ` of a pixel tile skipped.

The per-block boxes are plain torch `amin`/`amax` outside the kernel, as
they were plain XLA outside the Pallas body. The kernel takes any H, W and
S (it masks the edges itself), so the reference's fallback for untileable
shapes does not carry over.

Forward only: the vertex gradient (`raster_pallas._bwd_kernel`) is not
ported yet, so a call that would need it raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from indirect_learning_pose_shape_tpu_torch.ops import raster as raster_lib
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build

KERNEL = "raster_fwd"
KV = 128  # slots per culling block (csrc/raster_fwd.cu kKV)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def block_bboxes(verts_t: torch.Tensor, num_parts: int, seg_size: int) -> torch.Tensor:
    """[B, 2, C*S] -> per-(class, 128-slot block) (minx, maxx, miny, maxy):
    [B, C*ceil(S/128), 4]. A class's last, partial block is padded with its
    own last slot, which leaves the box unchanged."""
    B = verts_t.shape[0]
    nb = -(-seg_size // KV)
    v = verts_t.reshape(B * 2, num_parts, seg_size)
    if nb * KV != seg_size:
        v = F.pad(v, (0, nb * KV - seg_size), mode="replicate")
    v = v.reshape(B, 2, num_parts * nb, KV)
    lo, hi = v.amin(dim=-1), v.amax(dim=-1)
    return torch.stack([lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], dim=-1).contiguous()


def _launch(vx: torch.Tensor, num_parts: int, seg_size: int, cfg) -> torch.Tensor:
    B, N, _ = vx.shape
    H = W = cfg.image_size
    verts_t = vx.transpose(1, 2).contiguous()  # [B, 2, N]
    bbox = block_bboxes(verts_t, num_parts, seg_size)
    out = torch.empty((B, num_parts, H, W), dtype=torch.float32, device=vx.device)
    with torch.cuda.device(vx.device):
        stream = torch.cuda.current_stream(vx.device).cuda_stream
        _build.launch(
            "ilps_raster_fwd",
            (_P, verts_t.data_ptr()), (_P, bbox.data_ptr()), (_P, out.data_ptr()),
            (_I, B), (_I, num_parts), (_I, seg_size), (_I, H), (_I, W),
            (_F, 1.0 / (2.0 * cfg.sigma * cfg.sigma)), (_F, cfg.cutoff_sigmas * cfg.sigma),
            (_P, stream),
        )
    _build.count(KERNEL)
    return out


def raster_scores_fwd(
    vx: torch.Tensor, num_parts: int, seg_size: int, cfg
) -> torch.Tensor:
    """vx [B, C*S, 2] class-sorted slots (pixels) -> scores [B, H*W, C].

    The kernel for CUDA tensors, the pairwise twin for CPU tensors.
    """
    if vx.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "raster kernel is forward-only: its vertex gradient "
            "(raster_pallas._bwd_kernel) is not ported yet; run under "
            "torch.no_grad()/inference_mode() or use impl='torch'"
        )
    B, N, two = vx.shape
    if two != 2 or N != num_parts * seg_size or vx.dtype != torch.float32:
        raise ValueError(
            f"raster kernel: expected float32 [B, {num_parts * seg_size}, 2], got "
            f"{vx.dtype} {tuple(vx.shape)}"
        )
    if vx.is_cuda:
        out = _launch(vx, num_parts, seg_size, cfg)  # [B, C, H, W]
        return out.reshape(B, num_parts, -1).transpose(1, 2)
    if vx.device.type != "cpu":
        raise ValueError(f"raster kernel: unsupported device {vx.device}")
    return raster_lib.pairwise_scores(vx, num_parts, seg_size, cfg)
