"""Soft silhouette / body-part rasterizer (port of ops/raster.py).

    d2[p, v]   = ||pixel_p − vert2d_v||²
    score[p,c] = Σ_{v: part(v)=c} exp(−d2 / 2σ²)
    probs      = (γ, score) / (γ + Σ_c score)   channel 0 = background
    silhouette = 1 − probs[..., 0]

Vertices are statically permuted so each part is a contiguous segment padded
to S (`PartLayout`); padding slots sit at a far sentinel, so their Gaussians
are exactly 0. The gather into that layout is an autograd Function whose
backward is the inverse-slot gather (the reference's `_gather_sorted_bwd`),
not the scatter-add autograd of indexing would emit.

`raster_scores` has two implementations of the same sum, both behind the
autograd Function of ops/kernels/raster_cuda.py: 'kernel' (the culled CUDA
kernels, ports of the Pallas `raster_pallas._fwd_kernel` / `_bwd_kernel`)
and 'torch' (the pairwise, pixel-chunked plain versions, twins of the
reference's `impl='xla'` path); 'auto' is the kernel for CUDA tensors and
the plain versions for CPU tensors. The reference's default 'separable'
implementation is not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_SENTINEL = 1.0e6  # padded slots live here: exp(-d²/2σ²) underflows to 0
_LANE = 128  # segment sizes are multiples of the kernel's culling block
# Elements of one pairwise [B, chunk, C*S] temporary in the torch twin.
_PAIRWISE_BUDGET = 1 << 26


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    image_size: int = 256
    num_parts: int = 24  # foreground classes (channel 0 of probs is bg)
    sigma: float = 2.0  # Gaussian falloff in pixels
    bg_gamma: float = 1.0  # background strength in the soft normalization
    # Kernel culling radius in sigmas: exp(-18) ~ 1.5e-8 at 6σ, below
    # float32 significance next to any covered pixel.
    cutoff_sigmas: float = 6.0


@dataclasses.dataclass(frozen=True)
class PartLayout:
    """Static class-sorted vertex layout.

    perm  [C*S] int64: vertex index feeding slot i (padding repeats index 0),
    valid [C*S] float32: 1 for real slots, 0 for padding,
    inv   [V]   int64: the valid slot holding vertex v,
    real  [C]   int32: real slots per class; they come first in its segment,
    seg_size S: per-class segment length (padded to a 128 multiple).
    """

    perm: torch.Tensor
    valid: torch.Tensor
    inv: torch.Tensor
    real: torch.Tensor
    num_parts: int
    seg_size: int


def build_part_layout(
    part_labels: np.ndarray,
    num_parts: int,
    positions: np.ndarray | None = None,
    device: torch.device | str = "cpu",
) -> PartLayout:
    """Group vertex indices by part label into equal padded segments.

    With `positions` ([V, 3] rest-pose vertices), vertices inside each class
    are ordered along the part's principal axis, so each 128-vertex block
    covers a thin slice of the limb and the kernel's per-block culling boxes
    stay tight. (numpy copy of the reference's function.)
    """
    labels = np.asarray(part_labels)
    counts = np.bincount(labels, minlength=num_parts)
    if labels.max() >= num_parts:
        raise ValueError(f"label {labels.max()} >= num_parts {num_parts}")
    seg = int(max(_LANE, -(-int(counts.max()) // _LANE) * _LANE))
    perm = np.zeros((num_parts, seg), dtype=np.int32)
    valid = np.zeros((num_parts, seg), dtype=np.float32)
    for c in range(num_parts):
        idx = np.nonzero(labels == c)[0]
        if positions is not None and len(idx) > 1:
            p = np.asarray(positions, np.float64)[idx]
            centred = p - p.mean(axis=0)
            _, _, vt = np.linalg.svd(centred, full_matrices=False)
            idx = idx[np.argsort(centred @ vt[0])]
        perm[c, : len(idx)] = idx
        valid[c, : len(idx)] = 1.0
    flat_perm = perm.reshape(-1)
    flat_valid = valid.reshape(-1)
    inv = np.zeros(len(labels), dtype=np.int32)
    inv[flat_perm[flat_valid > 0]] = np.nonzero(flat_valid > 0)[0]
    return PartLayout(
        perm=torch.as_tensor(flat_perm, dtype=torch.long, device=device),
        valid=torch.as_tensor(flat_valid, device=device),
        inv=torch.as_tensor(inv, dtype=torch.long, device=device),
        real=torch.as_tensor(counts, dtype=torch.int32, device=device),
        num_parts=num_parts,
        seg_size=seg,
    )


class _GatherSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, verts2d, layout):
        ctx.layout = layout
        g = verts2d[:, layout.perm]
        return torch.where(layout.valid[None, :, None] > 0, g, _SENTINEL)

    @staticmethod
    def backward(ctx, dy):
        # The layout is a padded permutation (each vertex owns exactly one
        # valid slot), so the transpose of the gather is another gather by
        # the inverse slot map. Padding slots are masked first, as the
        # forward's `where` gates them.
        layout = ctx.layout
        dm = dy * layout.valid[None, :, None].to(dy.dtype)
        return dm[:, layout.inv], None


def gather_class_sorted(verts2d: torch.Tensor, layout: PartLayout) -> torch.Tensor:
    """[B, V, 2] -> [B, C*S, 2] class-sorted, padding slots at the sentinel."""
    return _GatherSorted.apply(verts2d, layout)


def pixel_grid(image_size: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """[H*W, 2] pixel-centre coordinates, (x, y) order, row-major."""
    r = torch.arange(image_size, dtype=dtype, device=device)
    ys, xs = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([xs, ys], dim=-1).reshape(-1, 2)


def pairwise_scores(
    vx: torch.Tensor, num_parts: int, seg_size: int, cfg: RasterConfig, keep=None
) -> torch.Tensor:
    """Plain twin of the raster kernel: every pixel against every slot.

    vx [B, C*S, 2] class-sorted (sentinel-padded) -> scores [B, H*W, C].
    Pixels go in chunks so the [B, chunk, C*S] temporaries stay bounded.
    `keep(i, j)`, when given, is a [B, j - i, C*S] bool mask of the pairs
    of pixels i..j-1 that are summed (raster_cuda's culled plain version).
    """
    B, N, _ = vx.shape
    C, S = num_parts, seg_size
    pix = pixel_grid(cfg.image_size, vx.dtype, vx.device)
    pc = max(1, _PAIRWISE_BUDGET // max(1, B * N))
    inv_two_sigma2 = 1.0 / (2.0 * cfg.sigma * cfg.sigma)
    vxx, vyy = vx[:, None, :, 0], vx[:, None, :, 1]
    chunks = []
    for i in range(0, pix.shape[0], pc):
        p = pix[i : i + pc]
        dx = p[None, :, None, 0] - vxx
        dy = p[None, :, None, 1] - vyy
        e = torch.exp(-(dx * dx + dy * dy) * inv_two_sigma2)
        if keep is not None:
            e = torch.where(keep(i, i + p.shape[0]), e, 0.0)
        chunks.append(e.reshape(B, p.shape[0], C, S).sum(dim=-1))
    return torch.cat(chunks, dim=1)


def raster_scores_cf(
    verts2d: torch.Tensor,
    layout: PartLayout,
    cfg: RasterConfig,
    impl: str = "auto",
    out_dtype: torch.dtype | None = None,
) -> torch.Tensor:
    """Per-class scores, channel-first: verts2d [B, V, 2] (pixels) ->
    [B, C, H, W], the kernel's native layout (no transpose), cast to
    `out_dtype` when given. Differentiable in verts2d."""
    from indirect_learning_pose_shape_tpu_torch.ops.kernels import raster_cuda

    if impl == "auto":
        impl = "kernel" if verts2d.is_cuda else "torch"
    if impl not in ("kernel", "torch"):
        raise ValueError(f"raster impl must be 'kernel' | 'torch' | 'auto', got {impl!r}")
    vx = gather_class_sorted(verts2d, layout)
    out = raster_cuda.raster_scores4(
        vx, layout.real, layout.num_parts, layout.seg_size, cfg, impl=impl
    )
    return out.to(out_dtype) if out_dtype is not None else out


def raster_scores(
    verts2d: torch.Tensor, layout: PartLayout, cfg: RasterConfig, impl: str = "auto"
) -> torch.Tensor:
    """Per-class Gaussian scores. verts2d [B, V, 2] (pixels) -> [B, H*W, C]."""
    B = verts2d.shape[0]
    score = raster_scores_cf(verts2d, layout, cfg, impl=impl)
    return score.reshape(B, layout.num_parts, -1).transpose(1, 2)


def soft_rasterize(
    verts2d: torch.Tensor, layout: PartLayout, cfg: RasterConfig, impl: str = "auto"
) -> dict[str, torch.Tensor]:
    """probs [B, H, W, C+1] (channel 0 = background), silhouette [B, H, W]."""
    B = verts2d.shape[0]
    size, C = cfg.image_size, cfg.num_parts
    score = raster_scores(verts2d, layout, cfg, impl=impl)
    s_total = torch.sum(score, dim=-1, keepdim=True)
    denom = cfg.bg_gamma + s_total
    probs = torch.cat([cfg.bg_gamma / denom, score / denom], dim=-1).reshape(
        B, size, size, C + 1
    )
    sil = (s_total / denom).reshape(B, size, size)
    return {"probs": probs, "silhouette": sil}


def soft_rasterize_train(
    verts2d: torch.Tensor, layout: PartLayout, cfg: RasterConfig, impl: str = "auto"
) -> dict[str, torch.Tensor]:
    """Score-form rasterization for the training losses: the normalized
    [B, H, W, C+1] probabilities are never built (losses.part_seg_ce_scores
    folds the normalization into per-pixel scalars).

    Returns score_cp [B, C, H*W] float32 raw class scores (channel-first),
    s_total [B, H*W] = Σ_c score (float32), silhouette [B, H, W].
    """
    B = verts2d.shape[0]
    size, C = cfg.image_size, cfg.num_parts
    score_cp = raster_scores_cf(verts2d, layout, cfg, impl=impl).reshape(B, C, size * size)
    s_total = torch.sum(score_cp, dim=1, dtype=torch.float32)
    sil = (s_total / (cfg.bg_gamma + s_total)).reshape(B, size, size)
    return {"score_cp": score_cp, "s_total": s_total, "silhouette": sil}
