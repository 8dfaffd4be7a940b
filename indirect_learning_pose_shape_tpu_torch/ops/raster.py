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

`raster_scores` has three implementations of the same sum:

- 'kernel': the culled CUDA kernels (ports of the Pallas
  `raster_pallas._fwd_kernel` / `_bwd_kernel`), behind the autograd Function
  of ops/kernels/raster_cuda.py;
- 'torch': the pairwise, pixel-chunked plain versions behind the same
  Function (twins of the reference's `impl='xla'` path);
- 'separable': the reference's default formulation, plain torch: the
  Gaussian factorises over the axes, so a class's score image is
  Fyᵀ @ Fx with Fx[s, w] = exp(−(w − x_s)²/2σ²) [B,C,S,W] and Fy [B,C,S,H]
  built from 1-D exponentials, one batched matmul; its backward is two more.

'auto' is the kernel for CUDA tensors and the plain versions for CPU
tensors; under a render axis it is 'separable', the one route that renders a
band of rows (`rows`, a `parallel/render_sp.Rows`: the reference's
`constrain` hook, which acts on its separable route only). The reference's
'auto' is 'separable', because the TPU's matrix
unit makes its S-deep products nearly free; here the kernels stay the
default until a benchmark cell shows the separable route faster end to end
(`chip_smoke.py` times both at the training batch).

`RasterConfig.matmul_precision` sets the separable product's arithmetic,
as the reference's `jax.lax.Precision` does on the TPU's bf16 matrix unit:

- 'highest': float32 operands and sums, TF32 off;
- 'high': the 3-pass bf16 product, hi·hi + hi·lo + lo·hi with hi = bf16(x)
  and lo = bf16(x − hi), float32 sums and output (the reference measured
  5e-5 against 'highest'; TF32 would be another function);
- 'default': bf16 operands, float32 sums and output (~9e-3).

With `out_dtype=torch.bfloat16` (the synthetic targets, and the training
scores under `train_score_dtype='bfloat16'`) the factors are rounded to
bf16, summed in float32 and the result rounded once to bf16, as the
reference's `preferred_element_type=bf16`; `matmul_precision` then plays no
part. The product is asked for in float32 and rounded after, so cuBLAS never
reduces split-K partials in bf16. Both knobs act on the separable impl only;
the kernels keep float32 scores, as the reference's 'pallas' path does.

The reference's `pixel_chunk` (its pairwise path's streamed-chunk size) is
not a field here: eager PyTorch materialises the pairwise temporaries that
XLA fuses away, so the plain versions bound them by element count
(`_PAIRWISE_BUDGET`) instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.utils.precision import full_f32

_SENTINEL = 1.0e6  # padded slots live here: exp(-d²/2σ²) underflows to 0
_LANE = 128  # segment sizes are multiples of the kernel's culling block
# Elements of one pairwise [B, chunk, C*S] temporary in the torch twin.
_PAIRWISE_BUDGET = 1 << 26
IMPLS = ("kernel", "torch", "separable", "auto")
PRECISIONS = ("highest", "high", "default")
SCORE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    image_size: int = 256
    num_parts: int = 24  # foreground classes (channel 0 of probs is bg)
    sigma: float = 2.0  # Gaussian falloff in pixels
    bg_gamma: float = 1.0  # background strength in the soft normalization
    # Kernel culling radius in sigmas: exp(-18) ~ 1.5e-8 at 6σ, below
    # float32 significance next to any covered pixel.
    cutoff_sigmas: float = 6.0
    # The separable impl's product arithmetic (module docstring).
    matmul_precision: str = "high"
    # Storage of the training render's scores on the separable impl:
    # 'float32' | 'bfloat16' (presets train with bf16, as the reference's).
    train_score_dtype: str = "float32"

    def __post_init__(self):
        if self.matmul_precision not in PRECISIONS:
            raise ValueError(f"matmul_precision must be one of {PRECISIONS}, got {self.matmul_precision!r}")
        if self.train_score_dtype not in SCORE_DTYPES:
            raise ValueError(
                f"train_score_dtype must be one of {tuple(SCORE_DTYPES)}, got {self.train_score_dtype!r}"
            )


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


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 [N, M, S] @ [N, S, K]: float32 sums and output (the products of
    two bf16 values are exact in float32, so on the CPU that is the float32
    product of the widened operands)."""
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """float32 [N, M, S] @ [N, S, K] at `precision` (module docstring)."""
    if precision == "highest":
        with full_f32():
            return torch.bmm(a, b)
    ah, bh = a.to(torch.bfloat16), b.to(torch.bfloat16)
    out = _bf16_mm(ah, bh)
    if precision == "high":
        al = (a - ah.float()).to(torch.bfloat16)
        bl = (b - bh.float()).to(torch.bfloat16)
        out = out + _bf16_mm(ah, bl) + _bf16_mm(al, bh)
    return out


def _mm_bf16_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[N, M, S] @ [N, S, K] from bf16-rounded operands, float32 sums,
    result rounded once to bf16."""
    return _bf16_mm(a.to(torch.bfloat16), b.to(torch.bfloat16)).to(torch.bfloat16)


class _SeparableProduct(torch.autograd.Function):
    """fyt [N, H, S] @ fx [N, S, W] (float32 factor tables) -> [N, H, W] at
    `precision` in float32, or rounded once to bf16 when `bf16_out`. The
    backward products take the same arithmetic: the reference's
    precision-tagged einsum differentiates that way, and with bf16 output
    its cotangent arrives in bf16 and each operand's gradient is rounded to
    bf16 before the cast back to float32."""

    @staticmethod
    def forward(ctx, fyt, fx, precision, bf16_out):
        ctx.save_for_backward(fyt, fx)
        ctx.meta = (precision, bf16_out)
        return _mm_bf16_out(fyt, fx) if bf16_out else _mm(fyt, fx, precision)

    @staticmethod
    def backward(ctx, g):
        fyt, fx = ctx.saved_tensors
        precision, bf16_out = ctx.meta
        if bf16_out:
            g_fyt = _mm_bf16_out(g, fx.transpose(1, 2)).float()
            g_fx = _mm_bf16_out(fyt.transpose(1, 2), g).float()
        else:
            g_fyt = _mm(g, fx.transpose(1, 2), precision)
            g_fx = _mm(fyt.transpose(1, 2), g, precision)
        return g_fyt, g_fx, None, None


def separable_scores(
    vx: torch.Tensor,
    num_parts: int,
    seg_size: int,
    cfg: RasterConfig,
    out_dtype: torch.dtype | None = None,
    rows=None,
) -> torch.Tensor:
    """The separable raster (the reference's `_raster_scores_separable`):
    vx [B, C*S, 2] class-sorted, sentinel-padded slots (pixels) -> scores
    [B, C, H, W] in float32 at `cfg.matmul_precision`, or in bf16 when
    `out_dtype` is torch.bfloat16. Padding slots sit at the sentinel, so
    both factors are exactly 0 there. Differentiable in vx.

    With `rows` (render_sp.Rows) only that band's rows of fy are built and
    the scores are [B, C, H/n, W]; the gradient of vx is summed over the
    render group, so every render rank holds the whole image's."""
    if out_dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError(f"separable scores come in float32 or bfloat16, not {out_dtype}")
    B, size = vx.shape[0], cfg.image_size
    C, S = num_parts, seg_size
    r = torch.arange(size, dtype=vx.dtype, device=vx.device)
    ry = r
    if rows is not None:
        ry = r[rows.band(size)]
        vx = rows.sum_grad(vx)
    v = vx.reshape(B, C, S, 2)
    inv_two_sigma2 = 1.0 / (2.0 * cfg.sigma * cfg.sigma)
    fx = torch.exp(-torch.square(r - v[..., 0:1]) * inv_two_sigma2).reshape(B * C, S, size)
    fy = torch.exp(-torch.square(ry - v[..., 1:2]) * inv_two_sigma2).reshape(B * C, S, len(ry))
    score = _SeparableProduct.apply(
        fy.transpose(1, 2), fx, cfg.matmul_precision, out_dtype == torch.bfloat16
    )
    return score.reshape(B, C, len(ry), size)


def resolve_impl(impl: str, verts2d: torch.Tensor, rows=None) -> str:
    """The route `impl` names: 'auto' is 'separable' under a render axis,
    else the kernel on CUDA tensors and the plain versions on the CPU. Rows
    are rendered by the separable route only."""
    if impl == "auto":
        impl = "separable" if rows is not None else ("kernel" if verts2d.is_cuda else "torch")
    if impl not in IMPLS:
        raise ValueError(f"raster impl must be one of {IMPLS}, got {impl!r}")
    if rows is not None and impl != "separable":
        raise ValueError(
            f"raster impl {impl!r} cannot render a band of rows: row-sharded rendering "
            "runs the separable raster, as the reference's (its kernel route is never "
            "row-sharded)"
        )
    return impl


def raster_scores_cf(
    verts2d: torch.Tensor,
    layout: PartLayout,
    cfg: RasterConfig,
    impl: str = "auto",
    out_dtype: torch.dtype | None = None,
    rows=None,
) -> torch.Tensor:
    """Per-class scores, channel-first: verts2d [B, V, 2] (pixels) ->
    [B, C, H, W], the kernel's and the separable product's native layout
    (no transpose), in `out_dtype` when given (the separable impl computes
    it in that type; the others cast). Differentiable in verts2d. With
    `rows`, this rank's band: [B, C, H/n, W]."""
    from indirect_learning_pose_shape_tpu_torch.ops.kernels import raster_cuda

    impl = resolve_impl(impl, verts2d, rows)
    vx = gather_class_sorted(verts2d, layout)
    if impl == "separable":
        return separable_scores(vx, layout.num_parts, layout.seg_size, cfg, out_dtype, rows)
    out = raster_cuda.raster_scores4(
        vx, layout.real, layout.num_parts, layout.seg_size, cfg, impl=impl
    )
    return out.to(out_dtype) if out_dtype is not None else out


def raster_scores(
    verts2d: torch.Tensor, layout: PartLayout, cfg: RasterConfig, impl: str = "auto", rows=None
) -> torch.Tensor:
    """Per-class Gaussian scores. verts2d [B, V, 2] (pixels) -> [B, H*W, C]
    ([B, H/n*W, C] for a band of `rows`)."""
    B = verts2d.shape[0]
    score = raster_scores_cf(verts2d, layout, cfg, impl=impl, rows=rows)
    return score.reshape(B, layout.num_parts, -1).transpose(1, 2)


def soft_rasterize(
    verts2d: torch.Tensor, layout: PartLayout, cfg: RasterConfig, impl: str = "auto", rows=None
) -> dict[str, torch.Tensor]:
    """probs [B, H, W, C+1] (channel 0 = background), silhouette [B, H, W];
    H is the band's height with `rows`."""
    B = verts2d.shape[0]
    size, C = cfg.image_size, cfg.num_parts
    score = raster_scores(verts2d, layout, cfg, impl=impl, rows=rows)
    h = score.shape[1] // size
    s_total = torch.sum(score, dim=-1, keepdim=True)
    denom = cfg.bg_gamma + s_total
    probs = torch.cat([cfg.bg_gamma / denom, score / denom], dim=-1).reshape(
        B, h, size, C + 1
    )
    sil = (s_total / denom).reshape(B, h, size)
    return {"probs": probs, "silhouette": sil}


def soft_rasterize_train(
    verts2d: torch.Tensor, layout: PartLayout, cfg: RasterConfig, impl: str = "auto", rows=None
) -> dict[str, torch.Tensor]:
    """Score-form rasterization for the training losses: the normalized
    [B, H, W, C+1] probabilities are never built (losses.part_seg_ce_scores
    folds the normalization into per-pixel scalars).

    Returns score_cp [B, C, H*W] raw class scores (channel-first; in
    `cfg.train_score_dtype` on the separable impl, float32 otherwise),
    s_total [B, H*W] = Σ_c score (summed in float32), silhouette [B, H, W];
    H is the band's height with `rows`.
    """
    B = verts2d.shape[0]
    size, C = cfg.image_size, cfg.num_parts
    impl = resolve_impl(impl, verts2d, rows)
    out_dtype = SCORE_DTYPES[cfg.train_score_dtype] if impl == "separable" else None
    score_cp = raster_scores_cf(verts2d, layout, cfg, impl=impl, out_dtype=out_dtype, rows=rows)
    h = score_cp.shape[2]
    score_cp = score_cp.reshape(B, C, h * size)
    s_total = torch.sum(score_cp, dim=1, dtype=torch.float32)
    sil = (s_total / (cfg.bg_gamma + s_total)).reshape(B, h, size)
    return {"score_cp": score_cp, "s_total": s_total, "silhouette": sil}
