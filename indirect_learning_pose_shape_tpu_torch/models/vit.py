"""ViT image encoder: the plain ViT of ViTPose as HMR 2.0 uses it (Goel et
al., "Humans in 4D", ICCV 2023; Xu et al., ViTPose, NeurIPS 2022).

The square crop's columns `crop_cols` (HMR 2.0: 32:224 of 256) are cut
into patches by a `patch_size` convolution with stride `patch_size` and
padding `patch_padding` (ViTPose's `PatchEmbed` at ratio 1: 16, 16, 2, so a
256x192 input gives a 16x12 grid of 192 tokens). The position embedding
holds a class term (row 0) and one term a patch, and every patch token gets
its own term plus the class term, as ViTPose's `forward_features` adds
them. Then `depth` pre-LN blocks,

    x = x + drop_path(proj(attention(qkv(LN1(x)))))
    x = x + drop_path(fc2(GELU(fc1(LN2(x)))))

with `num_heads` heads, a bias on qkv, the exact (erf) GELU, LayerNorm eps
`ln_eps`, and a last LayerNorm. The output is the tokens [B, N, width]
float32, which the transformer head (`models/transformer_head.py`) attends
to.

Precision, as `encoder.py`'s: the parameters are float32, and every product
runs in `compute_dtype` (bf16) with the weights cast at the call; the
LayerNorm statistics and the residual stream stay in float32.

A branch joins the residual stream where the next LayerNorm reads it: each
of a block's two LayerNorm sites is one `add_layer_norm` call
(`ops/kernels/vit_add_ln_cuda.py`), x' = x + y.float()·s and its LayerNorm
cast to `compute_dtype`, one hand-written CUDA kernel forward and one
backward on the card (x' bitwise the eager sum), its plain twin on the CPU.
The kernels take a bf16 `compute_dtype` and widths that are multiples of 8
up to 1536; on the card any other configuration raises.
Block 0's norm1 has no branch to add; the last block's MLP branch joins
outside the op, before `last_norm`, which stays a module call. Counters
`vit.tokens.add_ln.kernel` / `.eager`: the rows each route normalised.

Attention goes through `scaled_dot_product_attention` (`attention`), which
must pick a fused backend on the card (flash, memory-efficient or cuDNN):
a choice of the math backend on a CUDA tensor raises. Each call counts
`attn.calls.<backend>` (`utils/tracing.py`), where host code runs: in an
eager call and at a CUDA graph's capture.

Drop path (stochastic depth) keeps a sample's branch with probability
1 − p_i and scales it by 1 / (1 − p_i), p_i rising linearly from 0 at the
first block to `drop_path` at the last, a draw a branch (two a block), as
ViTPose's `DropPath`. The draws for the whole network are one uniform
draw [B, 2·depth] (`drop_path_u`), which the training step takes from its
batch's generator after the batch (`train._draw_batch`), so a CUDA graph
replay draws fresh masks without a host copy.

Spans (recorded only under a profiler, in an eager call and at a capture):
`vit.embed`, `vit.blocks`; counter `vit.tokens` (the tokens a call
encodes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.attention import SDPBackend
from torch.nn.utils import skip_init

from indirect_learning_pose_shape_tpu_torch.ops.kernels.vit_add_ln_cuda import add_layer_norm
from indirect_learning_pose_shape_tpu_torch.utils import tracing

FUSED = (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION, SDPBackend.CUDNN_ATTENTION)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """ViT-H/16 as HMR 2.0 configures ViTPose's backbone."""

    crop_cols: tuple = (32, 224)  # the columns of the square crop the backbone reads
    patch_size: int = 16
    patch_padding: int = 2
    width: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_dim: int = 5120
    qkv_bias: bool = True
    ln_eps: float = 1e-6
    drop_path: float = 0.55
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads

    @property
    def feature_dim(self) -> int:
        return self.width

    def grid(self, image_size: int) -> tuple[int, int]:
        """Patch rows and columns of a crop of `image_size`²."""
        def n(size):
            return (size + 2 * self.patch_padding - self.patch_size) // self.patch_size + 1

        return n(image_size), n(self.crop_cols[1] - self.crop_cols[0])

    def num_tokens(self, image_size: int) -> int:
        h, w = self.grid(image_size)
        return h * w


def linear(gen: torch.Generator, cin: int, cout: int, std: float, bias: bool = True) -> nn.Linear:
    """nn.Linear with weights N(0, std²) drawn from `gen`, zero bias."""
    layer = skip_init(nn.Linear, cin, cout, bias=bias)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen) * std)
        if bias:
            layer.bias.zero_()
    return layer


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q·kᵀ/√d)·v by `scaled_dot_product_attention`, q [B, H, Nq, d],
    k and v [B, H, Nk, d]. On the card the backend it picks must be a fused
    one; the math backend raises."""
    backend = SDPBackend(torch._fused_sdp_choice(q, k, v))
    if q.is_cuda and backend not in FUSED:
        raise RuntimeError(
            f"scaled_dot_product_attention would take the {backend.name} backend for q "
            f"{tuple(q.shape)} {q.dtype}, k {tuple(k.shape)}: no fused kernel applies"
        )
    tracing.count(f"attn.calls.{backend.name.lower()}")
    return F.scaled_dot_product_attention(q, k, v)


class Attention(nn.Module):
    def __init__(self, cfg: ViTConfig, gen: torch.Generator):
        super().__init__()
        self.qkv = linear(gen, cfg.width, 3 * cfg.width, 0.02, bias=cfg.qkv_bias)
        self.proj = linear(gen, cfg.width, cfg.width, 0.02)


class Mlp(nn.Module):
    def __init__(self, cfg: ViTConfig, gen: torch.Generator):
        super().__init__()
        self.fc1 = linear(gen, cfg.width, cfg.mlp_dim, 0.02)
        self.fc2 = linear(gen, cfg.mlp_dim, cfg.width, 0.02)


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig, gen: torch.Generator):
        super().__init__()
        self.norm1 = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.attn = Attention(cfg, gen)
        self.norm2 = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.mlp = Mlp(cfg, gen)


class ViT(nn.Module):
    """ViTPose's ViT under its parameter names (`patch_embed.proj`,
    `pos_embed`, `blocks.{i}.norm1 | attn.qkv | attn.proj | norm2 | mlp.fc1 |
    mlp.fc2`, `last_norm`): weights N(0, 0.02²) drawn from `gen`, zero
    biases, LayerNorms at identity."""

    def __init__(self, cfg: ViTConfig, image_size: int, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        ps = cfg.patch_size
        self.patch_embed = nn.Module()
        self.patch_embed.proj = skip_init(nn.Conv2d, 3, cfg.width, ps, stride=ps, padding=cfg.patch_padding)
        n = cfg.num_tokens(image_size)
        self.pos_embed = nn.Parameter(torch.randn((1, n + 1, cfg.width), generator=gen) * 0.02)
        with torch.no_grad():
            proj = self.patch_embed.proj
            proj.weight.copy_(torch.randn(proj.weight.shape, generator=gen) * 0.02)
            proj.bias.zero_()
        self.blocks = nn.ModuleList(Block(cfg, gen) for _ in range(cfg.depth))
        self.last_norm = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)


def layer_norm_to(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm in float32, its output in `dtype`."""
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(dtype)


def cast_linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """`layer` in x's dtype: its float32 weights cast at the call."""
    bias = None if layer.bias is None else layer.bias.to(x.dtype)
    return F.linear(x, layer.weight.to(x.dtype), bias)


def drop_path_scales(cfg: ViTConfig, u: torch.Tensor) -> torch.Tensor:
    """[B, 2·depth] float32: each sample's scale of each branch, keep / (1 − p)
    with keep = u ≥ p for the uniform draws u [B, 2·depth]."""
    rates = torch.linspace(0.0, cfg.drop_path, cfg.depth, device=u.device).repeat_interleave(2)
    return (u >= rates).float() / (1.0 - rates)


def _block(blk: Block, x: torch.Tensor, y: Optional[torch.Tensor], s: Optional[torch.Tensor], cfg: ViTConfig,
           scales: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """One block on the float32 residual stream x [B, N, D], which the
    previous block's MLP branch y (bf16; None at the first block) with its
    scale s [B] joins at norm1's site. scales [B, 2] or None (no drop path).
    Returns the stream and this block's MLP branch, which the next site
    adds."""
    B, N, D = x.shape
    dt = cfg.compute_dtype
    x, h = add_layer_norm(x, y, s, blk.norm1, dt)
    qkv = cast_linear(h, blk.attn.qkv)
    q, k, v = qkv.view(B, N, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4).unbind(0)
    a = attention(q, k, v).transpose(1, 2).reshape(B, N, D)
    x, h = add_layer_norm(x, cast_linear(a, blk.attn.proj), None if scales is None else scales[:, 0], blk.norm2, dt)
    h = F.gelu(cast_linear(h, blk.mlp.fc1))
    return x, cast_linear(h, blk.mlp.fc2)


def embed(vit: ViT, images: torch.Tensor) -> torch.Tensor:
    """images [B, S, S, 3] float32 in [-1, 1] -> the float32 tokens
    [B, N, D] with their position terms."""
    cfg = vit.cfg
    c0, c1 = cfg.crop_cols
    x = images[:, :, c0:c1].permute(0, 3, 1, 2).to(cfg.compute_dtype)
    proj = vit.patch_embed.proj
    x = F.conv2d(x, proj.weight.to(x.dtype), proj.bias.to(x.dtype), stride=cfg.patch_size,
                 padding=cfg.patch_padding)
    x = x.flatten(2).transpose(1, 2).float()
    return x + vit.pos_embed[:, 1:] + vit.pos_embed[:, :1]


def vit_apply(vit: ViT, images: torch.Tensor, drop_path_u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """images [B, S, S, 3] float32 in [-1, 1] -> tokens [B, N, width]
    float32. With `drop_path_u` (the training step's uniform draws [B,
    2·depth]) it applies drop path."""
    cfg = vit.cfg
    with tracing.span("vit.embed"):
        x = embed(vit, images)
    tracing.count("vit.tokens", x.shape[0] * x.shape[1])
    scales = None
    if drop_path_u is not None:
        scales = drop_path_scales(cfg, drop_path_u).view(x.shape[0], cfg.depth, 2)
    with tracing.span("vit.blocks"):
        y = s = None
        for i, blk in enumerate(vit.blocks):
            x, y = _block(blk, x, y, s, cfg, None if scales is None else scales[:, i])
            s = None if scales is None else scales[:, i, 1]
        # The last branch joins outside the op: `last_norm` stays a module
        # call, which forward hooks read.
        y = y.float()
        return vit.last_norm(x + (y if s is None else y * s[:, None, None]))
