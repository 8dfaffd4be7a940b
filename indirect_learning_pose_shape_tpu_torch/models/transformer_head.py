"""HMR 2.0's SMPL head: a transformer decoder with one query token that
cross-attends to the backbone's tokens (Goel et al., ICCV 2023:
`SMPLTransformerDecoderHead`, `TransformerDecoder`, `TransformerCrossAttn`).

The query is a zero token of width `token_dim` (1), embedded by
Linear(1, width) and given a learned position term. Then `depth` layers,

    x = x + SelfAttention(LN(x))
    x = x + CrossAttention(LN(x), context)
    x = x + FeedForward(LN(x))

with `num_heads` heads of `head_dim`, q/k/v projections without bias and
an output projection with one, keys and values of the cross-attention
projected from the context's `context_dim` channels, and a feed-forward
width → `mlp_dim` → width with the exact GELU. A final LayerNorm, then
linear decoders to the pose, the betas and the camera, added to Θ₀ (one
iteration of HMR 2.0's IEF loop, whose query is the zero token every
time). Θ comes out in the layout of the port's IEF ([pose | betas | cam],
`ief.split_theta`) from the same Θ₀ (`smpl.mean_params`), which the head
holds as the buffer `mean_theta`, as HMR 2.0 holds its mean parameters.

Precision as in `vit.py`: float32 parameters, the products in
`compute_dtype` (bf16), the LayerNorm statistics, the residual stream and
the decoders in float32. The span `head.decoder` covers the decoder layers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from indirect_learning_pose_shape_tpu_torch.models import vit as vit_mod
from indirect_learning_pose_shape_tpu_torch.models.ief import IEFConfig
from indirect_learning_pose_shape_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class TransformerHeadConfig:
    """HMR 2.0's `TRANSFORMER_DECODER` settings."""

    width: int = 1024
    depth: int = 6
    num_heads: int = 8
    head_dim: int = 64
    mlp_dim: int = 1024
    context_dim: int = 1280
    token_dim: int = 1
    ln_eps: float = 1e-5
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.head_dim


class DecoderLayer(nn.Module):
    def __init__(self, cfg: TransformerHeadConfig, gen: torch.Generator):
        super().__init__()
        d, inner = cfg.width, cfg.inner_dim
        lin = vit_mod.linear
        self.norm_sa = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.to_qkv = lin(gen, d, 3 * inner, 0.02, bias=False)
        self.sa_out = lin(gen, inner, d, 0.02)
        self.norm_ca = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.to_q = lin(gen, d, inner, 0.02, bias=False)
        self.to_kv = lin(gen, cfg.context_dim, 2 * inner, 0.02, bias=False)
        self.ca_out = lin(gen, inner, d, 0.02)
        self.norm_ff = nn.LayerNorm(d, eps=cfg.ln_eps)
        self.ff1 = lin(gen, d, cfg.mlp_dim, 0.02)
        self.ff2 = lin(gen, cfg.mlp_dim, d, 0.02)


class TransformerHead(nn.Module):
    """The head's parameters (`token_embedding`, `pos_embedding`,
    `layers.{i}.*`, `norm`, `decpose`, `decshape`, `deccam`) drawn from
    `gen`: N(0, 0.02²) weights, zero biases, the position term N(0, 1) as
    HMR 2.0 draws it, the decoders at std 1e-3 (as IEF's last layer) so Θ
    starts at Θ₀; and Θ₀ (`mean_theta`, a buffer)."""

    def __init__(self, cfg: TransformerHeadConfig, ief: IEFConfig, mean_theta, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        lin = vit_mod.linear
        self.token_embedding = lin(gen, cfg.token_dim, cfg.width, 0.02)
        self.pos_embedding = nn.Parameter(torch.randn((1, 1, cfg.width), generator=gen))
        self.layers = nn.ModuleList(DecoderLayer(cfg, gen) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(cfg.width, eps=cfg.ln_eps)
        self.decpose = lin(gen, cfg.width, ief.num_pose, 1e-3)
        self.decshape = lin(gen, cfg.width, ief.num_betas, 1e-3)
        self.deccam = lin(gen, cfg.width, ief.num_cam, 1e-3)
        self.register_buffer("mean_theta", torch.as_tensor(np.asarray(mean_theta, np.float32)))


def _heads(x: torch.Tensor, cfg: TransformerHeadConfig) -> torch.Tensor:
    """[B, N, H·d] -> [B, H, N, d]."""
    B, N, _ = x.shape
    return x.view(B, N, cfg.num_heads, cfg.head_dim).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    """[B, H, N, d] -> [B, N, H·d]."""
    B, H, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, H * d)


def _layer(layer: DecoderLayer, x: torch.Tensor, context: torch.Tensor, cfg: TransformerHeadConfig):
    """One decoder layer on the float32 residual x [B, 1, width]; context
    [B, N, context_dim] in the compute dtype."""
    dt, lin, ln = cfg.compute_dtype, vit_mod.cast_linear, vit_mod.layer_norm_to
    q, k, v = lin(ln(x, layer.norm_sa, dt), layer.to_qkv).chunk(3, dim=-1)
    a = vit_mod.attention(_heads(q, cfg), _heads(k, cfg), _heads(v, cfg))
    x = x + lin(_merge(a), layer.sa_out).float()
    q = lin(ln(x, layer.norm_ca, dt), layer.to_q)
    k, v = lin(context, layer.to_kv).chunk(2, dim=-1)
    a = vit_mod.attention(_heads(q, cfg), _heads(k, cfg), _heads(v, cfg))
    x = x + lin(_merge(a), layer.ca_out).float()
    h = F.gelu(lin(ln(x, layer.norm_ff, dt), layer.ff1))
    return x + lin(h, layer.ff2).float()


def head_apply(head: TransformerHead, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, N, context_dim] float32 (the backbone's) -> Θ [B, theta_dim]."""
    cfg = head.cfg
    B = tokens.shape[0]
    with tracing.span("head.decoder"):
        context = tokens.to(cfg.compute_dtype)
        query = tokens.new_zeros((B, 1, cfg.token_dim))
        x = head.token_embedding(query) + head.pos_embedding
        for layer in head.layers:
            x = _layer(layer, x, context, cfg)
        t = head.norm(x[:, 0])
    delta = torch.cat([head.decpose(t), head.decshape(t), head.deccam(t)], dim=1)
    return head.mean_theta + delta

