"""Model FLOPs of the HMR 2.0 configuration from its shapes (2 FLOPs a
multiply-add), read from the configuration file's `vit` and `head` groups.

- ViT, a crop's forward: the patch convolution (tokens x 3·p² x width),
  then each block's qkv, output projection and two MLP products (tokens x
  (3d² + d² + 2·d·mlp)) and its attention, q·kᵀ and the product with v,
  tokens² x head_dim a head each. LayerNorm, GELU, softmax and the residual
  adds are not products and are not counted.
- Head: each layer's self-attention (projections and the one-token
  attention), cross-attention (the query's projections, the keys and values
  projected from every context token, the attention over them) and
  feed-forward; the three decoders.
- A training image: the forward three times (forward, and the input and
  weight gradients), less the patch convolution's input gradient (the
  images need none); SMPL four times (`flops.lbs_flops`: the target bodies
  posed once, the predicted ones forward and backward). The soft raster's
  pairs are left out: under 0.1% of the step.
- Attention's needed FLOPs, a head: 4·Nq·Nk·d forward, twice that backward.
"""

from __future__ import annotations

from portbench import trace
from portbench.work import flops


def vit_macs(v: dict) -> dict:
    """Multiply-adds of one crop's forward through the ViT, by part."""
    n, d, m, ps = v["tokens"], v["width"], v["mlp_dim"], v["patch_size"]
    return {"patch": n * 3 * ps * ps * d,
            "blocks": v["depth"] * n * (3 * d * d + d * d + 2 * d * m),
            "attention": v["depth"] * v["num_heads"] * 2 * n * n * v["head_dim"]}


def head_macs(h: dict, tokens: int, theta_dim: int) -> dict:
    """Multiply-adds of one crop's forward through the head, by part."""
    d, inner, hd = h["width"], h["num_heads"] * h["head_dim"], h["head_dim"]
    layer = d * 3 * inner + inner * d + d * inner + inner * d + 2 * d * h["mlp_dim"]
    attention = h["num_heads"] * 2 * hd * (1 + tokens)  # one query: over itself, over the context
    return {"layers": h["depth"] * layer, "kv": h["depth"] * tokens * h["context_dim"] * 2 * inner,
            "attention": h["depth"] * attention,
            "decoders": h["token_dim"] * d + d * theta_dim}


def _theta_dim(config: dict) -> int:
    return 6 * config["smpl"]["num_joints"] + config["smpl"]["num_betas"] + 3


def forward_flops_per_image(config: dict) -> float:
    """The ViT and head's forward FLOPs of one crop."""
    v = config["vit"]
    macs = sum(vit_macs(v).values()) + sum(head_macs(config["head"], v["tokens"], _theta_dim(config)).values())
    return 2.0 * macs


def train_flops_per_image(config: dict) -> float:
    """A training image: the network x3 less the patch convolution's input
    gradient, and SMPL x4."""
    patch = 2.0 * vit_macs(config["vit"])["patch"]
    return 3 * forward_flops_per_image(config) - patch + 4 * flops.lbs_flops()


def attention_flops_per_image(config: dict) -> float:
    """Attention's needed FLOPs of one training image, forward and backward:
    3 x (4·Nq·Nk·d a head) over every attention of the ViT and the head."""
    v, h = config["vit"], config["head"]
    n = v["tokens"]
    fwd = v["depth"] * v["num_heads"] * 4 * n * n * v["head_dim"]
    fwd += h["depth"] * h["num_heads"] * 4 * (1 + n) * h["head_dim"]
    return 3.0 * fwd


# Device items of a profiled stretch by name (case aside), apart from
# `trace.category`'s groups: the attention kernels of
# `scaled_dot_product_attention` (FlashAttention's `flash_fwd*` /
# `flash_bwd*`, the memory-efficient `fmha_cutlass*` / `*AttentionKernel*`,
# cuDNN's `*sdpa*` graphs and the two helpers of its backward,
# `cudnn::fusion::compute_dot_do_o` and `convert_dq_to_16bits`), and
# cuBLAS's Hopper GEMMs (`nvjet_*`), whose names hold none of the conv/gemm
# category's keys.
ATTENTION_NAMES = ("flash", "fmha", "sdpa", "attention", "dot_do_o", "convert_dq")
GEMM_NAMES = ("nvjet",)


def kind(name: str) -> str:
    """'attention', 'gemm' (the conv/gemm category and cuBLAS's nvjet GEMMs,
    attention left out), or the item's `trace.category`."""
    lower = name.lower()
    if any(k in lower for k in ATTENTION_NAMES):
        return "attention"
    cat = trace.category(name)
    return "gemm" if cat == "conv/gemm" or any(k in lower for k in GEMM_NAMES) else cat


def kind_ms(summary: dict, which: str):
    """Device ms a unit of a profiled stretch's items of `kind` `which`
    (`trace.summarize`'s summary); None without any."""
    ms = [v for n, v in summary["by_kernel_ms"].items() if kind(n) == which]
    return sum(ms) / summary["units"] if ms else None
