"""HMR 2.0 (Goel et al., "Humans in 4D", ICCV 2023) in plain PyTorch and
float32, TF32 off: the ViT-H/16 backbone of ViTPose, the transformer
decoder head, then this system's SMPL, camera, soft raster, losses
(`body.py`, `model.py`, `raster.py`, `train.py`) and an AdamW step. The
repository's plain reference of the model and the benchmark's alike.

Backbone. The crop's columns `crop_cols` into a patch convolution
(`patch_size`, stride `patch_size`, padding `patch_padding`), each patch
token plus its position term plus the class term (position row 0); `depth`
pre-LN blocks x + s₁·proj(attn(qkv(LN(x)))), x + s₂·fc2(GELU(fc1(LN(x))))
with `num_heads` heads, softmax(q·kᵀ/√d)·v written out; a last LayerNorm.
Drop path: s = keep / (1 − p) per sample and branch, keep = u ≥ p, p rising
linearly from 0 at the first block to `drop_path_rate` at the last, for
the step's uniforms u [B, 2·depth] (`make_batch`); s = 1 without them.
LayerNorm is (x − mean) / √(var + eps) · w + b, the biased variance; GELU
the exact ½x(1 + erf(x/√2)).

Head. A zero query token of width 1 through Linear(1, width), plus its
position term; `depth` layers of pre-LN self-attention, cross-attention to
the backbone's tokens (keys and values from `context_dim`), and a
feed-forward with GELU; a final LayerNorm; linear decoders to pose, betas
and camera added to Θ₀ (`head.mean_theta`, fixed). One iteration.

Departures from the published model, as the configuration's `assumed`
lists them: this system's indirect losses in place of HMR 2.0's keypoint
losses and adversarial prior, weak perspective in place of its focal-5000
camera, seeded weights in place of ViTPose's pretrained ones, the SMPL
stand-in and its Θ₀ in place of `smpl_mean_params`.

Parameters are a flat dict under the port's `state_dict` names
(`encoder.blocks.{i}.attn.qkv.weight`, `head.layers.{i}.to_kv.weight`,
...). `Precision()` computes every product in float32; the control's
`Precision(encoder='fp8')` rounds both operands of every product of the
backbone and the head (patch convolution, linear layers, q·kᵀ and the
softmax's product with v) to float8 e4m3 with a per-tensor scale, the
gradient passing straight through. A training step runs the batch in
micro-batches (`micro`), each term taken as its share of the whole batch's
mean: exact in the mathematics, since nothing normalises across samples.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import model as model_lib
from portbench.reference import raster as raster_lib
from portbench.reference import stream as stream_lib
from portbench.reference import train as train_lib
from portbench.reference.precision import Precision, full_float32

FIXED = ("head.mean_theta",)  # buffers: not trained
_FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale; gradient straight
    through."""
    scale = (x.detach().abs().amax() / _FP8_MAX).clamp_min(1e-30)
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x.detach())


def _ops(prec: Precision, *xs):
    return tuple(_fp8(x) for x in xs) if prec.encoder == "fp8" else xs


def linear(prec: Precision, x, w, b=None):
    x, w = _ops(prec, x, w)
    y = torch.matmul(x, w.T)
    return y if b is None else y + b


def layer_norm(x, w, b, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def attend(prec: Precision, q, k, v):
    """q [B, H, Nq, d], k and v [B, H, Nk, d]."""
    q, k = _ops(prec, q, k)
    p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1]), dim=-1)
    p, v = _ops(prec, p, v)
    return torch.matmul(p, v)


def _split(x, heads: int):
    B, N, C = x.shape
    return x.reshape(B, N, heads, C // heads).transpose(1, 2)


def _merge(x):
    B, H, N, d = x.shape
    return x.transpose(1, 2).reshape(B, N, H * d)


def drop_scales(u: torch.Tensor, rate: float, depth: int) -> torch.Tensor:
    """[B, 2·depth]: keep / (1 − p) for the uniforms u, p linear from 0 to
    `rate` over the blocks, two branches a block."""
    p = torch.linspace(0.0, rate, depth, device=u.device).repeat_interleave(2)
    return (u >= p).float() / (1.0 - p)


def make_batch(inp, cfg: dict, seed: int, step: int, prec: Precision) -> dict:
    """`train.make_batch`'s batch of `step`, and at a drop-path rate above 0
    its uniforms `drop_path_u` [B, 2·depth], drawn from the batch's
    generator after the batch's draws."""
    b = inp.body
    gen = torch.Generator(device=b.v_template.device).manual_seed(stream_lib.step_seed(seed, step))
    d = stream_lib.draws(gen, cfg["batch_size"], b.num_joints, b.shapedirs.shape[1],
                         b.coco_regressor.shape[0], cfg["num_parts"], cfg["stream"], cfg["image_size"])
    u = None
    if cfg.get("drop_path_rate", 0.0) > 0:
        u = torch.rand((cfg["batch_size"], 2 * cfg["vit"]["depth"]), generator=gen, device=gen.device)
    include_3d = any(cfg["loss_weights"].get(k) for k in ("j3d", "v3d", "rotmat"))
    with full_float32():
        batch = stream_lib.batch(d, b, inp.parts, inp.fclass, cfg["stream"], cfg["image_size"],
                                 cfg["sigma"], cfg["bg_gamma"], prec, include_3d)
    if u is not None:
        batch["drop_path_u"] = u
    return batch


def backbone(w: dict, images: torch.Tensor, vc: dict, prec: Precision, scales=None) -> torch.Tensor:
    """images [B, S, S, 3] in [-1, 1] -> tokens [B, N, width]; `scales` [B,
    2·depth] the drop-path scales (`drop_scales`), None for none."""
    c0, c1 = vc["crop_cols"]
    x = images[:, :, c0:c1].permute(0, 3, 1, 2)
    pw = w["encoder.patch_embed.proj.weight"]
    x, pw = _ops(prec, x, pw)
    x = F.conv2d(x, pw, w["encoder.patch_embed.proj.bias"], stride=vc["patch_size"], padding=vc["patch_padding"])
    pos = w["encoder.pos_embed"]
    x = x.flatten(2).transpose(1, 2) + pos[:, 1:] + pos[:, :1]
    eps, heads = vc["ln_eps"], vc["num_heads"]
    for i in range(vc["depth"]):
        p = f"encoder.blocks.{i}."

        def lin(name, h):
            return linear(prec, h, w[p + name + ".weight"], w.get(p + name + ".bias"))

        h = layer_norm(x, w[p + "norm1.weight"], w[p + "norm1.bias"], eps)
        s1, s2 = (1.0, 1.0) if scales is None else (scales[:, 2 * i, None, None], scales[:, 2 * i + 1, None, None])
        q, k, v = lin("attn.qkv", h).chunk(3, dim=-1)
        x = x + s1 * lin("attn.proj", _merge(attend(prec, _split(q, heads), _split(k, heads), _split(v, heads))))
        h = layer_norm(x, w[p + "norm2.weight"], w[p + "norm2.bias"], eps)
        x = x + s2 * lin("mlp.fc2", gelu(lin("mlp.fc1", h)))
    return layer_norm(x, w["encoder.last_norm.weight"], w["encoder.last_norm.bias"], eps)


def decoder(w: dict, tokens: torch.Tensor, hc: dict, prec: Precision) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, N, context_dim] -> Θ [B, theta_dim], and the final
    LayerNorm's output [B, width] that the decoders read."""
    B = tokens.shape[0]
    eps, heads = hc["ln_eps"], hc["num_heads"]
    query = tokens.new_zeros((B, 1, hc["token_dim"]))
    x = query @ w["head.token_embedding.weight"].T + w["head.token_embedding.bias"] + w["head.pos_embedding"]
    for i in range(hc["depth"]):
        p = f"head.layers.{i}."

        def lin(name, h):
            return linear(prec, h, w[p + name + ".weight"], w.get(p + name + ".bias"))

        h = layer_norm(x, w[p + "norm_sa.weight"], w[p + "norm_sa.bias"], eps)
        q, k, v = lin("to_qkv", h).chunk(3, dim=-1)
        x = x + lin("sa_out", _merge(attend(prec, _split(q, heads), _split(k, heads), _split(v, heads))))
        h = layer_norm(x, w[p + "norm_ca.weight"], w[p + "norm_ca.bias"], eps)
        k, v = lin("to_kv", tokens).chunk(2, dim=-1)
        x = x + lin("ca_out", _merge(attend(prec, _split(lin("to_q", h), heads), _split(k, heads), _split(v, heads))))
        h = layer_norm(x, w[p + "norm_ff.weight"], w[p + "norm_ff.bias"], eps)
        x = x + lin("ff2", gelu(lin("ff1", h)))
    t = layer_norm(x[:, 0], w["head.norm.weight"], w["head.norm.bias"], eps)
    delta = torch.cat([t @ w[f"head.{d}.weight"].T + w[f"head.{d}.bias"] for d in ("decpose", "decshape", "deccam")],
                      dim=1)
    return w["head.mean_theta"] + delta, t


def forward(w: dict, body, images: torch.Tensor, cfg: dict, prec: Precision, drop_path_u=None) -> dict:
    """The outputs of `model.head` from the images, the backbone's `tokens`
    and the head's final LayerNorm output `head_norm`. `cfg`: `vit`, `head`,
    `rotation`, `image_size`, `drop_path_rate` (with `drop_path_u`)."""
    scales = None
    if drop_path_u is not None:
        scales = drop_scales(drop_path_u, cfg["drop_path_rate"], cfg["vit"]["depth"])
    tokens = backbone(w, images, cfg["vit"], prec, scales)
    theta, t = decoder(w, tokens, cfg["head"], prec)
    out = model_lib.head(theta, body, cfg, prec)
    out["tokens"], out["head_norm"] = tokens, t
    return out


def _shares(terms: dict, n: int, batch: int, vis: torch.Tensor, vis_all: torch.Tensor) -> dict:
    """A micro-batch's terms (`train.losses`, means over it) as their shares
    of the whole batch's: the means times n / batch, the keypoint ratio
    Σ err·vis / (Σ vis + ε) times (Σ vis + ε) / (Σ vis over the batch + ε)."""
    out = {k: v * (n / batch) for k, v in terms.items() if k not in ("total", "kp")}
    if "kp" in terms:
        eps = 1e-7
        out["kp"] = terms["kp"] * (vis + eps) / (vis_all + eps)
    return out


def run_steps(weights: dict, inp, cfg: dict, seed: int, steps: int, prec: Precision, first: int = 0,
              adam=None, micro: int = 16) -> dict:
    """`steps` training steps from `weights` (not modified) on the stream of
    `seed`, the first of them step `first`: each step's terms, the first
    step's gradient as AdamW gets it (after the clip), the first step's
    `tokens` and `head_norm` (`forward`; on the host) and the parameters
    after the last. `adam`, when given, is AdamW's (first, second) moments
    after `first` updates, {leaf: tensor}; else both start at 0. The update:
    clip by global norm, then AdamW (β₁ 0.9, β₂ 0.999, ε 1e-8, decay
    lr·wd·p on every parameter before the step), at `learning_rate` times
    `train.lr_factor`."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items() if k not in FIXED}
    fixed = {k: v for k, v in weights.items() if k in FIXED}
    if adam is None:
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    else:
        m, v2 = ({k: d[k].detach().to(p.device, torch.float32, copy=True) if k in d else torch.zeros_like(p)
                  for k, p in params.items()} for d in adam)
    b1, b2, eps = train_lib.ADAM
    lw, size = cfg["loss_weights"], cfg["image_size"]
    terms_per_step, first_grad, seen = [], None, {"tokens": [], "head_norm": []}
    with full_float32():
        for t in range(first, first + steps):
            batch = make_batch(inp, cfg, seed, t, prec)
            B = batch["image"].shape[0]
            vis_all = batch["kp_vis"].sum()
            grads = {k: torch.zeros_like(p) for k, p in params.items()}
            step_terms: dict = {}
            for i in range(0, B, micro):
                mb = {k: v[i : i + micro] for k, v in batch.items()}
                out = forward({**params, **fixed}, inp.body, mb["image"], cfg, prec, mb.get("drop_path_u"))
                if t == first:
                    for k, v in seen.items():
                        v.append(out[k].detach().cpu())
                score = raster_lib.scores(out["verts2d"], inp.parts, size, cfg["sigma"], prec)
                terms = _shares(train_lib.losses(out, score, mb, lw, cfg), mb["image"].shape[0], B,
                                mb["kp_vis"].sum(), vis_all)
                total = sum(lw[k] * v for k, v in terms.items())
                got = torch.autograd.grad(total, list(params.values()), allow_unused=True)
                with torch.no_grad():
                    for (k, _), g in zip(params.items(), got):
                        if g is not None:
                            grads[k] += g
                for k, v in {**terms, "total": total}.items():
                    step_terms[k] = step_terms.get(k, 0.0) + float(v.detach())
                del out, score, terms, total, got
            with torch.no_grad():
                if cfg["grad_clip_norm"]:
                    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
                    if float(norm) >= cfg["grad_clip_norm"]:
                        grads = {k: g * (cfg["grad_clip_norm"] / norm) for k, g in grads.items()}
                if first_grad is None:
                    first_grad = {k: g.clone() for k, g in grads.items()}
                lr = cfg["learning_rate"] * train_lib.lr_factor(t, cfg)
                for k, p in params.items():
                    g = grads[k]
                    p.mul_(1.0 - lr * cfg["weight_decay"])
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[k] / (1 - b1 ** (t + 1))
                    vhat = v2[k] / (1 - b2 ** (t + 1))
                    p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
            del grads
            terms_per_step.append(step_terms)
    return {"terms": terms_per_step, "first_grad": first_grad, "params": {k: p.detach() for k, p in params.items()},
            **{k: torch.cat(v) for k, v in seen.items()}}
