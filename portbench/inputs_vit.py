"""The weights of the HMR 2.0 configuration, drawn on the card from the seed
in one call and named as the port's `state_dict` (`encoder.*` the ViT,
`head.*` the transformer head):

- linear and patch-convolution weights N(0, 0.02²) (ViTPose's and the
  head's truncated-normal 0.02, untruncated), biases 0;
- LayerNorms scale 1 + 0.1·z and bias 0.1·z, so that every leaf of a
  LayerNorm moves the output;
- the ViT's position embedding N(0, 0.02²), the head's query position term
  N(0, 1) (HMR 2.0's `torch.randn`);
- the pose, shape and camera decoders at std 1e-3 · 0.01, from Θ₀ = the
  neutral pose in 6D, zero betas and camera scale 0.9 (`inputs.py`'s IEF
  output layer and Θ₀), so the bodies stay in frame.

Sizes come from the configuration file (`portbench/configs/hmr2_vith.json`).
"""

from __future__ import annotations

import math

import torch


def weight_shapes(config: dict) -> list:
    """[(name, shape, kind)] of every tensor, kind in 'w' (N(0, 0.02²)),
    'pos' (N(0, 1)), 'dec' (std 1e-5), 'zero', 'ln_w', 'ln_b', 'theta0'."""
    v, h, smpl = config["vit"], config["head"], config["smpl"]
    d, m, ps = v["width"], v["mlp_dim"], v["patch_size"]
    out = [("encoder.patch_embed.proj.weight", (d, 3, ps, ps), "w"), ("encoder.patch_embed.proj.bias", (d,), "zero"),
           ("encoder.pos_embed", (1, v["tokens"] + 1, d), "w")]

    def ln(name, c):
        return [(name + ".weight", (c,), "ln_w"), (name + ".bias", (c,), "ln_b")]

    def lin(name, cin, cout, bias=True, kind="w"):
        return [(name + ".weight", (cout, cin), kind)] + ([(name + ".bias", (cout,), "zero")] if bias else [])

    for i in range(v["depth"]):
        p = f"encoder.blocks.{i}."
        out += ln(p + "norm1", d) + lin(p + "attn.qkv", d, 3 * d, v["qkv_bias"]) + lin(p + "attn.proj", d, d)
        out += ln(p + "norm2", d) + lin(p + "mlp.fc1", d, m) + lin(p + "mlp.fc2", m, d)
    out += ln("encoder.last_norm", d)
    w, inner = h["width"], h["num_heads"] * h["head_dim"]
    out += lin("head.token_embedding", h["token_dim"], w) + [("head.pos_embedding", (1, 1, w), "pos")]
    for i in range(h["depth"]):
        p = f"head.layers.{i}."
        out += ln(p + "norm_sa", w) + lin(p + "to_qkv", w, 3 * inner, False) + lin(p + "sa_out", inner, w)
        out += ln(p + "norm_ca", w) + lin(p + "to_q", w, inner, False)
        out += lin(p + "to_kv", h["context_dim"], 2 * inner, False) + lin(p + "ca_out", inner, w)
        out += ln(p + "norm_ff", w) + lin(p + "ff1", w, h["mlp_dim"]) + lin(p + "ff2", h["mlp_dim"], w)
    out += ln("head.norm", w)
    J = smpl["num_joints"]
    out += lin("head.decpose", w, 6 * J, kind="dec") + lin("head.decshape", w, smpl["num_betas"], kind="dec")
    out += lin("head.deccam", w, 3, kind="dec")
    out.append(("head.mean_theta", (6 * J + smpl["num_betas"] + 3,), "theta0"))
    return out


def make_weights(config: dict, seed: int, device) -> dict:
    """Every tensor of the model from `seed`, drawn on `device` in one call."""
    shapes = weight_shapes(config)
    drawn = [s for _, s, kind in shapes if kind not in ("zero", "theta0")]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(math.prod(s) for s in drawn), generator=gen, device=device)
    w, at = {}, 0
    scale = {"w": 0.02, "pos": 1.0, "dec": 1e-3 * 0.01, "ln_b": 0.1}
    for name, shape, kind in shapes:
        if kind == "zero":
            w[name] = torch.zeros(shape, device=device)
            continue
        if kind == "theta0":
            J = config["smpl"]["num_joints"]
            theta = [1.0, 0, 0, 0, 1, 0] * J + [0.0] * config["smpl"]["num_betas"] + [0.9, 0.0, 0.0]
            w[name] = torch.tensor(theta, device=device)
            continue
        n = math.prod(shape)
        x = z[at : at + n].reshape(shape)
        at += n
        w[name] = 1.0 + 0.1 * x if kind == "ln_w" else x * scale[kind]
    return {k: v.contiguous() for k, v in w.items()}
