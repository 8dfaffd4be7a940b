"""PyTorch port, HMR 2.0 (`hmr2_vith`: `models/vit.py`,
`models/transformer_head.py`) against the plain reference
`portbench/reference/vit.py` on seeded weights, at a small size on the CPU:
a 64² crop read at 64x48 (12 tokens), width 64, 2 blocks of 4 heads, a
2-layer head, the 864-vertex stand-in, batches of 2, float32 products (the
preset's bf16 is held to the reference on the card, by the benchmark's
cell `train.hmr2_vith.soft_b48`).

Θ, the loss terms, every leaf's gradient and one AdamW step of the port's
training step against the reference's (in micro-batches of one image),
without drop path and with it (the reference replays the batch
generator's draws); drop path's per-sample masks and their expectation; the padding-2 patch
grid; the preset's published widths; the Predictor against the network's
forward. On the card (`card` tests, which skip without CUDA) the graphed
step against the eager one, bitwise, and the attention on fused kernels.
This file imports no JAX; run it on the card with

    python -m pytest tests/test_torch_hmr2.py -q -p no:cacheprovider --noconftest
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from indirect_learning_pose_shape_tpu_torch import configs, serve, train
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import transformer_head as th
from indirect_learning_pose_shape_tpu_torch.models import vit as vit_mod
from indirect_learning_pose_shape_tpu_torch.utils import tracing
from portbench import inputs, inputs_vit
from portbench.reference import stream as ref_stream
from portbench.reference import train as ref_train
from portbench.reference import vit as ref_vit
from portbench.reference.precision import Precision

SEED = 2**31 + 11
VIT = dict(crop_cols=(8, 56), width=64, depth=2, num_heads=4, mlp_dim=128)
HEAD = dict(width=64, depth=2, num_heads=4, head_dim=16, mlp_dim=64, context_dim=64)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def small(dtype=torch.float32, drop_path=0.0, batch=2) -> configs.TrainConfig:
    """`hmr2_vith` at the small size."""
    p = configs.HMR2_VITH
    m = p.model
    model = dataclasses.replace(
        m, image_size=64, raster=dataclasses.replace(m.raster, image_size=64),
        encoder=dataclasses.replace(m.encoder, compute_dtype=dtype, drop_path=drop_path, **VIT),
        head=dataclasses.replace(m.head, compute_dtype=dtype, **HEAD))
    return dataclasses.replace(p, model=model, batch_size=batch, seed=SEED)


def file_config() -> dict:
    """The configuration file's form of `small()`, as the reference and the
    weights maker read it."""
    v = {"crop_cols": list(VIT["crop_cols"]), "patch_size": 16, "patch_padding": 2, "width": 64, "depth": 2,
         "num_heads": 4, "head_dim": 16, "mlp_dim": 128, "qkv_bias": True, "ln_eps": 1e-6, "tokens": 12}
    h = {**HEAD, "token_dim": 1, "ln_eps": 1e-5, "iterations": 1}
    return {"vit": v, "head": h, "smpl": {"num_joints": 24, "num_betas": 10}, "asset": {"num_verts": 864, "seed": 1}}


def ref_config(cfg: configs.TrainConfig) -> dict:
    c = file_config()
    return {"vit": c["vit"], "head": c["head"], "drop_path_rate": cfg.model.encoder.drop_path, "rotation": "rot6d", "image_size": 64, "num_parts": 24,
            "sigma": cfg.model.raster.sigma, "bg_gamma": cfg.model.raster.bg_gamma, "batch_size": cfg.batch_size,
            "stream": ref_stream.Stream(), "loss_weights": cfg.loss_weight_dict,
            "learning_rate": cfg.learning_rate, "weight_decay": cfg.weight_decay, "lr_schedule": cfg.lr_schedule,
            "warmup_steps": cfg.warmup_steps, "num_steps": cfg.num_steps, "grad_clip_norm": cfg.grad_clip_norm}


@pytest.fixture(scope="module")
def asset():
    return inputs.stand_in(num_verts=864, seed=1)


def state(cfg, asset, device="cpu"):
    ts, consts = train.init_state(cfg, asset=inputs.port_asset(asset), device=device)
    ts.model.load_state_dict(inputs_vit.make_weights(file_config(), 7, device))
    return ts, consts


def vit_params(cfg: vit_mod.ViTConfig, image_size: int) -> int:
    """The ViT's parameters by hand: the patch convolution and its bias, the
    position terms (a class row), each block's LayerNorms, qkv (with bias),
    output projection and MLP, the last LayerNorm."""
    d, m, ps = cfg.width, cfg.mlp_dim, cfg.patch_size
    block = 4 * d + 3 * d * d + (3 * d if cfg.qkv_bias else 0) + d * d + d + d * m + m + m * d + d
    return 3 * ps * ps * d + d + (cfg.num_tokens(image_size) + 1) * d + cfg.depth * block + 2 * d


def head_params(cfg: th.TransformerHeadConfig, theta_dim: int) -> int:
    """The head's parameters by hand: the query's embedding and position
    term, each layer's three LayerNorms, self-attention (qkv without bias,
    output with), cross-attention (q and kv without bias, output with) and
    feed-forward, the final LayerNorm, the three decoders."""
    d, inner, m = cfg.width, cfg.inner_dim, cfg.mlp_dim
    layer = 6 * d + d * 3 * inner + inner * d + d + d * inner + cfg.context_dim * 2 * inner + inner * d + d
    layer += d * m + m + m * d + d
    return cfg.token_dim * d + d + d + cfg.depth * layer + 2 * d + (d + 1) * theta_dim


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.double() - b.double()) / torch.linalg.vector_norm(b.double()))


@pytest.fixture(scope="module", params=[0.0, 0.5], ids=["no_drop_path", "drop_path"])
def stepped(request, asset):
    """One training step of the port and of the reference (micro-batches of
    one image) from the same weights, without drop path and with it (the
    second block's branches, rate 0.5, dropped for some samples and kept
    for others)."""
    cfg = small(drop_path=request.param)
    ts, consts = state(cfg, asset)
    weights = {k: v.detach().clone() for k, v in ts.model.state_dict().items()}
    batch = train.make_batch(SEED, 0, cfg.batch_size, consts, cfg)
    images = batch["image"]
    if request.param:
        kept = vit_mod.drop_path_scales(cfg.model.encoder, batch["drop_path_u"])[:, 2:] > 0
        assert torch.any(kept) and not torch.all(kept)
    with torch.no_grad():
        theta = net.forward(ts.model, consts, images, cfg.model)["theta"]
    terms = {k: float(v) for k, v in train.fused_step(ts, consts, cfg).items()}
    names = {p: k for k, p in ts.model.named_parameters()}
    grad = {names[p]: s["exp_avg"] / 0.1 for p, s in ts.optimizer.state.items()}
    inp = ref_train.Inputs(asset, 24, "cpu")
    rcfg = ref_config(cfg)
    ref = ref_vit.run_steps(weights, inp, rcfg, SEED, 1, Precision(), micro=1)
    with torch.no_grad():
        ref_theta = ref_vit.forward(weights, inp.body, images, rcfg, Precision())["theta"]
    return {"theta": (theta, ref_theta), "terms": (terms, ref["terms"][0]), "grad": (grad, ref["first_grad"]),
            "params": (dict(ts.model.named_parameters()), ref["params"]), "start": weights}


def test_theta_matches_the_reference(stepped):
    theta, ref = stepped["theta"]
    assert theta.shape == (2, 157)
    spread = (ref - ref.mean(0)).abs().max()
    assert float((theta - ref).abs().max()) < 1e-4 * float(spread) + 1e-7


def test_loss_terms_match_the_reference(stepped):
    terms, ref = stepped["terms"]
    assert set(ref) - {"total"} == {k for k, w in configs.HMR2_VITH.loss_weights if w}
    for k, v in ref.items():
        assert terms[k] == pytest.approx(v, rel=2e-5, abs=1e-9), k


def test_every_leafs_gradient_matches_the_reference(stepped):
    grad, ref = stepped["grad"]
    assert set(grad) == set(ref)
    scale = np.median([float(torch.linalg.vector_norm(g)) for g in ref.values()])
    for k, g in ref.items():
        norm = float(torch.linalg.vector_norm(g))
        if k == "head.token_embedding.weight":  # its input is the zero query
            assert norm == 0.0 and float(grad[k].abs().max()) == 0.0
            continue
        gap = float(torch.linalg.vector_norm(grad[k].double() - g.double()))
        assert gap <= 1e-3 * max(norm, scale), (k, gap, norm)


def test_one_adamw_step_matches_the_reference(stepped):
    params, ref = stepped["params"]
    start = stepped["start"]
    for k, p in ref.items():
        change, want = params[k].detach() - start[k], p - start[k]
        if not torch.any(want):  # the zero query's weight: no gradient, a decay below float32's step
            assert not torch.any(change), k
            continue
        # AdamW's first step is near lr·sign(g) on every element: compare the
        # step as a whole, leaf by leaf.
        assert _rel(change, want) < 1e-3, k


def test_micro_batches_sum_to_the_whole_batch(asset):
    """The reference's micro-batches of one image give the whole batch's
    terms and gradient."""
    cfg = small()
    ts, _ = state(cfg, asset)
    weights = {k: v.detach() for k, v in ts.model.state_dict().items()}
    inp = ref_train.Inputs(asset, 24, "cpu")
    one = ref_vit.run_steps(weights, inp, ref_config(cfg), SEED, 1, Precision(), micro=1)
    whole = ref_vit.run_steps(weights, inp, ref_config(cfg), SEED, 1, Precision(), micro=2)
    for k, v in whole["terms"][0].items():
        assert one["terms"][0][k] == pytest.approx(v, rel=1e-5), k
    for k, g in whole["first_grad"].items():
        assert float(torch.linalg.vector_norm(one["first_grad"][k] - g)) <= 1e-5 * (
            float(torch.linalg.vector_norm(g)) + 1e-12), k


def test_drop_path_masks_are_per_sample_and_unbiased():
    cfg = vit_mod.ViTConfig(depth=4, drop_path=0.6)
    gen = torch.Generator().manual_seed(3)
    s = vit_mod.drop_path_scales(cfg, torch.rand((40000, 8), generator=gen))
    rates = np.repeat(np.linspace(0.0, 0.6, 4), 2)
    assert s.shape == (40000, 8)
    assert torch.all(s[:, :2] == 1.0)  # the first block's rate is 0
    for j in range(2, 8):
        kept = s[:, j] > 0
        assert torch.allclose(s[kept, j], torch.tensor(1.0 / (1.0 - rates[j]), dtype=torch.float32))
        # E[scale] = 1, within 4 standard errors of the Bernoulli mean
        se = np.sqrt(rates[j] / (1.0 - rates[j]) / 40000)
        assert abs(float(s[:, j].mean()) - 1.0) < 4 * se, j
    assert not torch.equal(s[:, 6], s[:, 7])  # a draw a branch


def test_drop_path_scales_each_samples_branches(asset):
    """A training forward with drop path equals, sample by sample, the eval
    forward of the model with the last block's two branches scaled by that
    sample's draws."""
    cfg = small(drop_path=0.5, batch=6)
    ts, consts = state(cfg, asset)
    model = ts.model.encoder
    images = torch.rand(6, 64, 64, 3, generator=torch.Generator().manual_seed(1)) * 2 - 1
    u = torch.rand((6, 4), generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        got = vit_mod.vit_apply(model, images, drop_path_u=u)
        scales = vit_mod.drop_path_scales(model.cfg, u).view(6, 2, 2)
        assert {float(x) for x in scales[:, 1].flatten()} == {0.0, 2.0}
        for b in range(6):
            m = copy.deepcopy(model)
            last = m.blocks[1]
            for layer, s in ((last.attn.proj, scales[b, 1, 0]), (last.mlp.fc2, scales[b, 1, 1])):
                layer.weight.mul_(s)
                layer.bias.mul_(s)
            want = vit_mod.vit_apply(m, images[b : b + 1])
            assert torch.allclose(got[b : b + 1], want, atol=1e-5), b


def test_the_batch_draws_drop_path_after_the_batch(asset):
    """The step's drop-path uniforms come from the batch's generator after
    the batch's draws: the batch is the one drawn without drop path, the
    reference's `make_batch` replays the uniforms, and a ResNet preset's
    batch carries none."""
    cfg = small(drop_path=0.5, batch=3)
    _, consts = state(cfg, asset)
    batch = train.make_batch(SEED, 4, 3, consts, cfg)
    plain = train.make_batch(SEED, 4, 3, consts, small(batch=3))
    assert batch["drop_path_u"].shape == (3, 2 * cfg.model.encoder.depth) and "drop_path_u" not in plain
    for k, v in plain.items():
        assert torch.equal(batch[k], v), k
    ref = ref_vit.make_batch(ref_train.Inputs(asset, 24, "cpu"), ref_config(cfg), SEED, 4, Precision())
    assert torch.equal(ref["drop_path_u"], batch["drop_path_u"])
    resnet = dataclasses.replace(configs.CONFIG4_MIXED, model=dataclasses.replace(
        configs.CONFIG4_MIXED.model, image_size=64, raster=dataclasses.replace(
            configs.CONFIG4_MIXED.model.raster, image_size=64)))
    assert "drop_path_u" not in train.make_batch(SEED, 4, 2, consts, resnet)


def test_the_patch_grid_pads_by_two():
    cfg = vit_mod.ViTConfig()
    assert cfg.grid(256) == (16, 12) and cfg.num_tokens(256) == 192
    small_cfg = dataclasses.replace(cfg, compute_dtype=torch.float32, **VIT)
    assert small_cfg.grid(64) == (4, 3)
    vit = vit_mod.ViT(small_cfg, 64, torch.Generator().manual_seed(0))
    images = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(2)) * 2 - 1
    # By hand: the crop's 64x48 columns padded by 2 zeros on every side
    # (68x52), 16x16 patches from the top-left corner at stride 16; the
    # last 4 rows and columns of the padded image are never read.
    x = F.pad(images[:, :, 8:56].permute(0, 3, 1, 2), (2, 2, 2, 2))
    patches = x.unfold(2, 16, 16).unfold(3, 16, 16)  # [B, 3, 4, 3, 16, 16]
    assert patches.shape[2:4] == (4, 3)
    flat = patches.permute(0, 2, 3, 1, 4, 5).reshape(2, 12, 3 * 256)
    w = vit.patch_embed.proj.weight.reshape(64, -1)
    want = flat @ w.T + vit.patch_embed.proj.bias + vit.pos_embed[:, 1:] + vit.pos_embed[:, :1]
    with torch.no_grad():
        got = vit_mod.embed(vit, images)
    assert torch.allclose(got, want, atol=1e-5)


def test_the_preset_has_hmr2s_published_widths():
    p = configs.PRESETS["hmr2_vith"]
    v, h, m = p.model.encoder, p.model.head, p.model
    assert (m.image_size, v.crop_cols, v.patch_size, v.patch_padding) == (256, (32, 224), 16, 2)
    assert v.grid(256) == (16, 12) and v.num_tokens(256) == 192
    assert (v.width, v.depth, v.num_heads, v.head_dim, v.mlp_dim) == (1280, 32, 16, 80, 5120)
    assert (v.qkv_bias, v.ln_eps, v.drop_path, v.compute_dtype) == (True, 1e-6, 0.55, torch.bfloat16)
    assert (h.width, h.depth, h.num_heads, h.head_dim, h.inner_dim) == (1024, 6, 8, 64, 512)
    assert (h.mlp_dim, h.context_dim, h.token_dim, h.ln_eps) == (1024, 1280, 1, 1e-5)
    assert (m.ief.rotation_format, m.ief.num_iterations, m.ief.theta_dim) == ("rot6d", 1, 157)
    assert (m.raster.num_parts, m.raster.sigma) == (24, 2.0)
    assert (p.learning_rate, p.weight_decay, p.batch_size, p.lr_schedule) == (1e-5, 1e-4, 48, "constant")
    assert p.loss_weights == configs.CONFIG4_MIXED.loss_weights and p.grad_clip_norm == 1.0
    assert vit_params(v, 256) == 630_912_000  # HMR 2.0's "about 631 M"
    assert head_params(h, m.ief.theta_dim) == 39_549_085


def test_the_network_holds_a_vit_and_the_head(asset):
    cfg = small()
    model, _ = net.init(inputs.port_asset(asset), cfg.model, device="cpu")
    assert isinstance(model.encoder, vit_mod.ViT) and model.regressor is model.head
    assert not hasattr(model, "ief")
    assert [k for k, _ in model.named_buffers()] == ["head.mean_theta"]
    n = sum(p.numel() for p in model.parameters())
    assert n == vit_params(cfg.model.encoder, 64) + head_params(cfg.model.head, cfg.model.ief.theta_dim)
    with pytest.raises(ValueError, match="transformer head"):
        dataclasses.replace(cfg.model, head=None)


def test_the_predictor_serves_the_network(asset):
    cfg = small(dtype=torch.bfloat16)
    ts, consts = state(cfg, asset)
    images = torch.rand(4, 64, 64, 3, generator=torch.Generator().manual_seed(4)) * 2 - 1
    pred = serve.Predictor(cfg.model, ts.model, consts, buckets=(1, 2, 4))
    with torch.inference_mode():
        want = net.forward(ts.model, consts, images, cfg.model)
    got = pred(images)
    for k in ("theta", "verts", "kp2d"):
        assert torch.equal(got[k], want[k]), k
    three = pred(images[:3])  # padded to bucket 4
    spread = float((want["theta"] - want["theta"].mean(0)).abs().max())
    assert float((three["theta"] - want["theta"][:3]).abs().max()) <= 1e-3 * spread


def test_the_attention_counts_its_backend(asset):
    cfg = small()
    ts, consts = state(cfg, asset)
    before = tracing.counters("attn.calls.")
    with torch.no_grad():
        net.forward(ts.model, consts, torch.zeros(2, 64, 64, 3), cfg.model)
    after = tracing.counters("attn.calls.")
    calls = sum(after.values()) - sum(before.values())
    assert calls == 2 + 2 * 2  # a call a block, two a head layer


@pytest.mark.card
def test_the_graphed_step_is_the_eager_step_on_fused_attention(card, asset):
    """Three steps through `compile_fused_step`'s graph against three eager
    `fused_step`s from the same state, bitwise, in the preset's bf16 with
    drop path on (its draws from the batch's registered generator); every
    attention on a fused backend, and the math backend refused."""
    cfg = small(dtype=torch.bfloat16, drop_path=0.4, batch=4)
    ts, consts = state(cfg, asset, card)
    ts2 = copy.deepcopy(ts)
    before = tracing.counters("attn.calls.")
    step_fn = train.compile_fused_step(cfg, consts)
    for _ in range(3):
        graphed = step_fn(ts)
        eager = train.fused_step(ts2, consts, cfg)
    assert step_fn.captures == 1
    for k in eager:
        assert torch.equal(graphed[k], eager[k]), k
    for (k, p), q in zip(ts.model.named_parameters(), ts2.model.parameters()):
        assert torch.equal(p, q), k
    calls = {k: n - before.get(k, 0) for k, n in tracing.counters("attn.calls.").items()}
    assert sum(calls.values()) > 0
    assert set(k for k, n in calls.items() if n) <= {"flash_attention", "efficient_attention", "cudnn_attention"}
    q = torch.randn(2, 16, 192, 80, device=card, dtype=torch.bfloat16)
    with sdpa_kernel([SDPBackend.MATH]), pytest.raises(RuntimeError, match="MATH"):
        vit_mod.attention(q, q, q)
