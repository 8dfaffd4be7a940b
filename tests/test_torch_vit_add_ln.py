"""PyTorch port: the ViT blocks' fused residual add, drop-path scale,
LayerNorm and cast (`ops/kernels/vit_add_ln_cuda.py`, kernels
`csrc/vit_add_ln.cu`), in three variants: drop path on (a scale a sample,
some 0), drop path off, and no branch (block 0's norm1: LayerNorm and cast
only).

On the CPU: the twin's forward and its gradients of x, y, γ and β against
autograd of the eager chain it replaces (`x + y.float() * s`, then
`vit.layer_norm_to`); CPU tensors, whatever their layout or width, routed
to the twin and counted as eager rows; a forward of the small ViT makes
2·depth calls over 2·depth·B·N rows, one without a branch. On the card
(`card` tests, which skip without CUDA) the kernels against the twin at
ViT-H's [48, 192, 1280] and at width 64: x' bitwise, h within one bf16 ulp
on every element, dx within 1e-5 and dγ, dβ within 1e-4 (relative norms),
dy the bf16 rounding of the kernel's own g·s and within one bf16 ulp of
the twin's, two backward calls bitwise equal, the op through autograd
bitwise the kernels; what the kernels do not take raises, from the launch
function and from the op (CUDA tensors never run the twin). This file
imports no JAX; run it on the card with

    python -m pytest tests/test_torch_vit_add_ln.py -q -p no:cacheprovider --noconftest
"""

import dataclasses

import pytest
import torch
from torch import nn

from indirect_learning_pose_shape_tpu_torch.models import vit as vit_mod
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build
from indirect_learning_pose_shape_tpu_torch.ops.kernels import vit_add_ln_cuda as op
from indirect_learning_pose_shape_tpu_torch.utils import tracing

VARIANTS = ["drop_path", "no_drop_path", "no_y"]
BF16 = torch.bfloat16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def make(shape, variant, dtype=BF16, device="cpu", seed=0):
    """x float32, the branch y in `dtype` (None for 'no_y'), the scales s [B]
    (a strided column of a [B, 4] table, as the model's are; 0 for every
    third sample; None without drop path), a LayerNorm away from identity,
    and the cotangents dh (`dtype`) and dres (float32)."""
    gen = torch.Generator().manual_seed(seed)
    B, N, D = shape
    x = torch.randn(shape, generator=gen)
    y = None if variant == "no_y" else (torch.randn(shape, generator=gen) * 0.5).to(dtype)
    s = None
    if variant == "drop_path":
        keep = (torch.arange(B) % 3 != 1).float()
        s = torch.stack([keep / 0.6, keep / 0.7, keep / 0.8, keep], dim=1)[:, 1]
    norm = nn.LayerNorm(D, eps=1e-6)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(D, generator=gen))
        norm.bias.copy_(0.1 * torch.randn(D, generator=gen))
    dh = torch.randn(shape, generator=gen).to(dtype)
    dres = torch.randn(shape, generator=gen)
    to = lambda t: None if t is None else t.to(device)  # noqa: E731
    return to(x), to(y), to(s), norm.to(device), to(dh), to(dres)


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.double() - b.double()) / torch.linalg.vector_norm(b.double()))


def within_ulp(a: torch.Tensor, b: torch.Tensor, floor: float = 2.0**-10) -> bool:
    """Every element of the bf16 tensors a and b within one bf16 ulp of the
    larger magnitude (8 significant bits: 2^(e − 8) for |v| in [2^(e−1),
    2^e)), that magnitude taken as at least `floor`: two float32 LayerNorms
    that sum in different orders differ by ~1e-7 absolute, which is more than
    an ulp of the values that cancel to near zero."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(torch.maximum(torch.maximum(a.abs(), b.abs()), torch.tensor(floor, device=a.device)))
    return bool(((a - b).abs() <= torch.ldexp(torch.ones_like(a), e - 8)).all())


def eager_chain(x, y, s, norm, dtype):
    """What `models/vit._block` ran before the op: the add, then
    `layer_norm_to`."""
    if y is not None:
        y = y.float()
        x = x + (y if s is None else y * s[:, None, None])
    return x, vit_mod.layer_norm_to(x, norm, dtype)


def grads(fn, x, y, s, norm, dtype, dh, dres):
    """(x', h, and the gradients of x, y, γ, β) of fn(x, y, s, norm, dtype)
    for the cotangents dh of h and dres of x' (none without y)."""
    x = x.detach().requires_grad_()
    y = None if y is None else y.detach().requires_grad_()
    norm.zero_grad(set_to_none=True)
    xo, h = fn(x, y, s, norm, dtype)
    outs, cots = ([h], [dh]) if y is None else ([xo, h], [dres, dh])
    inputs = [x, norm.weight, norm.bias] + ([] if y is None else [y])
    g = torch.autograd.grad(outs, inputs, cots)
    return xo.detach(), h.detach(), dict(zip(["x", "gamma", "beta", "y"], g))


@pytest.mark.parametrize("dtype", [BF16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_the_twin_is_the_eager_chain(variant, dtype):
    x, y, s, norm, dh, dres = make((3, 5, 64), variant, dtype)
    xo, h, g = grads(op.add_layer_norm, x, y, s, norm, dtype, dh, dres)
    exo, eh, eg = grads(eager_chain, x, y, s, norm, dtype, dh, dres)
    assert torch.equal(xo, exo)
    if dtype == BF16:
        assert within_ulp(h, eh)
    else:
        assert rel(h, eh) < 1e-6
    assert set(g) == set(eg) == ({"x", "gamma", "beta"} | (set() if y is None else {"y"}))
    for k in ("x", "gamma", "beta"):
        assert rel(g[k], eg[k]) < 1e-5, k
    if y is not None:
        assert g["y"].dtype == dtype
        if dtype == BF16:
            assert within_ulp(g["y"], eg["y"])
        else:
            assert rel(g["y"], eg["y"]) < 1e-5


WIDTHS = {"width12": 12, "wide": op.MAX_WIDTH + 8}


def _case(name, device="cpu"):
    """A call the kernels refuse: CPU tensors, x's rows strided, a width of
    12 or one past `MAX_WIDTH`, float32 h, a LayerNorm without bias, or γ at
    an offset that is not 16-byte aligned (on `device` but for 'cpu').
    Returns x, y, s, the LayerNorm and h's dtype."""
    x, y, s, norm, _, _ = make((2, 3, WIDTHS.get(name, 64)), "drop_path", device="cpu" if name == "cpu" else device)
    if name == "strided":
        x = torch.randn(2, 3, 128, device=x.device)[..., ::2]
    if name == "no_bias":
        norm = nn.LayerNorm(64, eps=1e-6, bias=False).to(x.device)
    if name == "gamma_offset":
        norm.weight = nn.Parameter(torch.ones(65, device=x.device)[1:])
    return x, y, s, norm, torch.float32 if name == "f32" else BF16


@pytest.mark.parametrize("name, why", [("cpu", "CUDA"), ("strided", "contiguous"), ("width12", "multiple of 8")])
def test_what_the_kernels_refuse_runs_the_twin(name, why):
    """CPU tensors run the twin whatever their layout and width (routing is
    by device alone; `refusal` names the first thing the kernels would not
    take)."""
    x, y, s, norm, dtype = _case(name)
    assert why in op.refusal(x, y, s, norm.weight, norm.bias, dtype)
    before = tracing.counters(op.COUNTER)
    launches = _build.counts()
    xo, h = op.add_layer_norm(x, y, s, norm, BF16)
    after = tracing.counters(op.COUNTER)
    rows = x.shape[0] * x.shape[1]
    assert after.get("eager", 0) - before.get("eager", 0) == rows
    assert after.get("kernel", 0) == before.get("kernel", 0)
    assert _build.counts() == launches
    exo, eh = op.add_ln_torch(x, y, s, norm.weight, norm.bias, norm.eps, BF16)[:2]
    assert torch.equal(xo, exo) and torch.equal(h, eh)


def test_a_vit_forward_makes_two_calls_a_block(monkeypatch):
    cfg = dataclasses.replace(vit_mod.ViTConfig(), crop_cols=(8, 56), width=64, depth=2, num_heads=4, mlp_dim=128)
    vit = vit_mod.ViT(cfg, 64, torch.Generator().manual_seed(3))
    calls = []

    def record(x, y, s, norm, dtype):
        calls.append((y is None, x.shape[0] * x.shape[1]))
        return op.add_layer_norm(x, y, s, norm, dtype)

    monkeypatch.setattr(vit_mod, "add_layer_norm", record)
    before = tracing.counters(op.COUNTER)
    B, N = 2, cfg.num_tokens(64)
    with torch.no_grad():
        tokens = vit_mod.vit_apply(vit, torch.zeros(B, 64, 64, 3), torch.rand(B, 2 * cfg.depth))
    assert tokens.shape == (B, N, cfg.width)
    assert len(calls) == 2 * cfg.depth
    assert [no_y for no_y, _ in calls] == [True] + [False] * (2 * cfg.depth - 1)
    assert sum(r for _, r in calls) == 2 * cfg.depth * B * N
    after = tracing.counters(op.COUNTER)
    assert after["eager"] - before.get("eager", 0) == 2 * cfg.depth * B * N


@pytest.mark.card
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("shape", [(48, 192, 1280), (2, 12, 64)], ids=["vit_h", "width64"])
def test_the_kernels_match_the_twin(card, shape, variant):
    x, y, s, norm, dh, dres = make(shape, variant, device=card)
    w, b, eps = norm.weight.detach(), norm.bias.detach(), norm.eps
    assert op.refusal(x, y, s, w, b, BF16) is None
    kxo, kh, kmean, krstd = op.add_ln_cuda(x, y, s, w, b, eps, BF16)
    txo, th, tmean, trstd = op.add_ln_torch(x, y, s, w, b, eps, BF16)
    assert torch.equal(kxo, txo)
    assert within_ulp(kh, th)
    assert rel(kmean, tmean) < 1e-5 and rel(krstd, trstd) < 1e-5
    dres = None if y is None else dres
    ydt = None if y is None else BF16
    kdx, kdy, kdg, kdb = op.add_ln_bwd_cuda(dh, dres, kxo, kmean, krstd, w, s, ydt)
    tdx, tdy, tdg, tdb = op.add_ln_bwd_torch(dh, dres, txo, tmean, trstd, w, s, ydt)
    assert rel(kdx, tdx) < 1e-5
    assert rel(kdg, tdg) < 1e-4 and rel(kdb, tdb) < 1e-4
    if y is None:
        assert kdy is None
    else:
        assert torch.equal(kdy, (kdx if s is None else kdx * s[:, None, None]).to(BF16))
        assert within_ulp(kdy, tdy)
    again = op.add_ln_bwd_cuda(dh, dres, kxo, kmean, krstd, w, s, ydt)
    for first, second in zip((kdx, kdy, kdg, kdb), again):
        assert (first is None and second is None) or torch.equal(first, second)
    # The op through autograd is these launches, and counts kernel rows.
    before = tracing.counters(op.COUNTER)
    xo, h, g = grads(op.add_layer_norm, x, y, s, norm, BF16, dh, dres)
    after = tracing.counters(op.COUNTER)
    assert after["kernel"] - before.get("kernel", 0) == shape[0] * shape[1]
    assert torch.equal(xo, kxo) and torch.equal(h, kh)
    assert torch.equal(g["x"], kdx) and torch.equal(g["gamma"], kdg) and torch.equal(g["beta"], kdb)
    if y is not None:
        assert torch.equal(g["y"], kdy)


@pytest.mark.card
@pytest.mark.parametrize("name, why", [
    ("cpu", "CUDA"), ("strided", "contiguous"), ("width12", "multiple of 8"), ("wide", "multiple of 8"),
    ("f32", "bfloat16"), ("no_bias", "weight and bias"), ("gamma_offset", "16-byte aligned")])
def test_the_kernel_wrapper_raises_on_what_it_refuses(card, name, why):
    """The launch function raises on what the kernels do not take, and so
    does the op on CUDA tensors: nothing falls back to the twin there."""
    x, y, s, norm, dtype = _case(name, card)
    with pytest.raises(ValueError, match=why):
        op.add_ln_cuda(x, y, s, norm.weight, norm.bias, norm.eps, dtype)
    if x.is_cuda:
        before = tracing.counters(op.COUNTER)
        with pytest.raises(ValueError, match=why):
            op.add_layer_norm(x, y, s, norm, dtype)
        assert tracing.counters(op.COUNTER) == before
    x, y, s, norm, dh, dres = make((2, 3, 64), "drop_path", device=card)
    xo, _, mean, rstd = op.add_ln_cuda(x, y, s, norm.weight, norm.bias, norm.eps, BF16)
    with pytest.raises(ValueError, match="dh must be"):
        op.add_ln_bwd_cuda(dh.float(), dres, xo, mean, rstd, norm.weight, s, BF16)


@pytest.mark.card
def test_a_vit_forward_takes_the_kernels_under_inference_mode(card, monkeypatch):
    """The serving route: the small ViT in bf16 under `inference_mode` runs
    its 2·depth sites on the kernels, and its tokens match the same forward
    with every site on the twin."""
    cfg = dataclasses.replace(vit_mod.ViTConfig(), crop_cols=(8, 56), width=64, depth=2, num_heads=4, mlp_dim=128)
    vit = vit_mod.ViT(cfg, 64, torch.Generator().manual_seed(3)).to(card)
    with torch.no_grad():
        for blk in vit.blocks:  # LayerNorms away from identity
            for n in (blk.norm1, blk.norm2):
                n.weight.normal_(1.0, 0.1)
                n.bias.normal_(0.0, 0.1)
    images = torch.rand(3, 64, 64, 3, generator=torch.Generator().manual_seed(5)).to(card) * 2 - 1
    before = tracing.counters(op.COUNTER)
    with torch.inference_mode():
        tokens = vit_mod.vit_apply(vit, images)
    after = tracing.counters(op.COUNTER)
    assert after["kernel"] - before.get("kernel", 0) == 2 * cfg.depth * 3 * cfg.num_tokens(64)
    monkeypatch.setattr(op, "add_ln_cuda", op.add_ln_torch)  # the twin, on the card, for comparison
    with torch.inference_mode():
        twin = vit_mod.vit_apply(vit, images)
    assert rel(tokens, twin) < 1e-2
