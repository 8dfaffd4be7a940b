"""PyTorch port, raster vertex gradient: the port's autograd Function (on
CPU tensors its plain forward and plain backward, the CUDA kernels' twins)
and the class-sorted gather's inverse-slot backward, against the JAX
reference. The Pallas backward runs in interpret mode at 128², as in
test_kernels.py; gradients are compared after normalising by the largest
reference entry, at 2e-5 as the reference's own kernel test does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.ops import raster as jraster
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build, raster_cuda


def _setup(rng, batch=1, num_verts=200, size=128, num_parts=8):
    verts2d = (rng.rand(batch, num_verts, 2) * size * 1.2 - 0.1 * size).astype(np.float32)
    labels = rng.randint(0, num_parts, size=num_verts)
    jl = jraster.build_part_layout(labels, num_parts, lane=128)
    tl = raster.build_part_layout(labels, num_parts)
    jcfg = jraster.RasterConfig(image_size=size, num_parts=num_parts, sigma=2.0)
    tcfg = raster.RasterConfig(image_size=size, num_parts=num_parts, sigma=2.0)
    return verts2d, (jl, jcfg), (tl, tcfg)


def _port_grad(v, g_out, tl, tcfg, impl="kernel"):
    vt = torch.from_numpy(v).requires_grad_(True)
    out = raster.raster_scores(vt, tl, tcfg, impl=impl)
    (grad,) = torch.autograd.grad(out, vt, grad_outputs=torch.from_numpy(g_out))
    return grad.numpy()


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_raster_gradient_matches_jax(rng, jax_impl):
    v, (jl, jcfg), (tl, tcfg) = _setup(rng)
    g_out = rng.randn(1, tcfg.image_size**2, tcfg.num_parts).astype(np.float32)
    ref = jax.grad(
        lambda x: jnp.sum(jraster.raster_scores(x, jl, jcfg, impl=jax_impl) * g_out)
    )(jnp.asarray(v))
    ref = np.asarray(ref)
    got = _port_grad(v, g_out, tl, tcfg)
    scale = float(np.abs(ref).max()) + 1e-12
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-5)
    assert _build.counts().get(raster_cuda.KERNEL_BWD, 0) == 0  # no launch on CPU


def test_off_canvas_slots_get_zero_gradient(rng):
    v, (jl, jcfg), (tl, tcfg) = _setup(rng, num_verts=100)
    v[0, :50] = 5000.0
    g_out = np.ones((1, tcfg.image_size**2, tcfg.num_parts), np.float32)
    ref = np.asarray(jax.grad(
        lambda x: jnp.sum(jraster.raster_scores(x, jl, jcfg, impl="pallas"))
    )(jnp.asarray(v)))
    got = _port_grad(v, g_out, tl, tcfg)
    assert np.all(np.isfinite(got))
    assert np.all(got[0, :50] == 0.0)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got / scale, ref / scale, atol=2e-5)


@pytest.mark.parametrize("seg_size", [128, 200])
def test_plain_backward_equals_autograd_of_plain_forward(seg_size):
    """raster_scores_bwd_torch against autograd through pairwise_scores, with
    a ragged slot count and some slots off the canvas."""
    rng = np.random.RandomState(3)
    B, C, size = 2, 3, 32
    cfg = raster.RasterConfig(image_size=size, num_parts=C, sigma=2.0)
    vx = (rng.rand(B, C * seg_size, 2) * size * 1.4 - 0.2 * size).astype(np.float32)
    vx[:, ::7] = 1e6  # sentinel slots
    g = torch.from_numpy(rng.randn(B, C, size, size).astype(np.float32))
    x = torch.from_numpy(vx).requires_grad_(True)
    out = raster.pairwise_scores(x, C, seg_size, cfg)  # [B, H*W, C]
    (want,) = torch.autograd.grad(out, x, grad_outputs=g.reshape(B, C, -1).transpose(1, 2))
    got = raster_cuda.raster_scores_bwd_torch(torch.from_numpy(vx), g, C, seg_size, cfg)
    assert got.shape == (B, 2, C * seg_size)
    scale = float(want.abs().max())
    np.testing.assert_allclose(
        got.transpose(1, 2).numpy() / scale, want.numpy() / scale, atol=1e-5
    )
    assert torch.all(got.transpose(1, 2)[:, ::7] == 0)


def test_culled_gradient_matches_jax_pallas(rng):
    """The plain culled backward (the port's kernels' function) against the
    reference's Pallas backward in interpret mode on a random cotangent."""
    v, (jl, jcfg), (tl, tcfg) = _setup(rng)
    C, S, size = tl.num_parts, tl.seg_size, tcfg.image_size
    g = rng.randn(1, C, size, size).astype(np.float32)
    ref = np.asarray(jax.grad(
        lambda x: jnp.sum(jraster.raster_scores_cf(x, jl, jcfg, impl="pallas") * g)
    )(jnp.asarray(v)))
    x = torch.from_numpy(v).requires_grad_(True)
    vx = raster.gather_class_sorted(x, tl)
    dv = raster_cuda.raster_scores_bwd_culled_torch(
        vx.detach(), torch.from_numpy(g), tl.real, C, S, tcfg
    )
    (got,) = torch.autograd.grad(vx, x, grad_outputs=dv.transpose(1, 2))
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got.numpy() / scale, ref / scale, atol=2e-5)


@pytest.mark.parametrize("seg_size", [128, 200])
def test_culled_backward_equals_autograd_of_culled_forward(seg_size):
    """raster_scores_bwd_culled_torch is the gradient of
    raster_scores_culled_torch (same pairs), with a ragged slot count,
    padding slots at the sentinel and a class without real slots; padding
    gets exactly 0 and so do real slots far off the canvas."""
    rng = np.random.RandomState(9)
    B, C, size = 2, 3, 48
    cfg = raster.RasterConfig(image_size=size, num_parts=C, sigma=2.0)
    real = torch.tensor([seg_size, seg_size - 90, 0], dtype=torch.int32)
    vx = (rng.rand(B, C, seg_size, 2) * size * 1.4 - 0.2 * size).astype(np.float32)
    vx[:, 0, :5] = 5000.0  # real slots off canvas
    pad = np.arange(seg_size)[None, :] >= real.numpy()[:, None]
    vx[:, pad] = 1e6
    vx = vx.reshape(B, C * seg_size, 2)
    g = torch.from_numpy(rng.randn(B, C, size, size).astype(np.float32))
    x = torch.from_numpy(vx).requires_grad_(True)
    out = raster_cuda.raster_scores_culled_torch(x, real, C, seg_size, cfg)
    (want,) = torch.autograd.grad(out, x, grad_outputs=g)
    got = raster_cuda.raster_scores_bwd_culled_torch(torch.from_numpy(vx), g, real, C, seg_size, cfg)
    scale = float(want.abs().max())
    assert scale > 0
    np.testing.assert_allclose(got.transpose(1, 2).numpy() / scale, want.numpy() / scale, atol=1e-5)
    zero = pad.reshape(-1).copy()
    zero[:5] = True
    assert torch.all(got[:, :, torch.from_numpy(zero)] == 0)


def test_gather_backward_matches_jax(tiny_asset):
    """The gather's backward is the inverse-slot gather of the reference's
    `_gather_sorted_bwd`; padding slots feed nothing back."""
    rng = np.random.RandomState(4)
    labels = tiny_asset.part_labels()
    jl = jraster.build_part_layout(labels, 24, positions=tiny_asset.v_template)
    tl = raster.build_part_layout(labels, 24, positions=tiny_asset.v_template)
    v = rng.randn(2, tiny_asset.num_verts, 2).astype(np.float32)
    dy = rng.randn(2, 24 * tl.seg_size, 2).astype(np.float32)
    out, vjp = jax.vjp(lambda x: jraster.gather_class_sorted(x, jl), jnp.asarray(v))
    (ref,) = vjp(jnp.asarray(dy))

    x = torch.from_numpy(v).requires_grad_(True)
    y = raster.gather_class_sorted(x, tl)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(out))
    (got,) = torch.autograd.grad(y, x, grad_outputs=torch.from_numpy(dy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    # Only valid slots reach a vertex: changing the padding cotangent changes nothing.
    dy_pad = dy.copy()
    dy_pad[:, tl.valid.numpy() == 0] = 1e3
    (got_pad,) = torch.autograd.grad(
        raster.gather_class_sorted(x, tl), x, grad_outputs=torch.from_numpy(dy_pad)
    )
    np.testing.assert_array_equal(got_pad.numpy(), got.numpy())


def test_raster_scores_cf_and_train_render(rng):
    """The channel-first scores and the score-form render against the
    reference's `raster_scores_cf` / `soft_rasterize_train` (Pallas)."""
    v, (jl, jcfg), (tl, tcfg) = _setup(rng, batch=2, num_verts=300)
    ref_cf = np.asarray(jraster.raster_scores_cf(jnp.asarray(v), jl, jcfg, impl="pallas"))
    got_cf = raster.raster_scores_cf(torch.from_numpy(v), tl, tcfg)
    assert got_cf.shape == (2, tcfg.num_parts, tcfg.image_size, tcfg.image_size)
    np.testing.assert_allclose(got_cf.numpy(), ref_cf, atol=1e-5, rtol=1e-5)
    bf = raster.raster_scores_cf(torch.from_numpy(v), tl, tcfg, out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, got_cf.to(torch.bfloat16))

    ref = jraster.soft_rasterize_train(jnp.asarray(v), jl, jcfg, impl="pallas")
    got = raster.soft_rasterize_train(torch.from_numpy(v), tl, tcfg)
    for k in ("score_cp", "s_total", "silhouette"):
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=1e-5, rtol=1e-5, err_msg=k)


def test_backward_wrapper_checks_layout(rng):
    """The backward kernel's wrapper refuses a strided or misshapen g before
    anything reaches the card; the Function hands it a contiguous one."""
    v, _, (tl, tcfg) = _setup(rng, batch=2)
    vx = raster.gather_class_sorted(torch.from_numpy(v), tl)
    vt = vx.transpose(1, 2).contiguous()
    C, S, size = tl.num_parts, tl.seg_size, tcfg.image_size
    g = torch.randn(2, size, size, C).permute(0, 3, 1, 2)  # [B, C, H, W] view, strided
    with pytest.raises(ValueError, match="contiguous float32"):
        raster_cuda.raster_bwd_cuda(vt, g, tl.real, C, S, tcfg)
    with pytest.raises(ValueError, match="contiguous float32"):
        raster_cuda.raster_bwd_cuda(vt, g.contiguous()[:, :-1], tl.real, C, S, tcfg)
    with pytest.raises(ValueError, match="contiguous int32"):
        raster_cuda.raster_bwd_cuda(vt, g.contiguous(), tl.real.long(), C, S, tcfg)
    # Through the Function, the strided cotangent of the [B, H*W, C] view works.
    x = torch.from_numpy(v).requires_grad_(True)
    out = raster.raster_scores(x, tl, tcfg, impl="kernel")
    (grad,) = torch.autograd.grad(out, x, grad_outputs=g.reshape(2, C, -1).transpose(1, 2))
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
