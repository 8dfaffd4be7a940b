"""PyTorch port, camera + soft raster: the port against the JAX reference on
CPU. The Pallas raster kernel runs in interpret mode (test_kernels.py's
setup: 128², 8 parts); the port's kernel wrapper runs its plain pairwise
version for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.ops import camera as jcamera
from indirect_learning_pose_shape_tpu.ops import raster as jraster
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build, raster_cuda


def _setup(rng, batch=2, num_verts=500, size=128, num_parts=8):
    verts2d = (rng.rand(batch, num_verts, 2) * size * 1.2 - 0.1 * size).astype(np.float32)
    labels = rng.randint(0, num_parts, size=num_verts)
    jl = jraster.build_part_layout(labels, num_parts, lane=128)
    tl = raster.build_part_layout(labels, num_parts)
    jcfg = jraster.RasterConfig(image_size=size, num_parts=num_parts, sigma=2.0)
    tcfg = raster.RasterConfig(image_size=size, num_parts=num_parts, sigma=2.0)
    return verts2d, (jl, jcfg), (tl, tcfg)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_pairwise_twin_matches_jax(rng, jax_impl):
    v, (jl, jcfg), (tl, tcfg) = _setup(rng)
    ref = jraster.raster_scores(jnp.asarray(v), jl, jcfg, impl=jax_impl)
    out = raster.raster_scores(torch.from_numpy(v), tl, tcfg, impl="torch")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_kernel_wrapper_on_cpu_matches_twin(rng):
    v, _, (tl, tcfg) = _setup(rng, batch=1, size=64)
    v = torch.from_numpy(v)
    a = raster.raster_scores(v, tl, tcfg, impl="kernel")
    b = raster.raster_scores(v, tl, tcfg, impl="torch")
    assert torch.equal(a, b)
    assert _build.counts().get(raster_cuda.KERNEL, 0) == 0  # no launch on CPU


def test_off_canvas_vertices_give_zero(rng):
    v, (jl, jcfg), (tl, tcfg) = _setup(rng, batch=1, num_verts=100)
    v[0, :50] = 5000.0
    ref = jraster.raster_scores(jnp.asarray(v), jl, jcfg, impl="pallas")
    out = raster.raster_scores(torch.from_numpy(v), tl, tcfg, impl="torch")
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    v[0, :] = 5000.0
    assert not raster.raster_scores(torch.from_numpy(v), tl, tcfg).any()


@pytest.mark.parametrize("with_positions", [False, True])
def test_build_part_layout_matches_jax(tiny_asset, with_positions):
    labels = tiny_asset.part_labels()
    pos = tiny_asset.v_template if with_positions else None
    j = jraster.build_part_layout(labels, 24, positions=pos)
    t = raster.build_part_layout(labels, 24, positions=pos)
    assert t.seg_size == j.seg_size and t.num_parts == j.num_parts
    for f in ("perm", "valid", "inv"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    # Real slots come first in each class, `real` of them.
    valid = t.valid.reshape(24, t.seg_size).numpy()
    real = t.real.numpy()
    assert t.real.dtype == torch.int32
    np.testing.assert_array_equal(valid, np.arange(t.seg_size)[None, :] < real[:, None])


def test_soft_rasterize_matches_jax(rng):
    v, (jl, jcfg), (tl, tcfg) = _setup(rng)
    ref = jraster.soft_rasterize(jnp.asarray(v), jl, jcfg, impl="xla")
    out = raster.soft_rasterize(torch.from_numpy(v), tl, tcfg, impl="kernel")
    for k in ("probs", "silhouette"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5, err_msg=k)


def test_kernel_wrapper_refuses_gradients(rng):
    """The kernel wrapper is differentiable now (the raster backward kernel's
    autograd Function): float32 slots get the plain twin's gradient, and it
    refuses the inputs the kernels do not take, with or without a gradient."""
    v, _, (tl, tcfg) = _setup(rng, batch=1, size=32)
    vt = torch.from_numpy(v).requires_grad_(True)
    out = raster.raster_scores(vt, tl, tcfg, impl="kernel")
    (got,) = torch.autograd.grad(out.sum(), vt)
    vt2 = torch.from_numpy(v).requires_grad_(True)
    (want,) = torch.autograd.grad(raster.raster_scores(vt2, tl, tcfg, impl="torch").sum(), vt2)
    assert torch.equal(got, want) and got.abs().max() > 0
    vx64 = raster.gather_class_sorted(vt.double(), tl)
    with pytest.raises(ValueError, match="expected float32"):
        raster_cuda.raster_scores4(vx64, tl.real, tl.num_parts, tl.seg_size, tcfg)
    with torch.no_grad(), pytest.raises(ValueError, match="expected float32"):
        raster_cuda.raster_scores4(vx64, tl.real, tl.num_parts, tl.seg_size, tcfg)


@pytest.mark.parametrize("seg_size", [128, 200])
def test_block_bboxes(seg_size):
    """Per-(class, 128-slot block) boxes over real slots: a full class, a
    class whose real slots end inside a block (sentinel padding after them),
    and an all-padding class; with S=200 a partial last block too. A block
    without a real slot gets an empty box that fails every tile test."""
    rng = np.random.RandomState(5)
    C, B = 3, 2
    real = np.array([seg_size, seg_size - 100, 0], np.int32)
    v = (rng.rand(B, 2, C, seg_size) * 64).astype(np.float32)
    v[..., np.arange(seg_size)[None, :] >= real[:, None]] = 1e6  # sentinel padding
    v = v.reshape(B, 2, C * seg_size)
    box = raster_cuda.block_bboxes(torch.from_numpy(v), torch.from_numpy(real), C, seg_size).numpy()
    nb = -(-seg_size // raster_cuda.KV)
    assert box.shape == (B, C * nb, 4)
    xh, yh = raster_cuda.tile_hits(torch.from_numpy(box), 64, 64, 12.0)
    empty = 0
    for c in range(C):
        for j in range(nb):
            lo, hi = c * seg_size + j * 128, c * seg_size + min(real[c], (j + 1) * 128)
            if hi <= lo:
                empty += 1
                np.testing.assert_array_equal(box[:, c * nb + j], [[np.inf, -np.inf, np.inf, -np.inf]] * B)
                assert not (xh[:, c * nb + j].any() or yh[:, c * nb + j].any())
                continue
            s = v[:, :, lo:hi]
            want = np.stack([s[:, 0].min(1), s[:, 0].max(1), s[:, 1].min(1), s[:, 1].max(1)], 1)
            np.testing.assert_array_equal(box[:, c * nb + j], want)
            assert xh[:, c * nb + j].any() and yh[:, c * nb + j].any()
    assert empty == (nb if seg_size == 128 else 2 * nb - 1)


def test_culled_version_matches_jax_pallas(rng):
    """The plain culled forward (the port's kernels' function: 32x8 tiles,
    boxes over real slots) against the reference's Pallas kernel in
    interpret mode (16x128 tiles, boxes with the padding): they differ only
    by Gaussian tails below exp(-18)."""
    v, (jl, jcfg), (tl, tcfg) = _setup(rng)
    ref = np.asarray(jraster.raster_scores_cf(jnp.asarray(v), jl, jcfg, impl="pallas"))
    vx = raster.gather_class_sorted(torch.from_numpy(v), tl)
    got = raster_cuda.raster_scores_culled_torch(vx, tl.real, tl.num_parts, tl.seg_size, tcfg)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_real_slot_boxes_cull_where_padding_boxes_reach():
    """A class with 10 real slots near x=17 and 118 padding slots at the
    sentinel: the reference's box (padding included) reaches the tile at
    x=32, the box over real slots does not (x=19.5 < 32 - 12). There the
    culled version reads exactly 0, the exact twin a Gaussian tail."""
    rng = np.random.RandomState(8)
    size, C = 64, 2
    labels = np.r_[np.zeros(10, int), np.ones(40, int)]
    tl = raster.build_part_layout(labels, C)
    cfg = raster.RasterConfig(image_size=size, num_parts=C, sigma=2.0)
    v = np.c_[rng.uniform(15.0, 19.5, 50), rng.uniform(5.0, 10.0, 50)].astype(np.float32)
    v[:10, 0] = np.linspace(15.0, 19.5, 10)
    vx = raster.gather_class_sorted(torch.from_numpy(v)[None], tl)
    S = tl.seg_size
    vt = vx.transpose(1, 2).contiguous()
    padded_box = raster_cuda.block_bboxes(vt, torch.full((C,), S, dtype=torch.int32), C, S)
    real_box = raster_cuda.block_bboxes(vt, tl.real, C, S)
    assert raster_cuda.tile_hits(padded_box, size, size, 12.0)[0][0, 0, 1]
    assert not raster_cuda.tile_hits(real_box, size, size, 12.0)[0][0, 0, 1]

    culled = raster_cuda.raster_scores_culled_torch(vx, tl.real, C, S, cfg)[0, 0]
    exact = raster_cuda.raster_scores4(vx, tl.real, C, S, cfg, impl="torch")[0, 0]
    assert torch.all(culled[:, 32:] == 0)
    assert 0 < float(exact[:, 32:].max()) < 1e-6
    np.testing.assert_allclose(culled[:, :32].numpy(), exact[:, :32].numpy(), atol=1e-6)


def test_camera_matches_jax():
    rng = np.random.RandomState(6)
    x3d = rng.randn(2, 7, 3).astype(np.float32)
    cam = rng.randn(2, 3).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        camera.project_pixel(t(x3d), t(cam), 128).numpy(),
        np.asarray(jcamera.project_pixel(jnp.asarray(x3d), jnp.asarray(cam), 128)),
        atol=1e-5,
    )
    cam_t = np.array([[0.1, -0.2, 3.0], [0.0, 0.1, 2.5]], np.float32)
    np.testing.assert_allclose(
        camera.perspective_project_pixel(t(x3d), t(cam_t), 500.0, 128).numpy(),
        np.asarray(jax.jit(jcamera.perspective_project_pixel, static_argnums=(2, 3))(
            jnp.asarray(x3d), jnp.asarray(cam_t), 500.0, 128)),
        rtol=1e-5, atol=1e-3,
    )
