"""PyTorch port, row-sharded rendering on a 2 x 2 mesh of gloo ranks, the
mesh validation, `entry.dryrun_multichip(4)` and `entry.entry()`, on the CPU.

The render checks are the reference's (tests/test_render_sp.py): the
row-sharded render against the local one, and against JAX's
`render_sp.rasterize_spatial` / `spatial_render_loss_grad` on its own 2 x 2
mesh of the conftest's virtual devices, within its bounds (probs and
silhouette 1e-6, loss rtol 1e-6, vertex gradient 1e-5). Both sides run the
separable raster at 'highest' (JAX on the CPU ignores the precision tag; the
port emulates 'high' in bf16 passes, so 'highest' is the common function).
The rank function lives at module level (ranks import this module by name),
so JAX is imported inside the tests only.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu_torch import configs, entry, losses, train
from indirect_learning_pose_shape_tpu_torch.ops import raster, raster_hard
from indirect_learning_pose_shape_tpu_torch.parallel import mesh as mesh_lib
from indirect_learning_pose_shape_tpu_torch.parallel import render_sp

SIZE, NUM_PARTS, NUM_VERTS = 32, 6, 120


def _setup(seed=0, batch=4, size=SIZE):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, NUM_PARTS, size=NUM_VERTS)
    verts2d = (rng.rand(batch, NUM_VERTS, 2) * size).astype(np.float32)
    target = (rng.rand(batch, size, size) > 0.5).astype(np.float32)
    cfg = raster.RasterConfig(image_size=size, num_parts=NUM_PARTS, sigma=2.0, matmul_precision="highest")
    return labels, verts2d, target, cfg


def _render_ranks(device):
    labels, verts2d, target, cfg = _setup()
    layout = raster.build_part_layout(labels, NUM_PARTS)
    mesh = render_sp.render_mesh(2, 2, device)
    v, t = torch.from_numpy(verts2d), torch.from_numpy(target)
    return {
        "rank": (mesh.data_index, mesh.render_index),
        "out": render_sp.rasterize_spatial(v, layout, cfg, mesh),
        "loss_grad": render_sp.spatial_render_loss_grad(v, t, layout, cfg, mesh),
    }


@pytest.fixture(scope="module")
def sp_runs():
    import jax
    import jax.numpy as jnp

    from indirect_learning_pose_shape_tpu.ops import raster as jraster
    from indirect_learning_pose_shape_tpu.parallel import render_sp as jrender_sp

    labels, verts2d, target, cfg = _setup()
    jcfg = jraster.RasterConfig(image_size=SIZE, num_parts=NUM_PARTS, sigma=2.0)
    jlayout = jraster.build_part_layout(labels, NUM_PARTS)
    jmesh = jrender_sp.render_mesh(n_data=2, n_render=2)
    jout = jrender_sp.rasterize_spatial(jnp.asarray(verts2d), jlayout, jcfg, jmesh)
    jloss, jgrad = jrender_sp.spatial_render_loss_grad(
        jnp.asarray(verts2d), jnp.asarray(target), jlayout, jcfg, jmesh
    )
    ref = {"out": jax.tree.map(np.asarray, jout), "loss": float(jloss), "grad": np.asarray(jgrad)}

    layout = raster.build_part_layout(labels, NUM_PARTS)
    v = torch.from_numpy(verts2d).requires_grad_(True)
    local = raster.soft_rasterize(v, layout, cfg, impl="separable")
    loss = losses.silhouette_bce(local["silhouette"], torch.from_numpy(target))
    (grad,) = torch.autograd.grad(loss, v)
    one = {"out": {k: x.detach() for k, x in local.items()}, "loss": float(loss.detach()), "grad": grad}
    ranks = mesh_lib.spawn(_render_ranks, 4, backend="gloo", device="cpu")
    return ref, one, ranks


def _block(x, rank):
    d, r = rank
    h = SIZE // 2
    return np.asarray(x)[2 * d : 2 * d + 2, r * h : (r + 1) * h]


@pytest.mark.parametrize("against", ["local", "jax"])
def test_row_sharded_render_matches(sp_runs, against):
    """Each rank's [B/2, H/2, W] block of probs and silhouette."""
    ref, one, ranks = sp_runs
    want = one["out"] if against == "local" else ref["out"]
    for r in ranks:
        for k in ("probs", "silhouette"):
            got = r["out"][k].numpy()
            assert got.shape[:3] == (2, SIZE // 2, SIZE)
            np.testing.assert_allclose(got, _block(want[k], r["rank"]), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("against", ["local", "jax"])
def test_row_sharded_loss_grad_matches(sp_runs, against):
    """The global BCE loss on every rank (rtol 1e-6) and the vertex gradient
    of the rank's batch rows, summed over its render group (atol 1e-5)."""
    ref, one, ranks = sp_runs
    want = one if against == "local" else ref
    for r in ranks:
        loss, grad = r["loss_grad"]
        np.testing.assert_allclose(float(loss), want["loss"], rtol=1e-6)
        d = r["rank"][0]
        np.testing.assert_allclose(grad.numpy(), np.asarray(want["grad"])[2 * d : 2 * d + 2], atol=1e-5)


def _offline_mesh(n_data, n_render):
    """A Mesh that no process group backs: enough for checks that raise
    before any collective."""
    return mesh_lib.Mesh(
        world=n_data * n_render, rank=0, n_data=n_data, n_render=n_render,
        device=torch.device("cpu"), backend="gloo", world_group=None, data_group=None,
        render_group=None,
    )


def test_indivisible_rows_rejected():
    labels, verts2d, target, cfg = _setup(size=30)  # 30 % 4 != 0
    layout = raster.build_part_layout(labels, NUM_PARTS)
    with pytest.raises(ValueError, match="divisible"):
        render_sp.rasterize_spatial(torch.from_numpy(verts2d), layout, cfg, _offline_mesh(2, 4))
    with pytest.raises(ValueError, match="divisible"):
        render_sp.spatial_render_loss_grad(
            torch.from_numpy(verts2d), torch.from_numpy(target), layout, cfg, _offline_mesh(2, 4)
        )
    # The hard raster shards whole tile rows: 64² has 2 of 32 px, not 3.
    hc = raster_hard.build_hard_consts(np.array([[0, 1, 2]]), np.zeros(3, np.int32))
    with pytest.raises(ValueError, match="divisible"):
        raster_hard.hard_raster(
            torch.zeros(1, 3, 2), torch.zeros(1, 3), hc, 64, rows=render_sp.Rows(0, 3, None)
        )


def test_kernel_route_is_not_row_sharded():
    """The reference's kernel route is never row-sharded: asked to render a
    band, the kernel and plain routes refuse, and so does a configuration
    that pairs them with render_devices > 1; 'auto' is the separable route."""
    labels, verts2d, _, cfg = _setup()
    layout = raster.build_part_layout(labels, NUM_PARTS)
    rows = render_sp.Rows(0, 2, None)
    for impl in ("kernel", "torch"):
        with pytest.raises(ValueError, match="separable"):
            raster.raster_scores_cf(torch.from_numpy(verts2d), layout, cfg, impl=impl, rows=rows)
        model = dataclasses.replace(configs.CONFIG5_DATA_PARALLEL.model, raster_impl=impl)
        with pytest.raises(ValueError, match="never row-sharded"):
            dataclasses.replace(configs.CONFIG5_DATA_PARALLEL, model=model, render_devices=2)
    assert raster.resolve_impl("auto", torch.zeros(1), rows) == "separable"


@pytest.mark.parametrize("kw, match", [
    (dict(render_devices=3, num_devices=8), "8 devices not divisible by render_devices 3"),
    (dict(render_devices=2, num_devices=8, batch_size=6), "not divisible by the data axis"),
    (dict(render_devices=4, num_devices=8, image_size=30), "image_size 30 not divisible by render_devices 4"),
    (dict(num_devices=4, batch_size=6), "batch_size 6 not divisible by num_devices 4"),
    (dict(num_devices=2), "requested 2 devices, have 1"),
    (dict(render_devices=2, num_devices=4), "requested 4 devices, have 1"),
])
def test_mesh_validation(kw, match):
    """`train._auto_mesh` refuses as the reference's does
    (tests/test_render_sp.py::test_sp_mesh_validation), and a mesh needing
    more ranks than were launched (one here) as its `make_mesh` does."""
    kw = dict(kw)
    size = kw.pop("image_size", SIZE)
    cfg = dataclasses.replace(configs.CONFIG5_DATA_PARALLEL, **{"batch_size": 8, **kw})
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, image_size=size, raster=dataclasses.replace(cfg.model.raster, image_size=size)
    ))
    with pytest.raises(ValueError, match=match):
        train._auto_mesh(cfg, "cpu")


def test_one_process_has_no_mesh():
    """Without a process group and with num_devices None or 1 the run is
    one process: no mesh, the one-process code path."""
    for n in (None, 1):
        assert train._auto_mesh(dataclasses.replace(configs.CONFIG5_DATA_PARALLEL, num_devices=n), "cpu") is None


def test_dryrun_multichip(capsys):
    """The reference's dry run on 4 gloo ranks: the fused and split paths
    with mixed supervision, the 2 x 2 render within 1e-5, the SP step's loss
    and the hard-target SP step's within rtol 2e-3 of the 1-D ones."""
    entry.dryrun_multichip(4)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(
        r"dryrun_multichip OK: 4 devices, global batch 8, loss [\d.]+, 2x2 render mesh err \S+, "
        r"SP train-step loss [\d.]+ == 1-D loss [\d.]+ \(asserted, rtol 2e-3\), "
        r"hard-target SP loss [\d.]+ == 1-D [\d.]+ \(asserted\)",
        line,
    ), line


def test_entry_forward_step():
    """`entry()`: the flagship forward step on the full-size asset at 256²."""
    fn, args = entry.entry(device="cpu")
    theta, verts, kp2d = fn(*args)
    assert theta.shape == (4, 85) and verts.shape == (4, 6890, 3) and kp2d.shape[0] == 4
    assert all(bool(torch.isfinite(x).all()) for x in (theta, verts, kp2d))
