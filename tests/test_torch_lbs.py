"""PyTorch port, fused LBS kernel's module: plain version, residual choice
and launch plan, against the JAX reference on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks. The
reference's Pallas kernel runs in interpret mode on the CPU (as in
test_kernels.py); the port's wrapper, `lbs_planar`, runs its plain version
for CPU tensors.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.models import smpl as jsmpl
from indirect_learning_pose_shape_tpu.ops.kernels import lbs_pallas
from indirect_learning_pose_shape_tpu_torch.models import smpl
from indirect_learning_pose_shape_tpu_torch.ops.kernels import lbs_cuda


@pytest.fixture(scope="module")
def consts(tiny_asset):
    return smpl.smpl_consts(tiny_asset), jsmpl.smpl_consts(tiny_asset)


def _inputs(tc, batch, seed=0):
    """betas [B, Kb], pose features [B, Kp], rigid rows [B, J, 12]."""
    rng = np.random.RandomState(seed)
    J = tc.num_joints
    betas = rng.randn(batch, tc.num_betas).astype(np.float32)
    pf = (rng.randn(batch, (J - 1) * 9) * 0.3).astype(np.float32)
    rel = rng.randn(batch, J, 12).astype(np.float32)
    return betas, pf, rel


@pytest.mark.parametrize("residuals", [True, False])
@pytest.mark.parametrize("batch", [1, 3, 5])
def test_plain_version_matches_pallas(consts, batch, residuals):
    tc, jc = consts
    assert tc.num_verts_padded == 896
    betas, pf, rel = _inputs(tc, batch, seed=batch)
    want = lbs_pallas._fwd_planar(jc, jnp.asarray(betas), jnp.asarray(pf), jnp.asarray(rel))
    got = lbs_cuda.lbs_planar(
        tc, torch.from_numpy(betas), torch.from_numpy(pf), torch.from_numpy(rel), residuals
    )
    names = ("verts", "v_posed", "T")
    for name, g, w in zip(names, got, want):
        if not residuals and name != "verts":
            assert g is None, name
            continue
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, err_msg=name)


_MODES = {
    "grad": (contextlib.nullcontext, True, True),
    "grad, no input requires grad": (contextlib.nullcontext, False, False),
    "no_grad": (torch.no_grad, True, False),
    "inference_mode": (torch.inference_mode, True, False),
}


@pytest.mark.parametrize("mode", list(_MODES))
def test_fused_blend_lbs_residual_choice(consts, monkeypatch, mode):
    """verts are the same in every autograd mode; the launch asks for the
    residuals exactly where autograd will run the backward."""
    tc, _ = consts
    ctx, requires_grad, want_residuals = _MODES[mode]
    betas, pf, rel = (torch.from_numpy(x) for x in _inputs(tc, 4, seed=7))
    ref = lbs_cuda.lbs_planar_torch(tc, betas, pf, rel)[0][:, :, : tc.num_verts].transpose(1, 2)

    calls = []
    planar = lbs_cuda.lbs_planar

    def recording(*args, residuals=True):
        calls.append(residuals)
        return planar(*args, residuals=residuals)

    monkeypatch.setattr(lbs_cuda, "lbs_planar", recording)
    leaves = [x.clone().requires_grad_(requires_grad) for x in (betas, pf, rel)]
    with ctx():
        assert lbs_cuda.wants_residuals(*leaves) is want_residuals
        verts = lbs_cuda.fused_blend_lbs(tc, *leaves)
    assert calls == [want_residuals]
    assert verts.requires_grad is want_residuals
    np.testing.assert_array_equal(verts.detach().numpy(), ref.numpy())
    if want_residuals:
        (g,) = torch.autograd.grad(verts.sum(), leaves[0])
        assert bool(torch.isfinite(g).all())


@pytest.mark.parametrize("Vp", [896, 6912])
def test_launch_plan_covers_each_item_and_vertex_once(Vp):
    """The kernel's index map (csrc/lbs.cu: item b0 + ty*ipt + i, vertex
    v0 + 2*tx + d) over the plan's grid hits every (item, vertex) of [B, Vp]
    once, and no block's batch tile is empty, for B = 1..130."""
    tx, d = np.arange(lbs_cuda.VT // 2), np.arange(2)
    for B in range(1, 131):
        ipt, b_tiles, v_tiles = lbs_cuda.launch_plan(B, Vp)
        assert ipt in lbs_cuda.IPTS
        bt = lbs_cuda.ITEM_ROWS * ipt
        assert (b_tiles - 1) * bt < B <= b_tiles * bt
        assert v_tiles * lbs_cuda.VT == Vp
        if ipt > lbs_cuda.IPTS[0]:  # the next narrower tile would not hold B
            assert B > lbs_cuda.ITEM_ROWS * lbs_cuda.IPTS[lbs_cuda.IPTS.index(ipt) - 1]
        items = (
            np.arange(b_tiles)[:, None, None] * bt
            + np.arange(lbs_cuda.ITEM_ROWS)[None, :, None] * ipt
            + np.arange(ipt)[None, None, :]
        ).reshape(-1)
        verts = (np.arange(v_tiles)[:, None, None] * lbs_cuda.VT + 2 * tx[None, :, None] + d).reshape(-1)
        items = items[items < B]
        assert np.array_equal(np.bincount(items, minlength=B), np.ones(B, int)), B
        assert np.array_equal(np.bincount(verts, minlength=Vp), np.ones(Vp, int)), B


def test_launch_plan_fills_rows_before_widening():
    """ipt grows only once the narrower tile cannot hold the batch."""
    got = {B: lbs_cuda.launch_plan(B, 6912) for B in (1, 8, 16, 17, 32, 33, 64, 65, 128, 129)}
    assert got == {
        1: (1, 1, 216), 8: (1, 1, 216), 16: (1, 1, 216), 17: (2, 1, 216), 32: (2, 1, 216),
        33: (4, 1, 216), 64: (4, 1, 216), 65: (8, 1, 216), 128: (8, 1, 216), 129: (8, 2, 216),
    }


@pytest.mark.parametrize("bad", ["dtype", "shape", "strides", "Vp"])
def test_launch_refuses_what_the_kernel_does_not_take(consts, bad):
    """The wrapper's checks run before any build or launch."""
    tc, _ = consts
    betas, pf, rel = (torch.from_numpy(x) for x in _inputs(tc, 2))
    if bad == "dtype":
        betas = betas.double()
    elif bad == "shape":
        rel = rel[:, :-1]
    elif bad == "strides":
        rel = rel.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        if bad == "Vp":
            lbs_cuda.launch_plan(2, 900)
        else:
            lbs_cuda._launch(tc, betas, pf, rel, residuals=False)
