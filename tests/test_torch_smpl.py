"""PyTorch port, SMPL + fused LBS: the port against the JAX reference on CPU.

Inputs are made with numpy from a seed and handed to both frameworks. The
Pallas LBS kernel runs in interpret mode on the CPU (as in test_kernels.py);
the port's kernel wrapper runs its plain version for CPU tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.models import smpl as jsmpl
from indirect_learning_pose_shape_tpu.utils import assets as jassets
from indirect_learning_pose_shape_tpu.utils import oracle
from indirect_learning_pose_shape_tpu_torch.models import smpl
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build, lbs_cuda
from indirect_learning_pose_shape_tpu_torch.utils import assets


@pytest.fixture(scope="module")
def consts(tiny_asset):
    return smpl.smpl_consts(tiny_asset), jsmpl.smpl_consts(tiny_asset)


def _inputs(asset, batch=3, scale=0.4, seed=0):
    rng = np.random.RandomState(seed)
    pose = (rng.randn(batch, asset.num_joints * 3) * scale).astype(np.float32)
    betas = rng.randn(batch, asset.num_betas).astype(np.float32)
    return pose, betas


@pytest.mark.parametrize("jax_impl", ["xla", "pallas"])
def test_smpl_forward_matches_jax(tiny_asset, consts, jax_impl):
    tc, jc = consts
    pose, betas = _inputs(tiny_asset)
    ref = jsmpl.smpl_forward(jc, jnp.asarray(pose), jnp.asarray(betas), impl=jax_impl)
    out = smpl.smpl_forward(tc, torch.from_numpy(pose), torch.from_numpy(betas), impl="torch")
    for k in ("verts", "joints", "kp3d"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=1e-5, err_msg=k)


def test_smpl_consts_layouts_match_jax(consts):
    tc, jc = consts
    for f in ("v_template_p", "shapedirs_p", "posedirs_p", "weights_p", "shapedirs_flat"):
        np.testing.assert_array_equal(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f)
    assert tc.parents == jc.parents


def test_kernel_wrapper_on_cpu_matches_twin(tiny_asset, consts):
    """impl='kernel' on CPU tensors (the autograd Function, its planar
    output sliced to [B, V, 3]) equals impl='torch' (the twin)."""
    tc, _ = consts
    pose, betas = map(torch.from_numpy, _inputs(tiny_asset, batch=4, seed=1))
    a = smpl.smpl_forward(tc, pose, betas, impl="kernel")
    b = smpl.smpl_forward(tc, pose, betas, impl="torch")
    for k in ("verts", "joints", "kp3d"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-5, err_msg=k)


def test_rodrigues_zero_pose_is_identity():
    r = smpl.batch_rodrigues(torch.zeros(5, 24, 3))
    assert torch.equal(r, torch.eye(3).expand(5, 24, 3, 3))


def test_rot6d_matches_jax():
    x = np.random.RandomState(2).randn(4, 24, 6).astype(np.float32)
    np.testing.assert_allclose(
        smpl.rot6d_to_rotmat(torch.from_numpy(x)).numpy(),
        np.asarray(jsmpl.rot6d_to_rotmat(jnp.asarray(x))),
        atol=1e-6,
    )


@pytest.mark.parametrize("fmt", ["axis_angle", "rot6d"])
def test_mean_params_matches_jax(consts, fmt):
    tc, jc = consts
    np.testing.assert_array_equal(
        smpl.mean_params(tc, 3, fmt), jsmpl.mean_params(jc, 3, fmt)
    )


def test_lbs_backward_matches_autograd_of_twin(tiny_asset, consts):
    tc, _ = consts
    rng = np.random.RandomState(3)
    B, J = 3, tc.num_joints
    betas = torch.from_numpy(rng.randn(B, tc.num_betas).astype(np.float32))
    pf = torch.from_numpy((rng.randn(B, (J - 1) * 9) * 0.3).astype(np.float32))
    rel = torch.from_numpy(rng.randn(B, J, 12).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, tc.num_verts, 3).astype(np.float32))

    leaves = [x.clone().requires_grad_(True) for x in (betas, pf, rel)]
    want = torch.autograd.grad(smpl._lbs_torch(tc, *leaves), leaves, grad_outputs=g)

    _, v_posed, T = lbs_cuda.lbs_planar_torch(tc, betas, pf, rel)
    g_planar = torch.zeros(B, 3, tc.num_verts_padded)
    g_planar[:, :, : tc.num_verts] = g.transpose(1, 2)
    got = lbs_cuda.lbs_backward_torch(tc, v_posed, T, g_planar)
    for name, a, b in zip(("betas", "pose_feat", "rel"), got, want):
        scale = float(b.abs().max()) + 1e-9
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, atol=1e-5, err_msg=name)


def test_kernel_path_gradient_matches_twin(tiny_asset, consts):
    """Pose/betas gradients through the kernel's autograd Function (CPU)."""
    tc, _ = consts
    pose, betas = _inputs(tiny_asset, seed=4)
    grads = {}
    for impl in ("kernel", "torch"):
        p = torch.from_numpy(pose).requires_grad_(True)
        b = torch.from_numpy(betas).requires_grad_(True)
        v = smpl.smpl_forward(tc, p, b, impl=impl)["verts"]
        grads[impl] = torch.autograd.grad((v * v).sum(), (p, b))
    for a, b in zip(grads["kernel"], grads["torch"]):
        scale = float(b.abs().max()) + 1e-9
        np.testing.assert_allclose(a.numpy() / scale, b.numpy() / scale, atol=1e-5)
    assert _build.counts().get(lbs_cuda.KERNEL, 0) == 0  # no launch on CPU


@pytest.mark.parametrize("kw", [dict(num_verts=864, seed=1), dict(num_verts=300, seed=2),
                                dict(num_verts=200, num_joints=10, num_betas=6, seed=3)])
def test_asset_copy_matches_jax(kw):
    """The port's numpy copy of the asset module builds the same arrays."""
    a, b = assets.synthetic_asset(**kw), jassets.synthetic_asset(**kw)
    for f in assets._FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    np.testing.assert_array_equal(a.part_labels(), b.part_labels())


def test_asset_copy_loads_reference_npz(tiny_asset, tmp_path):
    path = str(tmp_path / "asset.npz")
    jassets.save_npz(tiny_asset, path)
    got = assets.load_asset(path)
    for f in assets._FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(tiny_asset, f), err_msg=f)


# --- Against the float64 numpy oracle (utils/oracle.py), as test_smpl.py
# holds the reference: float32 model vs float64 oracle.


def test_rodrigues_matches_oracle():
    aa = np.random.RandomState(11).randn(17, 3).astype(np.float32)
    got = smpl.batch_rodrigues(torch.from_numpy(aa)).numpy()
    np.testing.assert_allclose(got, oracle.rodrigues(aa), atol=2e-6)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_smpl_forward_matches_oracle(tiny_asset, consts, impl):
    tc, _ = consts
    pose, betas = _inputs(tiny_asset, seed=12)
    out = smpl.smpl_forward(tc, torch.from_numpy(pose), torch.from_numpy(betas), impl=impl)
    for i in range(pose.shape[0]):
        want = oracle.smpl_forward(tiny_asset, pose[i], betas[i])
        for k in ("verts", "joints", "kp3d"):
            np.testing.assert_allclose(out[k][i].numpy(), want[k], atol=2e-4, err_msg=k)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_smpl_pose_grad_finite_difference(tiny_asset, consts, impl):
    """The port's autograd (the kernel's autograd Function for impl='kernel',
    its plain backward on the CPU) against central differences of the
    float64 oracle, at test_smpl.py's tolerance."""
    tc, _ = consts
    pose, betas = _inputs(tiny_asset, batch=1, seed=13)
    p = torch.from_numpy(pose).requires_grad_(True)
    v = smpl.smpl_forward(tc, p, torch.from_numpy(betas), impl=impl)["verts"]
    (g,) = torch.autograd.grad(torch.sum(v**2), p)
    pose64, betas64 = pose.astype(np.float64), betas.astype(np.float64)

    def f(x):
        return float(np.sum(oracle.smpl_forward(tiny_asset, x[0], betas64[0])["verts"] ** 2))

    eps = 1e-4
    for idx in [0, 5, 23, 47, 71]:
        dp = np.zeros_like(pose64)
        dp[0, idx] = eps
        fd = (f(pose64 + dp) - f(pose64 - dp)) / (2 * eps)
        np.testing.assert_allclose(float(g[0, idx]), fd, rtol=2e-2, atol=1e-3, err_msg=str(idx))
