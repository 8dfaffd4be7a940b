"""PyTorch port, the network-free fit (examples/fit_to_silhouette.py): the
same target and starting point through the JAX reference's chain (SMPL,
camera, soft raster, the example's loss) and the port's: the step-1 loss,
its gradients (`jax.grad` of the same loss), the parameters after the update
`p - lr·g` and the step-2 loss, each within 1e-4 relative (gradients and
parameters per leaf, over the leaf's largest entry); the loss falls over a
few steps; the CLI runs on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from indirect_learning_pose_shape_tpu import losses as jlosses
from indirect_learning_pose_shape_tpu.models import smpl as jsmpl
from indirect_learning_pose_shape_tpu.ops import camera as jcamera
from indirect_learning_pose_shape_tpu.ops import raster as jraster
from indirect_learning_pose_shape_tpu_torch.examples import fit_to_silhouette as fit
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib

SIZE, B = 32, 2
LR = 0.05
REL = 1e-4


def _gt():
    rng = np.random.RandomState(0)
    return {
        "pose": (0.3 * rng.randn(B, 72)).astype(np.float32),
        "betas": rng.randn(B, 10).astype(np.float32),
        "cam": np.tile(np.array([0.9, 0.0, 0.0], np.float32), (B, 1)),
    }


def _jax_loss(asset, gt):
    """The reference example's render and loss_fn, on the given target:
    (target silhouette, loss_fn)."""
    consts = jsmpl.smpl_consts(asset)
    layout = jraster.build_part_layout(asset.part_labels().clip(0, 23), 24, positions=asset.v_template)
    cfg = jraster.RasterConfig(image_size=SIZE, num_parts=24)

    def render(pose, betas, cam):
        out = jsmpl.smpl_forward(consts, pose, betas)
        v2d = jcamera.project_pixel(out["verts"], cam, SIZE)
        sil = jraster.soft_rasterize(v2d, layout, cfg)["silhouette"]
        return sil, jcamera.project_pixel(out["kp3d"], cam, SIZE)

    target_sil, target_kp = jax.jit(render)(gt["pose"], gt["betas"], gt["cam"])
    vis = jnp.ones(target_kp.shape[:2])

    def loss_fn(p):
        sil, kp2d = render(p["pose"], p["betas"], p["cam"])
        return (
            jlosses.silhouette_bce(sil, target_sil)
            + jlosses.silhouette_iou(sil, target_sil)
            + 10.0 * jlosses.keypoint_l2(kp2d, target_kp, vis, SIZE)
            + 1e-3 * jlosses.shape_reg(p["betas"])
        )

    return np.asarray(target_sil), loss_fn


def _leaf_err(got: torch.Tensor, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(got.detach().numpy() - ref).max() / np.abs(ref).max())


def test_step1_loss_matches_jax(tiny_asset):
    gt = _gt()
    p = fit.make_problem(tiny_asset, SIZE, B, "cpu", gt={k: torch.from_numpy(v) for k, v in gt.items()})
    params = fit.initial_params(B, "cpu")
    target_sil, loss_fn = _jax_loss(tiny_asset, gt)
    ref = float(jax.jit(loss_fn)({k: v.numpy() for k, v in params.items()}))
    np.testing.assert_allclose(p.target_sil.numpy(), target_sil, atol=1e-5)
    assert float(p.target_sil.max()) > 0.5  # bodies in frame
    got = float(fit.step(p, params, lr=LR))
    np.testing.assert_allclose(got, ref, rtol=REL)


def test_step1_gradients_and_step2_loss_match_jax(tiny_asset):
    gt = _gt()
    p = fit.make_problem(tiny_asset, SIZE, B, "cpu", gt={k: torch.from_numpy(v) for k, v in gt.items()})
    _, loss_fn = _jax_loss(tiny_asset, gt)
    params = fit.initial_params(B, "cpu")
    ref_params = {k: v.numpy().copy() for k, v in params.items()}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(ref_params)
    loss, grads = fit.loss_and_grads(p, {k: v.clone() for k, v in params.items()})
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=REL)
    assert set(grads) == set(ref_grads) == {"pose", "betas", "cam"}
    for k, g in grads.items():
        assert float(np.abs(np.asarray(ref_grads[k])).max()) > 0, k
        assert _leaf_err(g, ref_grads[k]) <= REL, k

    fit.step(p, params, lr=LR)
    ref_params = {k: v - LR * np.asarray(ref_grads[k]) for k, v in ref_params.items()}
    for k, v in params.items():
        assert _leaf_err(v, ref_params[k]) <= REL, k
    with torch.no_grad():
        loss2 = float(fit.loss_fn(p, params))
    np.testing.assert_allclose(loss2, float(jax.jit(loss_fn)(ref_params)), rtol=REL)


def test_loss_falls(tiny_asset):
    p = fit.make_problem(tiny_asset, SIZE, B, "cpu")
    params = fit.initial_params(B, "cpu")
    history = fit.fit(p, params, 6, lr=0.05)
    assert history[-1] < history[0] and all(np.isfinite(history))
    assert float(fit.loss_fn(p, params).detach()) < history[0]


def test_cli_runs_on_cpu(tiny_asset, monkeypatch, capsys):
    monkeypatch.setattr(assets_lib, "load_asset", lambda *a, **k: tiny_asset)
    assert fit.main(["--steps", "4", "--size", str(SIZE), "--batch", str(B), "--device", "cpu"]) == 0
    assert "recover the target" in capsys.readouterr().out
