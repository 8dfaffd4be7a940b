"""PyTorch port, the serving slice as a whole: JAX `net.forward` +
`render_outputs` (both Pallas kernels, interpret mode) against the port's
`Predictor` + `render_silhouette` with converted weights, plus bucketing,
launch counters on CPU, weight loading, and the no-jax import rule.

128² images: at 64² the JAX raster kernel would fall back to its XLA path
and its interpret-mode body would go unchecked.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.models import encoder as jenc
from indirect_learning_pose_shape_tpu.models import ief as jief
from indirect_learning_pose_shape_tpu.models import network as jnet
from indirect_learning_pose_shape_tpu.ops import raster as jraster
from indirect_learning_pose_shape_tpu_torch import predict, serve
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build
from indirect_learning_pose_shape_tpu_torch.tools import profile_serve
from indirect_learning_pose_shape_tpu_torch.utils import convert

SIZE = 128
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_cfg(**kw):
    return net.ModelConfig(
        image_size=SIZE,
        encoder=enc.EncoderConfig(depth=18, width=16, compute_dtype=torch.float32),
        ief=ief.IEFConfig(hidden_dims=(128,)),
        raster=raster.RasterConfig(image_size=SIZE, num_parts=24),
        **kw,
    )


@pytest.fixture(scope="module")
def reference(tiny_asset):
    """JAX forward + render with both Pallas kernels on converted-able params."""
    cfg = jnet.ModelConfig(
        image_size=SIZE,
        encoder=jenc.EncoderConfig(depth=18, width=16, compute_dtype=jnp.float32),
        ief=jief.IEFConfig(hidden_dims=(128,)),
        raster=jraster.RasterConfig(image_size=SIZE, num_parts=24),
        smpl_impl="pallas",
        raster_impl="pallas",
    )
    params, state, consts = jnet.init(jax.random.PRNGKey(0), tiny_asset, cfg)
    params, state = jax.tree.map(np.asarray, (params, state))
    # An output layer small enough that the bodies stay in frame, large
    # enough that pose, shape and camera differ per image.
    rng = np.random.RandomState(0)
    last = params["ief"]["layers"][-1]
    last["w"] = (rng.randn(*last["w"].shape) * 2e-4).astype(np.float32)
    images = rng.uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)

    @jax.jit
    def run(p, s, im):
        out, _ = jnet.forward(p, s, consts, im, cfg, train=False)
        return jnet.render_outputs(out, consts, cfg)

    out = jax.tree.map(np.asarray, run(params, state, images))
    return params, state, images, out


@pytest.mark.parametrize("impl", ["auto", "kernel"])
def test_slice_matches_jax(tiny_asset, reference, impl):
    params, state, images, ref = reference
    cfg = _port_cfg(smpl_impl=impl, raster_impl=impl)
    model, consts = net.init(tiny_asset, cfg, seed=1, device="cpu")
    convert.load_jax_params(model, params, state)
    p = serve.Predictor(cfg, model, consts, buckets=(4,))
    out = p(images)
    sil = predict.render_silhouette(out, consts, cfg)["silhouette"]
    assert 0.5 < float(sil.max()) < 1.0  # a body in frame
    assert float(np.abs(ref["pose"]).max()) > 1e-3  # predictions move off the mean
    for k, atol in (("theta", 1e-4), ("verts", 1e-4), ("kp2d", 5e-3), ("joints", 1e-4)):
        np.testing.assert_allclose(out[k].numpy(), ref[k], atol=atol, err_msg=k)
    np.testing.assert_allclose(sil.numpy(), ref["silhouette"], atol=1e-4)


def test_predictor_bucketing(tiny_asset):
    cfg = _port_cfg()
    model, consts = net.init(tiny_asset, cfg, seed=0, device="cpu")
    p = serve.Predictor(cfg, model, consts, buckets=(2, 4, 8))
    assert p.bucket_for(1) == 2 and p.bucket_for(3) == 4 and p.bucket_for(8) == 8
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        p.bucket_for(9)
    with pytest.raises(ValueError, match="positive"):
        serve.Predictor(cfg, model, consts, buckets=(0, 2))
    x = np.random.RandomState(1).uniform(-1, 1, (8, SIZE, SIZE, 3)).astype(np.float32)
    out3 = p(x[:3])  # padded 3 -> 4
    out8 = p(x)
    assert out3["verts"].shape[0] == 3
    for k in out3:
        np.testing.assert_allclose(out3[k].numpy(), out8[k][:3].numpy(), atol=1e-5, err_msg=k)


def test_kernel_counters_stay_zero_on_cpu(tiny_asset):
    cfg = _port_cfg(smpl_impl="kernel", raster_impl="kernel")
    model, consts = net.init(tiny_asset, cfg, seed=0, device="cpu")
    _build.reset_counts()
    out = predict.predict(model, consts, torch.zeros(1, SIZE, SIZE, 3), cfg)
    predict.render_silhouette(out, consts, cfg)
    assert _build.counts() == {}


def test_load_model_from_npz(tiny_asset, reference, tmp_path):
    params, state, images, ref = reference
    path = tmp_path / "weights.npz"
    np.savez(path, **convert.jax_to_state_dict(params, state))
    cfg = _port_cfg()
    model, consts = predict.load_model(cfg, str(path), asset=tiny_asset, device="cpu")
    out = predict.predict(model, consts, torch.from_numpy(images), cfg)
    np.testing.assert_allclose(out["theta"].numpy(), ref["theta"], atol=1e-4)
    bad = dataclasses.replace(cfg, ief=ief.IEFConfig(hidden_dims=(64,)))
    with pytest.raises(RuntimeError, match="size mismatch"):
        predict.load_model(bad, str(path), asset=tiny_asset, device="cpu")


def test_port_imports_no_jax():
    """The port's modules, serving (float and int8), a training step on hard
    targets with appearance randomisation and one on a written disk dataset
    with augmentation, the int8 evaluation and the example's step, on the
    CPU, import neither jax nor the JAX package (nor does importing the
    export and the tools)."""
    code = (
        "import dataclasses, sys, torch\n"
        "from indirect_learning_pose_shape_tpu_torch import configs, evaluate, export, losses, predict, serve, train\n"
        "from indirect_learning_pose_shape_tpu_torch.data import augment, dataset, image_dir, native_preprocess\n"
        "from indirect_learning_pose_shape_tpu_torch.data import preprocess, synthetic\n"
        "from indirect_learning_pose_shape_tpu_torch.models import encoder, ief, network, pretrained, quantize\n"
        "from indirect_learning_pose_shape_tpu_torch.examples import fit_to_silhouette\n"
        "from indirect_learning_pose_shape_tpu_torch.ops import raster, raster_hard\n"
        "from indirect_learning_pose_shape_tpu_torch.ops.kernels import lbs_cuda, raster_cuda\n"
        "from indirect_learning_pose_shape_tpu_torch.tools import make_synthetic_dataset, profile_serve\n"
        "from indirect_learning_pose_shape_tpu_torch.tools import profile_train, quality_eval, shard_dataset\n"
        "from indirect_learning_pose_shape_tpu_torch.tools import convert_smpl_pkl, export_model\n"
        "from indirect_learning_pose_shape_tpu_torch.tools import import_resnet_weights, profile_step\n"
        "from indirect_learning_pose_shape_tpu_torch.utils import checkpoint, debug, metrics\n"
        "from indirect_learning_pose_shape_tpu_torch.utils.assets import synthetic_asset\n"
        "cfg = network.ModelConfig(image_size=64,\n"
        "    encoder=encoder.EncoderConfig(width=8), ief=ief.IEFConfig(hidden_dims=(16,)),\n"
        "    raster=raster.RasterConfig(image_size=64))\n"
        "asset = synthetic_asset(num_verts=300, seed=2)\n"
        "model, consts = network.init(asset, cfg, device='cpu')\n"
        "out = serve.Predictor(cfg, model, consts)(torch.zeros(2, 64, 64, 3))\n"
        "sil = predict.render_silhouette(out, consts, cfg)['silhouette']\n"
        "assert sil.shape == (2, 64, 64)\n"
        "tcfg = dataclasses.replace(configs.CONFIG4_FULL, model=cfg, batch_size=2,\n"
        "    synthetic=configs.CONFIG4_ROBUST.synthetic)\n"
        "_, terms = train.fit(tcfg, num_steps=1, asset=asset, device='cpu')\n"
        "assert terms['total'] > 0\n"
        "arrays = dataset.make_synthetic_dataset(None, 2, source_size=64, asset=asset, device='cpu')\n"
        "dcfg = dataclasses.replace(tcfg, augment=dataclasses.replace(tcfg.augment, enabled=True))\n"
        "_, terms = train.fit_dataset(dcfg, dataset.NpzDataset(arrays, 2), num_steps=1, asset=asset, device='cpu')\n"
        "assert terms['total'] > 0\n"
        "native_preprocess.crop_resize_normalize([arrays['images'][0]], [[32.0, 32.0, 40.0]], 16)\n"
        "m = evaluate.evaluate(model, consts, tcfg, num_batches=1)\n"
        "assert 0.0 <= m['sil_iou'] <= 1.0 and m['pve'] > 0\n"
        "qp = quantize.ptq_quantize(model.encoder, torch.zeros(2, 64, 64, 3), keep_sites=('stem',))\n"
        "out = serve.Predictor(cfg, model, consts, qparams=qp)(torch.zeros(2, 64, 64, 3))\n"
        "assert out['verts'].shape == (2, 300, 3)\n"
        "m = evaluate.evaluate(model, consts, tcfg, num_batches=1, qparams=qp)\n"
        "prob = fit_to_silhouette.make_problem(asset, 32, 1, 'cpu')\n"
        "fit_to_silhouette.fit(prob, fit_to_silhouette.initial_params(1, 'cpu'), 1, 0.05)\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert 'indirect_learning_pose_shape_tpu' not in sys.modules\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_rot6d_forward_matches_jax(tiny_asset):
    """The rot6d head (config4_r34, config4_large, config4_mixed): JAX
    `forward` (train=False) against the port's, outputs and the gradient of
    every parameter of a loss on the posed mesh, keypoints and camera."""
    cfg_j = jnet.ModelConfig(
        image_size=64,
        encoder=jenc.EncoderConfig(depth=18, width=16, compute_dtype=jnp.float32),
        ief=jief.IEFConfig(hidden_dims=(128,), rotation_format="rot6d"),
        raster=jraster.RasterConfig(image_size=64, num_parts=24),
    )
    params, state, consts_j = jnet.init(jax.random.PRNGKey(2), tiny_asset, cfg_j)
    params, state = jax.tree.map(np.asarray, (params, state))
    rng = np.random.RandomState(3)
    last = params["ief"]["layers"][-1]
    last["w"] = (rng.randn(*last["w"].shape) * 2e-3).astype(np.float32)
    images = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)

    def jloss(p):
        out, _ = jnet.forward(p, state, consts_j, images, cfg_j, train=False)
        loss = jnp.sum(out["verts"] ** 2) + 1e-3 * jnp.sum(out["kp2d"]) + jnp.sum(out["pose_prior"] ** 2)
        return loss, out

    (_, ref), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    ref = jax.tree.map(np.asarray, ref)
    jgrad = convert.jax_to_state_dict(jax.tree.map(np.asarray, jgrad), state)

    cfg = net.ModelConfig(
        image_size=64,
        encoder=enc.EncoderConfig(depth=18, width=16, compute_dtype=torch.float32),
        ief=ief.IEFConfig(hidden_dims=(128,), rotation_format="rot6d"),
        raster=raster.RasterConfig(image_size=64, num_parts=24),
    )
    model, consts = net.init(tiny_asset, cfg, seed=1, device="cpu")
    convert.load_jax_params(model, params, state)
    out = net.forward(model, consts, torch.from_numpy(images), cfg)
    assert out["pose"].shape == (2, 24 * 6)
    assert float(np.abs(ref["theta"] - params["ief"]["mean_theta"]).max()) > 1e-3  # off the mean
    for k, atol in (("theta", 1e-4), ("rotmats", 1e-5), ("pose_prior", 1e-4), ("verts", 1e-4),
                    ("joints", 1e-4), ("kp2d", 5e-3)):
        np.testing.assert_allclose(out[k].detach().numpy(), ref[k], atol=atol, err_msg=k)
    loss = (out["verts"] ** 2).sum() + 1e-3 * out["kp2d"].sum() + (out["pose_prior"] ** 2).sum()
    loss.backward()
    for k, p in model.named_parameters():
        want = jgrad[k]
        scale = float(np.abs(want).max()) + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / scale, want / scale, atol=1e-4, err_msg=k)
    assert float(np.abs(jgrad["ief.mean_theta"]).max()) > 0


@pytest.mark.parametrize("name, want", [
    ("(anonymous namespace)::raster_fwd_kernel(float const*, float const*, float*, int", "raster kernel"),
    ("(anonymous namespace)::lbs_forward_kernel(float const*, float const*, float cons", "lbs kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "H2D copy"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize64x64x6", "conv/gemm"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, at::native::f", "other"),
])
def test_profile_categories(name, want):
    assert profile_serve.category(name) == want
