"""PyTorch port, the training step as a whole: three Adam steps on one
injected batch from converted initial parameters, against the JAX
reference's `loss_and_metrics` + optax Adam (its `train_step`) with both
Pallas alternatives selected (`smpl_impl`/`raster_impl='pallas'`, interpret
mode). Width-16 f32 encoder, tiny asset, 128² (at 64² the reference's raster
kernel would fall back to its XLA path). Also the configuration refusals,
the step-seeded stream, the CLI and the CUDA-by-default entry points.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from indirect_learning_pose_shape_tpu import configs as jconfigs
from indirect_learning_pose_shape_tpu import train as jtrain
from indirect_learning_pose_shape_tpu.data import synthetic as jsyn
from indirect_learning_pose_shape_tpu.models import encoder as jenc
from indirect_learning_pose_shape_tpu.models import ief as jief
from indirect_learning_pose_shape_tpu.models import network as jnet
from indirect_learning_pose_shape_tpu.ops import raster as jraster
from indirect_learning_pose_shape_tpu_torch import configs, predict, train
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.tools import profile_serve
from indirect_learning_pose_shape_tpu_torch.utils import convert

SIZE, BATCH, STEPS = 128, 2, 3


def _port_cfg():
    model = net.ModelConfig(
        image_size=SIZE,
        encoder=enc.EncoderConfig(depth=18, width=16, compute_dtype=torch.float32),
        ief=ief.IEFConfig(hidden_dims=(128,)),
        raster=raster.RasterConfig(image_size=SIZE, num_parts=24),
    )
    return configs.TrainConfig(model=model, batch_size=BATCH)


@pytest.fixture(scope="module")
def runs(tiny_asset):
    """Both frameworks' step-1 terms and gradients, state after step 1, and
    the loss of each of three steps on one batch."""
    jmodel = jnet.ModelConfig(
        image_size=SIZE,
        encoder=jenc.EncoderConfig(depth=18, width=16, compute_dtype=jnp.float32),
        ief=jief.IEFConfig(hidden_dims=(128,)),
        raster=jraster.RasterConfig(image_size=SIZE, num_parts=24),
        smpl_impl="pallas",
        raster_impl="pallas",
    )
    jcfg = jconfigs.TrainConfig(model=jmodel, batch_size=BATCH)
    ts, jconsts = jtrain.init_state(jcfg, tiny_asset)
    params, state = jax.tree.map(np.asarray, (ts.params, ts.model_state))
    # An output layer small enough that the predicted bodies stay in frame
    # (so the raster gradient is not vacuous), large enough to vary per image.
    last = params["ief"]["layers"][-1]
    last["w"] = (np.random.RandomState(0).randn(*last["w"].shape) * 2e-4).astype(np.float32)
    batch = jax.tree.map(np.asarray, jax.jit(
        lambda k: jsyn.generate_batch(k, BATCH, jconsts, jmodel, jcfg.synthetic)
    )(jax.random.PRNGKey(3)))

    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, s: jtrain.loss_and_metrics(p, s, jconsts, batch, jcfg), has_aux=True
    ))
    opt = jtrain.make_optimizer(jcfg)
    update = jax.jit(lambda g, o, p: (lambda u, o2: (optax.apply_updates(p, u), o2))(
        *opt.update(g, o, p)))
    p, s, o = params, state, opt.init(params)
    ref = {"loss": []}
    for i in range(STEPS):
        (loss, (terms, s)), g = grad_fn(p, s)
        if i == 0:
            ref["terms"] = {k: float(v) for k, v in terms.items()}
            ref["grads"] = convert.jax_to_state_dict(jax.tree.map(np.asarray, g), state)
            ref["state"] = convert.jax_to_state_dict(params, jax.tree.map(np.asarray, s))
        ref["loss"].append(float(loss))
        p, o = update(g, o, p)

    cfg = _port_cfg()
    model, consts = net.init(tiny_asset, cfg.model, seed=1, device="cpu")
    convert.load_jax_params(model, params, state)
    tstate = train.TrainState(model, train.make_optimizer(model, cfg), 0, 0)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = {"loss": []}
    for i in range(STEPS):
        terms = train.train_step(tstate, tbatch, consts, cfg)
        if i == 0:
            got["terms"] = {k: float(v) for k, v in terms.items()}
            got["grads"] = {k: p.grad.clone() for k, p in model.named_parameters()}
            got["state"] = {k: v.clone() for k, v in model.state_dict().items()}
        got["loss"].append(float(terms["total"]))
    assert tstate.step == STEPS
    return ref, got, batch


def test_train_step_terms_match_jax(runs):
    ref, got, batch = runs
    assert set(got["terms"]) == set(ref["terms"])
    for k, v in ref["terms"].items():
        np.testing.assert_allclose(got["terms"][k], v, rtol=1e-5, err_msg=k)
    assert batch["silhouette"].mean() > 0.05  # target bodies in frame


def test_train_step_gradients_match_jax(runs):
    """Step-1 gradient of every parameter, normalised per leaf: the raster's
    (through the prediction render), the encoder's through the batch
    statistics, IEF's and mean_theta's."""
    ref, got, _ = runs
    assert set(got["grads"]) <= set(ref["grads"])
    for k, g in got["grads"].items():
        want = ref["grads"][k]
        scale = float(np.abs(want).max()) + 1e-12
        np.testing.assert_allclose(g.numpy() / scale, want / scale, atol=1e-4, err_msg=k)
    assert float(got["grads"]["ief.mean_theta"].abs().max()) > 0


def test_train_step_bn_statistics_match_jax(runs):
    ref, got, _ = runs
    keys = [k for k in ref["state"] if k.endswith((".mean", ".var"))]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got["state"][k].numpy(), ref["state"][k], atol=1e-5, err_msg=k)


def test_train_loss_over_steps_matches_jax(runs):
    ref, got, _ = runs
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-3)
    assert got["loss"][-1] < got["loss"][0]


@pytest.mark.parametrize("field, value", [
    ("lr_schedule", "cosine"), ("grad_clip_norm", 1.0), ("weight_decay", 1e-4),
    ("ema_decay", 0.999), ("steps_per_call", 4), ("checkpoint_every", 100),
    ("pretrained", "enc18.npz"), ("mean_params", "mean.npz"), ("render_devices", 2),
    ("num_devices", 4),
])
def test_unported_train_fields_are_refused(field, value):
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md, Queue 1 item"):
        dataclasses.replace(configs.CONFIG4_FULL, **{field: value})


def test_presets_are_train_configs():
    for name, cfg in configs.PRESETS.items():
        assert isinstance(cfg, configs.TrainConfig), name
        assert isinstance(cfg.model, net.ModelConfig) and cfg.batch_size == 32
    assert configs.CONFIG4_FULL.model.image_size == 256
    assert configs.CONFIG4_FULL.loss_weight_dict == dict(jconfigs.CONFIG4_FULL.loss_weights)


def test_batches_are_seeded_by_seed_and_step(tiny_asset):
    cfg = dataclasses.replace(_port_cfg(), model=dataclasses.replace(
        _port_cfg().model, image_size=32, raster=raster.RasterConfig(image_size=32)))
    consts = net.build_consts(tiny_asset, cfg.model, device="cpu")
    a, b = (train.make_batch(0, 5, 2, consts, cfg) for _ in range(2))
    c = train.make_batch(0, 6, 2, consts, cfg)
    d = train.make_batch(1, 5, 2, consts, cfg)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["gt_pose"], c["gt_pose"])
    assert not torch.equal(a["gt_pose"], d["gt_pose"])


def test_cli_prints_json_lines(capsys):
    """The CLI on the CPU, full-width ResNet-18 on the SMPL-sized asset at a
    small batch and image size."""
    assert train.main([
        "--preset", "config4_full", "--steps", "2", "--batch-size", "1",
        "--image-size", "32", "--lr", "1e-4", "--seed", "3", "--device", "cpu",
    ]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [r["step"] for r in lines] == [0, 1]
    assert all(np.isfinite(r["total"]) and "part_ce" in r for r in lines)


def test_entry_points_default_to_cuda(tiny_asset):
    """Without a card, an entry point asked for nothing raises instead of
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    cfg = _port_cfg()
    for call in (
        lambda: net.init(tiny_asset, cfg.model),
        lambda: predict.load_model(cfg.model, asset=tiny_asset),
        lambda: train.init_state(cfg, tiny_asset),
        lambda: train.fit(cfg, num_steps=1, asset=tiny_asset),
        lambda: train.main(["--steps", "1"]),
    ):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("name, want", [
    ("(anonymous namespace)::raster_bwd_kernel(float const*, float const*, float cons", "raster bwd kernel"),
    ("(anonymous namespace)::raster_fwd_kernel(float const*, float const*, float*, int", "raster kernel"),
    ("void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16, __nv_bfloat16, f", "conv/gemm"),
])
def test_profile_train_categories(name, want):
    assert profile_serve.category(name) == want
