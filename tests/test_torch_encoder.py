"""PyTorch port, encoder + IEF + weight bridge: the port against the JAX
reference on CPU, with the reference's params converted by utils/convert.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.models import encoder as jenc
from indirect_learning_pose_shape_tpu.models import ief as jief
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models.network import Model
from indirect_learning_pose_shape_tpu_torch.utils import convert


def _randomize_bn(params, state, rng, residual_scale=1.0):
    """Non-trivial BN affine, running statistics perturbed by up to 20%. The
    last BN of each residual branch is damped (as trained ResNets keep it
    small), so the residual stream stays O(1) through all blocks."""
    for k, v in params.items():
        if isinstance(v, dict) and "scale" in v:
            n = v["scale"].shape
            v["scale"] = ((1 + 0.2 * rng.randn(*n)) * residual_scale).astype(np.float32)
            v["bias"] = (0.2 * rng.randn(*n) * residual_scale).astype(np.float32)
            state[k]["mean"] = state[k]["mean"] + 0.2 * np.sqrt(state[k]["var"]) * rng.randn(*n)
            state[k]["var"] = state[k]["var"] * rng.uniform(0.8, 1.2, n)
        elif isinstance(v, dict):
            last = "bn3" if "bn3" in v else "bn2"
            for kk, vv in v.items():
                if isinstance(vv, dict):
                    _randomize_bn({kk: vv}, {kk: state[k][kk]}, rng, 0.2 if kk == last else 1.0)


def _jax_encoder(depth, fold, dtype, seed=0):
    """Reference encoder whose running statistics are calibrated on a batch
    (train-mode BN, momentum 0), so activations stay O(1) as in a trained
    network, then perturbed."""
    cfg = jenc.EncoderConfig(depth=depth, width=16, compute_dtype=dtype, fold_bn_eval=fold)
    params, state = jenc.encoder_init(jax.random.PRNGKey(seed), cfg)
    calib = dataclasses.replace(cfg, compute_dtype=jnp.float32, bn_momentum=0.0)
    _, state = jax.jit(lambda p, s, im: jenc.encoder_apply(p, s, im, calib, train=True))(
        params, state, _images(batch=4, seed=seed + 100)
    )
    params, state = jax.tree.map(lambda x: np.asarray(x, np.float32), (params, state))
    _randomize_bn(params, state, np.random.RandomState(seed))
    state = jax.tree.map(lambda x: np.asarray(x, np.float32), state)
    return cfg, params, state


def _images(batch=2, size=64, seed=7):
    return np.random.RandomState(seed).uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)


def _port_encoder(depth, fold, dtype, params, state):
    cfg = enc.EncoderConfig(depth=depth, width=16, compute_dtype=dtype, fold_bn_eval=fold)
    model = enc.Encoder(cfg, torch.Generator().manual_seed(1))
    sd = convert.jax_to_state_dict({"encoder": params, "ief": {"layers": [], "mean_theta": []}},
                                   {"encoder": state})
    convert.load_state_arrays(model, {k[len("encoder."):]: v for k, v in sd.items()
                                      if k.startswith("encoder.")})
    return model.eval()


@pytest.mark.parametrize("depth", [18, 34, 50])
@pytest.mark.parametrize("fold", [False, True])
def test_encoder_f32_matches_jax(depth, fold):
    jcfg, params, state = _jax_encoder(depth, fold, jnp.float32)
    x = _images()
    ref, _ = jax.jit(lambda p, s, im: jenc.encoder_apply(p, s, im, jcfg, train=False))(
        params, state, x
    )
    model = _port_encoder(depth, fold, torch.float32, params, state)
    with torch.inference_mode():
        out = enc.encoder_apply(model, torch.from_numpy(x))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_encoder_bf16_close_to_jax():
    """bf16 rounds at other places in the two frameworks: 3e-2 relative."""
    jcfg, params, state = _jax_encoder(18, True, jnp.bfloat16, seed=2)
    x = _images(seed=8)
    ref, _ = jax.jit(lambda p, s, im: jenc.encoder_apply(p, s, im, jcfg, train=False))(
        params, state, x
    )
    model = _port_encoder(18, True, torch.bfloat16, params, state)
    with torch.inference_mode():
        out = enc.encoder_apply(model, torch.from_numpy(x))
    ref = np.asarray(ref, np.float32)
    assert np.abs(out.numpy() - ref).max() / np.abs(ref).max() < 3e-2


def test_ief_matches_jax():
    rng = np.random.RandomState(9)
    jcfg = jief.IEFConfig(hidden_dims=(64, 32))
    feat_dim = 40
    mean = rng.randn(jcfg.theta_dim).astype(np.float32)
    p = jax.tree.map(np.asarray, jief.ief_init(jax.random.PRNGKey(3), jcfg, feat_dim, mean))
    p["layers"][-1]["w"] = (rng.randn(*p["layers"][-1]["w"].shape) * 0.05).astype(np.float32)
    for layer in p["layers"]:
        layer["b"] = (0.1 * rng.randn(*layer["b"].shape)).astype(np.float32)
    feats = rng.randn(3, feat_dim).astype(np.float32)
    ref = jief.ief_apply(p, jnp.asarray(feats), jcfg)

    cfg = ief.IEFConfig(hidden_dims=(64, 32))
    m = ief.ief_init(cfg, feat_dim, np.zeros(cfg.theta_dim), torch.Generator().manual_seed(0))
    sd = convert.jax_to_state_dict({"encoder": {}, "ief": p}, {"encoder": {}})
    convert.load_state_arrays(m, {k[len("ief."):]: v for k, v in sd.items()})
    with torch.inference_mode():
        out = ief.ief_apply(m, torch.from_numpy(feats))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    assert isinstance(m.mean_theta, torch.nn.Parameter)


def test_convert_layouts_and_strict_keys():
    jcfg, params, state = _jax_encoder(18, False, jnp.float32, seed=4)
    ip = jax.tree.map(np.asarray, jief.ief_init(
        jax.random.PRNGKey(0), jief.IEFConfig(hidden_dims=(8,)), jcfg.feature_dim,
        np.zeros(85, np.float32)))
    full_p, full_s = {"encoder": params, "ief": ip}, {"encoder": state}
    model = Model(
        enc.Encoder(enc.EncoderConfig(width=16), torch.Generator().manual_seed(0)),
        ief.IEF(ief.IEFConfig(hidden_dims=(8,)), jcfg.feature_dim, np.zeros(85)),
    )
    convert.load_jax_params(model, full_p, full_s)
    got = {k: v.numpy() for k, v in model.state_dict().items()}
    np.testing.assert_array_equal(got["encoder.stem"], params["stem"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        got["encoder.s1b0.proj"], params["s1b0"]["proj"].transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(got["encoder.s1b0.bn_proj.var"], state["s1b0"]["bn_proj"]["var"])
    np.testing.assert_array_equal(got["ief.layers.1.weight"], ip["layers"][1]["w"].T)
    np.testing.assert_array_equal(got["ief.mean_theta"], ip["mean_theta"])

    sd = convert.jax_to_state_dict(full_p, full_s)
    missing = dict(sd)
    del missing["encoder.s1b0.bn_proj.var"]
    with pytest.raises(RuntimeError, match="Missing key"):
        convert.load_state_arrays(model, missing)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        convert.load_state_arrays(model, {**sd, "encoder.extra": np.zeros(1, np.float32)})


def test_encoder_train_bn_matches_jax():
    """Training-mode BatchNorm over two calls of the ResNet-18 encoder:
    features, the gradients of every parameter (through the batch
    statistics) and the running statistics, which the reference returns and
    the port updates in place."""
    depth = 18
    jcfg, params, state = _jax_encoder(depth, True, jnp.float32, seed=5)
    x1, x2 = _images(batch=3, seed=11), _images(batch=3, seed=12)
    r = np.random.RandomState(13).randn(3, jcfg.feature_dim).astype(np.float32)

    def jloss(p, s, im):
        feat, new_s = jenc.encoder_apply(p, s, im, jcfg, train=True)
        return jnp.sum(feat * r), (feat, new_s)

    step = jax.jit(jax.value_and_grad(jloss, has_aux=True))
    (_, (ref1, s1)), grads = step(params, state, x1)
    (_, (ref2, s2)), _ = step(params, s1, x2)

    model = _port_encoder(depth, True, torch.float32, params, state)
    model.train()
    out1 = enc.encoder_apply(model, torch.from_numpy(x1), train=True)
    (out1 * torch.from_numpy(r)).sum().backward()
    got_s1 = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        out2 = enc.encoder_apply(model, torch.from_numpy(x2), train=True)

    np.testing.assert_allclose(out1.detach().numpy(), np.asarray(ref1), atol=1e-5)
    np.testing.assert_allclose(out2.numpy(), np.asarray(ref2), atol=1e-5)
    empty_ief = {"layers": [], "mean_theta": []}
    for ref_s, got in ((s1, got_s1), (s2, model.state_dict())):
        want = convert.jax_to_state_dict(
            {"encoder": params, "ief": empty_ief}, {"encoder": jax.tree.map(np.asarray, ref_s)}
        )
        for k, v in want.items():
            if k.endswith((".mean", ".var")):
                np.testing.assert_allclose(
                    got[k[len("encoder."):]].numpy(), v, atol=1e-5, err_msg=k
                )
    # Gradients at 5e-5 after normalising per leaf, not 1e-5: the BN backward
    # subtracts batch means of the upstream gradient, and at the last stage's
    # 2x2 maps (12 values a channel at batch 3) that cancellation leaves
    # float32 reduction-order noise of ~1.6e-5 between the frameworks.
    want_g = convert.jax_to_state_dict(
        {"encoder": jax.tree.map(np.asarray, grads), "ief": empty_ief}, {"encoder": state}
    )
    for name, p in model.named_parameters():
        g = want_g[f"encoder.{name}"]
        scale = float(np.abs(g).max()) + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / scale, g / scale, atol=5e-5, err_msg=name)
