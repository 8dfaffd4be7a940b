"""PyTorch port, the reference's default raster route and its best recipe:

- one `loss_and_metrics` of config4_full's model (small width, float32
  encoder) on the separable raster with the presets' bf16 products and bf16
  training scores, against the reference's default (`raster_impl='auto'`,
  which is separable) on the same batch;
- three steps of a config4_mixed-shaped run (rot6d, cosine warm-up over 2
  steps, clip 1.0, the 3D weights, EMA) from converted parameters on one
  injected batch with its 3D targets, against the reference's `train_step`.

JAX on the CPU computes every matmul precision in float32, so the port's
float32 run uses 'highest'. 64² images, tiny asset, width-16 encoder.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu import configs as jconfigs
from indirect_learning_pose_shape_tpu import train as jtrain
from indirect_learning_pose_shape_tpu.data import synthetic as jsyn
from indirect_learning_pose_shape_tpu.models import encoder as jenc
from indirect_learning_pose_shape_tpu.models import ief as jief
from indirect_learning_pose_shape_tpu.models import network as jnet
from indirect_learning_pose_shape_tpu_torch import configs, train
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.utils import convert

SIZE, BATCH, STEPS = 64, 2, 3
RUN = dict(warmup_steps=2, num_steps=10, ema_decay=0.9)


def _small(model, jax_side: bool, depth: int, rotation: str):
    """`model` at width 16 with a float32 encoder, IEF (128,), 64²."""
    e, i = (jenc, jief) if jax_side else (enc, ief)
    dtype = jnp.float32 if jax_side else torch.float32
    return dataclasses.replace(
        model,
        image_size=SIZE,
        encoder=e.EncoderConfig(depth=depth, width=16, compute_dtype=dtype, fold_bn_eval=True),
        ief=i.IEFConfig(hidden_dims=(128,), rotation_format=rotation),
        raster=dataclasses.replace(model.raster, image_size=SIZE),
    )


def _reference(tiny_asset, jcfg, include_3d):
    """Seeded reference state with a small random output layer (bodies in
    frame) and the EMA restarted at it, and one batch from key 3."""
    ts, jconsts = jtrain.init_state(jcfg, tiny_asset)
    params = jax.tree.map(np.asarray, ts.params)
    last = params["ief"]["layers"][-1]
    last["w"] = (np.random.RandomState(0).randn(*last["w"].shape) * 2e-4).astype(np.float32)
    ema = jax.tree.map(jnp.asarray, params) if jcfg.ema_decay else None
    ts = dataclasses.replace(ts, params=jax.tree.map(jnp.asarray, params), ema_params=ema)
    batch = jax.tree.map(np.asarray, jax.jit(lambda k: jsyn.generate_batch(
        k, BATCH, jconsts, jcfg.model, jcfg.synthetic, include_3d=include_3d))(jax.random.PRNGKey(3)))
    return ts, jconsts, params, batch


def _port_state(tiny_asset, cfg, params, state):
    model, consts = net.init(tiny_asset, cfg.model, seed=1, device="cpu")
    convert.load_jax_params(model, params, state)
    return train.new_state(model, cfg), consts


def test_separable_bf16_loss_matches_reference_default(tiny_asset):
    """config4_full's raster (bf16 products, bf16 training scores) on the
    separable impl against the reference's default route: loss terms at
    1e-4 relative (4e-6 measured: both round the same float32 sums to
    bf16), every gradient at 1e-3 normalised per leaf (1e-4 measured)."""
    jmodel = _small(jconfigs.CONFIG4_FULL.model, True, 18, "axis_angle")
    jcfg = dataclasses.replace(jconfigs.CONFIG4_FULL, model=jmodel, batch_size=BATCH)
    assert jmodel.raster_impl == "auto" and jmodel.raster.train_score_dtype == "bfloat16"
    ts, jconsts, params, batch = _reference(tiny_asset, jcfg, include_3d=False)
    state = jax.tree.map(np.asarray, ts.model_state)
    (_, (jterms, _)), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jtrain.loss_and_metrics(p, ts.model_state, jconsts, batch, jcfg), has_aux=True))(ts.params)
    jgrad = convert.jax_to_state_dict(jax.tree.map(np.asarray, jgrad), state)

    model = dataclasses.replace(
        _small(configs.CONFIG4_FULL.model, False, 18, "axis_angle"), raster_impl="separable")
    cfg = dataclasses.replace(configs.CONFIG4_FULL, model=model, batch_size=BATCH)
    assert cfg.model.raster.matmul_precision == "default"
    tstate, consts = _port_state(tiny_asset, cfg, params, state)
    total, terms = train.loss_and_metrics(
        tstate.model, consts, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    total.backward()
    assert set(terms) == set(jterms)
    for k, v in jterms.items():
        np.testing.assert_allclose(float(terms[k]), float(v), rtol=1e-4, err_msg=k)
    for k, p in tstate.model.named_parameters():
        want = jgrad[k]
        scale = float(np.abs(want).max()) + 1e-12
        np.testing.assert_allclose(p.grad.numpy() / scale, want / scale, atol=1e-3, err_msg=k)


@pytest.fixture(scope="module")
def mixed_runs(tiny_asset):
    """Both frameworks' three config4_mixed-shaped steps on one batch with
    its 3D targets: each step's loss and terms, and the final EMA."""
    jmodel = _small(jconfigs.CONFIG4_MIXED.model, True, 18, "rot6d")
    jmodel = dataclasses.replace(
        jmodel, raster=dataclasses.replace(jmodel.raster, train_score_dtype="float32"))
    jcfg = dataclasses.replace(jconfigs.CONFIG4_MIXED, model=jmodel, batch_size=BATCH, **RUN)
    ts, jconsts, params, batch = _reference(tiny_asset, jcfg, include_3d=True)
    state = jax.tree.map(np.asarray, ts.model_state)
    step = jax.jit(lambda t: jtrain.train_step(t, batch, jconsts, jcfg))
    ref = []
    for _ in range(STEPS):
        ts, terms = step(ts)
        ref.append({k: float(v) for k, v in terms.items()})
    ref_ema = convert.jax_to_state_dict(jax.tree.map(np.asarray, ts.ema_params), state)

    model = _small(configs.CONFIG4_MIXED.model, False, 18, "rot6d")
    model = dataclasses.replace(model, raster_impl="separable", raster=dataclasses.replace(
        model.raster, matmul_precision="highest", train_score_dtype="float32"))
    cfg = dataclasses.replace(configs.CONFIG4_MIXED, model=model, batch_size=BATCH, **RUN)
    tstate, consts = _port_state(tiny_asset, cfg, params, state)
    init = {k: p.detach().clone() for k, p in tstate.model.named_parameters()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = [{k: float(v) for k, v in train.train_step(tstate, tbatch, consts, cfg).items()}
           for _ in range(STEPS)]
    return ref, got, ref_ema, tstate, init


def test_mixed_loss_tracks_reference(mixed_runs):
    ref, got, _, ts, _ = mixed_runs
    assert ts.step == STEPS and {"j3d", "rotmat", "betas_l2"} <= set(got[0])
    np.testing.assert_allclose([g["total"] for g in got], [r["total"] for r in ref], rtol=1e-3)
    for k, v in ref[0].items():  # step 1, from the same parameters
        np.testing.assert_allclose(got[0][k], v, rtol=1e-4, err_msg=k)
    # lr 0 at the first update: step 2 sees the same parameters (and batch
    # statistics), step 3 the first real update.
    assert got[1]["total"] == pytest.approx(got[0]["total"], rel=1e-6)
    assert got[2]["total"] != pytest.approx(got[1]["total"], rel=1e-6)


def test_mixed_ema_tracks_reference(mixed_runs):
    """The EMA's move from the initial parameters over three steps, per
    leaf: the mean absolute difference within 1e-2 of the reference's mean
    move (6e-4 measured). Adam's step is ±lr wherever a gradient is not
    ~0, so an entry whose gradient is float32 noise can move the other way
    in the two frameworks; the mean bounds how many do."""
    _, _, ref_ema, ts, init = mixed_runs
    assert ts.ema.keys() <= ref_ema.keys()
    moved = 0
    for k, e in ts.ema.items():
        want = ref_ema[k] - init[k].numpy()
        got = (e - init[k]).numpy()
        scale = float(np.abs(want).mean())
        moved += scale > 0
        assert float(np.abs(got - want).mean()) <= 1e-2 * scale + 1e-12, k
    assert moved >= len(ts.ema) - 2  # nearly every leaf moved
