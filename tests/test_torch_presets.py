"""PyTorch port, the presets that the other port-vs-JAX training tests do not
reach, each against the reference's `train_step` on the CPU:

- config4_large: the ResNet-50 bottleneck encoder in train mode (batch
  statistics through the 1x1-3x3-1x1 blocks and their projections), rot6d;
- config4_parts31: 31 part classes on the tiny asset, 7 of them with no
  vertex (the counterpart of the reference's `test_parts31_preset_trains`);
- config3_render: the silhouette losses alone;
- config1_single: batch 1, train-mode BatchNorm over one image.

Each case keeps its preset's encoder depth, rotation format, part count,
loss weights, optimizer and batch (config1's 1; 2 for the others), shrunk to
width 8, IEF (128,), 64² images and a float32 encoder. Three steps (two
for config4_large) on one injected batch from the port's initial parameters,
which the reference's state is built to hold: the losses at rtol 1e-3 (each
term of step 1 too). Both render on the separable formulation, the
reference's default route, with float32 training scores (the raster
kernels' shapes are held to their plain versions on the card by
`chip_smoke.py`'s presets phase). ResNet-50's float32 step is
ill-conditioned at this size: Adam's first update (±lr an entry) carries
the float32 rounding of its gradients into the next losses, so the
reference compiled at another XLA optimisation level parts from itself by
1e-3 at step 2 (the port from it by 1e-5), where ResNet-18 and -34 stay
within 1e-5 for 4 steps (`tests/presets_conditioning.py` prints these
numbers); config4_large is held for 2 steps. Also the part
palette against the reference's `_part_palette` at counts other than 25
and 32.
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
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.utils import convert

SIZE, WIDTH = 64, 8
CASES = {  # preset: (batch, steps)
    "config4_large": (2, 2),
    "config4_parts31": (2, 3),
    "config3_render": (2, 3),
    "config1_single": (1, 3),
}


@pytest.mark.parametrize("n", [2, 9, 15, 25, 32, 40])
def test_palette_matches_reference_at_any_count(n):
    want = np.asarray(jsyn._part_palette(n))
    got = synthetic.part_palette(n)
    assert got.dtype == np.float32 and got.shape == (n, 3)
    np.testing.assert_array_equal(got, want)


def _shrink(preset, jax_side: bool, batch: int):
    """`preset` at WIDTH with a float32 encoder, IEF (128,), SIZE² and
    float32 training scores; depth, rotations, parts and losses its own.
    Both render on the separable formulation, the reference's default (the
    port's at 'highest': JAX on the CPU computes every product in float32)."""
    e, i = (jenc, jief) if jax_side else (enc, ief)
    m = preset.model
    raster = dataclasses.replace(m.raster, image_size=SIZE, train_score_dtype="float32")
    port = {} if jax_side else {"raster_impl": "separable"}
    if not jax_side:
        raster = dataclasses.replace(raster, matmul_precision="highest")
    model = dataclasses.replace(
        m,
        image_size=SIZE,
        encoder=e.EncoderConfig(
            depth=m.encoder.depth, width=WIDTH, compute_dtype=jnp.float32 if jax_side else torch.float32,
            fold_bn_eval=True,
        ),
        ief=i.IEFConfig(hidden_dims=(128,), rotation_format=m.ief.rotation_format),
        raster=raster,
        **port,
    )
    return dataclasses.replace(preset, model=model, batch_size=batch)


def _reference_tree(arrays: dict, like: dict, prefix: str) -> dict:
    """The port's state-dict `arrays` as the reference's subtree shaped as
    `like` (conv weights OIHW -> HWIO)."""
    out = {}
    for k, v in like.items():
        name = prefix + k
        if isinstance(v, dict):
            out[k] = _reference_tree(arrays, v, name + ".")
        else:
            a = arrays[name]
            out[k] = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a
    return out


def _reference_state(model, jcfg, asset):
    """The reference's `TrainState` holding the port model's parameters and
    BN buffers (the reverse of `convert.jax_to_state_dict`, checked by a
    round trip) and a fresh optimizer state. The reference's tree layout
    comes from an abstract trace of its `init_state`: nothing is compiled
    for it."""
    like = jax.eval_shape(lambda: jtrain.init_state(jcfg, asset)[0])
    arrays = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    layers = like.params["ief"]["layers"]
    params = {
        "encoder": _reference_tree(arrays, like.params["encoder"], "encoder."),
        "ief": {
            "layers": [{"w": arrays[f"ief.layers.{i}.weight"].T.copy(), "b": arrays[f"ief.layers.{i}.bias"]}
                       for i in range(len(layers))],
            "mean_theta": arrays["ief.mean_theta"],
        },
    }
    state = {"encoder": _reference_tree(arrays, like.model_state["encoder"], "encoder.")}
    back = convert.jax_to_state_dict(params, state)
    assert back.keys() == arrays.keys() and all(np.array_equal(back[k], arrays[k]) for k in arrays)
    opt_state = jax.jit(jtrain.make_optimizer(jcfg).init)(params)
    return jtrain.TrainState(params=params, model_state=state, opt_state=opt_state,
                             step=jnp.zeros((), jnp.int32), rng=jax.random.PRNGKey(0))


@pytest.mark.parametrize("name", list(CASES))
def test_preset_steps_track_reference(tiny_asset, name):
    batch_size, steps = CASES[name]
    jcfg = _shrink(jconfigs.PRESETS[name], True, batch_size)
    cfg = _shrink(configs.PRESETS[name], False, batch_size)
    model, consts = net.init(tiny_asset, cfg.model, seed=1, device="cpu")
    with torch.no_grad():  # small enough to keep the bodies in frame, large enough to vary per image
        last = model.ief.layers[-1].weight
        last.copy_(torch.from_numpy(np.random.RandomState(0).randn(*last.shape).astype(np.float32) * 2e-4))
    jts = _reference_state(model, jcfg, tiny_asset)
    batch = train.make_batch(cfg.seed, 3, batch_size, consts, cfg)
    jbatch = {k: v.numpy() for k, v in batch.items()}
    jconsts = jnet.build_consts(tiny_asset, jcfg.model)
    jstep = jax.jit(lambda t, b, c: jtrain.train_step(t, b, c, jcfg))
    ref = []
    for _ in range(steps):
        jts, t = jstep(jts, jbatch, jconsts)
        ref.append({k: float(v) for k, v in t.items()})
    ts = train.new_state(model, cfg)
    got = [{k: float(v) for k, v in train.train_step(ts, batch, consts, cfg).items()} for _ in range(steps)]

    assert ts.step == steps
    assert set(got[0]) == set(ref[0])
    for k, v in ref[0].items():  # step 1, from the same parameters
        np.testing.assert_allclose(got[0][k], v, rtol=1e-3, err_msg=k)
    np.testing.assert_allclose([g["total"] for g in got], [r["total"] for r in ref], rtol=1e-3)
    assert float(batch["silhouette"].mean()) > 0.02  # target bodies in frame
    assert len({g["total"] for g in got}) == steps  # the updates move the loss

    layout = consts.part_layout
    assert layout.num_parts == jconsts.part_layout.num_parts == cfg.model.raster.num_parts
    valid = np.asarray(jconsts.part_layout.valid).reshape(layout.num_parts, -1)
    np.testing.assert_array_equal(layout.real.numpy(), valid.sum(axis=1))
    if name == "config4_parts31":
        assert int((layout.real == 0).sum()) == 7  # the classes no SMPL vertex carries
        assert int(batch["part_labels"].max()) <= 24
    if name == "config3_render":
        assert not {"part_ce", "kp"} & set(got[0])
    if name == "config4_large":
        assert len(model.encoder.block_names) == 16 and model.encoder.s0b0.bottleneck
