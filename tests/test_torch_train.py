"""PyTorch port, the training step as a whole: three Adam steps on one
injected batch from converted initial parameters, against the JAX
reference's `loss_and_metrics` + optax Adam (its `train_step`) with both
Pallas alternatives selected (`smpl_impl`/`raster_impl='pallas'`, interpret
mode). Width-16 f32 encoder, tiny asset, 128² (at 64² the reference's raster
kernel would fall back to its XLA path). Also the configuration refusals
(and the pretrained and mean-parameter files, taken),
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
from indirect_learning_pose_shape_tpu_torch import configs, evaluate, predict, train
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
    # The same steps through compile_train_fns' step_fn (on the CPU the
    # eager train_step; on the card a CUDA graph of it).
    model, consts = net.init(tiny_asset, cfg.model, seed=1, device="cpu")
    convert.load_jax_params(model, params, state)
    cstate = train.TrainState(model, train.make_optimizer(model, cfg), 0, 0)
    _, step_fn = train.compile_train_fns(cfg, consts)
    got["compiled"] = [{k: float(v) for k, v in step_fn(cstate, tbatch).items()} for _ in range(STEPS)]
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


def test_compile_train_fns_step_matches_jax(runs):
    """compile_train_fns' step_fn on the injected batch: step 1's terms and
    the loss of each step against the reference's train_step, at the
    tolerances of the eager step's tests."""
    ref, got, _ = runs
    for k, v in ref["terms"].items():
        np.testing.assert_allclose(got["compiled"][0][k], v, rtol=1e-5, err_msg=k)
    np.testing.assert_allclose([t["total"] for t in got["compiled"]], ref["loss"], rtol=1e-3)


def test_train_loss_over_steps_matches_jax(runs):
    ref, got, _ = runs
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-3)
    assert got["loss"][-1] < got["loss"][0]


@pytest.mark.parametrize("field, value", [
    ("pretrained", "enc18.npz"), ("mean_params", "mean.npz"),
    ("render_devices", 2), ("num_devices", 4),
])
def test_unported_train_fields_are_refused(field, value, tmp_path, monkeypatch):
    """Once refused, now taken. The multi-GPU fields hold the value the
    reference's hold and a value below 1 is refused, naming the field
    (the mesh they select is checked in test_torch_render_sp.py).
    `pretrained` and `mean_params`: `train.main --pretrained` /
    `--mean-params` (one step on the CPU) starts from the file's weights."""
    if field in ("render_devices", "num_devices"):
        cfg = dataclasses.replace(configs.CONFIG4_FULL, **{field: value})
        ref = dataclasses.replace(jconfigs.CONFIG4_FULL, **{field: value})
        assert getattr(cfg, field) == getattr(ref, field) == value
        with pytest.raises(ValueError, match=field):
            dataclasses.replace(configs.CONFIG4_FULL, **{field: 0})
        return
    from indirect_learning_pose_shape_tpu_torch.models import pretrained
    from tests.test_torch_pretrained import _torchvision_sd

    path = str(tmp_path / value)
    if field == "pretrained":
        pretrained.save_encoder_npz(path, *pretrained.map_state_dict(_torchvision_sd(seed=3), 18), 18)
        want = {"encoder." + k: v for k, v in convert.encoder_to_state_dict(
            *pretrained.load_encoder_npz(path)[:2]).items()}
    else:
        want = {"ief.mean_theta": np.random.RandomState(3).randn(85).astype(np.float32)}
        np.savez(path, mean_theta=want["ief.mean_theta"])
    started = {}
    new_state = train.new_state

    def recording(model, *args):
        started.update({k: v.detach().clone() for k, v in model.state_dict().items()})
        return new_state(model, *args)

    monkeypatch.setattr(train, "new_state", recording)
    flag = "--" + field.replace("_", "-")
    assert train.main(["--preset", "config4_full", "--batch-size", "1", "--image-size", "32",
                       "--steps", "1", "--device", "cpu", flag, path]) == 0
    assert set(want) <= set(started)
    for k, v in want.items():
        np.testing.assert_array_equal(started[k].numpy(), v, err_msg=k)


def test_checkpoint_fields_are_taken():
    """The checkpoint and metrics fields are the reference's and are taken."""
    kw = dict(checkpoint_every=100, checkpoint_dir="ckpt", metrics_path="m.jsonl", tensorboard_dir="tb")
    cfg = dataclasses.replace(configs.CONFIG4_FULL, **kw)
    ref = dataclasses.replace(jconfigs.CONFIG4_FULL, **kw)
    assert _fields(cfg, kw) == _fields(ref, kw) == kw


@pytest.mark.parametrize("field, value", [
    ("lr_schedule", "linear"), ("steps_per_call", 0), ("ema_decay", 1.0),
])
def test_bad_optimizer_fields_are_refused(field, value):
    with pytest.raises(ValueError, match=field):
        dataclasses.replace(configs.CONFIG4_FULL, **{field: value})


_UNPORTED_PRESETS = set()
# Presets of the port alone: HMR 2.0's ViT and transformer head have no
# reference preset (tests/test_torch_hmr2.py holds them to the plain one).
_PORT_ONLY_PRESETS = {"hmr2_vith"}


def _fields(obj, names):
    return {n: getattr(obj, n) for n in names}


@pytest.mark.parametrize("name", sorted(set(configs.PRESETS) - _PORT_ONLY_PRESETS))
def test_presets_are_train_configs(name):
    """Each port preset carries the reference preset's fields: the run's,
    the encoder's, IEF's, the raster's and the synthetic stream's."""
    assert set(configs.PRESETS) - _PORT_ONLY_PRESETS == set(jconfigs.PRESETS) - _UNPORTED_PRESETS
    cfg, ref = configs.PRESETS[name], jconfigs.PRESETS[name]
    assert isinstance(cfg, configs.TrainConfig) and isinstance(cfg.model, net.ModelConfig)
    run = ("batch_size", "learning_rate", "lr_schedule", "warmup_steps", "grad_clip_norm",
           "weight_decay", "num_steps", "seed", "loss_weights", "log_every", "ema_decay",
           "steps_per_call")
    assert _fields(cfg, run) == _fields(ref, run)
    assert _fields(cfg.model, ("image_size", "smpl_impl", "raster_impl")) == _fields(
        ref.model, ("image_size", "smpl_impl", "raster_impl"))
    e = ("depth", "width", "fold_bn_eval")
    assert _fields(cfg.model.encoder, e) == _fields(ref.model.encoder, e)
    assert str(cfg.model.encoder.compute_dtype).removeprefix("torch.") == np.dtype(
        ref.model.encoder.compute_dtype).name
    i = ("num_iterations", "hidden_dims", "rotation_format", "num_cam")
    assert _fields(cfg.model.ief, i) == _fields(ref.model.ief, i)
    r = [f.name for f in dataclasses.fields(raster.RasterConfig)]
    assert _fields(cfg.model.raster, r) == _fields(ref.model.raster, r)
    sy = [f.name for f in dataclasses.fields(type(cfg.synthetic))]
    assert _fields(cfg.synthetic, sy) == _fields(ref.synthetic, sy)


# --- The update: clip, Adam/AdamW at the scheduled rate, EMA ---------------


class _Leaves(torch.nn.Module):
    """A few parameters of several shapes, for the update alone."""

    def __init__(self, arrays):
        super().__init__()
        self.p = torch.nn.ParameterList([torch.nn.Parameter(torch.from_numpy(a.copy())) for a in arrays])


def _optax_run(jcfg, params, grads):
    """The reference's update (its make_optimizer, then the EMA of its
    train_step) over the gradient sequence; params and EMA after each step."""
    opt = jtrain.make_optimizer(jcfg)
    p = {str(i): jnp.asarray(a) for i, a in enumerate(params)}
    state, ema, out = opt.init(p), dict(p), []
    for g in grads:
        u, state = opt.update({str(i): jnp.asarray(a) for i, a in enumerate(g)}, state, p)
        p = optax.apply_updates(p, u)
        d = jcfg.ema_decay
        ema = jax.tree.map(lambda e, q: d * e + (1.0 - d) * q, ema, p)
        out.append(([np.asarray(p[str(i)]) for i in range(len(params))],
                    [np.asarray(ema[str(i)]) for i in range(len(params))]))
    return out


UPDATE_CASES = {
    "adam": {},
    "adamw": dict(weight_decay=0.05),
    "cosine": dict(lr_schedule="cosine", warmup_steps=2, num_steps=5),
    "clip_hit": dict(grad_clip_norm=0.5),
    "clip_miss": dict(grad_clip_norm=1e3),
    "mixed_ema": dict(lr_schedule="cosine", warmup_steps=2, num_steps=5, grad_clip_norm=1.0,
                      weight_decay=0.01, ema_decay=0.9),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_matches_optax(case):
    """Six updates from the same parameters and gradients (numpy, seeded)
    against optax: the parameters and the EMA after every step at 1e-6
    absolute (parameters ~1, learning rate 1e-2)."""
    kw = dict(UPDATE_CASES[case], learning_rate=1e-2)
    kw.setdefault("ema_decay", 0.5)
    cfg = dataclasses.replace(configs.TrainConfig(), **kw)
    jcfg = dataclasses.replace(jconfigs.TrainConfig(), **kw)
    rng = np.random.RandomState(4)
    shapes = [(8, 4), (4,), (3, 3, 2)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) * 0.3 for s in shapes] for _ in range(6)]
    ref = _optax_run(jcfg, params, grads)
    ts = train.new_state(_Leaves(params), cfg)
    for step, g in enumerate(grads):
        for p, a in zip(ts.model.parameters(), g):
            p.grad = torch.from_numpy(a.copy())
        train.apply_update(ts, cfg)
        want_p, want_e = ref[step]
        for name, got, want in (("param", list(ts.model.parameters()), want_p),
                                ("ema", list(ts.ema.values()), want_e)):
            for a, b in zip(got, want):
                np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-6, err_msg=f"{case} step {step} {name}")


@pytest.mark.parametrize("warmup", [0, 3])
def test_lr_schedule_matches_optax(warmup):
    jcfg = jconfigs.TrainConfig(lr_schedule="cosine", warmup_steps=warmup, num_steps=8)
    cfg = configs.TrainConfig(lr_schedule="cosine", warmup_steps=warmup, num_steps=8)
    sched = optax.warmup_cosine_decay_schedule(0.0, 1.0, warmup, max(8, warmup + 1))
    for count in range(12):
        np.testing.assert_allclose(train.lr_factor(count, cfg), float(sched(count)), atol=1e-7)
    assert train.lr_factor(5, dataclasses.replace(cfg, lr_schedule="constant")) == 1.0
    assert jcfg.num_steps == cfg.num_steps


def test_cosine_first_update_has_lr_zero():
    """optax evaluates the schedule at the count before the increment: the
    first update leaves every parameter as it was (AdamW's decay too), the
    second moves them."""
    rng = np.random.RandomState(5)
    params = [rng.randn(6, 3).astype(np.float32), rng.randn(3).astype(np.float32)]
    cfg = configs.TrainConfig(lr_schedule="cosine", warmup_steps=2, num_steps=10,
                              weight_decay=0.1, learning_rate=1e-2)
    ts = train.new_state(_Leaves(params), cfg)
    for step in range(2):
        for p in ts.model.parameters():
            p.grad = torch.ones_like(p)
        train.apply_update(ts, cfg)
        same = all(np.array_equal(p.detach().numpy(), a) for p, a in zip(ts.model.parameters(), params))
        assert same == (step == 0), step


def test_clip_is_optax_form():
    """Below the limit the gradients are untouched (no multiply); above it
    each is g / norm * limit."""
    g = [torch.tensor([3.0, 4.0]), torch.tensor([0.0])]
    train.clip_by_global_norm(g, 10.0)
    assert torch.equal(g[0], torch.tensor([3.0, 4.0]))
    train.clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(g[0].numpy(), [3.0 / 5.0, 4.0 / 5.0], rtol=1e-7)


def _tiny_cfg(**kw):
    model = dataclasses.replace(
        _port_cfg().model, image_size=32, raster=raster.RasterConfig(image_size=32),
        encoder=enc.EncoderConfig(depth=18, width=8, compute_dtype=torch.float32),
        ief=ief.IEFConfig(hidden_dims=(16,), rotation_format="rot6d"),
    )
    return dataclasses.replace(configs.CONFIG4_MIXED, model=model, batch_size=2, **kw)


def test_steps_per_call_equals_single_calls(tiny_asset):
    """fit with steps_per_call=4 (a call of 4, then the remainder in one
    call of 2) takes the same steps as single calls, bitwise, and logs once
    per call that took a step at a log_every multiple, and at the end."""
    cfg = _tiny_cfg(num_steps=6, warmup_steps=2, ema_decay=0.9, log_every=2)
    logs = {1: [], 4: []}
    runs = {k: train.fit(dataclasses.replace(cfg, steps_per_call=k), asset=tiny_asset, device="cpu",
                         log=logs[k].append)[0] for k in (1, 4)}
    assert runs[1].step == runs[4].step == 6
    for (k, a), b in zip(runs[1].model.state_dict().items(), runs[4].model.state_dict().values()):
        assert torch.equal(a, b), k
    assert all(torch.equal(runs[1].ema[k], runs[4].ema[k]) for k in runs[1].ema)
    assert [r["step"] for r in logs[1]] == [0, 2, 4, 5]
    assert [r["step"] for r in logs[4]] == [3, 5]
    assert logs[1][-1] == logs[4][-1]


def test_direct_3d_weights_train(tiny_asset):
    """A step with the mixed recipe's 3D weights (j3d=5, rotmat=1,
    betas_l2=0.02) runs on the synthetic stream: make_batch emits the 3D
    targets when a j3d, v3d or rotmat weight is set, and only then."""
    cfg = _tiny_cfg(num_steps=1)
    consts = net.build_consts(tiny_asset, cfg.model, device="cpu")
    with_3d = train.make_batch(0, 0, 2, consts, cfg)
    assert {"gt_joints3d", "gt_verts", "gt_rotmats"} <= set(with_3d)
    assert with_3d["gt_rotmats"].shape == (2, 24, 3, 3) and with_3d["gt_verts"].shape == (2, 864, 3)
    plain = train.make_batch(0, 0, 2, consts, configs.CONFIG4_FULL)
    assert not {"gt_joints3d", "gt_verts", "gt_rotmats"} & set(plain)
    _, terms = train.fit(cfg, asset=tiny_asset, device="cpu")
    assert {"j3d", "rotmat", "betas_l2"} <= set(terms) and np.isfinite(terms["total"])


def test_ema_model_carries_ema_and_live_bn(tiny_asset, tmp_path):
    """`ema_model` of a live run and `load_model(ema=True)` of its checkpoint
    serve the EMA parameters with the live BN statistics."""
    cfg = _tiny_cfg(num_steps=2, ema_decay=0.5, checkpoint_every=2, checkpoint_dir=str(tmp_path))
    ts, _ = train.fit(cfg, asset=tiny_asset, device="cpu")
    m = train.ema_model(ts)
    for k, p in m.named_parameters():
        assert torch.equal(p, ts.ema[k]), k
    live = dict(ts.model.named_buffers())
    for k, b in m.named_buffers():
        assert torch.equal(b, live[k]), k
    assert any(not torch.equal(p, q) for p, q in zip(m.parameters(), ts.model.parameters()))
    with pytest.raises(ValueError, match="ema_decay"):
        train.ema_model(train.new_state(ts.model, dataclasses.replace(cfg, ema_decay=0.0)))
    loaded, _ = predict.load_model(cfg.model, asset=tiny_asset, device="cpu", ema=True,
                                   checkpoint_dir=str(tmp_path))
    for (k, p), q in zip(m.state_dict().items(), loaded.state_dict().values()):
        assert torch.equal(p, q), k


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


def test_cli_optimizer_flags(capsys):
    """The optimizer menu from the CLI: config4_mixed (ResNet-34, full
    width) at a small batch and image size, AdamW, cosine, clipping, EMA,
    two steps in one call, a loss-weight override; then the refusals."""
    assert train.main([
        "--preset", "config4_mixed", "--steps", "2", "--batch-size", "1", "--image-size", "32",
        "--lr-schedule", "cosine", "--warmup-steps", "1", "--grad-clip", "1.0",
        "--weight-decay", "1e-4", "--ema-decay", "0.9", "--steps-per-call", "2",
        "--loss-weight", "v3d=1", "--log-every", "1", "--synthetic", "pose_std=0.2",
        "--device", "cpu",
    ]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [r["step"] for r in lines] == [1]
    assert {"j3d", "v3d", "rotmat", "betas_l2"} <= set(lines[0]) and np.isfinite(lines[0]["total"])
    for bad in (["--loss-weight", "nope=1"], ["--steps-per-call", "0"], ["--ema-decay", "1.5"],
                ["--synthetic", "targets=medium"], ["--synthetic", "nope=1"]):
        with pytest.raises(SystemExit):
            train.main(["--steps", "1", "--device", "cpu", *bad])


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
        lambda: evaluate.main(["--batches", "1"]),
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
