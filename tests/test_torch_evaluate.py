"""PyTorch port, evaluation on the synthetic stream: each metric against the
reference's on the same numpy inputs, `_batch_metrics` against the
reference's on the same batch (the reference's own batch injected, and the
port's render of the reference's draws), `evaluate`'s determinism, and the
CLI: a checkpoint, a step of it, its EMA and the hard suite, and the
refusals.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu import configs as jconfigs
from indirect_learning_pose_shape_tpu import evaluate as jeval
from indirect_learning_pose_shape_tpu.data import synthetic as jsyn
from indirect_learning_pose_shape_tpu.models import encoder as jenc
from indirect_learning_pose_shape_tpu.models import ief as jief
from indirect_learning_pose_shape_tpu.models import network as jnet
from indirect_learning_pose_shape_tpu.ops import raster as jraster
from indirect_learning_pose_shape_tpu_torch import configs, evaluate, predict, train
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.utils import convert

SIZE, BATCH = 64, 3
THRESHOLDED = ("sil_iou", "part_acc", "miou")


def _points(seed, n=19):
    rng = np.random.RandomState(seed)
    gt = rng.randn(4, n, 3).astype(np.float32)
    pred = (gt + 0.1 * rng.randn(4, n, 3)).astype(np.float32)
    return pred, gt


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("name", ["pve", "mpjpe", "pa_mpjpe", "procrustes_align"])
def test_3d_metric_matches_jax(name):
    pred, gt = _points(0)
    want = np.asarray(getattr(jeval, name)(jnp.asarray(pred), jnp.asarray(gt)))
    got = getattr(evaluate, name)(*_t(pred, gt)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_procrustes_undoes_a_similarity_and_fixes_reflections():
    """A rotated, scaled, shifted copy aligns back onto the original; a
    mirrored copy cannot (the rotation keeps det +1, as the reference's
    reflection fix makes it), and the port matches JAX there too."""
    rng = np.random.RandomState(1)
    gt = rng.randn(2, 24, 3).astype(np.float32)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    q *= np.sign(np.linalg.det(q))  # a proper rotation
    moved = (1.7 * gt @ q.T + np.array([0.3, -0.2, 1.0])).astype(np.float32)
    aligned = evaluate.procrustes_align(*_t(moved, gt)).numpy()
    np.testing.assert_allclose(aligned, gt, atol=1e-4)
    mirrored = (gt * np.array([-1.0, 1.0, 1.0])).astype(np.float32)
    got = evaluate.procrustes_align(*_t(mirrored, gt)).numpy()
    want = np.asarray(jeval.procrustes_align(jnp.asarray(mirrored), jnp.asarray(gt)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.abs(got - gt).max() > 0.1  # a reflection is not undone
    err = float(evaluate.pa_mpjpe(*_t(mirrored, gt)))
    np.testing.assert_allclose(err, float(jeval.pa_mpjpe(jnp.asarray(mirrored), jnp.asarray(gt))), rtol=1e-5)


def test_silhouette_iou_matches_jax():
    rng = np.random.RandomState(2)
    pred = rng.rand(3, 16, 16).astype(np.float32)
    tgt = (rng.rand(3, 16, 16) > 0.6).astype(np.float32)
    pred[2], tgt[2] = 0.0, 0.0  # an empty union scores 0
    want = float(jeval.silhouette_iou_metric(jnp.asarray(pred), jnp.asarray(tgt)))
    np.testing.assert_allclose(float(evaluate.silhouette_iou_metric(*_t(pred, tgt))), want, rtol=1e-6)


def test_part_metrics_matches_jax():
    rng = np.random.RandomState(3)
    probs = rng.rand(2, 16, 16, 6).astype(np.float32)
    probs[..., 4] = 0.0  # class 4 never predicted...
    labels = rng.randint(0, 4, (2, 16, 16)).astype(np.int32)  # ...nor labelled: absent
    want = jeval.part_metrics(jnp.asarray(probs), jnp.asarray(labels))
    got = evaluate.part_metrics(*_t(probs, labels))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


@pytest.fixture(scope="module")
def reference(tiny_asset):
    """The reference's model (seeded, output layer small enough to keep the
    bodies in frame), its batch from key 7 with the draws it was made from,
    and its `_batch_metrics` on that batch (running-statistics BN, its
    default separable raster, float32 on the CPU)."""
    jmodel = jnet.ModelConfig(
        image_size=SIZE,
        encoder=jenc.EncoderConfig(depth=18, width=16, compute_dtype=jnp.float32),
        ief=jief.IEFConfig(hidden_dims=(128,)),
        raster=jraster.RasterConfig(image_size=SIZE, num_parts=24),
    )
    jcfg = jconfigs.TrainConfig(model=jmodel, batch_size=BATCH)
    params, state, jconsts = jnet.init(jax.random.PRNGKey(0), tiny_asset, jmodel)
    params, state = jax.tree.map(np.asarray, (params, state))
    last = params["ief"]["layers"][-1]
    last["w"] = (np.random.RandomState(0).randn(*last["w"].shape) * 2e-4).astype(np.float32)
    key = jax.random.PRNGKey(7)
    batch = jax.tree.map(np.asarray, jax.jit(
        lambda k: jsyn.generate_batch(k, BATCH, jconsts, jmodel, jcfg.synthetic))(key))
    metrics = jax.jit(lambda p, s, b: jeval._batch_metrics(p, s, jconsts, b, jcfg))(params, state, batch)
    k_theta, k_noise, k_vis = jax.random.split(key, 3)
    pose, betas, cam = jsyn.sample_theta(k_theta, BATCH, jconsts, jcfg.synthetic)
    draws = {
        "pose": pose, "betas": betas, "cam": cam,
        "noise": jax.random.normal(k_noise, (BATCH, SIZE, SIZE, 3)),
        "vis_u": jax.random.uniform(k_vis, (BATCH, 19)),
    }
    draws = {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}
    return params, state, batch, draws, {k: float(v) for k, v in metrics.items()}


def _port(tiny_asset, params, state):
    model = net.ModelConfig(
        image_size=SIZE,
        encoder=enc.EncoderConfig(depth=18, width=16, compute_dtype=torch.float32),
        ief=ief.IEFConfig(hidden_dims=(128,)),
        raster=raster.RasterConfig(image_size=SIZE, num_parts=24),
    )
    cfg = configs.TrainConfig(model=model, batch_size=BATCH)
    m, consts = net.init(tiny_asset, model, seed=1, device="cpu")
    convert.load_jax_params(m, params, state)
    return m, consts, cfg


# Tolerances: on the injected batch both sides see the same inputs, so the
# continuous metrics agree to float32 rounding (1e-5 relative; 1e-6
# measured) and the thresholded ones to a flipped boundary pixel (2e-3
# absolute; 0 measured). On the port's render of the reference's draws the
# inputs differ where bf16 rounding ties decide a label and by the palette
# mix's rounding (image within 1e-2, test_torch_synthetic.py): 1e-2
# absolute and 1e-3 relative (2e-5 measured).
@pytest.mark.parametrize("source, abs_tol, rel_tol", [
    ("injected", 2e-3, 1e-5), ("rendered", 1e-2, 1e-3),
])
def test_batch_metrics_match_jax(tiny_asset, reference, source, abs_tol, rel_tol):
    params, state, jbatch, draws, want = reference
    model, consts, cfg = _port(tiny_asset, params, state)
    if source == "injected":
        batch = {k: torch.from_numpy(v) for k, v in jbatch.items()}
    else:
        batch = synthetic.render_batch(draws, consts, cfg.model, cfg.synthetic)
    got = {k: float(v) for k, v in evaluate._batch_metrics(model, consts, batch, cfg).items()}
    assert set(got) == set(want)
    assert want["sil_iou"] > 0.05 and want["pve"] > 0  # bodies in frame, a real error
    for k, w in want.items():
        tol = abs_tol if k in THRESHOLDED else rel_tol * abs(w)
        assert abs(got[k] - w) <= tol, f"{source} {k}: port {got[k]} vs reference {w}"


def test_evaluate_is_deterministic(tiny_asset, reference):
    params, state, *_ = reference
    model, consts, cfg = _port(tiny_asset, params, state)
    a, b = (evaluate.evaluate(model, consts, cfg, num_batches=2, seed=5) for _ in range(2))
    c = evaluate.evaluate(model, consts, cfg, num_batches=2, seed=6)
    assert a == b and a != c
    assert set(a) == {"sil_iou", "part_acc", "miou", "kp_err_px", "pve", "mpjpe", "pa_mpjpe"}
    assert all(isinstance(v, float) and np.isfinite(v) for v in a.values())


def test_cli_prints_metrics(capsys):
    """The CLI on the CPU: full-width ResNet-18 on the SMPL-sized asset at a
    small batch and image size, the plain suite and an override."""
    assert evaluate.main([
        "--preset", "config4_full", "--batches", "1", "--batch-size", "1", "--image-size", "32",
        "--eval-suite", "plain", "--synthetic", "pose_std=0.2", "--device", "cpu",
    ]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) == {"sil_iou", "part_acc", "miou", "kp_err_px", "pve", "mpjpe", "pa_mpjpe"}


_SMALL = ["--preset", "config4_full", "--batch-size", "1", "--image-size", "32", "--device", "cpu"]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A 2-step config4_full run (full-width ResNet-18, batch 1, 32²) with an
    EMA, checkpointed after each step."""
    d = str(tmp_path_factory.mktemp("run"))
    assert train.main([*_SMALL, "--steps", "2", "--checkpoint-every", "1", "--checkpoint-dir", d,
                       "--ema-decay", "0.5", "--lr", "1e-2", "--log-every", "1"]) == 0
    return d


@pytest.mark.parametrize("flags", [
    ["--checkpoint"], ["--checkpoint", "--step", "1"], ["--checkpoint", "--ema"],
    ["--checkpoint", "--eval-suite", "hard"],
])
def test_cli_scores_a_checkpoint(flags, run_dir, capsys):
    """--checkpoint (the latest step), --step, --ema and --eval-suite hard
    print what `evaluate` reads of `predict.load_model` of that checkpoint."""
    argv = [x for f in flags for x in ((f, run_dir) if f == "--checkpoint" else (f,))]
    capsys.readouterr()
    assert evaluate.main([*_SMALL, "--batches", "1", *argv]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cfg, _ = evaluate.eval_config(configs.CONFIG4_FULL, 1, 32, "hard" if "hard" in flags else None)
    step = 1 if "--step" in flags else None
    model, consts = predict.load_model(cfg.model, device="cpu", ema="--ema" in flags,
                                       checkpoint_dir=run_dir, step=step)
    want = evaluate.evaluate(model, consts, cfg, num_batches=1)
    assert got == {k: round(v, 5) for k, v in want.items()}


def test_cli_checkpoint_models_differ(run_dir):
    """The checkpoint's steps and its EMA are different models."""
    cfg = evaluate.eval_config(configs.CONFIG4_FULL, 1, 32)[0].model
    params = {
        label: dict(predict.load_model(cfg, device="cpu", checkpoint_dir=run_dir, **kw)[0].named_parameters())
        for label, kw in (("latest", {}), ("step 1", {"step": 1}), ("ema", {"ema": True}))
    }
    for a, b in (("latest", "step 1"), ("latest", "ema")):
        assert any(not torch.equal(p, params[b][k]) for k, p in params[a].items()), (a, b)


@pytest.mark.parametrize("flags, item", [
    (["--int8"], "item 17"), (["--qparams", "q.npz"], "item 17"), (["--int8-impl", "int8c"], "item 17"),
])
def test_cli_refusals_name_their_item(flags, item, capsys):
    with pytest.raises(SystemExit):
        evaluate.main(["--device", "cpu", *flags])
    assert item in capsys.readouterr().err


@pytest.fixture(scope="module")
def disk_data(tmp_path_factory, tiny_asset):
    """A 4-example dataset at 48² (with gt_pose and gt_betas) and the same
    as an image directory."""
    from indirect_learning_pose_shape_tpu_torch.data import dataset, image_dir

    d = tmp_path_factory.mktemp("disk")
    arrays = dataset.make_synthetic_dataset(str(d / "d.npz"), 4, source_size=48, asset=tiny_asset, device="cpu")
    image_dir.export_image_dir(arrays, str(d / "imgs"))
    return d


@pytest.mark.parametrize("flag, path, metrics", [
    ("--dataset", "d.npz", {"sil_iou", "part_acc", "miou", "kp_err_px", "pve", "mpjpe", "pa_mpjpe"}),
    ("--image-dir", "imgs", {"sil_iou", "part_acc", "miou", "kp_err_px"}),
])
def test_cli_scores_disk_data(disk_data, flag, path, metrics, capsys):
    """--dataset scores a dataset file (the 3D metrics from its gt_pose and
    gt_betas) and --image-dir an image directory (image-space metrics)."""
    capsys.readouterr()
    assert evaluate.main([*_SMALL, "--batches", "2", flag, str(disk_data / path)]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == metrics and all(np.isfinite(v) for v in got.values())
