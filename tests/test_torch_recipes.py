"""PyTorch port, the recorded recipes (`tools/recipe_parity.py`): each
recipe's config against the reference's preset with the same overrides,
each record against its source in the repo, the cosine schedule at the
recipes' horizons against optax's, the synthetic stream's law against the
reference's `sample_theta`, and the tool end to end on the CPU at a small
size (tiny asset, width 8, 64², 3 steps, 1 seed x 1 batch, the separable
route) with the bar's verdict.
"""

import dataclasses
import json
import re
import types
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
from scipy import stats

from indirect_learning_pose_shape_tpu import configs as jconfigs
from indirect_learning_pose_shape_tpu.data import synthetic as jsyn
from indirect_learning_pose_shape_tpu_torch import train
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.tools import recipe_parity as rp

REPO = Path(__file__).resolve().parents[1]

# The reference's side of each recipe: its preset and the overrides its
# `train` command line applies.
_INDIRECT = dict(num_steps=5000, learning_rate=3e-4, lr_schedule="cosine", grad_clip_norm=1.0)
REFERENCE = {
    "r34_indirect_5k": ("config4_r34", _INDIRECT, {"shape_reg": 3e-3}),
    "large_indirect_5k": ("config4_large", _INDIRECT, {"shape_reg": 3e-3}),
    "mixed_20k": ("config4_mixed", {}, {}),
}


def _fields(obj, names):
    return {n: getattr(obj, n) for n in names}


def _reference_config(name, seed, raster_impl):
    preset, updates, weights = REFERENCE[name]
    ref = jconfigs.PRESETS[preset]
    lw = tuple((k, weights.get(k, v)) for k, v in ref.loss_weights)
    ref = dataclasses.replace(ref, seed=seed, loss_weights=lw, **updates)
    return dataclasses.replace(ref, model=dataclasses.replace(ref.model, raster_impl=raster_impl))


@pytest.mark.parametrize("name", sorted(rp.RECIPES))
def test_recipe_config_is_the_references(name):
    """The tool's config (`train.parse_config` on the recipe's command line)
    carries the reference preset's fields with the recipe's overrides, field
    by field, at another seed and on the separable control route too."""
    for seed, impl in ((0, "auto"), (2, "separable")):
        cfg, ref = rp.recipe_config(rp.RECIPES[name], seed, impl), _reference_config(name, seed, impl)
        run = ("batch_size", "learning_rate", "lr_schedule", "warmup_steps", "grad_clip_norm",
               "weight_decay", "num_steps", "seed", "loss_weights", "log_every", "ema_decay",
               "steps_per_call")
        assert _fields(cfg, run) == _fields(ref, run)
        assert _fields(cfg.model, ("image_size", "smpl_impl", "raster_impl")) == _fields(
            ref.model, ("image_size", "smpl_impl", "raster_impl"))
        e = ("depth", "width", "fold_bn_eval")
        assert _fields(cfg.model.encoder, e) == _fields(ref.model.encoder, e)
        i = ("num_iterations", "hidden_dims", "rotation_format", "num_cam")
        assert _fields(cfg.model.ief, i) == _fields(ref.model.ief, i)
        r = [f.name for f in dataclasses.fields(raster.RasterConfig)]
        assert _fields(cfg.model.raster, r) == _fields(ref.model.raster, r)
        sy = [f.name for f in dataclasses.fields(type(cfg.synthetic))]
        assert _fields(cfg.synthetic, sy) == _fields(ref.synthetic, sy)
    # What `train.main` trains with: the same parse, `--steps` folded by fit.
    args, cfg = train.parse_config(list(rp.RECIPES[name].argv))
    assert dataclasses.replace(cfg, num_steps=args.steps or cfg.num_steps) == rp.recipe_config(rp.RECIPES[name])


def _baseline_lines(span):
    lo, hi = map(int, span.split("-"))
    return (REPO / "BASELINE.md").read_text().splitlines()[lo - 1:hi]


def _num(text):
    return float(re.search(r"[\d.]+", text).group(0))


@pytest.mark.parametrize("name", sorted(rp.RECIPES))
def test_records_equal_their_sources(name):
    """Each record the tool carries is its source's: the `quality_eval`
    JSON in the repo, or the BASELINE.md lines it cites."""
    recipe = rp.RECIPES[name]
    record = recipe.record()
    assert set(record) == set(recipe.suites)
    path, _, span = recipe.source.partition(":")
    if path.endswith(".json"):
        want = json.loads((REPO / path).read_text())["metrics"]
        assert record["plain"] == {k: (v["mean"], v["pm"]) for k, v in want.items()}
    elif name == "large_indirect_5k":
        text = " ".join(_baseline_lines(span))
        pve, pm = re.search(r"PVE ([\d.]+) ±([\d.]+)", text).groups()
        want = {"pve": (float(pve), float(pm))}
        for k, label in (("sil_iou", "sil IoU"), ("pa_mpjpe", "PA-MPJPE"), ("miou", "mIoU"),
                         ("kp_err_px", "kp")):
            want[k] = (float(re.search(rf"{label} ([\d.]+)", text).group(1)), None)
        assert record["plain"] == want
    else:
        rows = {}
        for line in _baseline_lines(span):
            cells = [c.strip().strip("*") for c in line.strip("|").split("|")]
            assert "config4_mixed" in cells[0] or cells[0] == "(same)", line
            pve, pm = re.search(r"([\d.]+) ±([\d.]+)", cells[3]).groups()
            rows[cells[2]] = {"pve": (float(pve), float(pm)), "sil_iou": (_num(cells[4]), None),
                              "miou": (_num(cells[5]), None), "kp_err_px": (_num(cells[6]), None),
                              "pa_mpjpe": (_num(cells[7]), None)}
        assert record == rows


@pytest.mark.parametrize("count, horizon", [(0, 5000), (200, 5000), (2500, 5000), (4999, 5000),
                                            (19999, 20000)])
def test_lr_factor_matches_optax(count, horizon):
    """The port's rate at update `count` of a recipe's horizon is the
    reference's `warmup_cosine_decay_schedule` (train.make_optimizer)."""
    cfg = rp.recipe_config(rp.RECIPES["mixed_20k" if horizon == 20000 else "r34_indirect_5k"])
    assert cfg.num_steps == horizon and cfg.lr_schedule == "cosine"
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=cfg.learning_rate, warmup_steps=cfg.warmup_steps,
        decay_steps=max(cfg.num_steps, cfg.warmup_steps + 1))
    want = float(sched(count))
    got = train.lr_factor(count, cfg) * cfg.learning_rate
    # optax computes the factor in float32: one ulp of 1 of the peak rate.
    assert got == pytest.approx(want, rel=1e-6, abs=2**-23 * cfg.learning_rate)


def test_stream_law_matches_reference():
    """4096 rows of `synthetic.sample_draws` against 4096 of the reference's
    `sample_theta` (eager jax.random): per column, the means and standard
    deviations of the pose, global orientation, betas, camera scale and
    translation agree within 4 standard errors, and a two-sample KS test on
    the camera scale gives p > 1e-3."""
    n, cfg = 4096, synthetic.SyntheticConfig()
    sy = [f.name for f in dataclasses.fields(cfg)]
    assert _fields(cfg, sy) == _fields(jsyn.SyntheticConfig(), sy)
    # What the draws read of the consts: SMPL's 24 joints, 10 betas, 19 keypoints.
    smpl = types.SimpleNamespace(num_joints=24, num_betas=10, cocoplus_regressor=torch.zeros(19, 1))
    got = synthetic.sample_draws(torch.Generator().manual_seed(0), n, types.SimpleNamespace(smpl=smpl), cfg, 1)
    pose, betas, cam = jsyn.sample_theta(jax.random.PRNGKey(0), n, types.SimpleNamespace(smpl=smpl), cfg)
    ours = {"global": got["pose"][:, :3], "pose": got["pose"][:, 3:], "betas": got["betas"],
            "scale": got["cam"][:, :1], "trans": got["cam"][:, 1:]}
    theirs = {"global": pose[:, :3], "pose": pose[:, 3:], "betas": betas, "scale": cam[:, :1],
              "trans": cam[:, 1:]}
    for k in ours:
        a, b = ours[k].double().numpy(), np.asarray(theirs[k], np.float64)
        assert a.shape == b.shape, k
        ma, mb, sa, sb = a.mean(0), b.mean(0), a.std(0), b.std(0)
        se_mean = np.sqrt((sa**2 + sb**2) / n)
        # The standard error of a standard deviation from the fourth moment.
        m4a, m4b = ((a - ma) ** 4).mean(0), ((b - mb) ** 4).mean(0)
        se_std = np.sqrt((m4a - sa**4) / (4 * sa**2 * n) + (m4b - sb**4) / (4 * sb**2 * n))
        assert np.all(np.abs(ma - mb) < 4 * se_mean), (k, np.abs(ma - mb) / se_mean)
        assert np.all(np.abs(sa - sb) < 4 * se_std), (k, np.abs(sa - sb) / se_std)
    assert stats.ks_2samp(ours["scale"].numpy()[:, 0], np.asarray(theirs["scale"])[:, 0]).pvalue > 1e-3


def _small(cfg):
    m = cfg.model
    m = dataclasses.replace(m, image_size=64, encoder=dataclasses.replace(m.encoder, width=8),
                            raster=dataclasses.replace(m.raster, image_size=64))
    return dataclasses.replace(cfg, model=m, batch_size=1, log_every=1)


@pytest.fixture
def one_thread():
    """One torch thread: this model's many small ops, each split over every
    core while other test workers hold the cores, run ~25x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tool_end_to_end_and_the_bar(tiny_asset, monkeypatch, one_thread):
    """r34_indirect_5k for 3 steps at width 8, 64², batch 1 on the CPU, on
    the separable control route (the kernel route's plain twin on the CPU
    is the pairwise raster, ~15x the cost), scored on 1 seed x 1 batch: a
    JSON line with every metric beside the
    record, the eager route named, the verdict flipping when the record
    moves past the bar, the mean over seeds holding PVE to the seed
    half-range when it exceeds the bar; and the CLI refuses to run without
    CUDA unless the CPU is asked for."""
    line = rp.run(rp.RECIPES["r34_indirect_5k"], 0, "separable", 3, "cpu", asset=tiny_asset, shrink=_small,
                  eval_seeds=(123,), batches=1)
    line = json.loads(json.dumps(line))
    assert line["route"] == "fit: eager fused_step (CPU)" and line["device"] == "cpu"
    assert line["raster_impl"] == "separable"
    assert line["steps"] == 3 and line["last_step"] == 2 and line["argv"][-2:] == ["--seed", "0"]
    metrics = line["suites"]["plain"]["metrics"]
    assert set(metrics) == {"kp_err_px", "miou", "mpjpe", "pa_mpjpe", "part_acc", "pve", "sil_iou"}
    for k, m in metrics.items():
        assert np.isfinite(m["mean"]) and m["pm"] == 0.0 and m["diff"] == pytest.approx(m["mean"] - m["ref"])
    summary = {k: {"mean": m["mean"], "pm": m["pm"]} for k, m in metrics.items()}
    at = {k: (m["mean"], None) for k, m in summary.items()}
    assert rp.judge(summary, at)["verdict"] == "meets"
    for k, bar in rp.BARRED.items():
        moved = {**at, k: (summary[k]["mean"] + 1.01 * bar, None)}
        assert rp.judge(summary, moved)["verdict"] == "misses"
        assert rp.judge(summary, {**at, k: (summary[k]["mean"] + 0.99 * bar, None)})["verdict"] == "meets"
    # Over seeds: a PVE half-range above the bar widens the PVE bar to it
    # plus the record's pm.
    ref = {**at, "pve": (summary["pve"]["mean"], 0.0005)}
    recipe = dataclasses.replace(rp.RECIPES["r34_indirect_5k"], record=lambda: {"plain": ref})
    other = json.loads(json.dumps(line))
    other["suites"]["plain"]["metrics"]["pve"]["mean"] += 0.006
    mean = rp.over_seeds([line, other], recipe)["suites"]["plain"]
    assert mean["pve_bar_from_seeds"] and mean["pve_bar"] == pytest.approx(0.0035)
    assert mean["metrics"]["pve"]["diff"] == pytest.approx(0.003) and mean["verdict"] == "meets"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rp.main(["r34_indirect_5k"])
