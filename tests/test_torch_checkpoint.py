"""PyTorch port, checkpoints and resume (`utils/checkpoint.py`,
`train.fit`'s checkpointing): the saved state round-trips bitwise; a run
that crashed after a checkpoint, or was extended, resumes to the straight
run's state bitwise on the CPU; the final save on an uneven budget, the
refusal of a stale directory, `max_to_keep`, the warning when a call spans
checkpoints; and `predict.load_model`'s partial restore.
"""

import dataclasses
import os

import pytest
import torch

from indirect_learning_pose_shape_tpu_torch import configs, predict, train
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.utils.checkpoint import Checkpointer


def _cfg(directory, **kw):
    """config4_robust (hard targets, appearance, cosine, clip, the 3D
    weights) with an EMA, narrow, at 32² and batch 2."""
    model = dataclasses.replace(
        configs.CONFIG4_ROBUST.model, image_size=32, raster=raster.RasterConfig(image_size=32),
        encoder=enc.EncoderConfig(depth=18, width=8, compute_dtype=torch.float32),
        ief=ief.IEFConfig(hidden_dims=(16,), rotation_format="rot6d"),
    )
    kw = {"num_steps": 6, "warmup_steps": 2, "ema_decay": 0.9, "checkpoint_every": 2,
          "checkpoint_dir": str(directory), **kw}
    return dataclasses.replace(configs.CONFIG4_ROBUST, model=model, batch_size=2, **kw)


def _assert_same(a, b, where=""):
    """Bitwise equality of two nested state dicts."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


def _assert_same_run(a: train.TrainState, b: train.TrainState):
    assert a.step == b.step and a.seed == b.seed
    _assert_same(train.state_dict(a), train.state_dict(b))


def test_state_round_trips_bitwise(tiny_asset, tmp_path):
    """save → restore gives every field back (parameters, the BN running
    statistics, Adam moments and counts, the schedule, the EMA, step, seed),
    and loading it into a fresh state rebuilds the run."""
    cfg = _cfg(tmp_path / "run", checkpoint_every=0, num_steps=2)
    ts, _ = train.fit(cfg, asset=tiny_asset, device="cpu")
    saved = train.state_dict(ts)
    assert saved["scheduler"] is not None and saved["ema"] is not None
    assert any(k.endswith(".var") for k in saved["model"])  # the BN running statistics
    assert all("exp_avg_sq" in v for v in saved["optimizer"]["state"].values())
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(2, saved, wait=True)
    _assert_same(ckpt.restore(), saved)
    fresh, _ = train.init_state(cfg, tiny_asset, "cpu")
    train.load_state_dict(fresh, ckpt.restore(2))
    _assert_same_run(fresh, ts)
    assert fresh.scheduler.get_last_lr() == ts.scheduler.get_last_lr()


@pytest.mark.parametrize("how", ["crash", "extend"])
def test_resume_equals_straight_run(tiny_asset, tmp_path, how, monkeypatch):
    """A run checkpointed every 2 steps that stops at step 4 (a crash in the
    batch of step 4, of a 6-step budget; or a 4-step budget at a constant
    learning rate, then extended to 6) and resumes to 6 ends bitwise where a
    straight 6-step run ends: the batch of step i depends only on (seed, i)."""
    extra = {"lr_schedule": "constant"} if how == "extend" else {}
    cfg = _cfg(tmp_path / "split", **extra)
    if how == "crash":
        make_batch = train.make_batch

        def crash(seed, step, *args):
            if step == 4:
                raise RuntimeError("simulated crash")
            return make_batch(seed, step, *args)

        monkeypatch.setattr(train, "make_batch", crash)
        with pytest.raises(RuntimeError, match="simulated crash"):
            train.fit(cfg, asset=tiny_asset, device="cpu")
        monkeypatch.setattr(train, "make_batch", make_batch)
    else:
        train.fit(cfg, num_steps=4, asset=tiny_asset, device="cpu")
    assert Checkpointer(cfg.checkpoint_dir).latest_step() == 4
    resumed, terms = train.fit(cfg, asset=tiny_asset, device="cpu")
    straight, want = train.fit(_cfg(tmp_path / "straight", **extra), asset=tiny_asset, device="cpu")
    _assert_same_run(resumed, straight)
    assert terms == want
    assert sorted(os.listdir(cfg.checkpoint_dir)) == ["2", "4", "6"]


def test_final_save_and_stale_directory(tiny_asset, tmp_path):
    """A 3-step budget at checkpoint_every=2 saves steps 2 and 3; a second
    run to the same budget is refused instead of training zero steps."""
    cfg = _cfg(tmp_path, num_steps=3)
    ts, _ = train.fit(cfg, asset=tiny_asset, device="cpu")
    assert Checkpointer(str(tmp_path))._steps() == [2, 3]
    _assert_same(Checkpointer(str(tmp_path)).restore()["model"], ts.model.state_dict())
    with pytest.raises(ValueError, match="already holds step 3"):
        train.fit(cfg, asset=tiny_asset, device="cpu")


def test_call_spanning_checkpoints_warns(tiny_asset, tmp_path, capsys):
    """steps_per_call > checkpoint_every: warned, and a save lands at each
    call that crosses a boundary, named by the global step."""
    cfg = _cfg(tmp_path, num_steps=5, checkpoint_every=2, steps_per_call=3)
    train.fit(cfg, asset=tiny_asset, device="cpu")
    assert "steps_per_call=3 > checkpoint_every=2" in capsys.readouterr().err
    assert Checkpointer(str(tmp_path))._steps() == [3, 5]


def test_checkpointer_keeps_the_latest_and_ignores_partial_writes(tmp_path):
    ckpt = Checkpointer(str(tmp_path), max_to_keep=3)
    assert ckpt.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore()
    for step in range(1, 6):
        ckpt.save(step, {"x": torch.full((2,), float(step)), "step": step})
    ckpt.close()
    assert ckpt._steps() == [3, 4, 5]
    os.makedirs(tmp_path / "9")
    (tmp_path / "9" / ".state.pt.tmp").write_bytes(b"half")  # a save cut off mid-write
    assert ckpt.latest_step() == 5
    assert torch.equal(ckpt.restore(4)["x"], torch.full((2,), 4.0))
    assert ckpt.restore_partial(["step"], 3) == {"step": 3}
    with pytest.raises(KeyError, match="lacks keys"):
        ckpt.restore_partial(["ema"])
    with pytest.raises(FileNotFoundError):
        ckpt.restore(1)


def test_load_model_is_optimizer_independent(tiny_asset, tmp_path):
    """A clip + AdamW + cosine run's checkpoint loads for serving under a
    plain-Adam configuration (only the model and the EMA are read), its EMA
    with ema=True; a full resume under another optimizer menu is refused, and
    a checkpoint without an EMA refuses ema=True."""
    cfg = _cfg(tmp_path / "adamw", num_steps=2, weight_decay=0.01)
    ts, _ = train.fit(cfg, asset=tiny_asset, device="cpu")
    model, _ = predict.load_model(cfg.model, asset=tiny_asset, device="cpu", checkpoint_dir=cfg.checkpoint_dir)
    _assert_same(model.state_dict(), ts.model.state_dict())
    ema, _ = predict.load_model(cfg.model, asset=tiny_asset, device="cpu", ema=True,
                                checkpoint_dir=cfg.checkpoint_dir, step=2)
    _assert_same(dict(ema.named_parameters()), ts.ema)
    plain = dataclasses.replace(cfg, weight_decay=0.0, lr_schedule="constant", grad_clip_norm=0.0, num_steps=4)
    with pytest.raises(ValueError, match="scheduler"):
        train.fit(plain, asset=tiny_asset, device="cpu")
    no_ema = _cfg(tmp_path / "no_ema", num_steps=2, ema_decay=0.0)
    train.fit(no_ema, asset=tiny_asset, device="cpu")
    with pytest.raises(ValueError, match="holds no EMA"):
        predict.load_model(cfg.model, asset=tiny_asset, device="cpu", ema=True, checkpoint_dir=no_ema.checkpoint_dir)
    with pytest.raises(ValueError, match="needs a checkpoint_dir"):
        predict.load_model(cfg.model, asset=tiny_asset, device="cpu", ema=True)
