"""PyTorch port, the quality protocol (`tools/quality_eval.py`): the CLI on
the CPU over 3 seeds × 1 batch on each suite, scoring a checkpoint's EMA;
each seed's metrics are `evaluate`'s, the summary's mean and `pm` (half the
range) are those of the seeds; and the int8 flags (`--int8`,
`--int8-impl`, `--keep-bf16`) scoring the quantized encoder.
"""

import json
import re

import pytest

from indirect_learning_pose_shape_tpu_torch import configs, evaluate, predict, train
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.tools import quality_eval

_SMALL = ["--preset", "config4_full", "--batch-size", "1", "--image-size", "32", "--device", "cpu"]
SEEDS = [123, 231, 312]


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A 2-step config4_full run (full-width ResNet-18, batch 1, 32²) with an
    EMA, checkpointed at its end."""
    d = str(tmp_path_factory.mktemp("run"))
    assert train.main([*_SMALL, "--steps", "2", "--checkpoint-every", "2", "--checkpoint-dir", d,
                       "--ema-decay", "0.5", "--lr", "1e-2"]) == 0
    return d


@pytest.mark.parametrize("suite", ["plain", "hard", "hardapp"])
def test_cli_three_seeds(suite, run_dir, capsys):
    capsys.readouterr()
    assert quality_eval.main([*_SMALL, "--checkpoint", run_dir, "--ema", "--eval-suite", suite,
                              "--batches", "1", "--seeds", *map(str, SEEDS)]) == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert out["seeds"] == SEEDS and out["ema"] and out["eval_suite"] == suite and out["batches"] == 1
    assert out["synthetic"] == (list(synthetic.EVAL_SUITES[suite]) or None)
    per_seed = {int(m.group(1)): json.loads(m.group(2))
                for m in re.finditer(r"^seed (\d+): (\{.*\})$", captured.err, re.M)}
    assert sorted(per_seed) == SEEDS
    cfg, _ = evaluate.eval_config(configs.CONFIG4_FULL, 1, 32, suite)
    model, consts = predict.load_model(cfg.model, device="cpu", ema=True, checkpoint_dir=run_dir)
    want = evaluate.evaluate(model, consts, cfg, num_batches=1, seed=SEEDS[1])
    assert per_seed[SEEDS[1]] == {k: round(v, 5) for k, v in want.items()}
    assert set(out["metrics"]) == set(want)
    for k, s in out["metrics"].items():
        vals = [per_seed[seed][k] for seed in SEEDS]
        assert s["mean"] == pytest.approx(sum(vals) / 3, abs=2e-5), k
        assert s["pm"] == pytest.approx((max(vals) - min(vals)) / 2, abs=2e-5), k
    assert any(s["pm"] > 0 for s in out["metrics"].values())  # three different streams


@pytest.mark.parametrize("suite", ["plain", "hard", "hardapp"])
def test_suite_names_the_whole_stream(suite):
    """A suite's fields apply to the default stream, not the preset's:
    config4_robust scored on 'plain' sees the plain stream."""
    for preset in ("config4_mixed", "config4_robust"):
        cfg, specs = evaluate.eval_config(configs.PRESETS[preset], suite=suite, synthetic_specs=["pose_std=0.3"])
        want = synthetic.apply_overrides(synthetic.SyntheticConfig(), [*synthetic.EVAL_SUITES[suite], "pose_std=0.3"])
        assert cfg.synthetic == want and specs == [*synthetic.EVAL_SUITES[suite], "pose_std=0.3"]
    assert evaluate.eval_config(configs.CONFIG4_ROBUST)[0].synthetic == configs.CONFIG4_ROBUST.synthetic


@pytest.mark.parametrize("flags", [["--int8"], ["--keep-bf16", "s3"], ["--int8-impl", "int8c"]])
def test_cli_refuses_int8(flags, capsys):
    """The int8 flags, once refused, run the protocol on the int8 encoder
    (with --int8; --keep-bf16 alone is refused): each seed's metrics are
    `evaluate`'s with the same qparams, impl and kept sites."""
    keep = tuple(flags[1:]) if flags[0] == "--keep-bf16" else ()
    impl = flags[1] if flags[0] == "--int8-impl" else "int8"
    if keep:
        with pytest.raises(SystemExit):
            quality_eval.main([*_SMALL, *flags])
        assert "--keep-bf16 applies to --int8" in capsys.readouterr().err
    argv = [*_SMALL, "--int8", *(flags if flags[0] != "--int8" else []), "--batches", "1", "--seeds", "231"]
    capsys.readouterr()
    assert quality_eval.main(argv) == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert out["int8"] and out["int8_impl"] == impl and out["keep_bf16"] == (list(keep) or None)
    cfg, _ = evaluate.eval_config(configs.CONFIG4_FULL, 1, 32)
    model, consts = predict.load_model(cfg.model, seed=cfg.seed, device="cpu")
    qparams = evaluate.int8_qparams(model, consts, cfg, keep)
    assert {s for s, q in qparams.items() if "w_bf16" in q} == ({"s3b0/conv1", "s3b0/conv2", "s3b0/proj",
                                                                  "s3b1/conv1", "s3b1/conv2"} if keep else set())
    want = evaluate.evaluate(model, consts, cfg, num_batches=1, seed=231, qparams=qparams, int8_impl=impl)
    per_seed = json.loads(re.search(r"^seed 231: (\{.*\})$", captured.err, re.M).group(1))
    assert per_seed == {k: round(v, 5) for k, v in want.items()}
