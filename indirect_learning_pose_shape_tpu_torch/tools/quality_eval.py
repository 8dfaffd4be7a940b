"""The quality protocol with error bars (port of tools/quality_eval.py).

A quality claim is held to spread across disjoint evaluation streams, not
to one stream's reading:

- metrics: `evaluate.evaluate` on the synthetic stream (PVE, MPJPE,
  PA-MPJPE, silhouette IoU, part accuracy and mIoU, keypoint pixels);
- seeds: 123, 231 and 312 (three disjoint streams; `--seeds` overrides);
- batches: 8 per seed at the preset's batch size;
- model: the latest checkpoint of `--checkpoint` (or `--step`), its EMA with
  `--ema`; the preset's seed-initialised model without `--checkpoint`;
- stream: the preset's, or a named suite (`--eval-suite plain|hard|hardapp`)
  with `--synthetic FIELD=VALUE` overrides on top;
- report: one JSON line with each metric's mean over the seeds and `pm`,
  half the range. An improvement counts only if two runs' means differ by
  more than the sum of their `pm`.

    python -m indirect_learning_pose_shape_tpu_torch.tools.quality_eval \\
        --preset config4_robust --checkpoint D --eval-suite hardapp [--ema]

With `--int8` the protocol scores the int8 encoder (models/quantize.py),
calibrated on 16 images of the stream at seed 999, under `--int8-impl`
('int8' by default; 'int8c', 'sim', 'simc'), with the sites matching
`--keep-bf16` (names or prefixes, e.g. `stem s3`) kept in bf16.

Each seed's metrics go to standard error. On the card a batch is a replay
of `evaluate`'s cached CUDA graph, captured once and reused over the seeds.
On the CPU (`--device cpu`) shrink the run with `--batch-size` and
`--image-size`.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from indirect_learning_pose_shape_tpu_torch import configs, evaluate, predict
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import quantize as quant
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib
from indirect_learning_pose_shape_tpu_torch.utils.precision import disable_tf32

PROTOCOL_SEEDS = (123, 231, 312)


def protocol(
    model: net.Model,
    consts: net.ModelConsts,
    cfg: configs.TrainConfig,
    seeds=PROTOCOL_SEEDS,
    batches: int = 8,
    qparams=None,
    int8_impl: str = "int8",
) -> tuple[dict[int, dict[str, float]], dict[str, dict[str, float]]]:
    """(each seed's metrics, each metric's {"mean", "pm"} over the seeds,
    `pm` half the range); with `qparams`, of the int8 encoder."""
    per_seed = {
        s: evaluate.evaluate(model, consts, cfg, num_batches=batches, seed=s,
                             qparams=qparams, int8_impl=int8_impl)
        for s in seeds
    }
    summary = {}
    for m in sorted(next(iter(per_seed.values()))):
        vals = [per_seed[s][m] for s in seeds]
        summary[m] = {"mean": sum(vals) / len(vals), "pm": (max(vals) - min(vals)) / 2.0}
    return per_seed, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="config4_full", choices=sorted(configs.PRESETS))
    ap.add_argument("--checkpoint", default=None, help="a training run's checkpoint_dir")
    ap.add_argument("--step", type=int, default=None, help="score this checkpoint step (default: the latest)")
    ap.add_argument("--ema", action="store_true", help="score the checkpoint's EMA parameters")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(PROTOCOL_SEEDS))
    ap.add_argument("--eval-suite", default=None, choices=sorted(synthetic.EVAL_SUITES),
                    help="a named eval distribution (synthetic.EVAL_SUITES)")
    ap.add_argument("--synthetic", action="append", default=None, metavar="FIELD=VALUE",
                    help="override one synthetic-stream field (repeatable), on top of the suite")
    ap.add_argument("--ief-iters", type=int, default=None,
                    help="the IEF iterations the checkpoint trained with")
    ap.add_argument("--rot-format", default=None, choices=["axis_angle", "rot6d"],
                    help="the rotation format the checkpoint trained with")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--int8", action="store_true",
                    help="score the int8 encoder, calibrated on a synthetic batch (seed 999, 16 images)")
    ap.add_argument("--int8-impl", default="int8", choices=quant.IMPLS,
                    help="'int8' per site, 'int8c' carried int8 (sim/simc their float32-sum twins)")
    ap.add_argument("--keep-bf16", nargs="*", default=[], metavar="SITE",
                    help="with --int8: encoder sites (names or prefixes, e.g. stem s3) kept in bf16")
    args = ap.parse_args(argv)
    if args.keep_bf16 and not args.int8:
        ap.error("--keep-bf16 applies to --int8")
    if (args.step is not None or args.ema) and not args.checkpoint:
        ap.error("--step and --ema need --checkpoint")
    try:
        cfg, specs = evaluate.eval_config(
            configs.PRESETS[args.preset], args.batch_size, args.image_size, args.eval_suite,
            args.synthetic, args.ief_iters, args.rot_format,
        )
    except ValueError as e:
        ap.error(str(e))

    disable_tf32()
    model, consts = predict.load_model(
        cfg.model, asset=assets_lib.load_asset(), seed=cfg.seed, device=args.device,
        ema=args.ema, checkpoint_dir=args.checkpoint, step=args.step,
    )
    qparams = None
    if args.int8:
        try:
            qparams = evaluate.int8_qparams(model, consts, cfg, tuple(args.keep_bf16))
        except ValueError as e:
            ap.error(str(e))
    per_seed, summary = protocol(model, consts, cfg, args.seeds, args.batches, qparams, args.int8_impl)
    for seed, m in per_seed.items():
        print(f"seed {seed}: {json.dumps({k: round(v, 5) for k, v in m.items()})}", file=sys.stderr)
    print(json.dumps({
        "preset": args.preset,
        "checkpoint": args.checkpoint,
        "step": args.step,
        "seeds": args.seeds,
        "batches": args.batches,
        "batch_size": cfg.batch_size,
        "int8": args.int8,
        "int8_impl": args.int8_impl if args.int8 else None,
        "keep_bf16": args.keep_bf16 or None,
        "ema": args.ema,
        "eval_suite": args.eval_suite,
        "synthetic": specs or None,
        "device": str(next(model.parameters()).device),
        "metrics": {k: {"mean": round(v["mean"], 5), "pm": round(v["pm"], 5)} for k, v in summary.items()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
