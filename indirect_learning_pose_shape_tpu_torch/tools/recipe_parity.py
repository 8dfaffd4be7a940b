"""The reference's recorded training recipes, trained to their horizon and
held to the quality the reference recorded for them.

    python -m indirect_learning_pose_shape_tpu_torch.tools.recipe_parity r34_indirect_5k \\
        [--raster-impl auto|separable] [--seed 0 [1 2 ...]] [--steps N] [--device cuda|cpu]

A recipe (`RECIPES`) is the `train` command line of a recorded result, the
suites it was scored on and the record with its source. For each seed the
tool builds the config exactly as `train.main` does (`train.parse_config`
on the recipe's arguments and `--seed`), trains it with `train.fit` (on the
card the CUDA graph of `compile_fused_step`: a run that names another route
raises), saves the final state with `Checkpointer`, loads the model back
from it as `quality_eval` does (raw parameters, no EMA, as the records were
scored) and scores it with `quality_eval.protocol` (seeds 123, 231, 312 x 8
batches) under `evaluate.eval_config` for each suite of the record.

`--raster-impl separable` trains and scores on the reference's own route:
the separable product at the presets' `matmul_precision='default'` with
bf16 training scores; `auto` is the port's default, the raster kernels on
the card. `--steps` shortens the horizon (the schedule folds it in, as
`train --steps` does); a shortened run is no quality claim.

Output: one JSON line per seed, then, with several seeds, one line of the
mean over them. A line holds, per suite, every metric's mean and `pm` (half
the range over the protocol's seeds; in the mean line, half the range over
the training seeds), the record's mean and `pm`, the difference, what it
is allowed and whether it is inside, the bar's verdict (`judge`), the
graphed step's host wall, the run's walls, the first and last logged
total loss and the card's name and power limit as `nvidia-smi` gives them.

The bar, per suite: PVE within 0.002 of the record (the reference's own
bar for a real model difference, BASELINE.md:388-389) and silhouette IoU
within 0.005. The other metrics are held to the summed half-ranges (the
port's `pm` plus the record's) and flagged outside them, for the record
only. In the mean line over several seeds whose PVE half-range exceeds
0.002, that bar cannot tell a fault from seed noise: PVE is held to that
half-range plus the record's `pm` instead, and the line says so.

Card minutes at 700 W (NVIDIA H100 80GB HBM3; `PERF.md` §5 Quality): r34_indirect_5k
~2.1 a seed, large_indirect_5k ~4.2, mixed_20k ~8.5 with its three suites,
plus ~15 s a process to reach the card and build the kernels.
Needs a CUDA device unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from indirect_learning_pose_shape_tpu_torch import configs, evaluate, predict, train
from indirect_learning_pose_shape_tpu_torch.tools import quality_eval
from indirect_learning_pose_shape_tpu_torch.tools.profile_serve import smi_line
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib
from indirect_learning_pose_shape_tpu_torch.utils import device as device_lib
from indirect_learning_pose_shape_tpu_torch.utils.checkpoint import Checkpointer

REPO = Path(__file__).resolve().parents[2]

PVE_BAR = 0.002  # BASELINE.md:388-389: larger cross-run differences are real
IOU_BAR = 0.005
BARRED = {"pve": PVE_BAR, "sil_iou": IOU_BAR}
GRAPH_ROUTE = "graph: compile_fused_step"

_INDIRECT = ("--steps", "5000", "--lr", "3e-4", "--lr-schedule", "cosine", "--grad-clip", "1.0",
             "--loss-weight", "shape_reg=3e-3")


def _record_file(path: str, suite: str) -> dict:
    """{suite: {metric: (mean, pm)}} from a `quality_eval` JSON line in the repo."""
    with open(REPO / path) as f:
        metrics = json.load(f)["metrics"]
    return {suite: {k: (v["mean"], v["pm"]) for k, v in metrics.items()}}


def _row(pve, pve_pm, sil_iou, miou, kp_err_px, pa_mpjpe) -> dict:
    """A BASELINE.md record; only PVE carries a half-range there."""
    return {"pve": (pve, pve_pm), "sil_iou": (sil_iou, None), "miou": (miou, None),
            "kp_err_px": (kp_err_px, None), "pa_mpjpe": (pa_mpjpe, None)}


@dataclasses.dataclass(frozen=True)
class Recipe:
    name: str
    argv: tuple  # the `train` command line
    suites: tuple
    source: str  # where the record stands
    record: Callable[[], dict]  # {suite: {metric: (mean, pm or None)}}


RECIPES = {r.name: r for r in (
    Recipe(
        "r34_indirect_5k", ("--preset", "config4_r34", *_INDIRECT), ("plain",),
        "runs/disk/eval_r34_stream.json",
        lambda: _record_file("runs/disk/eval_r34_stream.json", "plain"),
    ),
    Recipe(
        "large_indirect_5k", ("--preset", "config4_large", *_INDIRECT), ("plain",),
        "BASELINE.md:469-472",
        # "shape_reg 3e-3 @5k scores PVE 0.09454 ±0.00045 (sil IoU 0.9007,
        # PA-MPJPE 0.0146, mIoU 0.5653, kp 1.91 px)"
        lambda: {"plain": _row(0.09454, 0.00045, 0.9007, 0.5653, 1.91, 0.0146)},
    ),
    Recipe(
        "mixed_20k", ("--preset", "config4_mixed"), ("plain", "hard", "hardapp"),
        "BASELINE.md:235-237",
        # The `config4_mixed` @20k rows: PVE, sil IoU, mIoU, kp px, PA-MPJPE.
        lambda: {
            "plain": _row(0.0617, 0.0005, 0.9104, 0.6805, 1.021, 0.0085),
            "hard": _row(0.1279, 0.0009, 0.8410, 0.2813, 2.910, 0.0170),
            "hardapp": _row(0.1899, 0.0018, 0.2071, 0.0432, 32.27, 0.0356),
        },
    ),
)}


def recipe_config(recipe: Recipe, seed: int = 0, raster_impl: str = "auto",
                  steps: Optional[int] = None) -> configs.TrainConfig:
    """The config a recipe trains with: `train.main`'s on the recipe's
    arguments and `--seed`, the `--steps` horizon folded in as `fit` folds
    it, on `raster_impl`."""
    args, cfg = train.parse_config([*recipe.argv, "--seed", str(seed)])
    num_steps = steps or args.steps or cfg.num_steps
    return dataclasses.replace(
        cfg, num_steps=num_steps, model=dataclasses.replace(cfg.model, raster_impl=raster_impl)
    )


def judge(summary: dict, record: dict, pve_bar: float = PVE_BAR) -> dict:
    """Each metric of `summary` ({metric: {"mean", "pm"}}) against `record`
    ({metric: (mean, pm or None)}): the difference, what it is allowed (the
    bar for PVE and silhouette IoU, else the summed half-ranges) and whether
    it is inside; and the verdict: "meets" when PVE and IoU are inside."""
    out = {}
    for k, s in summary.items():
        row = {"mean": s["mean"], "pm": s["pm"]}
        if k in record:
            ref, ref_pm = record[k]
            allowed = pve_bar if k == "pve" else BARRED.get(k, s["pm"] + (ref_pm or 0.0))
            diff = s["mean"] - ref
            row.update(ref=ref, ref_pm=ref_pm, diff=diff, allowed=allowed, inside=abs(diff) <= allowed)
        out[k] = row
    meets = all(out[k]["inside"] for k in BARRED)
    return {"metrics": out, "verdict": "meets" if meets else "misses",
            "outside": sorted(k for k, r in out.items() if not r.get("inside", True))}


class _Tee(io.StringIO):
    """A stream that keeps what is written and passes it on."""

    def __init__(self, out):
        super().__init__()
        self._out = out

    def write(self, s: str) -> int:
        self._out.write(s)
        return super().write(s)


def _train(cfg: configs.TrainConfig, asset, device: torch.device):
    """`train.fit` to the config's horizon: (state, route line, logged
    [(step, total, host time)])."""
    logged = []

    def log(rec):
        logged.append((rec["step"], rec["total"], time.perf_counter()))

    err = _Tee(sys.stderr)
    with contextlib.redirect_stderr(err):
        ts, _ = train.fit(cfg, asset=asset, device=device, log=log)
    route = next((x for x in err.getvalue().splitlines() if x.startswith("fit: ")), None)
    if device.type == "cuda" and not (route or "").startswith(f"fit: {GRAPH_ROUTE}"):
        raise RuntimeError(f"the recipe ran on {route!r}, not fit's CUDA graph ({GRAPH_ROUTE})")
    return ts, route, logged


def _step_ms(logged: list, log_every: int) -> Optional[float]:
    """Host wall a step between the logs after the first `log_every`
    steps (the eager warm-up step and the capture are before them)."""
    late = [x for x in logged if x[0] >= log_every]
    if len(late) < 2:
        return None
    (s0, _, t0), (s1, _, t1) = late[0], late[-1]
    return (t1 - t0) / (s1 - s0) * 1e3


def run(recipe: Recipe, seed: int = 0, raster_impl: str = "auto", steps: Optional[int] = None,
        device: torch.device | str = "cuda", asset=None,
        shrink: Optional[Callable[[configs.TrainConfig], configs.TrainConfig]] = None,
        eval_seeds=quality_eval.PROTOCOL_SEEDS, batches: int = 8) -> dict:
    """Train `recipe` at `seed` and score it on each of its suites; the
    JSON line's record. `shrink` resizes the config after it is built (the
    CPU test's small model); `eval_seeds` and `batches` the protocol."""
    device = device_lib.resolve(device)
    asset = asset if asset is not None else assets_lib.load_asset()
    cfg = recipe_config(recipe, seed, raster_impl, steps)
    if shrink is not None:
        cfg = shrink(cfg)
    t0 = time.perf_counter()
    ts, route, logged = _train(cfg, asset, device)
    train_s = time.perf_counter() - t0
    record = recipe.record()
    with tempfile.TemporaryDirectory() as d:
        ckpt = Checkpointer(d)
        ckpt.save(ts.step, train.state_dict(ts), wait=True)
        ckpt.close()
        del ts
        model, consts = predict.load_model(cfg.model, asset=asset, seed=cfg.seed, device=device,
                                           checkpoint_dir=d)
    suites = {}
    for suite in recipe.suites:
        ecfg, _ = evaluate.eval_config(cfg, suite=suite)
        _, summary = quality_eval.protocol(model, consts, ecfg, tuple(eval_seeds), batches)
        suites[suite] = judge(summary, record[suite])
    evaluate.clear_graphs()
    return {
        "recipe": recipe.name, "raster_impl": raster_impl, "seed": seed, "steps": cfg.num_steps,
        "argv": [*recipe.argv, "--seed", str(seed)], "record": recipe.source, "route": route,
        "eval_seeds": list(eval_seeds), "batches": batches,
        "verdict": "meets" if all(s["verdict"] == "meets" for s in suites.values()) else "misses",
        "suites": suites,
        "first_total": logged[0][1], "last_total": logged[-1][1], "last_step": logged[-1][0],
        "step_ms": _step_ms(logged, cfg.log_every), "train_s": train_s,
        "run_s": time.perf_counter() - t0, "device": smi_line() if device.type == "cuda" else "cpu",
    }


def over_seeds(lines: list[dict], recipe: Recipe) -> dict:
    """The mean line over several seeds' lines: each metric's mean over
    the seeds and half their range, judged against the record; PVE is held
    to its seed half-range plus the record's `pm` where that half-range
    exceeds PVE_BAR."""
    record = recipe.record()
    suites = {}
    for suite in recipe.suites:
        names = lines[0]["suites"][suite]["metrics"]
        summary = {}
        for k in names:
            vals = [x["suites"][suite]["metrics"][k]["mean"] for x in lines]
            summary[k] = {"mean": statistics.fmean(vals), "pm": (max(vals) - min(vals)) / 2}
        pve_bar = PVE_BAR
        if summary["pve"]["pm"] > PVE_BAR:
            pve_bar = summary["pve"]["pm"] + (record[suite]["pve"][1] or 0.0)
        suites[suite] = {**judge(summary, record[suite], pve_bar), "pve_bar": pve_bar,
                         "pve_bar_from_seeds": pve_bar != PVE_BAR}
    return {
        "recipe": recipe.name, "raster_impl": lines[0]["raster_impl"], "seeds": [x["seed"] for x in lines],
        "steps": lines[0]["steps"], "record": recipe.source,
        "verdict": "meets" if all(s["verdict"] == "meets" for s in suites.values()) else "misses",
        "suites": suites,
        "step_ms": [x["step_ms"] for x in lines], "run_s": [x["run_s"] for x in lines],
        "device": lines[0]["device"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("recipe", choices=sorted(RECIPES))
    ap.add_argument("--raster-impl", default="auto", choices=["auto", "separable"],
                    help="'auto': the port's default (the raster kernels on the card); "
                         "'separable': the reference's route, the control run")
    ap.add_argument("--seed", type=int, nargs="+", default=[0], help="training seeds, one run each")
    ap.add_argument("--steps", type=int, default=None, help="a shorter horizon than the recipe's")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = device_lib.resolve(args.device)
    recipe = RECIPES[args.recipe]
    lines = []
    for seed in args.seed:
        line = run(recipe, seed, args.raster_impl, args.steps, device)
        print(json.dumps(line), flush=True)
        lines.append(line)
    if len(lines) > 1:
        print(json.dumps(over_seeds(lines, recipe)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
