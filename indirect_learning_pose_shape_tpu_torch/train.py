"""Training on the synthetic soft-target stream (port of train.py's core).

One fused step, like the reference's `_fused_jit`: generate a batch on the
device (SMPL with the LBS kernel, the target render with the raster forward
kernel), then `forward_train` (bf16 ResNet with batch-statistics
BatchNorm → IEF → SMPL → score-form render), `losses.total_loss`, backward
(the raster backward kernel; LBS by its torch-einsum VJP) and the update.

    python -m indirect_learning_pose_shape_tpu_torch.train --preset config4_mixed --steps 200

prints the loss terms every `log_every` steps as JSON lines. Each step's
batch comes from a generator seeded by (seed, step), the counterpart of the
reference's `fold_in(rng, step)`, so a rerun sees the same stream (not the
reference's numbers: jax.random and torch differ).

The update is the reference's optax chain, in this order:
`optax.clip_by_global_norm` (`grad_clip_norm` > 0: gradients unchanged when
their global norm is below the limit, else scaled by limit / norm), then
Adam, or AdamW when `weight_decay` > 0 (decay on every parameter, as
optax's), at the learning rate of `lr_schedule` ('constant', or 'cosine':
`optax.warmup_cosine_decay_schedule(0, lr, warmup_steps, max(num_steps,
warmup_steps + 1))`, evaluated at the update count before it is
incremented, so the first update has learning rate 0), then the EMA of the
parameters (`ema_decay` > 0). `steps_per_call` fused steps go in one
`fused_step` call, each with its own step's batch; in eager PyTorch that
only sets how often `fit` logs.

Eager PyTorch: no `torch.compile`. TF32 is off, so float32 products (the
geometry, IEF) run in IEEE float32 as the reference's HIGHEST precision.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import math
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch import configs, losses
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib
from indirect_learning_pose_shape_tpu_torch.utils import device as device_lib
from indirect_learning_pose_shape_tpu_torch.utils.precision import disable_tf32

@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN running statistics, updated in place),
    its optimizer and learning-rate schedule (None when constant), the
    number of steps taken, the stream's seed, and the EMA of the parameters
    by name (None without `ema_decay`; never the BN buffers)."""

    model: net.Model
    optimizer: torch.optim.Optimizer
    step: int
    seed: int
    scheduler: Optional[torch.optim.lr_scheduler.LambdaLR] = None
    ema: Optional[dict[str, torch.Tensor]] = None


def lr_factor(count: int, cfg: configs.TrainConfig) -> float:
    """The learning rate of update `count` (0-based) over `cfg.learning_rate`:
    1, or optax's warm-up cosine schedule with init and end value 0."""
    if cfg.lr_schedule == "constant":
        return 1.0
    warmup = cfg.warmup_steps
    if count < warmup:
        return count / warmup
    decay = max(cfg.num_steps, warmup + 1) - warmup
    return 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, decay) / decay))


def make_optimizer(model: net.Model, cfg: configs.TrainConfig) -> torch.optim.Optimizer:
    """optax.adam's b1=0.9, b2=0.999, eps=1e-8; AdamW with decoupled decay
    on every parameter when `weight_decay` > 0."""
    kw = dict(lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8, foreach=True)
    if cfg.weight_decay:
        return torch.optim.AdamW(model.parameters(), weight_decay=cfg.weight_decay, **kw)
    return torch.optim.Adam(model.parameters(), **kw)


def new_state(model: net.Model, cfg: configs.TrainConfig, seed: int = 0) -> TrainState:
    """A state at step 0 around `model`: optimizer, the schedule (a LambdaLR
    of `lr_factor`, stepped after each update) and an EMA that starts as a
    copy of the parameters."""
    opt = make_optimizer(model, cfg)
    sched = ema = None
    if cfg.lr_schedule != "constant":
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda count: lr_factor(count, cfg))
    if cfg.ema_decay:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(model, opt, 0, seed, sched, ema)


def init_state(
    cfg: configs.TrainConfig, asset=None, device: torch.device | str = "cuda"
) -> tuple[TrainState, net.ModelConsts]:
    """(state, consts) on `device`: the card unless the caller asks for the
    CPU; raises without one. The model is initialised from `cfg.seed`."""
    device = device_lib.resolve(device)
    disable_tf32()
    if asset is None:
        asset = assets_lib.load_asset()
    model, consts = net.init(asset, cfg.model, seed=cfg.seed, device=device)
    return new_state(model, cfg, cfg.seed), consts


def ema_model(ts: TrainState) -> net.Model:
    """A copy of the model with the EMA parameters and the live BN
    statistics (what the reference's `load_model(..., ema=True)` serves)."""
    if ts.ema is None:
        raise ValueError("the state keeps no EMA: train with TrainConfig.ema_decay > 0")
    model = copy.deepcopy(ts.model)
    with torch.no_grad():
        for k, p in model.named_parameters():
            p.copy_(ts.ema[k])
    return model


def loss_and_metrics(
    model: net.Model, consts: net.ModelConsts, batch: dict, cfg: configs.TrainConfig
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss and its terms, plus the recovery diagnostics `pose_err`
    and `beta_err` (mean absolute error against the batch's ground truth).
    Updates the BN running statistics in place."""
    outputs = net.forward_train(model, consts, batch["image"], cfg.model, probs=False)
    targets = {k: batch[k] for k in ("silhouette", "part_labels", "kp2d", "kp_vis")}
    w = cfg.loss_weight_dict
    for wkey, tkey, src in (
        ("j3d", "joints3d", "gt_joints3d"),
        ("v3d", "verts3d", "gt_verts"),
        ("rotmat", "rotmats", "gt_rotmats"),
        ("betas_l2", "betas", "gt_betas"),
    ):
        if w.get(wkey, 0.0):
            if src not in batch:
                raise KeyError(
                    f"loss weight {wkey!r} is set but the batch carries no {src!r} "
                    "(make_batch emits the 3D targets when a j3d, v3d or rotmat weight is set)"
                )
            targets[tkey] = batch[src]
    total, terms = losses.total_loss(outputs, targets, w, cfg.model.image_size)
    with torch.no_grad():
        if "gt_pose" in batch and outputs["pose"].shape == batch["gt_pose"].shape:
            terms["pose_err"] = torch.mean(torch.abs(outputs["pose"] - batch["gt_pose"]))
        if "gt_betas" in batch:
            terms["beta_err"] = torch.mean(torch.abs(outputs["betas"] - batch["gt_betas"]))
    return total, terms


@torch.no_grad()
def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm in place: unchanged when the global norm is
    below `max_norm`, else each g / norm · max_norm. No host synchronisation."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    clip = norm >= max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(clip, norm, one))
    torch._foreach_mul_(grads, torch.where(clip, one * max_norm, one))


def apply_update(ts: TrainState, cfg: configs.TrainConfig) -> None:
    """The update from the gradients in the parameters' `.grad`: clip,
    Adam/AdamW at the scheduled rate, schedule step, EMA."""
    params = [p for p in ts.model.parameters() if p.grad is not None]
    if cfg.grad_clip_norm:
        clip_by_global_norm([p.grad for p in params], cfg.grad_clip_norm)
    ts.optimizer.step()
    if ts.scheduler is not None:
        ts.scheduler.step()
    if ts.ema is not None:
        d = cfg.ema_decay
        names, live = zip(*ts.model.named_parameters())
        shadow = [ts.ema[k] for k in names]
        with torch.no_grad():
            torch._foreach_mul_(shadow, d)
            torch._foreach_add_(shadow, [p.detach() for p in live], alpha=1.0 - d)


def train_step(
    ts: TrainState, batch: dict, consts: net.ModelConsts, cfg: configs.TrainConfig
) -> dict[str, torch.Tensor]:
    """One optimizer step on `batch`; updates `ts` in place and returns the
    terms as detached device tensors (no host synchronisation)."""
    ts.optimizer.zero_grad(set_to_none=True)
    total, terms = loss_and_metrics(ts.model, consts, batch, cfg)
    total.backward()
    apply_update(ts, cfg)
    ts.step += 1
    return {k: v.detach() for k, v in terms.items()}


def step_seed(seed: int, step: int) -> int:
    """The generator seed of `step`'s batch: a hash of (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


def make_batch(
    seed: int, step: int, batch_size: int, consts: net.ModelConsts, cfg: configs.TrainConfig
) -> dict[str, torch.Tensor]:
    """The synthetic batch of `step`, on the consts' device, with the 3D
    targets when a j3d, v3d or rotmat weight is set."""
    dev = consts.smpl.v_template.device
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step))
    draws = synthetic.sample_draws(
        gen, batch_size, consts, cfg.synthetic, cfg.model.image_size
    )
    w = cfg.loss_weight_dict
    include_3d = any(w.get(k, 0.0) for k in ("j3d", "v3d", "rotmat"))
    return synthetic.render_batch(draws, consts, cfg.model, cfg.synthetic, include_3d)


def fused_step(
    ts: TrainState, consts: net.ModelConsts, cfg: configs.TrainConfig
) -> dict[str, torch.Tensor]:
    """`cfg.steps_per_call` fused steps in one call, each generating the
    batch of its own step, then updating; returns the last step's terms.
    The same math as that many calls of one step: in eager PyTorch the call
    is a loop, so its size sets only when `fit` logs (capturing it as one
    CUDA graph is a performance follow-up in ROADMAP.md Queue 1)."""
    for _ in range(cfg.steps_per_call):
        batch = make_batch(ts.seed, ts.step, cfg.batch_size, consts, cfg)
        terms = train_step(ts, batch, consts, cfg)
    return terms


def fit(
    cfg: configs.TrainConfig,
    num_steps: Optional[int] = None,
    asset=None,
    device: torch.device | str = "cuda",
    log: Optional[Callable[[dict], None]] = None,
) -> tuple[TrainState, dict[str, float]]:
    """Train `num_steps` (default `cfg.num_steps`) fused steps from a fresh
    state in calls of `cfg.steps_per_call` (the remainder in one shorter
    call). `log`, when given, receives {"step": i, term: value, ...} after
    each call that took a step at a multiple of `cfg.log_every`, and after
    the last, with i the call's last step. Returns (state, last terms)."""
    num_steps = cfg.num_steps if num_steps is None else num_steps
    ts, consts = init_state(cfg, asset, device)
    le = max(1, cfg.log_every)
    terms: dict[str, torch.Tensor] = {}
    while ts.step < num_steps:
        first = ts.step
        call = dataclasses.replace(cfg, steps_per_call=min(cfg.steps_per_call, num_steps - first))
        terms = fused_step(ts, consts, call)
        if log is not None and (any(s % le == 0 for s in range(first, ts.step)) or ts.step == num_steps):
            log({"step": ts.step - 1, **{name: float(v) for name, v in terms.items()}})
    return ts, {name: float(v) for name, v in terms.items()}


def _weights(spec_list, base: tuple, error) -> tuple:
    """`base` loss weights with NAME=VALUE overrides; unknown names refused."""
    weights = dict(base)
    for spec in spec_list:
        name, sep, value = spec.partition("=")
        if not sep or name not in weights:
            error(f"--loss-weight {spec!r}: expected NAME=VALUE with NAME among {sorted(weights)}")
        weights[name] = float(value)
    return tuple(weights.items())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train on the synthetic soft-target stream.")
    ap.add_argument("--preset", default="config4_full", choices=sorted(configs.PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--lr-schedule", default=None, choices=["constant", "cosine"],
                    help="'cosine': linear warm-up over --warmup-steps, then cosine decay to 0")
    ap.add_argument("--warmup-steps", type=int, default=None)
    ap.add_argument("--grad-clip", type=float, default=None,
                    help="global-norm gradient clipping threshold (0 disables)")
    ap.add_argument("--weight-decay", type=float, default=None,
                    help="AdamW decoupled weight decay (0 = Adam)")
    ap.add_argument("--ema-decay", type=float, default=None,
                    help="keep an exponential moving average of the parameters (e.g. 0.999)")
    ap.add_argument("--steps-per-call", type=int, default=None,
                    help="fused steps per call (a loop here: it only sets where logs fall)")
    ap.add_argument("--loss-weight", action="append", default=None, metavar="NAME=VALUE",
                    help="override one loss weight (repeatable), e.g. --loss-weight j3d=5")
    ap.add_argument("--synthetic", action="append", default=None, metavar="FIELD=VALUE",
                    help="override one synthetic-stream field (repeatable), e.g. pose_std=0.35")
    ap.add_argument("--log-every", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = configs.PRESETS[args.preset]
    updates = {}
    if args.batch_size:
        updates["batch_size"] = args.batch_size
    if args.lr:
        updates["learning_rate"] = args.lr
    for flag, field in (("lr_schedule", "lr_schedule"), ("warmup_steps", "warmup_steps"),
                        ("grad_clip", "grad_clip_norm"), ("weight_decay", "weight_decay"),
                        ("ema_decay", "ema_decay"), ("steps_per_call", "steps_per_call"),
                        ("log_every", "log_every"), ("seed", "seed")):
        if getattr(args, flag) is not None:
            updates[field] = getattr(args, flag)
    if args.loss_weight:
        updates["loss_weights"] = _weights(args.loss_weight, cfg.loss_weights, ap.error)
    if args.synthetic:
        try:
            updates["synthetic"] = synthetic.apply_overrides(cfg.synthetic, args.synthetic)
        except (ValueError, NotImplementedError) as e:
            ap.error(str(e))
    if args.image_size:
        updates["model"] = dataclasses.replace(
            cfg.model,
            image_size=args.image_size,
            raster=dataclasses.replace(cfg.model.raster, image_size=args.image_size),
        )
    try:
        cfg = dataclasses.replace(cfg, **updates)
    except ValueError as e:
        ap.error(str(e))

    t0 = time.time()
    _, terms = fit(
        cfg, num_steps=args.steps, device=args.device,
        log=lambda rec: print(json.dumps(rec), flush=True),
    )
    print(f"done in {time.time() - t0:.1f}s; final: {terms}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
