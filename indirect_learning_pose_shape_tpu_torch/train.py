"""Training on the synthetic soft-target stream (port of train.py's core).

One fused step, like the reference's `_fused_jit`: generate a batch on the
device (SMPL with the LBS kernel, the target render with the raster forward
kernel), then `forward_train` (bf16 ResNet with batch-statistics
BatchNorm → IEF → SMPL → score-form render), `losses.total_loss`, backward
(the raster backward kernel; LBS by its torch-einsum VJP) and an Adam update.

    python -m indirect_learning_pose_shape_tpu_torch.train --preset config4_full --steps 200

prints the loss terms every `log_every` steps as JSON lines. Each step's
batch comes from a generator seeded by (seed, step), the counterpart of the
reference's `fold_in(rng, step)`, so a rerun sees the same stream (not the
reference's numbers: jax.random and torch differ).

Eager PyTorch: no `torch.compile`. TF32 is off, so float32 products (the
geometry, IEF) run in IEEE float32 as the reference's HIGHEST precision.
The optimizer is constant-LR Adam only (optax.adam's b1, b2, eps); the rest
of the reference's menu is refused by `configs.TrainConfig`.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
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
    its optimizer, the number of steps taken and the stream's seed."""

    model: net.Model
    optimizer: torch.optim.Adam
    step: int
    seed: int


def make_optimizer(model: net.Model, cfg: configs.TrainConfig) -> torch.optim.Adam:
    """Constant-LR Adam with optax.adam's b1=0.9, b2=0.999, eps=1e-8."""
    return torch.optim.Adam(
        model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8
    )


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
    return TrainState(model, make_optimizer(model, cfg), 0, cfg.seed), consts


def loss_and_metrics(
    model: net.Model, consts: net.ModelConsts, batch: dict, cfg: configs.TrainConfig
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss and its terms, plus the recovery diagnostics `pose_err`
    and `beta_err` (mean absolute error against the batch's ground truth).
    Updates the BN running statistics in place."""
    outputs = net.forward_train(model, consts, batch["image"], cfg.model)
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
                    f"loss weight {wkey!r} is set but the batch carries no {src!r}; the "
                    "synthetic stream's 3D targets other than gt_betas are not ported yet"
                )
            targets[tkey] = batch[src]
    total, terms = losses.total_loss(outputs, targets, w, cfg.model.image_size)
    with torch.no_grad():
        if "gt_pose" in batch and outputs["pose"].shape == batch["gt_pose"].shape:
            terms["pose_err"] = torch.mean(torch.abs(outputs["pose"] - batch["gt_pose"]))
        if "gt_betas" in batch:
            terms["beta_err"] = torch.mean(torch.abs(outputs["betas"] - batch["gt_betas"]))
    return total, terms


def train_step(
    ts: TrainState, batch: dict, consts: net.ModelConsts, cfg: configs.TrainConfig
) -> dict[str, torch.Tensor]:
    """One optimizer step on `batch`; updates `ts` in place and returns the
    terms as detached device tensors (no host synchronisation)."""
    ts.optimizer.zero_grad(set_to_none=True)
    total, terms = loss_and_metrics(ts.model, consts, batch, cfg)
    total.backward()
    ts.optimizer.step()
    ts.step += 1
    return {k: v.detach() for k, v in terms.items()}


def step_seed(seed: int, step: int) -> int:
    """The generator seed of `step`'s batch: a hash of (seed, step)."""
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


def make_batch(
    seed: int, step: int, batch_size: int, consts: net.ModelConsts, cfg: configs.TrainConfig
) -> dict[str, torch.Tensor]:
    """The synthetic batch of `step`, on the consts' device."""
    dev = consts.smpl.v_template.device
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step))
    draws = synthetic.sample_draws(
        gen, batch_size, consts, cfg.synthetic, cfg.model.image_size
    )
    return synthetic.render_batch(draws, consts, cfg.model, cfg.synthetic)


def fused_step(
    ts: TrainState, consts: net.ModelConsts, cfg: configs.TrainConfig
) -> dict[str, torch.Tensor]:
    """Generate the batch of step `ts.step`, then update: one call."""
    batch = make_batch(ts.seed, ts.step, cfg.batch_size, consts, cfg)
    return train_step(ts, batch, consts, cfg)


def fit(
    cfg: configs.TrainConfig,
    num_steps: Optional[int] = None,
    asset=None,
    device: torch.device | str = "cuda",
    log: Optional[Callable[[dict], None]] = None,
) -> tuple[TrainState, dict[str, float]]:
    """Train `num_steps` (default `cfg.num_steps`) fused steps from a fresh
    state. `log`, when given, receives {"step": i, term: value, ...} every
    `cfg.log_every` steps and at the last. Returns (state, last terms)."""
    num_steps = cfg.num_steps if num_steps is None else num_steps
    ts, consts = init_state(cfg, asset, device)
    le = max(1, cfg.log_every)
    terms: dict[str, torch.Tensor] = {}
    for i in range(num_steps):
        terms = fused_step(ts, consts, cfg)
        if log is not None and (i % le == 0 or i == num_steps - 1):
            log({"step": i, **{k: float(v) for k, v in terms.items()}})
    return ts, {k: float(v) for k, v in terms.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train on the synthetic soft-target stream.")
    ap.add_argument("--preset", default="config4_full", choices=sorted(configs.PRESETS))
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    cfg = configs.PRESETS[args.preset]
    updates = {}
    if args.batch_size:
        updates["batch_size"] = args.batch_size
    if args.lr:
        updates["learning_rate"] = args.lr
    if args.seed is not None:
        updates["seed"] = args.seed
    if args.image_size:
        updates["model"] = dataclasses.replace(
            cfg.model,
            image_size=args.image_size,
            raster=dataclasses.replace(cfg.model.raster, image_size=args.image_size),
        )
    cfg = dataclasses.replace(cfg, **updates)

    t0 = time.time()
    _, terms = fit(
        cfg, num_steps=args.steps, device=args.device,
        log=lambda rec: print(json.dumps(rec), flush=True),
    )
    print(f"done in {time.time() - t0:.1f}s; final: {terms}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
