"""Training (port of train.py): the synthetic stream, disk datasets and
host-preprocessed image directories.

One fused step on the synthetic stream, like the reference's `_fused_jit`:
generate a batch on the device (SMPL with the LBS kernel; the target render
with the raster forward kernel, or the hard z-buffer raster with
`targets='hard'`), then `forward_train` (bf16 ResNet with batch-statistics
BatchNorm → IEF → SMPL → score-form render), `losses.total_loss`, backward
(the raster backward kernel; LBS by its torch-einsum VJP) and the update.

    python -m indirect_learning_pose_shape_tpu_torch.train --preset config4_robust \
        --checkpoint-every 1000 --checkpoint-dir D --metrics m.jsonl --ema-decay 0.999

prints the loss terms every `log_every` steps as JSON lines, and writes them
to `metrics_path` (JSONL) and `tensorboard_dir` when set. Each step's batch
comes from a generator seeded by (seed, step), the counterpart of the
reference's `fold_in(rng, step)`, so a rerun sees the same stream (not the
reference's numbers: jax.random and torch differ) and a resumed run needs
only the step and the seed.

Disk data (`fit_dataset`, `--dataset D.npz` or a directory of shards): raw
batches of a `data/dataset.py` dataset, in the reference's order from the
resumed step, are staged on the card by `prefetch_to_device`; each step
crops and resizes them on the device (`preprocess_raw_batch`), after the
mirror and crop jitter of `cfg.augment` (`--augment`) drawn from a generator
seeded by (seed, step) apart from the synthetic stream's, so a resumed run
replays the same flips and boxes. The step runs the LBS kernel with
residuals, the raster forward and the raster backward once each; there is
no target render. Image directories (`fit_preprocessed`, `--image-dir`) come
already cropped by the native host preprocessor (`data/image_dir.py`), which
also does their augmentation.

`num_steps` is the run's total budget. With `checkpoint_every` > 0, each
`fit_*` resumes from the latest checkpoint in `checkpoint_dir` (the model
with its BN statistics, the optimizer, the schedule, the EMA, the step and
the seed), trains the remaining steps, saves at every crossing of a
`checkpoint_every` boundary under the global step, and saves the last step
when the budget is not a multiple of it; it refuses a directory already at
or past the budget.

The update is the reference's optax chain, in this order:
`optax.clip_by_global_norm` (`grad_clip_norm` > 0: gradients unchanged when
their global norm is below the limit, else scaled by limit / norm), then
Adam, or AdamW when `weight_decay` > 0 (decay on every parameter, as
optax's), at the learning rate of `lr_schedule` ('constant', or 'cosine':
`optax.warmup_cosine_decay_schedule(0, lr, warmup_steps, max(num_steps,
warmup_steps + 1))`, evaluated at the update count before it is
incremented, so the first update has learning rate 0), then the EMA of the
parameters (`ema_decay` > 0). `steps_per_call` fused steps go in one
call, each with its own step's batch; it sets how often `fit` logs and
hands the host back, and the disk paths refuse it.

The compiled step (the reference's `compile_fused_step`, and
`compile_train_fns`): on the card the fused step is one CUDA graph, captured
after a real first step that serves as its warm-up and replayed once a step
(`utils/graphs.py`), equal to the eager `fused_step` bitwise. The optimizer
is capturable there and reads its rate from a tensor on the card that the
schedule fills between replays; the batch's draws come from one generator
registered with the graph and reseeded by (seed, step) before each replay,
the ViT's drop-path draws (`hmr2_vith`) after the batch's.
`fit` runs the graph on the card, alone or on an NCCL mesh, and the eager
`fused_step` on the CPU, on gloo meshes and under `--debug-nans`; its first
log line (stderr) names the route. The disk steps take the same routes
(`compile_data_step`, the reference's `_data_step_jit` and `_step_jit`):
on the card each prefetched batch is copied into the graph's static input
buffers and one graph is replayed a step, its augmentation draws from a
registered generator reseeded by (seed, step, 1), equal to the eager
`data_train_step` (or `train_step`) bitwise. Each step of a compiled step,
and of the eager `fused_step`, is the span `train.step` (`utils/tracing.py`),
its host work the child spans `train.reseed`, `train.stale_check`,
`train.capture`, `train.copy_in`, `graph.replay`, `train.advance` and
`train.clone`.

Several GPUs (`config5_data_parallel`; `num_devices`, `render_devices`):
every rank runs this module on its rows of the global batch, over a mesh of
the process group (`parallel/mesh.py`, `_auto_mesh`), and computes the
numbers one process computes on that batch, up to float32 reduction order:
each step's batch is drawn whole from the step's generator (synthetic
draws, augmentation draws, disk batches) and cut to the rank's rows; BN
statistics and every loss term are the global batch's; the gradients are
summed over the ranks after `backward()` and before the clip. With
`render_devices` > 1 both renders (targets and prediction) are row-sharded
(`parallel/render_sp.py`). Rank 0 writes checkpoints and metrics; every rank
restores. Launch with

    torchrun --nproc_per_node N -m indirect_learning_pose_shape_tpu_torch.train \
        --preset config5_data_parallel

(NCCL, one card a rank; `--device cpu` runs gloo ranks on the CPU).

No `torch.compile`. TF32 is off, so float32 products (the
geometry, IEF) run in IEEE float32 as the reference's HIGHEST precision.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import sys
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from indirect_learning_pose_shape_tpu_torch import configs, losses
from indirect_learning_pose_shape_tpu_torch.data import augment, synthetic
from indirect_learning_pose_shape_tpu_torch.data import dataset as dataset_lib
from indirect_learning_pose_shape_tpu_torch.data import preprocess as pp
from indirect_learning_pose_shape_tpu_torch.models import ief as ief_mod
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import pretrained
from indirect_learning_pose_shape_tpu_torch.parallel import mesh as mesh_lib
from indirect_learning_pose_shape_tpu_torch.parallel import render_sp
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib
from indirect_learning_pose_shape_tpu_torch.utils import debug, metrics
from indirect_learning_pose_shape_tpu_torch.utils import device as device_lib
from indirect_learning_pose_shape_tpu_torch.utils import graphs, tracing
from indirect_learning_pose_shape_tpu_torch.utils.checkpoint import Checkpointer
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
    on every parameter when `weight_decay` > 0. On the card the optimizer is
    capturable (its step counts live on the card), so a CUDA graph can
    record its update; `new_state` then gives it its rate as a tensor on the
    card (`bind_lr`)."""
    cuda = next(model.parameters()).device.type == "cuda"
    kw = dict(lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8, foreach=True, capturable=cuda)
    if cfg.weight_decay:
        return torch.optim.AdamW(model.parameters(), weight_decay=cfg.weight_decay, **kw)
    return torch.optim.Adam(model.parameters(), **kw)


def bind_lr(opt: torch.optim.Optimizer) -> None:
    """Each parameter group's learning rate where its update reads it. On
    the card: a float32 tensor there, which the schedule fills in place
    before each update, so a CUDA graph of the update reads the rate of its
    own step (a number would be frozen into the graph at capture), and the
    group capturable. On the CPU: a number, and not capturable. Loading an
    optimizer state replaces the groups, so `load_state_dict` binds again."""
    for group in opt.param_groups:
        dev = group["params"][0].device
        group["capturable"] = dev.type == "cuda"
        lr = group["lr"]
        if group["capturable"] and not torch.is_tensor(lr):
            group["lr"] = torch.tensor(lr, dtype=torch.float32, device=dev)
        elif not group["capturable"] and torch.is_tensor(lr):
            group["lr"] = float(lr)


def new_state(model: net.Model, cfg: configs.TrainConfig, seed: int = 0) -> TrainState:
    """A state at step 0 around `model`: optimizer, the schedule (a LambdaLR
    of `lr_factor`, stepped after each update) and an EMA that starts as a
    copy of the parameters. The schedule is built on the rate as a number,
    then the rate is bound (`bind_lr`): the schedule keeps its base rates as
    numbers and fills the bound tensor."""
    opt = make_optimizer(model, cfg)
    sched = ema = None
    if cfg.lr_schedule != "constant":
        sched = torch.optim.lr_scheduler.LambdaLR(opt, lambda count: lr_factor(count, cfg))
    bind_lr(opt)
    if cfg.ema_decay:
        ema = {k: p.detach().clone() for k, p in model.named_parameters()}
    return TrainState(model, opt, 0, seed, sched, ema)


def init_state(
    cfg: configs.TrainConfig, asset=None, device: torch.device | str = "cuda"
) -> tuple[TrainState, net.ModelConsts]:
    """(state, consts) on `device`: the card unless the caller asks for the
    CPU; raises without one. The model is initialised from `cfg.seed`, then,
    as the reference's `init_state`, IEF's Θ₀ is read from `cfg.mean_params`
    (shape-checked against the IEF layout) and the encoder from
    `cfg.pretrained` (refused for another depth or shape)."""
    device = device_lib.resolve(device)
    disable_tf32()
    if asset is None:
        asset = assets_lib.load_asset()
    model, consts = net.init(asset, cfg.model, seed=cfg.seed, device=device)
    with torch.no_grad():
        if cfg.mean_params:
            model.regressor.mean_theta.copy_(ief_mod.load_mean_theta(cfg.mean_params, cfg.model.ief))
        if cfg.pretrained:
            pretrained.load_encoder(model.encoder, cfg.pretrained)
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


def state_dict(ts: TrainState) -> dict:
    """What a checkpoint holds: the model's state_dict (parameters and BN
    running statistics), the optimizer's (Adam moments and counts), the
    schedule's (None when constant), the step, the seed and the EMA (None
    without one); the rates as numbers whatever the device (on the card
    they live in tensors, `bind_lr`). Live tensors: `Checkpointer.save`
    copies them."""
    opt = ts.optimizer.state_dict()
    opt["param_groups"] = [{**g, "lr": float(g["lr"])} for g in opt["param_groups"]]
    sched = None
    if ts.scheduler is not None:
        sched = ts.scheduler.state_dict()
        sched["_last_lr"] = [float(lr) for lr in sched["_last_lr"]]
    return {
        "model": ts.model.state_dict(),
        "optimizer": opt,
        "scheduler": sched,
        "step": ts.step,
        "seed": ts.seed,
        "ema": ts.ema,
    }


def load_state_dict(ts: TrainState, saved: dict) -> None:
    """Restore `saved` (a `state_dict`) into `ts` in place. `ts` must be
    built as the saving run's was (`new_state`: the model, the optimizer, the
    LambdaLR, whose constructor takes one step of its own), so that each
    loaded state lands on the object that wrote it."""
    for key, have in (("scheduler", ts.scheduler), ("ema", ts.ema)):
        if (saved[key] is None) != (have is None):
            raise ValueError(
                f"the checkpoint {'has no' if saved[key] is None else 'has a'} {key} and this "
                f"configuration {'builds one' if have is not None else 'does not'} "
                "(lr_schedule and ema_decay must match the run that saved it)"
            )
    ts.model.load_state_dict(saved["model"])
    # New state tensors and groups: a CUDA graph captured before this reads
    # the old ones, so the compiled steps capture again (`_graph_tensors`).
    ts.optimizer.load_state_dict(saved["optimizer"])
    bind_lr(ts.optimizer)
    if ts.scheduler is not None:
        ts.scheduler.load_state_dict(saved["scheduler"])
    if ts.ema is not None:
        with torch.no_grad():
            for k, v in ts.ema.items():
                v.copy_(saved["ema"][k])
    ts.step, ts.seed = int(saved["step"]), int(saved["seed"])


# (loss weight, target name, the batch keys that carry it: the synthetic
# stream's gt_* name first, then the bare name of npz datasets).
_TARGETS_3D = (
    ("j3d", "joints3d", ("gt_joints3d", "joints3d")),
    ("v3d", "verts3d", ("gt_verts", "verts3d")),
    ("rotmat", "rotmats", ("gt_rotmats", "rotmats")),
    ("betas_l2", "betas", ("gt_betas", "betas")),
)


def loss_and_metrics(
    model: net.Model, consts: net.ModelConsts, batch: dict, cfg: configs.TrainConfig, mesh=None
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Total loss and its terms, plus the recovery diagnostics `pose_err`
    and `beta_err` (mean absolute error against the batch's ground truth).
    Updates the BN running statistics in place. Under `mesh`, `batch` is
    this rank's rows (its targets this rank's band of image rows under a
    render axis) and every value is the global batch's. The ViT's drop
    path takes the batch's `drop_path_u`."""
    outputs = net.forward_train(model, consts, batch["image"], cfg.model, probs=False, mesh=mesh,
                                drop_path_u=batch.get("drop_path_u"))
    targets = {k: batch[k] for k in ("silhouette", "part_labels", "kp2d", "kp_vis")}
    # The direct-supervision targets: the synthetic stream names them gt_*,
    # disk datasets carry the bare names.
    w = cfg.loss_weight_dict
    for wkey, tkey, candidates in _TARGETS_3D:
        if w.get(wkey, 0.0):
            src = next((c for c in candidates if c in batch), None)
            if src is None:
                raise KeyError(
                    f"loss weight {wkey!r} is set but the batch carries no {candidates} "
                    "target: direct supervision needs a data source with 3D ground truth "
                    "(the synthetic stream, or an npz dataset with that key)"
                )
            targets[tkey] = batch[src]
    total, terms = losses.total_loss(outputs, targets, w, cfg.model.image_size, mesh)
    with torch.no_grad():
        if "gt_pose" in batch and outputs["pose"].shape == batch["gt_pose"].shape:
            terms["pose_err"] = losses.global_mean(torch.abs(outputs["pose"] - batch["gt_pose"]), mesh)
        if "gt_betas" in batch:
            terms["beta_err"] = losses.global_mean(torch.abs(outputs["betas"] - batch["gt_betas"]), mesh)
        if "hard_overflow" in batch:  # faces the hard targets' culling dropped
            overflow = batch["hard_overflow"].float()
            if mesh is not None:
                overflow = mesh_lib.all_reduce_max(overflow, mesh.world_group)
            terms["hard_overflow"] = overflow
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


def _update_on_device(ts: TrainState, cfg: configs.TrainConfig) -> None:
    """The device work of the update: clip, Adam/AdamW at the rate the
    schedule set, EMA."""
    params = [p for p in ts.model.parameters() if p.grad is not None]
    if cfg.grad_clip_norm:
        clip_by_global_norm([p.grad for p in params], cfg.grad_clip_norm)
    ts.optimizer.step()
    if ts.ema is not None:
        d = cfg.ema_decay
        names, live = zip(*ts.model.named_parameters())
        shadow = [ts.ema[k] for k in names]
        with torch.no_grad():
            torch._foreach_mul_(shadow, d)
            torch._foreach_add_(shadow, [p.detach() for p in live], alpha=1.0 - d)


def _advance(ts: TrainState) -> None:
    """The host's part of a step, after its device work: the schedule's
    count (it writes the next update's rate) and the step."""
    if ts.scheduler is not None:
        ts.scheduler.step()
    ts.step += 1


def apply_update(ts: TrainState, cfg: configs.TrainConfig) -> None:
    """The update from the gradients in the parameters' `.grad`: clip,
    Adam/AdamW at the scheduled rate, EMA, schedule step."""
    _update_on_device(ts, cfg)
    if ts.scheduler is not None:
        ts.scheduler.step()


def _step_on_device(
    ts: TrainState, batch: dict, consts: net.ModelConsts, cfg: configs.TrainConfig, mesh=None
) -> dict[str, torch.Tensor]:
    """The device work of `train_step`, which is what a CUDA graph of the
    step records: its host code leaves `ts.step` and the schedule alone."""
    ts.optimizer.zero_grad(set_to_none=True)
    total, terms = loss_and_metrics(ts.model, consts, batch, cfg, mesh)
    total.backward()
    if mesh is not None:
        mesh_lib.all_reduce_grads(ts.model.parameters(), mesh)
    _update_on_device(ts, cfg)
    return {k: v.detach() for k, v in terms.items()}


def train_step(
    ts: TrainState, batch: dict, consts: net.ModelConsts, cfg: configs.TrainConfig, mesh=None
) -> dict[str, torch.Tensor]:
    """One optimizer step on `batch`; updates `ts` in place and returns the
    terms as detached device tensors (no host synchronisation). Under
    `mesh` the gradients are summed over the ranks before the update."""
    terms = _step_on_device(ts, batch, consts, cfg, mesh)
    _advance(ts)
    return terms


def step_seed(seed: int, step: int, *stream: int) -> int:
    """The generator seed of `step`'s batch: a hash of (seed, step), or of
    (seed, step, *stream) for another stream of the same step."""
    return int(np.random.SeedSequence([seed, step, *stream]).generate_state(1, np.uint64)[0] >> 1)


def make_batch(
    seed: int, step: int, batch_size: int, consts: net.ModelConsts, cfg: configs.TrainConfig,
    mesh=None,
) -> dict[str, torch.Tensor]:
    """The synthetic batch of `step`, on the consts' device, with the 3D
    targets when a j3d, v3d or rotmat weight is set. Under `mesh` the draws
    of the global batch (`batch_size`) are taken and this rank's rows
    rendered (its band of image rows of the targets under a render axis)."""
    dev = consts.smpl.v_template.device
    gen = torch.Generator(device=dev).manual_seed(step_seed(seed, step))
    return _draw_batch(gen, batch_size, consts, cfg, mesh)


def _draw_batch(
    gen: torch.Generator, batch_size: int, consts: net.ModelConsts, cfg: configs.TrainConfig,
    mesh=None,
) -> dict[str, torch.Tensor]:
    """`make_batch` from `gen`, seeded by the caller: a CUDA graph records
    the draws of a generator registered with it, and the caller reseeds it
    before each replay. A ViT with drop path takes its uniform draws
    `drop_path_u` [B, 2·depth] from `gen` after the batch's."""
    draws = synthetic.sample_draws(
        gen, batch_size, consts, cfg.synthetic, cfg.model.image_size
    )
    m, drop = cfg.model, None
    if m.head is not None and m.encoder.drop_path > 0:
        drop = torch.rand((batch_size, 2 * m.encoder.depth), generator=gen, device=gen.device)
    rows = slice(None) if mesh is None else mesh.batch_rows(batch_size)
    if mesh is not None:
        draws = synthetic.shard_draws(draws, rows)
    w = cfg.loss_weight_dict
    include_3d = any(w.get(k, 0.0) for k in ("j3d", "v3d", "rotmat"))
    batch = synthetic.render_batch(
        draws, consts, cfg.model, cfg.synthetic, include_3d, rows=render_sp.constrainer(mesh)
    )
    if drop is not None:
        batch["drop_path_u"] = drop[rows]
    return batch


def fused_step(
    ts: TrainState, consts: net.ModelConsts, cfg: configs.TrainConfig, mesh=None
) -> dict[str, torch.Tensor]:
    """`cfg.steps_per_call` fused steps in one call, each generating the
    batch of its own step, then updating; returns the last step's terms.
    The eager step, one host launch a kernel: `compile_fused_step` is the
    same step as a CUDA graph, and runs this on the CPU."""
    for _ in range(cfg.steps_per_call):
        with tracing.span("train.step", root=True):
            batch = make_batch(ts.seed, ts.step, cfg.batch_size, consts, cfg, mesh)
            terms = train_step(ts, batch, consts, cfg, mesh)
    return terms


def _graph_device(
    consts: net.ModelConsts, mesh, name: str, eager: str = "train.fused_step"
) -> Optional[torch.device]:
    """The card a compiled step is captured on; None on the CPU, where it
    runs eagerly. A gloo mesh is refused: gloo's collectives run on the
    host, and a CUDA graph records device work only."""
    dev = consts.smpl.v_template.device
    if mesh is not None and mesh.backend != "nccl":
        raise ValueError(
            f"{name} captures the step as a CUDA graph, which cannot record the "
            f"{mesh.backend} backend's host collectives: run the eager {eager} "
            "(the train.fit_* loops do on such a mesh), or an NCCL mesh"
        )
    return dev if dev.type == "cuda" else None


def _graph_tensors(ts: TrainState) -> list:
    """What a graph of `ts`'s step reads or writes in place and a caller
    could replace (`load_state_dict` replaces the optimizer's): the model,
    its parameters and buffers, the optimizer's rates and state, the EMA. A
    compiled step captures again when any of them is not the one it was
    captured with, and holds them meanwhile, so their memory is not
    reused."""
    opt = ts.optimizer
    out = [ts.model, *ts.model.parameters(), *ts.model.buffers()]
    out += [g["lr"] for g in opt.param_groups]
    out += [v for st in opt.state.values() for v in st.values() if torch.is_tensor(v)]
    return out + (list(ts.ema.values()) if ts.ema is not None else [])


class _GraphedStep:
    """One training step as a CUDA graph: captured at the first call on a
    state, after a real step that runs eagerly on the side stream as the
    warm-up (`utils/graphs.py`), then replayed. Around each replay the host
    reseeds the step's generator by (seed, step) and advances the schedule
    (which fills the rate tensor for the next update) and `ts.step`, as the
    eager step does."""

    def __init__(self, cfg: configs.TrainConfig, consts: net.ModelConsts, mesh, device: torch.device):
        self.cfg, self.consts, self.mesh, self.device = cfg, consts, mesh, device
        self.gen = torch.Generator(device=device)
        self.graph: Optional[graphs.Graph] = None
        self.captures = 0
        self._bound: Optional[list] = None

    def _capture(self, ts: TrainState, step_fn: Callable[[], dict]) -> dict:
        """The warm-up step (a real one, eager), then the capture."""
        bind_lr(ts.optimizer)
        terms = graphs.warm_up(step_fn, self.device)
        _advance(ts)
        self.graph = graphs.capture(step_fn, self.device, generators=(self.gen,))
        self.captures += 1
        self._bound = _graph_tensors(ts)
        return terms

    def _stale(self, ts: TrainState) -> bool:
        return self.graph is None or not graphs.same_tensors(self._bound, _graph_tensors(ts))

    def _step(self, ts: TrainState, step_fn: Callable[[], dict]) -> dict:
        """One step: captured when the graph is stale, else replayed, then
        the host's part (`_advance`)."""
        with tracing.span("train.stale_check"):
            stale = self._stale(ts)
        if stale:
            with tracing.span("train.capture"):
                return self._capture(ts, step_fn)
        terms = self.graph.replay()
        with tracing.span("train.advance"):
            _advance(ts)
        return terms

    @staticmethod
    def _clone(terms: dict) -> dict[str, torch.Tensor]:
        with tracing.span("train.clone"):
            return {k: v.clone() for k, v in terms.items()}


class FusedStepGraph(_GraphedStep):
    """`compile_fused_step`'s callable on the card: `fn(ts)` runs
    `cfg.steps_per_call` steps (`fn(ts, k)`: k), each a replay of one
    captured fused step (its batch generated on the device from the
    generator seeded by (seed, step), then the update), and returns clones
    of the last step's terms. `captures`, and the last graph's `seconds`
    and `pool_bytes`, say what capturing cost."""

    def __call__(self, ts: TrainState, num_steps: Optional[int] = None) -> dict[str, torch.Tensor]:
        cfg, consts, mesh = self.cfg, self.consts, self.mesh

        def step():
            batch = _draw_batch(self.gen, cfg.batch_size, consts, cfg, mesh)
            return _step_on_device(ts, batch, consts, cfg, mesh)

        n = cfg.steps_per_call if num_steps is None else num_steps
        for i in range(n):
            with tracing.span("train.step", root=True):
                with tracing.span("train.reseed"):
                    self.gen.manual_seed(step_seed(ts.seed, ts.step))
                terms = self._step(ts, step)
                if i == n - 1:  # the call's clones belong to its last step
                    terms = self._clone(terms)
        return terms


def compile_fused_step(cfg: configs.TrainConfig, consts: net.ModelConsts, mesh=None):
    """The reference's single-dispatch step (its `compile_fused_step`):
    `fn(ts) -> terms` runs `cfg.steps_per_call` fused steps, batch
    generation and update, and returns the last step's terms.

    On the card (`FusedStepGraph`): one step captured as a CUDA graph at
    the first call and replayed once a step, each replay reseeded for its
    own step, so the steps equal the eager `fused_step`'s bitwise. A state
    whose optimizer state was replaced since (a checkpoint loaded) is
    captured again. Under an NCCL mesh the graph records the step's
    collectives; a gloo mesh is refused (ValueError). A capture that fails
    raises: there is no eager fallback on the card. On the CPU `fn` is the
    eager `fused_step`."""
    dev = _graph_device(consts, mesh, "compile_fused_step")
    if dev is None:
        return lambda ts, num_steps=None: fused_step(
            ts, consts, cfg if num_steps is None else dataclasses.replace(cfg, steps_per_call=num_steps),
            mesh,
        )
    return FusedStepGraph(cfg, consts, mesh, dev)


class _BatchGraph:
    """`compile_train_fns`'s `gen_fn` on the card: `make_batch` as a CUDA
    graph, its generator reseeded by (seed, step) before each replay;
    returns clones of the batch."""

    def __init__(self, cfg: configs.TrainConfig, consts: net.ModelConsts, mesh, device: torch.device):
        self.gen = torch.Generator(device=device)
        self.fn = lambda: _draw_batch(self.gen, cfg.batch_size, consts, cfg, mesh)
        self.device = device
        self.graph: Optional[graphs.Graph] = None

    def __call__(self, seed: int, step: int) -> dict[str, torch.Tensor]:
        if self.graph is None:
            graphs.warm_up(self.fn, self.device)
            self.graph = graphs.capture(self.fn, self.device, generators=(self.gen,))
        self.gen.manual_seed(step_seed(seed, step))
        return {k: v.clone() for k, v in self.graph.replay().items()}


class TrainStepGraph(_GraphedStep):
    """`compile_train_fns`'s `step_fn` on the card: `fn(ts, batch)` copies
    the batch into the graph's input buffers and replays one captured
    `train_step`; returns clones of the terms. A batch of other keys,
    shapes or types is captured again, with its own buffers. The copies run
    on the current stream, so they follow whatever that stream waits on
    (the prefetcher's copy event)."""

    def __init__(self, cfg, consts, mesh, device):
        super().__init__(cfg, consts, mesh, device)
        self.inputs: Optional[dict[str, torch.Tensor]] = None

    def _device_step(self, ts: TrainState, inputs: dict) -> dict:
        return _step_on_device(ts, inputs, self.consts, self.cfg, self.mesh)

    def _reseed(self, ts: TrainState) -> None:
        """Reseed the step's generator before the replay (none here)."""

    def __call__(self, ts: TrainState, batch: dict) -> dict[str, torch.Tensor]:
        with tracing.span("train.step", root=True):
            self._reseed(ts)
            with tracing.span("train.copy_in"):
                layout = {k: (v.shape, v.dtype) for k, v in batch.items()}
                if self.inputs is None or layout != {k: (v.shape, v.dtype) for k, v in self.inputs.items()}:
                    self.inputs, self.graph = {k: torch.empty_like(v, device=self.device) for k, v in batch.items()}, None
                for k, v in batch.items():
                    self.inputs[k].copy_(v)
            inputs = self.inputs
            return self._clone(self._step(ts, lambda: self._device_step(ts, inputs)))


class DataStepGraph(TrainStepGraph):
    """`compile_data_step`'s callable on the card: `fn(ts, batch)` copies a
    prefetched batch into the graph's input buffers, reseeds the
    augmentation generator by (seed, step, 1) and replays one captured disk
    step; returns clones of the terms. The step is `data_train_step`'s
    device work on a raw batch (the draws from the registered generator,
    the rank's rows of them, `preprocess_raw_batch`, the band cut, the
    update), or `_local_step`'s on a preprocessed one (`raw=False`)."""

    def __init__(self, cfg, consts, mesh, device, raw: bool):
        super().__init__(cfg, consts, mesh, device)
        self.raw = raw

    def _device_step(self, ts: TrainState, inputs: dict) -> dict:
        batch = inputs
        if self.raw:
            batch = _disk_batch(inputs, self.cfg, self.mesh, lambda n: _draw_augment(self.gen, n, self.cfg))
        return _step_on_device(ts, _local_batch(batch, self.mesh), self.consts, self.cfg, self.mesh)

    def _reseed(self, ts: TrainState) -> None:
        with tracing.span("train.reseed"):
            self.gen.manual_seed(step_seed(ts.seed, ts.step, _AUGMENT_STREAM))


def compile_train_fns(cfg: configs.TrainConfig, consts: net.ModelConsts, mesh=None):
    """The reference's `compile_train_fns`: `(gen_fn, step_fn)`, with
    `gen_fn(seed, step)` the batch of `make_batch` and `step_fn(ts, batch)`
    the `train_step` on it, each a CUDA graph on the card (`_BatchGraph`,
    `TrainStepGraph`; equal to the eager functions bitwise) and the eager
    functions on the CPU. A gloo mesh is refused, as by
    `compile_fused_step`."""
    dev = _graph_device(consts, mesh, "compile_train_fns")
    if dev is None:
        return (
            lambda seed, step: make_batch(seed, step, cfg.batch_size, consts, cfg, mesh),
            lambda ts, batch: train_step(ts, batch, consts, cfg, mesh),
        )
    return _BatchGraph(cfg, consts, mesh, dev), TrainStepGraph(cfg, consts, mesh, dev)


def compile_data_step(cfg: configs.TrainConfig, consts: net.ModelConsts, mesh=None, raw: bool = True):
    """The disk steps compiled, as the reference jits them: `fn(ts, batch)
    -> terms` is `data_train_step` on a raw disk batch (its
    `_data_step_jit`, `fit_dataset`'s step) or, with `raw=False`,
    `_local_step` on a preprocessed one (its `_step_jit` as
    `fit_preprocessed` calls it).

    On the card (`DataStepGraph`): one step captured as a CUDA graph at
    the first call, after a real step that is its warm-up, and replayed once
    a step, its batch copied into static buffers and its augmentation draws
    from a registered generator reseeded by (seed, step, 1), so the steps
    equal the eager ones bitwise. A batch of another layout, or a state
    whose optimizer state was replaced since, is captured again. Under an
    NCCL mesh the graph records the collectives; a gloo mesh is refused
    (ValueError). A capture that fails raises. On the CPU `fn` is the eager
    step."""
    eager_name = "train.data_train_step" if raw else "train.train_step"
    dev = _graph_device(consts, mesh, "compile_data_step", eager_name)
    if dev is None:
        return _eager_data_step(cfg, consts, mesh, raw)
    return DataStepGraph(cfg, consts, mesh, dev, raw)


def _eager_data_step(cfg: configs.TrainConfig, consts: net.ModelConsts, mesh, raw: bool):
    """`fn(ts, batch)`: the eager `data_train_step`, or `_local_step` with
    `raw=False`."""
    eager = data_train_step if raw else _local_step
    return lambda ts, batch: eager(ts, batch, consts, cfg, mesh)


def _fold_num_steps(cfg: configs.TrainConfig, num_steps: Optional[int]):
    """`cfg` with an explicit step budget folded in before the schedule is
    built: the cosine schedule's horizon is `cfg.num_steps`."""
    if num_steps and num_steps != cfg.num_steps:
        cfg = dataclasses.replace(cfg, num_steps=num_steps)
    return cfg, cfg.num_steps


def _setup_checkpoint(cfg: configs.TrainConfig, ts: TrainState, num_steps: int, mesh=None):
    """The checkpointer of `cfg.checkpoint_dir` (None without
    `checkpoint_every`), with the latest checkpoint restored into `ts`;
    refuses a directory whose latest step is already at or past the budget.
    Under `mesh` every rank restores, after a barrier."""
    if not cfg.checkpoint_every:
        return None
    if mesh is not None:
        mesh_lib.barrier(mesh)
    ckpt = Checkpointer(cfg.checkpoint_dir)
    latest = ckpt.latest_step()
    if latest is not None:
        if latest >= num_steps:
            raise ValueError(
                f"checkpoint_dir {cfg.checkpoint_dir!r} already holds step {latest} >= "
                f"num_steps {num_steps}: refusing to train zero steps. Point checkpoint_dir "
                "somewhere fresh for a new run, or raise num_steps to continue this one."
            )
        print(f"resuming from step {latest} in {cfg.checkpoint_dir}", file=sys.stderr)
        # Loaded to host memory: load_state_dict puts each tensor where its
        # parameter lives, and keeps Adam's step counts on the CPU, where the
        # optimizer keeps them (non-capturable Adam refuses them on the card).
        load_state_dict(ts, ckpt.restore(latest, map_location="cpu"))
    return ckpt


def _final_save(ckpt: Checkpointer, ts: TrainState, start: int, cfg: configs.TrainConfig) -> None:
    """Save the last step when the periodic saves missed it (a budget that
    is not a multiple of checkpoint_every)."""
    if ts.step % cfg.checkpoint_every and ts.step > start:
        ckpt.save(ts.step, state_dict(ts))


# The stream of the augmentation draws of a step (step_seed's third word),
# apart from the synthetic stream of make_batch.
_AUGMENT_STREAM = 1


def augment_draws(
    seed: int, step: int, batch_size: int, cfg: configs.TrainConfig, device: torch.device
) -> dict[str, torch.Tensor]:
    """The mirror and crop-jitter draws of `step` (`augment.sample_draws`)
    from a generator seeded by (seed, step, 1): a function of the step, so a
    resumed run replays them."""
    gen = torch.Generator(device=device).manual_seed(step_seed(seed, step, _AUGMENT_STREAM))
    return _draw_augment(gen, batch_size, cfg)


def _draw_augment(gen: torch.Generator, batch_size: int, cfg: configs.TrainConfig) -> dict[str, torch.Tensor]:
    """`augment_draws` from `gen`, seeded by the caller: a CUDA graph records
    the draws of a generator registered with it, and the caller reseeds it
    before each replay."""
    return augment.sample_draws(gen, batch_size, cfg.augment)


def preprocess_raw_batch(
    raw: dict[str, torch.Tensor], cfg: configs.TrainConfig, draws: Optional[dict] = None
) -> dict[str, torch.Tensor]:
    """A raw disk batch (images [B, Hs, Ws, 3] uint8, masks [B, Hs, Ws] int,
    kp2d [B, K, 2] source pixels, kp_vis [B, K]) as a training batch at
    `cfg.model.image_size`, on its device: the square box around each mask
    (`preprocess.bbox_from_mask`) cropped from image, mask and keypoints.
    With `cfg.augment.enabled` and `draws` (see `augment_draws`) the mirror
    comes first and the box is jittered; evaluation passes no draws. The 3D
    targets pass through unchanged; mirroring a batch that carries a
    geometric one (joints3d, verts3d, rotmats) is refused, betas alone are
    mirror-invariant."""
    size = cfg.model.image_size
    num_parts = cfg.model.raster.num_parts
    extra_3d = [k for k in ("joints3d", "verts3d", "rotmats", "betas") if k in raw]
    if cfg.augment.enabled and draws is not None:
        if extra_3d and extra_3d != ["betas"]:
            raise ValueError(
                f"augmentation (mirror) is enabled but the batch carries 3D "
                f"targets {extra_3d}: flipping them is not implemented — "
                "disable augmentation for direct-supervision training on "
                "this dataset"
            )
        raw = augment.mirror_raw_batch(raw, draws["flip"], cfg.augment, num_parts=num_parts)
        bboxes = augment.jitter_bboxes(pp.bbox_from_mask(raw["masks"]), draws["scale"], draws["shift"])
    else:
        bboxes = pp.bbox_from_mask(raw["masks"])
    masks = pp.crop_resize_mask(raw["masks"], bboxes, size)
    batch = {
        "image": pp.normalize(pp.crop_resize(raw["images"], bboxes, size)),
        "silhouette": (masks > 0).float(),
        "part_labels": torch.clamp(masks.to(torch.int32), 0, num_parts),
        "kp2d": pp.transform_keypoints(raw["kp2d"], bboxes, size),
        "kp_vis": raw["kp_vis"],
    }
    for k in extra_3d:  # model-space labels, untouched by the 2D crop
        batch[k] = raw[k]
    return batch


def data_train_step(
    ts: TrainState, raw: dict[str, torch.Tensor], consts: net.ModelConsts, cfg: configs.TrainConfig,
    mesh=None,
) -> dict[str, torch.Tensor]:
    """One optimizer step on a raw disk batch: the augmentation draws of
    `ts.step` (when `cfg.augment.enabled`), `preprocess_raw_batch`, then
    `train_step`. Under `mesh`, `raw` is this rank's rows of the global
    batch: the draws are the global batch's, cut to those rows, and under a
    render axis the targets are cut to this rank's band of image rows."""
    dev = raw["images"].device
    batch = _disk_batch(raw, cfg, mesh, lambda n: augment_draws(ts.seed, ts.step, n, cfg, dev))
    return _local_step(ts, batch, consts, cfg, mesh)


def _disk_batch(raw: dict, cfg: configs.TrainConfig, mesh, draw: Callable[[int], dict]) -> dict:
    """`preprocess_raw_batch` of this rank's raw rows, with the
    augmentation draws `draw(global batch)` cut to those rows when
    `cfg.augment.enabled`."""
    draws = None
    if cfg.augment.enabled:
        draws = draw(raw["images"].shape[0] * (1 if mesh is None else mesh.n_data))
        if mesh is not None:
            draws = mesh_lib.shard_batch(draws, mesh)
    return preprocess_raw_batch(raw, cfg, draws)


def _local_batch(batch: dict, mesh) -> dict:
    """This rank's part of a whole-image batch: under a render axis, its
    targets cut to the rank's band of rows."""
    rows = render_sp.constrainer(mesh)
    return batch if rows is None else rows.targets(batch)


def _local_step(ts: TrainState, batch: dict, consts, cfg: configs.TrainConfig, mesh=None) -> dict:
    """`train_step` on this rank's rows of a whole-image batch (`_local_batch`)."""
    return train_step(ts, _local_batch(batch, mesh), consts, cfg, mesh)


def _auto_mesh(cfg: configs.TrainConfig, device: torch.device | str = "cuda"):
    """The run's mesh over the process group (the reference's
    `_auto_mesh`), None for one process: with `render_devices` > 1 a
    (num_devices / render_devices) x render_devices mesh, else a 1-D data
    mesh over `num_devices` ranks (None: every launched rank). Raises as
    the reference does when the devices, the batch or the image do not
    divide. A mesh spans every launched rank: where the reference would
    leave devices out (a batch that the device count does not divide),
    this refuses."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if cfg.render_devices > 1:
        total = cfg.num_devices or world
        if total % cfg.render_devices:
            raise ValueError(f"{total} devices not divisible by render_devices {cfg.render_devices}")
        n_data = total // cfg.render_devices
        if cfg.batch_size % n_data:
            raise ValueError(
                f"batch_size {cfg.batch_size} not divisible by the data axis "
                f"({n_data} = {total} devices / {cfg.render_devices} render)"
            )
        if cfg.model.raster.image_size % cfg.render_devices:
            raise ValueError(
                f"render image_size {cfg.model.raster.image_size} not divisible by "
                f"render_devices {cfg.render_devices}"
            )
        return render_sp.render_mesh(n_data, cfg.render_devices, device)
    n = world if cfg.num_devices is None else cfg.num_devices
    if n == 1 and world == 1:
        return None
    if cfg.batch_size % n:
        raise ValueError(f"batch_size {cfg.batch_size} not divisible by num_devices {n}")
    return mesh_lib.make_mesh(n, device)


def _fit_route(
    consts: net.ModelConsts, mesh, graph: str = "compile_fused_step", eager: str = "fused_step"
) -> str:
    """How a `fit_*` loop runs its steps, said in its first log line: the
    CUDA graph of `graph` (`compile_fused_step`, or `compile_data_step` for
    the disk steps) wherever it can capture (the card, alone or on an NCCL
    mesh), else the eager step `eager`: on the CPU, on a gloo mesh (host
    collectives), and under anomaly mode (`--debug-nans`), which checks
    every op on the host as it runs."""
    if consts.smpl.v_template.device.type != "cuda":
        return f"eager {eager} (CPU)"
    if mesh is not None and mesh.backend != "nccl":
        return f"eager {eager} ({mesh.backend} mesh: host collectives)"
    if torch.is_anomaly_enabled():
        return f"eager {eager} (anomaly mode, --debug-nans)"
    return f"graph: {graph}, one CUDA graph replay a step" + (
        "" if mesh is None else f" (NCCL mesh of {mesh.world})"
    )


# The route names of each loop: (graph, eager step), by `_run`'s `raw`
# (None: the synthetic stream).
_ROUTE_NAMES = {
    None: ("compile_fused_step", "fused_step"),
    True: ("compile_data_step", "data_train_step"),
    False: ("compile_data_step(raw=False)", "train_step"),
}


def _run(
    cfg: configs.TrainConfig,
    num_steps: Optional[int],
    asset,
    device: torch.device | str,
    log: Optional[Callable[[dict], None]],
    source: Optional[Callable[[int, torch.device, Optional[mesh_lib.Mesh]], Iterator[dict]]] = None,
    raw: bool = True,
) -> tuple[TrainState, dict[str, float]]:
    """The loop of every `fit_*`: init, resume, steps, logs, checkpoints.
    Without `source` the steps are `fused_step` calls on the synthetic
    stream (`compile_fused_step`'s graph on the card); with it, `source(start
    step, device, mesh)` gives the device batches from the resumed step and
    each is one disk step, `data_train_step` on a raw batch or `_local_step`
    on a preprocessed one (`raw=False`), `compile_data_step`'s graph on the
    card. `_fit_route` picks the route and the first log line names it.
    Under a mesh (`_auto_mesh`) the ranks run on `mesh.device`, rank 0 alone
    writes checkpoints, metrics and `log`, and the ranks meet at the end,
    once the last checkpoint is on disk."""
    cfg, num_steps = _fold_num_steps(cfg, num_steps)
    if source is not None and cfg.steps_per_call != 1:
        raise ValueError("steps_per_call applies to synthetic-stream training only")
    mesh = _auto_mesh(cfg, device)
    if mesh is not None:
        device = mesh.device
    lead = mesh is None or mesh.rank == 0
    ts, consts = init_state(cfg, asset, device)
    ckpt = _setup_checkpoint(cfg, ts, num_steps, mesh)
    if mesh is not None:
        mesh_lib.replicate(ts.model, mesh)
    start, every = ts.step, cfg.checkpoint_every
    if ckpt and lead and cfg.steps_per_call > every:
        print(
            f"warning: steps_per_call={cfg.steps_per_call} > checkpoint_every={every}; "
            f"checkpoints land once per call (every {cfg.steps_per_call} steps)",
            file=sys.stderr,
        )
    batches = None if source is None else source(start, consts.smpl.v_template.device, mesh)
    route = _fit_route(consts, mesh, *_ROUTE_NAMES[None if source is None else raw])
    if lead:
        print(f"fit: {route}", file=sys.stderr)
    step_fn = None
    if route.startswith("graph"):
        step_fn = compile_fused_step(cfg, consts, mesh) if source is None else compile_data_step(cfg, consts, mesh, raw)
    elif source is not None:
        step_fn = _eager_data_step(cfg, consts, mesh, raw)
    writer = (
        metrics.MetricsWriter(cfg.metrics_path, tensorboard_dir=cfg.tensorboard_dir)
        if lead else metrics.MetricsWriter(print_every=0)
    )
    le = max(1, cfg.log_every)
    values: dict[str, float] = {}
    try:
        while ts.step < num_steps:
            first = ts.step
            if batches is None:
                k = min(cfg.steps_per_call, num_steps - first)
                if step_fn is not None:
                    terms = step_fn(ts, k)
                else:
                    terms = fused_step(ts, consts, dataclasses.replace(cfg, steps_per_call=k), mesh)
            else:
                terms = step_fn(ts, next(batches))
            if any(s % le == 0 for s in range(first, ts.step)) or ts.step == num_steps:
                values = writer.write(ts.step - 1, terms)
                if log is not None and lead:
                    log({"step": ts.step - 1, **values})
            if ckpt and lead and ts.step // every > first // every:
                ckpt.save(ts.step, state_dict(ts))  # the global step: resume-safe
        if ckpt and lead:
            _final_save(ckpt, ts, start, cfg)
    finally:
        if batches is not None:
            batches.close()
        if ckpt:
            ckpt.close()
        writer.close()
    if mesh is not None:
        mesh_lib.barrier(mesh)
    return ts, values


def fit(
    cfg: configs.TrainConfig,
    num_steps: Optional[int] = None,
    asset=None,
    device: torch.device | str = "cuda",
    log: Optional[Callable[[dict], None]] = None,
) -> tuple[TrainState, dict[str, float]]:
    """Train on the synthetic stream to `num_steps` (default
    `cfg.num_steps`), the total budget, in calls of `cfg.steps_per_call`
    (the remainder in one shorter call), resuming from `cfg.checkpoint_dir`
    when `cfg.checkpoint_every` is set.

    After each call that took a step at a multiple of `cfg.log_every`, and
    after the last, the call's last terms go to a `MetricsWriter`
    (`cfg.metrics_path`, `cfg.tensorboard_dir`) in one host transfer, and
    `log`, when given, receives {"step": i, term: value, ...}, i the call's
    last step. Returns (state, last terms)."""
    return _run(cfg, num_steps, asset, device, log)


def dataset_pulls(cfg: configs.TrainConfig, keys) -> dict[str, str]:
    """The arrays a disk step reads, {batch name: dataset key}: the 2D ones,
    and the 3D target of each live direct weight under its bare name or its
    gt_* alias, whichever `keys` has first (the bare name when neither; the
    step then refuses the batch, naming both)."""
    pulls = {k: k for k in ("images", "masks", "kp2d", "kp_vis")}
    w = cfg.loss_weight_dict
    for wkey, tkey, candidates in _TARGETS_3D:
        if w.get(wkey, 0.0):
            bare_first = candidates[::-1]
            pulls[tkey] = next((c for c in bare_first if c in keys), bare_first[0])
    return pulls


def fit_dataset(
    cfg: configs.TrainConfig,
    dataset,
    num_steps: Optional[int] = None,
    asset=None,
    device: torch.device | str = "cuda",
    log: Optional[Callable[[dict], None]] = None,
) -> tuple[TrainState, dict[str, float]]:
    """Train on a disk dataset (`data/dataset.py`: `NpzDataset`,
    `ShardedNpzDataset`) as `fit` does on the stream: `dataset.batches`
    from the resumed step, filtered to `dataset_pulls` before the prefetch
    (so unused arrays never cross to the card), staged by
    `prefetch_to_device` two batches ahead, each through `data_train_step`
    (on the card `compile_data_step`'s graph of it, one replay a step).
    Under a mesh the dataset gives global batches (`cfg.batch_size`) and
    each rank stages only its rows."""
    pulls = dataset_pulls(cfg, getattr(dataset, "keys", frozenset()))

    def source(start: int, dev: torch.device, mesh) -> Iterator[dict]:
        raw = ({k: b[src] for k, src in pulls.items() if src in b} for b in dataset.batches(start))
        rows = None if mesh is None else mesh.batch_rows(cfg.batch_size)
        return dataset_lib.prefetch_to_device(raw, size=2, device=dev, rows=rows)

    return _run(cfg, num_steps, asset, device, log, source)


def fit_preprocessed(
    cfg: configs.TrainConfig,
    dataset,
    num_steps: Optional[int] = None,
    asset=None,
    device: torch.device | str = "cuda",
    log: Optional[Callable[[dict], None]] = None,
) -> tuple[TrainState, dict[str, float]]:
    """Train on a stream of host-preprocessed batches at model resolution
    (`data/image_dir.ImageDirDataset`), prefetched to the card, each through
    `train_step` (on the card `compile_data_step(raw=False)`'s graph of it,
    one replay a step). Augmentation is the dataset's own (the mirror acts on the
    source images before the host crop), so `cfg.augment.enabled` over a
    dataset that does not augment is refused rather than ignored."""
    if cfg.augment.enabled and getattr(dataset, "augment", None) is None:
        raise ValueError(
            "cfg.augment.enabled is set but this preprocessed dataset does "
            "not augment: batches arrive already cropped/resized, so the "
            "train step cannot mirror them. Construct the dataset with "
            "augment=cfg.augment (ImageDirDataset supports host-side "
            "mirror + crop jitter) or disable augmentation."
        )

    def source(start: int, dev: torch.device, mesh) -> Iterator[dict]:
        rows = None if mesh is None else mesh.batch_rows(cfg.batch_size)
        return dataset_lib.prefetch_to_device(dataset.batches(start), size=2, device=dev, rows=rows)

    return _run(cfg, num_steps, asset, device, log, source, raw=False)


def _weights(spec_list, base: tuple, error) -> tuple:
    """`base` loss weights with NAME=VALUE overrides; unknown names refused."""
    weights = dict(base)
    for spec in spec_list:
        name, sep, value = spec.partition("=")
        if not sep or name not in weights:
            error(f"--loss-weight {spec!r}: expected NAME=VALUE with NAME among {sorted(weights)}")
        weights[name] = float(value)
    return tuple(weights.items())


def parse_config(argv=None) -> tuple[argparse.Namespace, configs.TrainConfig]:
    """The command line's arguments and the `TrainConfig` that `main` trains
    with: the preset with each given flag applied. A bad flag exits through
    argparse, as `main` does. `--steps` stays an argument (`fit` folds it
    into the schedule's horizon)."""
    ap = argparse.ArgumentParser(description="Train on the synthetic stream, a disk dataset or an image directory.")
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
                    help="fused steps per call (graph replays on the card; sets where logs fall)")
    ap.add_argument("--loss-weight", action="append", default=None, metavar="NAME=VALUE",
                    help="override one loss weight (repeatable), e.g. --loss-weight j3d=5")
    ap.add_argument("--synthetic", action="append", default=None, metavar="FIELD=VALUE",
                    help="override one synthetic-stream field (repeatable), e.g. pose_std=0.35")
    ap.add_argument("--dataset", default=None,
                    help="train on a disk dataset: a .npz file, or a directory or glob of .npz shards")
    ap.add_argument("--image-dir", default=None,
                    help="train on an image directory (images/, masks/, keypoints.npz; data/image_dir.py)")
    ap.add_argument("--augment", action="store_true",
                    help="random mirror and crop jitter of the disk data, drawn per step (resume replays them)")
    ap.add_argument("--log-every", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=None,
                    help="save every N steps to --checkpoint-dir and resume from its latest")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--metrics", default=None, help="JSONL file of the logged steps' terms")
    ap.add_argument("--tensorboard", default=None, help="directory for TensorBoard event files")
    ap.add_argument("--profile", default=None,
                    help="write a torch.profiler Chrome trace of the run to DIR/trace.json")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly mode: name the op whose backward made a NaN")
    ap.add_argument("--ief-iters", type=int, default=None, help="IEF iterations (default 3)")
    ap.add_argument("--rot-format", default=None, choices=["axis_angle", "rot6d"],
                    help="pose rotation format; a checkpoint restores only under the format it trained with")
    ap.add_argument("--pretrained", default=None,
                    help="backbone npz from tools/import_resnet_weights.py")
    ap.add_argument("--mean-params", default=None,
                    help="IEF's initial Θ₀: an npz with 'mean_theta' or a .npy")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    disk = args.dataset or args.image_dir
    if args.dataset and args.image_dir:
        ap.error("--dataset and --image-dir are two data sources: give one")
    for flag, given in (("--synthetic", args.synthetic), ("--steps-per-call", args.steps_per_call)):
        if given is not None and disk:
            ap.error(f"{flag} applies to synthetic-stream training only")
    if args.augment and not disk:
        ap.error("--augment applies to disk data (--dataset or --image-dir)")

    cfg = configs.PRESETS[args.preset]
    updates = {}
    if args.augment:
        # replace(), not a fresh AugmentConfig: a preset's part convention
        # (config4_parts31) stays.
        updates["augment"] = dataclasses.replace(cfg.augment, enabled=True)
    if args.batch_size:
        updates["batch_size"] = args.batch_size
    if args.lr:
        updates["learning_rate"] = args.lr
    for flag, field in (("lr_schedule", "lr_schedule"), ("warmup_steps", "warmup_steps"),
                        ("grad_clip", "grad_clip_norm"), ("weight_decay", "weight_decay"),
                        ("ema_decay", "ema_decay"), ("steps_per_call", "steps_per_call"),
                        ("log_every", "log_every"), ("seed", "seed"),
                        ("checkpoint_every", "checkpoint_every"), ("checkpoint_dir", "checkpoint_dir"),
                        ("metrics", "metrics_path"), ("tensorboard", "tensorboard_dir"),
                        ("pretrained", "pretrained"), ("mean_params", "mean_params")):
        if getattr(args, flag) is not None:
            updates[field] = getattr(args, flag)
    if args.loss_weight:
        updates["loss_weights"] = _weights(args.loss_weight, cfg.loss_weights, ap.error)
    if args.synthetic:
        try:
            updates["synthetic"] = synthetic.apply_overrides(cfg.synthetic, args.synthetic)
        except (ValueError, NotImplementedError) as e:
            ap.error(str(e))
    model = cfg.model
    if args.image_size:
        model = dataclasses.replace(
            model, image_size=args.image_size,
            raster=dataclasses.replace(model.raster, image_size=args.image_size),
        )
    if args.ief_iters is not None:
        if args.ief_iters < 1:
            ap.error("--ief-iters must be >= 1")
        model = dataclasses.replace(model, ief=dataclasses.replace(model.ief, num_iterations=args.ief_iters))
    if args.rot_format is not None:
        model = dataclasses.replace(model, ief=dataclasses.replace(model.ief, rotation_format=args.rot_format))
    updates["model"] = model
    try:
        cfg = dataclasses.replace(cfg, **updates)
    except ValueError as e:
        ap.error(str(e))
    return args, cfg


def main(argv=None) -> int:
    args, cfg = parse_config(argv)
    if args.debug_nans:
        debug.enable_nan_checks()
    # Under torchrun: join the launched group (NCCL on the card, gloo for
    # --device cpu); _auto_mesh then spans it.
    joined = mesh_lib.init_from_env("nccl" if torch.device(args.device).type == "cuda" else "gloo")
    try:
        return _main_run(args, cfg)
    finally:
        if joined:
            dist.destroy_process_group()


def _main_run(args, cfg: configs.TrainConfig) -> int:
    trace = metrics.profile_trace(args.profile) if args.profile else contextlib.nullcontext()
    def log(rec):
        print(json.dumps(rec), flush=True)

    t0 = time.time()
    with trace:
        if args.image_dir:
            from indirect_learning_pose_shape_tpu_torch.data.image_dir import ImageDirDataset

            ds = ImageDirDataset(
                args.image_dir, cfg.batch_size, cfg.model.image_size,
                num_parts=cfg.model.raster.num_parts, seed=cfg.seed,
                augment=cfg.augment if cfg.augment.enabled else None,
            )
            _, terms = fit_preprocessed(cfg, ds, num_steps=args.steps, device=args.device, log=log)
        elif args.dataset:
            ds = dataset_lib.open_dataset(args.dataset, cfg.batch_size, seed=cfg.seed)
            _, terms = fit_dataset(cfg, ds, num_steps=args.steps, device=args.device, log=log)
        else:
            _, terms = fit(cfg, num_steps=args.steps, device=args.device, log=log)
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(f"done in {time.time() - t0:.1f}s; final: {terms}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
