"""Evaluation (port of evaluate.py): the synthetic stream, disk datasets and
image directories.

The 3D pose/shape metrics of the genre against the stream's exact ground
truth, and the image-space metrics of the rendered prediction:

- PVE: mean per-vertex Euclidean error between the predicted and the
  ground-truth SMPL surfaces;
- MPJPE: mean per-joint position error on the regressed 3D keypoints;
- PA-MPJPE: MPJPE after a similarity (Procrustes) alignment per item;
- silhouette IoU at a 0.5 threshold, part accuracy and mean per-class IoU
  of the rendered part map, and the visible keypoints' pixel error.

`evaluate` scores `num_batches` batches of the stream, batch i drawn from a
generator seeded by (seed, i), with running-statistics BatchNorm
(`forward_train(train=False)`); it is deterministic for a fixed seed and
batch count. The metrics accumulate on the device and reach the host once.

    python -m indirect_learning_pose_shape_tpu_torch.evaluate --preset config4_robust \
        --checkpoint D [--step N] [--ema] [--eval-suite hardapp] --batches 4

scores the latest (or step N's) model of a training checkpoint, or its EMA
(the preset's seed-initialised model without --checkpoint), and prints one
JSON line. `tools/quality_eval.py` is the 3-seed protocol over `evaluate`.

`evaluate_dataset` (`--dataset D.npz` or a directory of shards) scores epoch
0 of a disk dataset in order, each raw batch cropped on the device by the
training path's own `train.preprocess_raw_batch` (no augmentation), the
ragged tail dropped; the 3D metrics appear when the file carries gt_pose
and gt_betas. `evaluate_preprocessed` (`--image-dir`) scores the host-
preprocessed batches of an image directory: image-space metrics only.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys

import torch

from indirect_learning_pose_shape_tpu_torch import configs, predict, train
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.data import dataset as dataset_lib
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import smpl as smpl_mod
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib
from indirect_learning_pose_shape_tpu_torch.utils.precision import disable_tf32


def pve(pred_verts: torch.Tensor, gt_verts: torch.Tensor) -> torch.Tensor:
    """Mean per-vertex Euclidean error. [B, V, 3] x2 -> scalar."""
    return torch.mean(torch.linalg.vector_norm(pred_verts - gt_verts, dim=-1))


def mpjpe(pred_joints: torch.Tensor, gt_joints: torch.Tensor) -> torch.Tensor:
    """Mean per-joint position error. [B, K, 3] x2 -> scalar."""
    return torch.mean(torch.linalg.vector_norm(pred_joints - gt_joints, dim=-1))


def procrustes_align(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Similarity-align pred to gt per item (Umeyama, float32, batched SVD),
    with the reflection fix: the rotation keeps det +1. [B, N, 3] x2."""
    mu_p = pred.mean(dim=1, keepdim=True)
    mu_g = gt.mean(dim=1, keepdim=True)
    pc, gc = pred - mu_p, gt - mu_g
    cov = torch.einsum("bni,bnj->bij", gc, pc) / pred.shape[1]
    u, s, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    rot = torch.einsum("bij,bj,bjk->bik", u, d, vt)
    var_p = torch.mean(torch.sum(pc * pc, dim=-1), dim=1)
    scale = torch.sum(s * d, dim=-1) / (var_p + 1e-12)
    return scale[:, None, None] * torch.einsum("bij,bnj->bni", rot, pc) + mu_g


def pa_mpjpe(pred_joints: torch.Tensor, gt_joints: torch.Tensor) -> torch.Tensor:
    return mpjpe(procrustes_align(pred_joints, gt_joints), gt_joints)


def silhouette_iou_metric(pred_sil: torch.Tensor, target_sil: torch.Tensor) -> torch.Tensor:
    """Hard IoU at a 0.5 threshold, per image, then the mean. [B, H, W] x2."""
    p, t = pred_sil > 0.5, target_sil > 0.5
    inter = torch.sum(p & t, dim=(-2, -1)).float()
    union = torch.sum(p | t, dim=(-2, -1)).float()
    return torch.mean(inter / torch.clamp(union, min=1.0))


def part_metrics(
    pred_probs: torch.Tensor, target_labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(part accuracy, mean per-class IoU) of the argmax part map.

    pred_probs [B, H, W, C+1], target_labels [B, H, W] int. Accuracy counts
    every pixel, background included; the IoU is averaged over the classes
    present in the target or the prediction."""
    pred = torch.argmax(pred_probs, dim=-1)
    tgt = target_labels.to(pred.dtype)
    acc = torch.mean((pred == tgt).float())
    classes = torch.arange(pred_probs.shape[-1], device=pred.device)
    p1 = pred[..., None] == classes
    t1 = tgt[..., None] == classes
    inter = torch.sum(p1 & t1, dim=(0, 1, 2)).float()
    union = torch.sum(p1 | t1, dim=(0, 1, 2)).float()
    present = union > 0
    iou = torch.where(present, inter / torch.clamp(union, min=1.0), 0.0)
    miou = torch.sum(iou) / torch.clamp(present.sum(), min=1).float()
    return acc, miou


@torch.no_grad()
def _batch_metrics(
    model: net.Model, consts: net.ModelConsts, batch: dict, cfg: configs.TrainConfig
) -> dict[str, torch.Tensor]:
    """The metrics of one batch, as device scalars: the rendered prediction
    with running-statistics BatchNorm, and, where the batch has gt_pose and
    gt_betas, the 3D metrics against the ground-truth SMPL through
    `cfg.model.smpl_impl` (the LBS kernel on the card)."""
    outputs = net.forward_train(model, consts, batch["image"], cfg.model, train=False)
    metrics = {"sil_iou": silhouette_iou_metric(outputs["silhouette"], batch["silhouette"])}
    metrics["part_acc"], metrics["miou"] = part_metrics(outputs["probs"], batch["part_labels"])
    vis = batch["kp_vis"]
    err = torch.linalg.vector_norm(outputs["kp2d"] - batch["kp2d"], dim=-1)
    metrics["kp_err_px"] = torch.sum(err * vis) / torch.clamp(torch.sum(vis), min=1.0)
    if "gt_pose" not in batch or "gt_betas" not in batch:
        return metrics
    gt = smpl_mod.smpl_forward(
        consts.smpl, batch["gt_pose"], batch["gt_betas"], impl=cfg.model.smpl_impl
    )
    metrics["pve"] = pve(outputs["verts"], gt["verts"])
    metrics["mpjpe"] = mpjpe(outputs["kp3d"], gt["kp3d"])
    metrics["pa_mpjpe"] = pa_mpjpe(outputs["kp3d"], gt["kp3d"])
    return metrics


def evaluate(
    model: net.Model,
    consts: net.ModelConsts,
    cfg: configs.TrainConfig,
    num_batches: int = 4,
    seed: int = 123,
) -> dict[str, float]:
    """The mean of each metric over `num_batches` batches of `cfg.batch_size`
    from the evaluation stream of `seed` (batch i is `train.make_batch(seed,
    i, ...)`, the training stream's batch i of seed `seed`)."""
    return _mean_metrics(
        model, consts, cfg,
        (train.make_batch(seed, i, cfg.batch_size, consts, cfg) for i in range(num_batches)),
    )


def _mean_metrics(model, consts, cfg, batches) -> dict[str, float]:
    """The mean of each metric over `batches`, accumulated on the device and
    read to the host once."""
    sums: dict[str, torch.Tensor] = {}
    n = 0
    for batch in batches:
        m = _batch_metrics(model, consts, batch, cfg)
        sums = {k: sums.get(k, 0.0) + v for k, v in m.items()}
        n += 1
    if n == 0:
        raise ValueError("dataset yielded no full batches")
    names = sorted(sums)
    means = (torch.stack([sums[k] for k in names]) / n).tolist()
    return dict(zip(names, means))


def evaluate_dataset(
    model: net.Model,
    consts: net.ModelConsts,
    cfg: configs.TrainConfig,
    dataset,
    max_batches: int | None = None,
) -> dict[str, float]:
    """The mean metrics over epoch 0 of a disk dataset (`NpzDataset` or
    `ShardedNpzDataset`), at most `max_batches` batches, in its order: each
    raw batch prefetched to the model's device and cropped by
    `train.preprocess_raw_batch` without augmentation. The 3D metrics
    (PVE, MPJPE, PA-MPJPE) appear when the dataset has gt_pose and
    gt_betas."""
    has_gt = {"gt_pose", "gt_betas"} <= set(dataset.keys)
    raw_keys = ("images", "masks", "kp2d", "kp_vis") + (("gt_pose", "gt_betas") if has_gt else ())
    raw = ({k: b[k] for k in raw_keys} for b in itertools.islice(dataset.epoch(0), max_batches or None))
    device = consts.smpl.v_template.device
    batches = dataset_lib.prefetch_to_device(raw, size=2, device=device)
    try:
        return _mean_metrics(model, consts, cfg, (
            dict(train.preprocess_raw_batch(r, cfg), **{k: r[k] for k in ("gt_pose", "gt_betas") if k in r})
            for r in batches
        ))
    finally:
        batches.close()


def evaluate_preprocessed(
    model: net.Model,
    consts: net.ModelConsts,
    cfg: configs.TrainConfig,
    dataset,
    max_batches: int | None = None,
) -> dict[str, float]:
    """The mean image-space metrics over one epoch (or `max_batches`) of a
    host-preprocessed stream (`data/image_dir.ImageDirDataset`), its batches
    prefetched to the model's device. An image directory carries no SMPL
    ground truth, so no 3D metric."""
    limit = min(max_batches or dataset.steps_per_epoch(), dataset.steps_per_epoch())
    device = consts.smpl.v_template.device
    batches = dataset_lib.prefetch_to_device(
        itertools.islice(dataset.batches(), limit), size=2, device=device
    )
    try:
        return _mean_metrics(model, consts, cfg, batches)
    finally:
        batches.close()


def eval_config(
    cfg: configs.TrainConfig,
    batch_size: int | None = None,
    image_size: int | None = None,
    suite: str | None = None,
    synthetic_specs=(),
    ief_iters: int | None = None,
    rot_format: str | None = None,
) -> tuple[configs.TrainConfig, list[str]]:
    """`cfg` scored as the CLIs ask: another batch or image size, the
    stream of a named suite (`synthetic.EVAL_SUITES`) with FIELD=VALUE
    overrides on top, the IEF iterations and rotation format the checkpoint
    trained with. Returns the config and the stream overrides applied;
    raises ValueError on a bad override.

    A suite names the whole stream: its fields are applied to the default
    `SyntheticConfig`, not to the preset's, so `plain` is the plain stream
    for config4_robust too (the reference applies them to the preset's
    stream, where config4_robust's 'plain' is its own hardapp stream)."""
    updates, model = {}, cfg.model
    if batch_size:
        updates["batch_size"] = batch_size
    if image_size:
        model = dataclasses.replace(
            model, image_size=image_size, raster=dataclasses.replace(model.raster, image_size=image_size)
        )
    if ief_iters is not None:
        model = dataclasses.replace(model, ief=dataclasses.replace(model.ief, num_iterations=ief_iters))
    if rot_format is not None:
        model = dataclasses.replace(model, ief=dataclasses.replace(model.ief, rotation_format=rot_format))
    specs = list(synthetic.EVAL_SUITES[suite]) if suite else []
    specs += list(synthetic_specs or [])
    if suite or specs:
        base = synthetic.SyntheticConfig() if suite else cfg.synthetic
        updates["synthetic"] = synthetic.apply_overrides(base, specs)
    return dataclasses.replace(cfg, model=model, **updates), specs


# Reference flags that need an item not ported yet.
_REFUSED = {"int8": configs.INT8, "qparams": configs.INT8, "int8_impl": configs.INT8}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Score a model on the synthetic stream, a disk dataset or an image directory."
    )
    ap.add_argument("--preset", default="config4_full", choices=sorted(configs.PRESETS))
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--eval-suite", default=None, choices=sorted(synthetic.EVAL_SUITES),
                    help="a named eval distribution (synthetic.EVAL_SUITES)")
    ap.add_argument("--synthetic", action="append", default=None, metavar="FIELD=VALUE",
                    help="override one synthetic-stream field (repeatable), on top of the suite")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--checkpoint", default=None, help="a training run's checkpoint_dir")
    ap.add_argument("--step", type=int, default=None, help="score this checkpoint step (default: the latest)")
    ap.add_argument("--ema", action="store_true", help="score the checkpoint's EMA parameters")
    ap.add_argument("--dataset", default=None,
                    help="score a disk dataset: a .npz file, or a directory or glob of .npz shards "
                    "(the 3D metrics when it has gt_pose and gt_betas)")
    ap.add_argument("--image-dir", default=None,
                    help="score an image directory (images/, masks/, keypoints.npz): image-space metrics")
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--qparams", default=None)
    ap.add_argument("--int8-impl", default=None)
    args = ap.parse_args(argv)
    for flag, item in _REFUSED.items():
        if getattr(args, flag) not in (None, False):
            ap.error(f"--{flag.replace('_', '-')} is not ported yet; it comes with {item}")
    if (args.step is not None or args.ema) and not args.checkpoint:
        ap.error("--step and --ema need --checkpoint")
    if args.dataset and args.image_dir:
        ap.error("--dataset and --image-dir are two data sources: give one")
    if (args.dataset or args.image_dir) and (args.eval_suite or args.synthetic):
        ap.error("--eval-suite/--synthetic apply to synthetic-stream scoring only")
    try:
        cfg, _ = eval_config(
            configs.PRESETS[args.preset], args.batch_size, args.image_size, args.eval_suite, args.synthetic
        )
    except ValueError as e:
        ap.error(str(e))

    disable_tf32()
    model, consts = predict.load_model(
        cfg.model, asset=assets_lib.load_asset(), seed=cfg.seed, device=args.device,
        ema=args.ema, checkpoint_dir=args.checkpoint, step=args.step,
    )
    if args.image_dir:
        from indirect_learning_pose_shape_tpu_torch.data.image_dir import ImageDirDataset

        ds = ImageDirDataset(args.image_dir, cfg.batch_size, cfg.model.image_size,
                             num_parts=cfg.model.raster.num_parts, seed=cfg.seed)
        metrics = evaluate_preprocessed(model, consts, cfg, ds, max_batches=args.batches or None)
    elif args.dataset:
        ds = dataset_lib.open_dataset(args.dataset, cfg.batch_size, seed=cfg.seed)
        metrics = evaluate_dataset(model, consts, cfg, ds, max_batches=args.batches or None)
    else:
        metrics = evaluate(model, consts, cfg, num_batches=args.batches)
    print(json.dumps({k: round(v, 5) for k, v in metrics.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
