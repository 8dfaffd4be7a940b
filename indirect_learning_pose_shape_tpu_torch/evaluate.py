"""Evaluation on the synthetic stream (port of evaluate.py's metrics and
`evaluate`).

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

    python -m indirect_learning_pose_shape_tpu_torch.evaluate --preset config4_mixed --batches 4

scores the preset's seed-initialised model and prints one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import torch

from indirect_learning_pose_shape_tpu_torch import configs, train
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import smpl as smpl_mod
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib
from indirect_learning_pose_shape_tpu_torch.utils import device as device_lib
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
    with running-statistics BatchNorm, and the ground-truth SMPL through
    `cfg.model.smpl_impl` (the LBS kernel on the card)."""
    outputs = net.forward_train(model, consts, batch["image"], cfg.model, train=False)
    metrics = {"sil_iou": silhouette_iou_metric(outputs["silhouette"], batch["silhouette"])}
    metrics["part_acc"], metrics["miou"] = part_metrics(outputs["probs"], batch["part_labels"])
    vis = batch["kp_vis"]
    err = torch.linalg.vector_norm(outputs["kp2d"] - batch["kp2d"], dim=-1)
    metrics["kp_err_px"] = torch.sum(err * vis) / torch.clamp(torch.sum(vis), min=1.0)
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
    sums: dict[str, torch.Tensor] = {}
    for i in range(num_batches):
        batch = train.make_batch(seed, i, cfg.batch_size, consts, cfg)
        m = _batch_metrics(model, consts, batch, cfg)
        sums = {k: sums.get(k, 0.0) + v for k, v in m.items()}
    names = sorted(sums)
    means = (torch.stack([sums[k] for k in names]) / num_batches).tolist()
    return dict(zip(names, means))


# Reference flags that need an item not ported yet.
_REFUSED = {
    "checkpoint": configs.CHECKPOINTS, "step": configs.CHECKPOINTS, "ema": configs.CHECKPOINTS,
    "dataset": configs.DISK_DATA, "image_dir": configs.DISK_DATA,
    "int8": configs.INT8, "qparams": configs.INT8, "int8_impl": configs.INT8,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Score a model on the synthetic stream.")
    ap.add_argument("--preset", default="config4_full", choices=sorted(configs.PRESETS))
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--eval-suite", default=None, choices=sorted(synthetic.EVAL_SUITES),
                    help="a named eval distribution (synthetic.EVAL_SUITES)")
    ap.add_argument("--synthetic", action="append", default=None, metavar="FIELD=VALUE",
                    help="override one synthetic-stream field (repeatable), on top of the suite")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--ema", action="store_true")
    ap.add_argument("--dataset", default=None)
    ap.add_argument("--image-dir", default=None)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--qparams", default=None)
    ap.add_argument("--int8-impl", default=None)
    args = ap.parse_args(argv)
    for flag, item in _REFUSED.items():
        if getattr(args, flag) not in (None, False):
            ap.error(f"--{flag.replace('_', '-')} is not ported yet; it comes with {item}")

    cfg = configs.PRESETS[args.preset]
    updates = {}
    if args.batch_size:
        updates["batch_size"] = args.batch_size
    if args.image_size:
        updates["model"] = dataclasses.replace(
            cfg.model,
            image_size=args.image_size,
            raster=dataclasses.replace(cfg.model.raster, image_size=args.image_size),
        )
    specs = list(synthetic.EVAL_SUITES[args.eval_suite]) if args.eval_suite else []
    specs += args.synthetic or []
    if specs:
        try:
            updates["synthetic"] = synthetic.apply_overrides(cfg.synthetic, specs)
        except (ValueError, NotImplementedError) as e:
            ap.error(str(e))
    cfg = dataclasses.replace(cfg, **updates)

    device = device_lib.resolve(args.device)
    disable_tf32()
    model, consts = net.init(assets_lib.load_asset(), cfg.model, seed=cfg.seed, device=device)
    metrics = evaluate(model, consts, cfg, num_batches=args.batches)
    print(json.dumps({k: round(v, 5) for k, v in metrics.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
