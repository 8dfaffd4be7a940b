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

With `qparams` (`--int8`, calibrated on 16 images of the stream at seed
999, or `--qparams FILE`) every entry point scores the int8 encoder
(models/quantize.py) under `int8_impl` ('int8' by default, as the
reference; `--int8-impl int8c|sim|simc`), with the model's head and the
same render: the accuracy cost of the deployed quantized model.

`evaluate_dataset` (`--dataset D.npz` or a directory of shards) scores epoch
0 of a disk dataset in order, each raw batch cropped on the device by the
training path's own `train.preprocess_raw_batch` (no augmentation), the
ragged tail dropped; the 3D metrics appear when the file carries gt_pose
and gt_betas. `evaluate_preprocessed` (`--image-dir`) scores the host-
preprocessed batches of an image directory: image-space metrics only.

On the card each evaluator scores a batch as a CUDA graph, the
counterpart of the reference's cached `jax.jit` evaluation functions: one
graph per (evaluator, model and its tensors, consts, quantized encoder,
config, int8 impl, batch layout), the 8 most recent kept. The stream's
draws come from a generator registered with the graph and reseeded by
(seed, i) for batch i; a disk batch is copied into the graph's static
inputs. PA-MPJPE's batched 3x3 SVD (cuSOLVER) checks its status on the
host, which a capture refuses, so the graph ends at the Procrustes
covariance and the SVD and the alignment's tail run eagerly after each
replay. Graphed and eager scores are equal bitwise (`chip_smoke.py`);
`graphs=False` scores eagerly on the card, and the CPU always does.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import itertools
import json
import sys

import torch

from indirect_learning_pose_shape_tpu_torch import configs, predict, train
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.data import dataset as dataset_lib
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import quantize as quant
from indirect_learning_pose_shape_tpu_torch.models import smpl as smpl_mod
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib
from indirect_learning_pose_shape_tpu_torch.utils import graphs as graphs_lib
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
    return _procrustes_apply(*_procrustes_moments(pred, gt))


def _procrustes_moments(pred: torch.Tensor, gt: torch.Tensor) -> tuple:
    """The alignment up to its SVD: (centred pred, gt mean, covariance,
    pred variance)."""
    mu_p = pred.mean(dim=1, keepdim=True)
    mu_g = gt.mean(dim=1, keepdim=True)
    pc, gc = pred - mu_p, gt - mu_g
    cov = torch.einsum("bni,bnj->bij", gc, pc) / pred.shape[1]
    var_p = torch.mean(torch.sum(pc * pc, dim=-1), dim=1)
    return pc, mu_g, cov, var_p


def _procrustes_apply(pc, mu_g, cov, var_p) -> torch.Tensor:
    """The alignment from its moments: the SVD of the covariance (on the
    card it reads its status on the host, so no CUDA graph can hold it),
    the rotation, the scale."""
    u, s, vt = torch.linalg.svd(cov)
    det = torch.linalg.det(u @ vt)
    d = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    rot = torch.einsum("bij,bj,bjk->bik", u, d, vt)
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
    model: net.Model,
    consts: net.ModelConsts,
    batch: dict,
    cfg: configs.TrainConfig,
    qenc: quant.QuantizedEncoder | None = None,
    int8_impl: str = "int8",
) -> dict[str, torch.Tensor]:
    """The metrics of one batch, as device scalars: the rendered prediction
    with running-statistics BatchNorm (or through the quantized encoder
    `qenc` under `int8_impl`), and, where the batch has gt_pose and
    gt_betas, the 3D metrics against the ground-truth SMPL through
    `cfg.model.smpl_impl` (the LBS kernel on the card)."""
    return _finish(*_metrics_on_device(model, consts, batch, cfg, qenc, int8_impl))


def _metrics_on_device(model, consts, batch, cfg, qenc, int8_impl) -> tuple[dict, tuple | None]:
    """`_batch_metrics` as far as a CUDA graph can record it: (the metrics
    but PA-MPJPE, PA-MPJPE's Procrustes moments and the ground-truth joints
    or None without ground truth)."""
    if qenc is None:
        outputs = net.forward_train(model, consts, batch["image"], cfg.model, train=False)
    else:
        outputs = quant.quantized_forward(qenc, model.ief, consts, batch["image"], cfg.model, int8_impl)
        outputs = net.render_outputs(outputs, consts, cfg.model)
    metrics = {"sil_iou": silhouette_iou_metric(outputs["silhouette"], batch["silhouette"])}
    metrics["part_acc"], metrics["miou"] = part_metrics(outputs["probs"], batch["part_labels"])
    vis = batch["kp_vis"]
    err = torch.linalg.vector_norm(outputs["kp2d"] - batch["kp2d"], dim=-1)
    metrics["kp_err_px"] = torch.sum(err * vis) / torch.clamp(torch.sum(vis), min=1.0)
    if "gt_pose" not in batch or "gt_betas" not in batch:
        return metrics, None
    gt = smpl_mod.smpl_forward(
        consts.smpl, batch["gt_pose"], batch["gt_betas"], impl=cfg.model.smpl_impl
    )
    metrics["pve"] = pve(outputs["verts"], gt["verts"])
    metrics["mpjpe"] = mpjpe(outputs["kp3d"], gt["kp3d"])
    return metrics, (*_procrustes_moments(outputs["kp3d"], gt["kp3d"]), gt["kp3d"])


def _finish(metrics: dict, moments: tuple | None) -> dict[str, torch.Tensor]:
    """The metrics with PA-MPJPE from `moments`, eagerly (`_procrustes_apply`)."""
    if moments is None:
        return dict(metrics)
    *align, gt = moments
    return dict(metrics, pa_mpjpe=mpjpe(_procrustes_apply(*align), gt))


# The evaluators' CUDA graphs, most recently used last: 8 kept, as the
# reference keeps 8 of each evaluation executable (`functools.lru_cache`).
_GRAPHS_KEPT = 8
_graphs: collections.OrderedDict = collections.OrderedDict()


def clear_graphs() -> None:
    """Drop the evaluators' cached CUDA graphs, their memory pools and the
    models they hold."""
    _graphs.clear()


def _device_fn(kind: str, model, consts, cfg, qenc, int8_impl, gen: torch.Generator):
    """One batch's device work, `item -> _metrics_on_device(...)`: for the
    stream (`kind` 'stream') the batch drawn from `gen`, seeded by the
    caller, for a disk dataset ('dataset') the raw batch `item` cropped by
    `train.preprocess_raw_batch` (no augmentation) with its ground truth
    passed through, for host-preprocessed batches ('preprocessed') `item`."""

    @torch.no_grad()
    def fn(item):
        if kind == "stream":
            batch = train._draw_batch(gen, cfg.batch_size, consts, cfg)
        elif kind == "dataset":
            batch = dict(train.preprocess_raw_batch(item, cfg), **{k: item[k] for k in _GT if k in item})
        else:
            batch = item
        return _metrics_on_device(model, consts, batch, cfg, qenc, int8_impl)

    return fn


_GT = ("gt_pose", "gt_betas")


def _runner(kind: str, model, consts, cfg, qparams, int8_impl, device, graphed: bool):
    """`item -> metrics`: the stream's generator reseeded by `item`, or the
    disk batch `item` staged, then the batch's device work (`_device_fn`)
    and PA-MPJPE's tail eagerly. `graphed`: through the cached captured
    call of each batch layout (see `_GRAPHS_KEPT`), captured anew where the
    model's parameters or buffers are not the tensors it was captured with;
    else eagerly, on `item` itself."""
    calls: dict = {}

    def call_for(layout) -> graphs_lib.CapturedCall:
        key = (kind, id(model), id(consts), id(qparams), cfg, int8_impl, layout)
        call = _graphs.pop(key, None) if graphed else None
        if call is None:
            # Built here and held by the call: a replay reads this encoder's tensors.
            qenc = None if qparams is None else quant.as_encoder(qparams, cfg.model.encoder, device)
            gen = torch.Generator(device=device)
            fn = _device_fn(kind, model, consts, cfg, qenc, int8_impl, gen)
            call = graphs_lib.CapturedCall(
                fn, device, (gen,), lambda: [model, consts, qparams, *model.parameters(), *model.buffers()]
            )
        if graphed:
            _graphs[key] = call
            while len(_graphs) > _GRAPHS_KEPT:
                _graphs.popitem(last=False)
        return call

    def run(item):
        layout = None if kind == "stream" else tuple((k, v.shape, v.dtype) for k, v in item.items())
        if layout not in calls:
            calls[layout] = call_for(layout)
        call = calls[layout]
        if kind == "stream":
            call.generators[0].manual_seed(item)
        elif graphed:
            call.stage(item)
        return _finish(*(call() if graphed else call.fn(item)))

    return run


def evaluate(
    model: net.Model,
    consts: net.ModelConsts,
    cfg: configs.TrainConfig,
    num_batches: int = 4,
    seed: int = 123,
    qparams=None,
    int8_impl: str = "int8",
    graphs: bool = True,
) -> dict[str, float]:
    """The mean of each metric over `num_batches` batches of `cfg.batch_size`
    from the evaluation stream of `seed` (batch i is `train.make_batch(seed,
    i, ...)`, the training stream's batch i of seed `seed`); with `qparams`,
    of the int8 encoder under `int8_impl`. On the card a batch is a graph
    replay (`graphs=False`: eager)."""
    seeds = (train.step_seed(seed, i) for i in range(num_batches))
    return _mean_metrics(model, consts, cfg, "stream", seeds, qparams, int8_impl, graphs)


def _mean_metrics(model, consts, cfg, kind, items, qparams=None, int8_impl="int8", graphs=True) -> dict[str, float]:
    """The mean of each metric over the batches of `items` (see
    `_device_fn`), accumulated on the device in batch order and read to the
    host once; through the cached graphs on the card unless `graphs` is
    False."""
    if int8_impl not in quant.IMPLS:
        raise ValueError(f"int8_impl must be one of {quant.IMPLS}, got {int8_impl!r}")
    device = consts.smpl.v_template.device
    graphed = graphs and graphs_lib.eager_reason(device) is None
    run = _runner(kind, model, consts, cfg, qparams, int8_impl, device, graphed)
    sums: dict[str, torch.Tensor] = {}
    n = 0
    for item in items:
        m = run(item)
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
    qparams=None,
    int8_impl: str = "int8",
    graphs: bool = True,
) -> dict[str, float]:
    """The mean metrics (of the int8 encoder with `qparams`) over epoch 0 of
    a disk dataset (`NpzDataset` or `ShardedNpzDataset`), at most
    `max_batches` batches, in its order: each raw batch prefetched to the
    model's device and cropped by `train.preprocess_raw_batch` without
    augmentation. The 3D metrics (PVE, MPJPE, PA-MPJPE) appear when the
    dataset has gt_pose and gt_betas. On the card a batch is a graph replay
    (`graphs=False`: eager)."""
    has_gt = set(_GT) <= set(dataset.keys)
    raw_keys = ("images", "masks", "kp2d", "kp_vis") + (_GT if has_gt else ())
    raw = ({k: b[k] for k in raw_keys} for b in itertools.islice(dataset.epoch(0), max_batches or None))
    device = consts.smpl.v_template.device
    batches = dataset_lib.prefetch_to_device(raw, size=2, device=device)
    try:
        return _mean_metrics(model, consts, cfg, "dataset", batches, qparams, int8_impl, graphs)
    finally:
        batches.close()


def evaluate_preprocessed(
    model: net.Model,
    consts: net.ModelConsts,
    cfg: configs.TrainConfig,
    dataset,
    max_batches: int | None = None,
    qparams=None,
    int8_impl: str = "int8",
    graphs: bool = True,
) -> dict[str, float]:
    """The mean image-space metrics (of the int8 encoder with `qparams`)
    over one epoch (or `max_batches`) of a host-preprocessed stream
    (`data/image_dir.ImageDirDataset`), its batches prefetched to the
    model's device. An image directory carries no SMPL ground truth, so no
    3D metric. On the card a batch is a graph replay (`graphs=False`:
    eager)."""
    limit = min(max_batches or dataset.steps_per_epoch(), dataset.steps_per_epoch())
    device = consts.smpl.v_template.device
    batches = dataset_lib.prefetch_to_device(
        itertools.islice(dataset.batches(), limit), size=2, device=device
    )
    try:
        return _mean_metrics(model, consts, cfg, "preprocessed", batches, qparams, int8_impl, graphs)
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


def int8_qparams(model: net.Model, consts: net.ModelConsts, cfg: configs.TrainConfig,
                 keep_sites: tuple = ()) -> dict:
    """The CLIs' quantized encoder: `ptq_quantize` calibrated on 16 images
    of `cfg`'s synthetic stream at seed 999, held out of every eval seed."""
    calib = predict.synthetic_images(consts, cfg.model, 16, seed=999, synthetic_cfg=cfg.synthetic)
    return quant.ptq_quantize(model.encoder, calib, keep_sites)


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
    ap.add_argument("--int8", action="store_true",
                    help="score the int8 encoder, calibrated on a synthetic batch (seed 999)")
    ap.add_argument("--qparams", default=None,
                    help="a quantized encoder .npz (models/quantize.save_qparams); implies --int8")
    ap.add_argument("--int8-impl", default="int8", choices=quant.IMPLS,
                    help="'int8' per site (float32 between convs), 'int8c' carried int8; "
                    "sim/simc their float32-sum twins")
    args = ap.parse_args(argv)
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
    qparams = None
    if args.qparams:
        qparams = quant.load_qparams(args.qparams)
    elif args.int8:
        qparams = int8_qparams(model, consts, cfg)
    kw = dict(qparams=qparams, int8_impl=args.int8_impl)
    if args.image_dir:
        from indirect_learning_pose_shape_tpu_torch.data.image_dir import ImageDirDataset

        ds = ImageDirDataset(args.image_dir, cfg.batch_size, cfg.model.image_size,
                             num_parts=cfg.model.raster.num_parts, seed=cfg.seed)
        metrics = evaluate_preprocessed(model, consts, cfg, ds, max_batches=args.batches or None, **kw)
    elif args.dataset:
        ds = dataset_lib.open_dataset(args.dataset, cfg.batch_size, seed=cfg.seed)
        metrics = evaluate_dataset(model, consts, cfg, ds, max_batches=args.batches or None, **kw)
    else:
        metrics = evaluate(model, consts, cfg, num_batches=args.batches, **kw)
    print(json.dumps({k: round(v, 5) for k, v in metrics.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
