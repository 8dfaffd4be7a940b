"""The training step in plain PyTorch: the batch (`stream.py`), the forward
(`model.py`) with the soft raster of the prediction, the indirect losses,
autograd, global-norm clipping, Adam and the learning-rate schedule.

Losses, each a mean over the batch (the reference package's `losses.py`):
silhouette BCE on clip(p, 1e-7, 1 − 1e-7) and soft IoU 1 − |p∩t|/|p∪t|
per image; part cross-entropy log(γ + Σ score) − log(max(score_label, 1e-7))
with score_bg = γ; visibility-masked squared keypoint error in image units;
priors Σ β² and Σ pose_prior²; with direct supervision squared 3D joint,
Frobenius rotation and β errors. A clip at a bound passes half the
gradient there (max/min of equal values), as `jnp.clip` does.

The update: clip by global norm when `clip` > 0; Adam (0.9, 0.999, 1e-8)
with bias correction; rate lr · factor(t) for update t = 0, 1, ...: 1, or a
linear warm-up over `warmup` updates then a cosine decay to 0 at `steps`.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import body as body_lib
from portbench.reference import model as model_lib
from portbench.reference import raster as raster_lib
from portbench.reference import stream as stream_lib
from portbench.reference.precision import Precision, full_float32

_EPS = 1e-7
ADAM = (0.9, 0.999, 1e-8)  # β₁, β₂, ε


def _clip(x, lo=None, hi=None):
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def losses(out: dict, score: torch.Tensor, batch: dict, weights: dict, cfg: dict) -> dict:
    """The weighted terms and `total`; score [B, C, H, W] float32."""
    B, C = score.shape[:2]
    gamma, size = cfg["bg_gamma"], cfg["image_size"]
    s_total = score.sum(dim=1)
    sil = s_total / (gamma + s_total)
    t = batch["silhouette"]
    terms = {}
    if weights.get("sil_bce"):
        p = _clip(sil, _EPS, 1.0 - _EPS)
        terms["sil_bce"] = -torch.mean(t * torch.log(p) + (1.0 - t) * torch.log1p(-p))
    if weights.get("sil_iou"):
        inter = torch.sum(sil * t, dim=(-2, -1))
        union = torch.sum(sil + t - sil * t, dim=(-2, -1))
        terms["sil_iou"] = torch.mean(1.0 - inter / (union + _EPS))
    if weights.get("part_ce"):
        labels = batch["part_labels"].reshape(B, 1, -1).long()
        flat = score.reshape(B, C, -1)
        picked = torch.gather(flat, 1, (labels - 1).clamp_min(0))[:, 0]
        picked = torch.where(labels[:, 0] == 0, torch.full_like(picked, gamma), picked)
        ce = torch.log(gamma + s_total.reshape(B, -1)) - torch.log(_clip(picked, _EPS, None))
        terms["part_ce"] = torch.mean(ce)
    if weights.get("kp"):
        err = torch.sum(((out["kp2d"] - batch["kp2d"]) / size) ** 2, dim=-1)
        vis = batch["kp_vis"]
        terms["kp"] = torch.sum(err * vis) / (torch.sum(vis) + _EPS)
    if weights.get("shape_reg"):
        terms["shape_reg"] = torch.mean(torch.sum(out["betas"] ** 2, dim=-1))
    if weights.get("pose_reg"):
        terms["pose_reg"] = torch.mean(torch.sum(out["pose_prior"] ** 2, dim=-1))
    if weights.get("j3d"):
        terms["j3d"] = torch.mean(torch.sum((out["joints"] - batch["joints3d"]) ** 2, dim=-1))
    if weights.get("rotmat"):
        terms["rotmat"] = torch.mean(torch.sum((out["rotmats"] - batch["rotmats"]) ** 2, dim=(-2, -1)))
    if weights.get("betas_l2"):
        terms["betas_l2"] = torch.mean(torch.sum((out["betas"] - batch["betas"]) ** 2, dim=-1))
    terms["total"] = sum(weights[k] * v for k, v in terms.items())
    return terms


def lr_factor(t: int, cfg: dict) -> float:
    if cfg["lr_schedule"] == "constant":
        return 1.0
    warm = cfg["warmup_steps"]
    if t < warm:
        return t / warm
    decay = max(cfg["num_steps"], warm + 1) - warm
    return 0.5 * (1.0 + math.cos(math.pi * min(t - warm, decay) / decay))


class Inputs:
    """What both sides get: the asset's body, its part grouping and face
    classes, on one device."""

    def __init__(self, asset, num_parts: int, device):
        self.body = body_lib.body_from_asset(asset, num_parts, device)
        self.parts = raster_lib.parts(self.body.labels, num_parts, device)
        from portbench.reference.hard import face_class

        self.fclass = torch.as_tensor(face_class(asset.faces, self.body.labels), device=device)


def make_batch(inp: Inputs, cfg: dict, seed: int, step: int, prec: Precision) -> dict:
    b = inp.body
    gen = torch.Generator(device=b.v_template.device).manual_seed(stream_lib.step_seed(seed, step))
    d = stream_lib.draws(gen, cfg["batch_size"], b.num_joints, b.shapedirs.shape[1],
                         b.coco_regressor.shape[0], cfg["num_parts"], cfg["stream"], cfg["image_size"])
    include_3d = any(cfg["loss_weights"].get(k) for k in ("j3d", "v3d", "rotmat"))
    with full_float32():
        return stream_lib.batch(d, b, inp.parts, inp.fclass, cfg["stream"], cfg["image_size"],
                                cfg["sigma"], cfg["bg_gamma"], prec, include_3d)


def run_steps(weights: dict, inp: Inputs, cfg: dict, seed: int, steps: int, prec: Precision,
              rows: int | None = None, first: int = 0, adam: tuple | None = None) -> dict:
    """`steps` training steps from `weights` (not modified) on the stream of
    `seed`, the first of them step `first`: each step's loss terms, the
    first step's BatchNorm batch statistics and gradients as Adam gets them
    (after the clip), and the parameters after the last step. `adam`, when
    given, is Adam's (first, second) moments after `first` updates, each
    {leaf: tensor}, a leaf without them at 0; else both start at 0. `rows` < the
    batch trains on the batch's first rows only (a fault, for the check's
    readings)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()
              if not k.endswith((".mean", ".var"))}
    fixed = {k: v for k, v in weights.items() if k.endswith((".mean", ".var"))}
    if adam is None:
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    else:
        m, v2 = ({k: d[k].detach().to(p.device, torch.float32, copy=True) if k in d else torch.zeros_like(p)
                  for k, p in params.items()} for d in adam)
    b1, b2, eps = ADAM
    terms_per_step, first_grad, bn1 = [], None, {}
    with full_float32():
        for t in range(first, first + steps):
            batch = make_batch(inp, cfg, seed, t, prec)
            if rows is not None:
                batch = {k: v[:rows] for k, v in batch.items()}
            out = model_lib.forward({**params, **fixed}, inp.body, batch["image"], cfg, True, prec,
                                    bn1 if t == first else None)
            score = raster_lib.scores(out["verts2d"], inp.parts, cfg["image_size"], cfg["sigma"], prec)
            terms = losses(out, score, batch, cfg["loss_weights"], cfg)
            grads = torch.autograd.grad(terms["total"], list(params.values()), allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), grads)}
            del out, score, batch
            with torch.no_grad():
                if cfg["grad_clip_norm"]:
                    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
                    if float(norm) >= cfg["grad_clip_norm"]:
                        grads = {k: g * (cfg["grad_clip_norm"] / norm) for k, g in grads.items()}
                if first_grad is None:
                    first_grad = {k: g.clone() for k, g in grads.items()}
                lr = cfg["learning_rate"] * lr_factor(t, cfg)
                for k, p in params.items():
                    g = grads[k]
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    mhat = m[k] / (1 - b1 ** (t + 1))
                    vhat = v2[k] / (1 - b2 ** (t + 1))
                    p.sub_(lr * mhat / (torch.sqrt(vhat) + eps))
            terms_per_step.append({k: float(v.detach()) for k, v in terms.items()})
    return {"terms": terms_per_step, "first_grad": first_grad, "bn1": bn1,
            "params": {k: p.detach() for k, p in params.items()}}
