"""Indirect-supervision losses (port of losses.py).

Render losses on the soft-rasterized map (silhouette BCE, soft IoU,
per-pixel part CE, either from normalized probabilities or from the raw
class scores of the training render), the 2D keypoint reprojection loss on
visible joints, the two parameter priors, and the direct 3D terms (joints,
vertices, rotation matrices, betas; weight 0 in the presets). Every loss is
a mean, so it does not depend on the batch size.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _clip(x: torch.Tensor, lo: float | None, hi: float | None) -> torch.Tensor:
    """jnp.clip with its gradient: where x equals a bound, maximum/minimum
    split the gradient in half (torch.clamp would pass it whole). The
    probabilities reach the bound 1.0 exactly on pixels no vertex reaches."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def silhouette_bce(pred_sil: torch.Tensor, target_sil: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy. pred/target [B, H, W], pred in (0, 1)."""
    p = _clip(pred_sil, _EPS, 1.0 - _EPS)
    return -torch.mean(target_sil * torch.log(p) + (1.0 - target_sil) * torch.log1p(-p))


def silhouette_iou(pred_sil: torch.Tensor, target_sil: torch.Tensor) -> torch.Tensor:
    """Soft-IoU loss: 1 − |p∩t| / |p∪t|, per image then mean over batch."""
    inter = torch.sum(pred_sil * target_sil, dim=(-2, -1))
    union = torch.sum(pred_sil + target_sil - pred_sil * target_sil, dim=(-2, -1))
    return torch.mean(1.0 - inter / (union + _EPS))


def part_seg_ce(pred_probs: torch.Tensor, target_labels: torch.Tensor) -> torch.Tensor:
    """Per-pixel categorical CE over C+1 channels (0 = background).

    pred_probs [B, H, W, C+1] (normalized), target_labels [B, H, W] int; the
    label is picked by a one-hot mask, as in the reference.
    """
    logp = torch.log(_clip(pred_probs, _EPS, 1.0))
    classes = torch.arange(pred_probs.shape[-1], device=target_labels.device)
    mask = (target_labels[..., None] == classes).to(logp.dtype)
    return -torch.sum(mask * logp) / (mask.numel() // pred_probs.shape[-1])


def part_seg_ce_scores(
    score_cp: torch.Tensor,
    s_total: torch.Tensor,
    bg_gamma: float,
    target_labels: torch.Tensor,
) -> torch.Tensor:
    """part_seg_ce from the raw class scores of the training render, without
    the normalized probabilities:

        CE(pixel) = log(bg_gamma + Σc score_c) − log(score_label or bg_gamma)

    score_cp [B, C, H*W], s_total [B, H*W], target_labels [B, H, W] int
    (0 = background). The label's score is picked by a one-hot mask summed
    in float32 (exact for any score dtype: one term survives per pixel).
    """
    B, C, P = score_cp.shape
    labels = target_labels.reshape(B, P)
    classes = torch.arange(1, C + 1, device=labels.device, dtype=labels.dtype)
    mask = (labels[:, None, :] == classes[:, None]).to(score_cp.dtype)
    picked = torch.sum(mask * score_cp, dim=1, dtype=torch.float32)  # [B, P]
    picked = torch.where(labels == 0, torch.full_like(picked, bg_gamma), picked)
    ce = torch.log(bg_gamma + s_total) - torch.log(_clip(picked, _EPS, None))
    return torch.mean(ce)


def keypoint_l2(
    pred_kp2d: torch.Tensor, target_kp2d: torch.Tensor, visibility: torch.Tensor,
    image_size: int,
) -> torch.Tensor:
    """Visibility-masked mean squared 2D keypoint error in units of the
    image size. pred/target [B, K, 2] pixels; visibility [B, K] in {0, 1}."""
    scale = 1.0 / image_size
    err = torch.sum(((pred_kp2d - target_kp2d) * scale) ** 2, dim=-1)  # [B, K]
    return torch.sum(err * visibility) / (torch.sum(visibility) + _EPS)


def shape_reg(betas: torch.Tensor) -> torch.Tensor:
    """L2 prior pulling β toward the mean shape."""
    return torch.mean(torch.sum(betas * betas, dim=-1))


def joints3d_l2(pred_joints: torch.Tensor, target_joints: torch.Tensor) -> torch.Tensor:
    """Mean squared 3D joint error in model space. [B, J, 3] each."""
    return torch.mean(torch.sum((pred_joints - target_joints) ** 2, dim=-1))


def verts3d_l2(pred_verts: torch.Tensor, target_verts: torch.Tensor) -> torch.Tensor:
    """Mean squared 3D vertex error in model space. [B, V, 3] each."""
    return torch.mean(torch.sum((pred_verts - target_verts) ** 2, dim=-1))


def rotmat_frob(pred_rotmats: torch.Tensor, target_rotmats: torch.Tensor) -> torch.Tensor:
    """Mean squared Frobenius distance of per-joint rotations. [B, J, 3, 3]."""
    d = pred_rotmats - target_rotmats
    return torch.mean(torch.sum(d * d, dim=(-2, -1)))


def betas_l2(pred_betas: torch.Tensor, target_betas: torch.Tensor) -> torch.Tensor:
    """Mean squared shape-coefficient error. [B, 10] each."""
    return torch.mean(torch.sum((pred_betas - target_betas) ** 2, dim=-1))


def pose_reg(pose_prior: torch.Tensor) -> torch.Tensor:
    """L2 prior on the body-pose deviation (global joint excluded)."""
    return torch.mean(torch.sum(pose_prior * pose_prior, dim=-1))


def total_loss(
    outputs: dict, targets: dict, weights: dict[str, float], image_size: int
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Weighted sum of the losses whose weight is non-zero.

    outputs: silhouette, kp2d, pose/pose_prior, betas, and either probs
    [B,H,W,C+1] or the score form (score_cp, s_total, bg_gamma); joints,
    verts, rotmats for the direct terms. targets: silhouette, part_labels,
    kp2d, kp_vis, and joints3d / verts3d / rotmats / betas for the direct
    terms. Returns (total, terms) with terms["total"] = total.
    """
    terms: dict[str, torch.Tensor] = {}
    if weights.get("sil_bce", 0.0):
        terms["sil_bce"] = silhouette_bce(outputs["silhouette"], targets["silhouette"])
    if weights.get("sil_iou", 0.0):
        terms["sil_iou"] = silhouette_iou(outputs["silhouette"], targets["silhouette"])
    if weights.get("part_ce", 0.0):
        if "score_cp" in outputs:
            terms["part_ce"] = part_seg_ce_scores(
                outputs["score_cp"], outputs["s_total"], outputs["bg_gamma"],
                targets["part_labels"],
            )
        else:
            terms["part_ce"] = part_seg_ce(outputs["probs"], targets["part_labels"])
    if weights.get("kp", 0.0):
        terms["kp"] = keypoint_l2(
            outputs["kp2d"], targets["kp2d"], targets["kp_vis"], image_size
        )
    if weights.get("shape_reg", 0.0):
        terms["shape_reg"] = shape_reg(outputs["betas"])
    if weights.get("pose_reg", 0.0):
        terms["pose_reg"] = pose_reg(outputs.get("pose_prior", outputs["pose"]))
    if weights.get("j3d", 0.0):
        terms["j3d"] = joints3d_l2(outputs["joints"], targets["joints3d"])
    if weights.get("v3d", 0.0):
        terms["v3d"] = verts3d_l2(outputs["verts"], targets["verts3d"])
    if weights.get("rotmat", 0.0):
        terms["rotmat"] = rotmat_frob(outputs["rotmats"], targets["rotmats"])
    if weights.get("betas_l2", 0.0):
        terms["betas_l2"] = betas_l2(outputs["betas"], targets["betas"])

    total = torch.zeros((), dtype=torch.float32)  # a 0-dim CPU tensor joins any device
    for name, value in terms.items():
        total = total + weights[name] * value
    terms["total"] = total
    return total, terms
