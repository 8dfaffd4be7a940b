"""Indirect-supervision losses (port of losses.py).

Render losses on the soft-rasterized map (silhouette BCE, soft IoU,
per-pixel part CE, either from normalized probabilities or from the raw
class scores of the training render), the 2D keypoint reprojection loss on
visible joints, the two parameter priors, and the direct 3D terms (joints,
vertices, rotation matrices, betas; weight 0 in the presets). Every loss is
a mean, so it does not depend on the batch size.

Under a mesh (`parallel/mesh.py`) each rank holds its rows of the batch
and, under a render axis, its band of image rows; every term's value is the
one-process value on the global batch: pixel sums and per-image IoU sums go
over the render group, batch sums and the keypoint ratio's numerator and
denominator over the data group, each through `all_reduce_partial` (every
rank gets the global value and differentiates its own part). Without a mesh
the code path is the one-process one.
"""

from __future__ import annotations

import torch

from indirect_learning_pose_shape_tpu_torch.parallel import mesh as mesh_lib

_EPS = 1e-7


def global_mean(x: torch.Tensor, mesh=None, rows: bool = False) -> torch.Tensor:
    """torch.mean(x); under `mesh`, the mean over the global batch of
    which `x` holds this rank's rows (and, with `rows`, this rank's band of
    image rows: the sum then goes over the whole mesh). The shards are
    equal, so that is the mean of the ranks' means, which at one rank is
    torch.mean(x) bit for bit."""
    if mesh is None:
        return torch.mean(x)
    group = mesh.world_group if rows else mesh.data_group
    return mesh_lib.all_reduce_partial(torch.mean(x), group) / (mesh.n_data * (mesh.n_render if rows else 1))


def _clip(x: torch.Tensor, lo: float | None, hi: float | None) -> torch.Tensor:
    """jnp.clip with its gradient: where x equals a bound, maximum/minimum
    split the gradient in half (torch.clamp would pass it whole). The
    probabilities reach the bound 1.0 exactly on pixels no vertex reaches."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def silhouette_bce(pred_sil: torch.Tensor, target_sil: torch.Tensor, mesh=None) -> torch.Tensor:
    """Binary cross-entropy. pred/target [B, H, W], pred in (0, 1)."""
    p = _clip(pred_sil, _EPS, 1.0 - _EPS)
    return -global_mean(target_sil * torch.log(p) + (1.0 - target_sil) * torch.log1p(-p), mesh, rows=True)


def silhouette_iou(pred_sil: torch.Tensor, target_sil: torch.Tensor, mesh=None) -> torch.Tensor:
    """Soft-IoU loss: 1 − |p∩t| / |p∪t|, per image then mean over batch."""
    inter = torch.sum(pred_sil * target_sil, dim=(-2, -1))
    union = torch.sum(pred_sil + target_sil - pred_sil * target_sil, dim=(-2, -1))
    if mesh is not None and mesh.render_group is not None:
        inter = mesh_lib.all_reduce_partial(inter, mesh.render_group)
        union = mesh_lib.all_reduce_partial(union, mesh.render_group)
    return global_mean(1.0 - inter / (union + _EPS), mesh)


def part_seg_ce(pred_probs: torch.Tensor, target_labels: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-pixel categorical CE over C+1 channels (0 = background).

    pred_probs [B, H, W, C+1] (normalized), target_labels [B, H, W] int; the
    label is picked by a one-hot mask, as in the reference.
    """
    logp = torch.log(_clip(pred_probs, _EPS, 1.0))
    classes = torch.arange(pred_probs.shape[-1], device=target_labels.device)
    mask = (target_labels[..., None] == classes).to(logp.dtype)
    total, count = torch.sum(mask * logp), mask.numel() // pred_probs.shape[-1]
    if mesh is not None:
        total = mesh_lib.all_reduce_partial(total, mesh.world_group)
        count *= mesh.n_data * mesh.n_render
    return -total / count


def part_seg_ce_scores(
    score_cp: torch.Tensor,
    s_total: torch.Tensor,
    bg_gamma: float,
    target_labels: torch.Tensor,
    mesh=None,
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
    return global_mean(ce, mesh, rows=True)


def keypoint_l2(
    pred_kp2d: torch.Tensor, target_kp2d: torch.Tensor, visibility: torch.Tensor,
    image_size: int,
    mesh=None,
) -> torch.Tensor:
    """Visibility-masked mean squared 2D keypoint error in units of the
    image size. pred/target [B, K, 2] pixels; visibility [B, K] in {0, 1}.
    Under `mesh` the numerator and the denominator are the global batch's
    (a mean of per-rank ratios would weigh ranks with few visible
    keypoints up)."""
    scale = 1.0 / image_size
    err = torch.sum(((pred_kp2d - target_kp2d) * scale) ** 2, dim=-1)  # [B, K]
    num, den = torch.sum(err * visibility), torch.sum(visibility)
    if mesh is not None:
        num = mesh_lib.all_reduce_partial(num, mesh.data_group)
        den = mesh_lib.all_reduce_partial(den, mesh.data_group)
    return num / (den + _EPS)


def shape_reg(betas: torch.Tensor, mesh=None) -> torch.Tensor:
    """L2 prior pulling β toward the mean shape."""
    return global_mean(torch.sum(betas * betas, dim=-1), mesh)


def joints3d_l2(pred_joints: torch.Tensor, target_joints: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean squared 3D joint error in model space. [B, J, 3] each."""
    return global_mean(torch.sum((pred_joints - target_joints) ** 2, dim=-1), mesh)


def verts3d_l2(pred_verts: torch.Tensor, target_verts: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean squared 3D vertex error in model space. [B, V, 3] each."""
    return global_mean(torch.sum((pred_verts - target_verts) ** 2, dim=-1), mesh)


def rotmat_frob(pred_rotmats: torch.Tensor, target_rotmats: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean squared Frobenius distance of per-joint rotations. [B, J, 3, 3]."""
    d = pred_rotmats - target_rotmats
    return global_mean(torch.sum(d * d, dim=(-2, -1)), mesh)


def betas_l2(pred_betas: torch.Tensor, target_betas: torch.Tensor, mesh=None) -> torch.Tensor:
    """Mean squared shape-coefficient error. [B, 10] each."""
    return global_mean(torch.sum((pred_betas - target_betas) ** 2, dim=-1), mesh)


def pose_reg(pose_prior: torch.Tensor, mesh=None) -> torch.Tensor:
    """L2 prior on the body-pose deviation (global joint excluded)."""
    return global_mean(torch.sum(pose_prior * pose_prior, dim=-1), mesh)


def total_loss(
    outputs: dict, targets: dict, weights: dict[str, float], image_size: int, mesh=None
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Weighted sum of the losses whose weight is non-zero.

    outputs: silhouette, kp2d, pose/pose_prior, betas, and either probs
    [B,H,W,C+1] or the score form (score_cp, s_total, bg_gamma); joints,
    verts, rotmats for the direct terms. targets: silhouette, part_labels,
    kp2d, kp_vis, and joints3d / verts3d / rotmats / betas for the direct
    terms. Under `mesh`, this rank's rows (and band of image rows) of each;
    the terms are the global batch's. Returns (total, terms) with
    terms["total"] = total.
    """
    m = mesh
    terms: dict[str, torch.Tensor] = {}
    if weights.get("sil_bce", 0.0):
        terms["sil_bce"] = silhouette_bce(outputs["silhouette"], targets["silhouette"], m)
    if weights.get("sil_iou", 0.0):
        terms["sil_iou"] = silhouette_iou(outputs["silhouette"], targets["silhouette"], m)
    if weights.get("part_ce", 0.0):
        if "score_cp" in outputs:
            terms["part_ce"] = part_seg_ce_scores(
                outputs["score_cp"], outputs["s_total"], outputs["bg_gamma"],
                targets["part_labels"], m,
            )
        else:
            terms["part_ce"] = part_seg_ce(outputs["probs"], targets["part_labels"], m)
    if weights.get("kp", 0.0):
        terms["kp"] = keypoint_l2(
            outputs["kp2d"], targets["kp2d"], targets["kp_vis"], image_size, m
        )
    if weights.get("shape_reg", 0.0):
        terms["shape_reg"] = shape_reg(outputs["betas"], m)
    if weights.get("pose_reg", 0.0):
        terms["pose_reg"] = pose_reg(outputs.get("pose_prior", outputs["pose"]), m)
    if weights.get("j3d", 0.0):
        terms["j3d"] = joints3d_l2(outputs["joints"], targets["joints3d"], m)
    if weights.get("v3d", 0.0):
        terms["v3d"] = verts3d_l2(outputs["verts"], targets["verts3d"], m)
    if weights.get("rotmat", 0.0):
        terms["rotmat"] = rotmat_frob(outputs["rotmats"], targets["rotmats"], m)
    if weights.get("betas_l2", 0.0):
        terms["betas_l2"] = betas_l2(outputs["betas"], targets["betas"], m)

    total = torch.zeros((), dtype=torch.float32)  # a 0-dim CPU tensor joins any device
    for name, value in terms.items():
        total = total + weights[name] * value
    terms["total"] = total
    return total, terms
