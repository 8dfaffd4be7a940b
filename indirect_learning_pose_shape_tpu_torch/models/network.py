"""Network assembly (port of models/network.py): encoder → IEF → SMPL →
projection, plus the soft-raster render of the predicted mesh.

`forward` is the inference path (`train=True` normalizes with batch
statistics); `render_outputs` adds the rendered part probabilities and
silhouette, or the score form the training losses read (`score_cp`,
`s_total`, `bg_gamma`); `forward_train` is both: the training path with
`probs=False`, evaluation's rendered outputs with `train=False`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief as ief_mod
from indirect_learning_pose_shape_tpu_torch.models import smpl as smpl_mod
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster
from indirect_learning_pose_shape_tpu_torch.utils import device as device_lib
from indirect_learning_pose_shape_tpu_torch.utils.assets import SMPLAsset


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    image_size: int = 256
    encoder: enc.EncoderConfig = enc.EncoderConfig()
    ief: ief_mod.IEFConfig = ief_mod.IEFConfig()
    raster: raster.RasterConfig = raster.RasterConfig()
    smpl_impl: str = "auto"  # 'kernel' | 'torch' | 'auto' (kernel on CUDA)
    # 'kernel' | 'torch' | 'separable' | 'auto' (kernel on CUDA; see ops/raster.py)
    raster_impl: str = "auto"


@dataclasses.dataclass(frozen=True)
class ModelConsts:
    """Non-trainable constants: SMPL tensors + class-sorted part layout."""

    smpl: smpl_mod.SMPLConsts
    part_layout: raster.PartLayout


class Model(nn.Module):
    """Trainable parameters and BN statistics: `encoder` and `ief`."""

    def __init__(self, encoder: enc.Encoder, ief: ief_mod.IEF):
        super().__init__()
        self.encoder = encoder
        self.ief = ief


def build_consts(
    asset: SMPLAsset, cfg: ModelConfig, device: torch.device | str = "cpu"
) -> ModelConsts:
    vlabels = np.minimum(asset.part_labels(), cfg.raster.num_parts - 1)
    return ModelConsts(
        smpl=smpl_mod.smpl_consts(asset, device=device),
        part_layout=raster.build_part_layout(
            vlabels, cfg.raster.num_parts, positions=asset.v_template, device=device
        ),
    )


def init(
    asset: SMPLAsset,
    cfg: ModelConfig,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> tuple[Model, ModelConsts]:
    """Fresh model from `seed` (one torch.Generator: encoder, then IEF) and
    its constants, both on `device` (the card unless the caller asks for the
    CPU). The model is in eval mode."""
    device = device_lib.resolve(device)
    consts = build_consts(asset, cfg, device)
    gen = torch.Generator().manual_seed(seed)
    encoder = enc.Encoder(cfg.encoder, gen)
    mean_theta = smpl_mod.mean_params(consts.smpl, cfg.ief.num_cam, cfg.ief.rotation_format)
    ief = ief_mod.ief_init(cfg.ief, cfg.encoder.feature_dim, mean_theta, gen)
    return Model(encoder, ief).to(device).eval(), consts


def forward(
    model: Model,
    consts: ModelConsts,
    images: torch.Tensor,
    cfg: ModelConfig,
    train: bool = False,
) -> dict[str, torch.Tensor]:
    """Inference path. images [B, H, W, 3] float32 in [-1, 1] -> outputs.

    train=True uses batch statistics in every BatchNorm and updates the
    running statistics in place (the reference returns them as new state).
    """
    feat = enc.encoder_apply(model.encoder, images, train=train)
    return head_from_features(model.ief, consts, feat, cfg)


def forward_train(
    model: Model,
    consts: ModelConsts,
    images: torch.Tensor,
    cfg: ModelConfig,
    train: bool = True,
    probs: bool = True,
) -> dict[str, torch.Tensor]:
    """`forward`, then the render of the prediction (`render_outputs`).

    train=True normalizes with batch statistics (running statistics updated
    in place); train=False uses the running statistics, which is what
    evaluation measures. probs=False renders the score form the training
    losses read (`score_cp`, `s_total`, `bg_gamma`) instead of `probs`."""
    outputs = forward(model, consts, images, cfg, train=train)
    return render_outputs(outputs, consts, cfg, probs=probs)


def head_from_features(
    ief: ief_mod.IEF, consts: ModelConsts, feat: torch.Tensor, cfg: ModelConfig
) -> dict[str, torch.Tensor]:
    """IEF → SMPL → projection from encoder features."""
    theta = ief_mod.ief_apply(ief, feat)
    pose, betas, cam = ief_mod.split_theta(theta, cfg.ief)
    B = pose.shape[0]
    J = consts.smpl.num_joints
    if cfg.ief.rotation_format == "rot6d":
        rotmats = smpl_mod.rot6d_to_rotmat(pose.reshape(B, J, 6))
        identity6 = torch.tensor([1, 0, 0, 0, 1, 0], dtype=pose.dtype, device=pose.device)
        pose_prior = (pose - identity6.repeat(J))[:, 6:]
    else:
        rotmats = smpl_mod.batch_rodrigues(pose.reshape(B, J, 3))
        pose_prior = pose[:, 3:]
    smpl_out = smpl_mod.smpl_forward_rotmats(consts.smpl, rotmats, betas, impl=cfg.smpl_impl)
    kp2d = camera.project_pixel(smpl_out["kp3d"], cam, cfg.image_size)
    return {
        "theta": theta,
        "pose": pose,
        "pose_prior": pose_prior,
        "rotmats": rotmats,
        "betas": betas,
        "cam": cam,
        "verts": smpl_out["verts"],
        "joints": smpl_out["joints"],
        "kp3d": smpl_out["kp3d"],
        "kp2d": kp2d,
    }


def render_outputs(
    outputs: dict, consts: ModelConsts, cfg: ModelConfig, probs: bool = True
) -> dict:
    """outputs + `verts2d`, `silhouette` and either the rendered `probs`
    [B,H,W,C+1] or, with probs=False, the score form
    (ops/raster.soft_rasterize_train): `score_cp` [B,C,H*W], `s_total`
    [B,H*W] and `bg_gamma`."""
    verts2d = camera.project_pixel(outputs["verts"], outputs["cam"], cfg.image_size)
    layout, rcfg, impl = consts.part_layout, cfg.raster, cfg.raster_impl
    if probs:
        rendered = raster.soft_rasterize(verts2d, layout, rcfg, impl=impl)
        outputs["probs"] = rendered["probs"]
    else:
        rendered = raster.soft_rasterize_train(verts2d, layout, rcfg, impl=impl)
        outputs.update(score_cp=rendered["score_cp"], s_total=rendered["s_total"],
                       bg_gamma=rcfg.bg_gamma)
    outputs["verts2d"] = verts2d
    outputs["silhouette"] = rendered["silhouette"]
    return outputs
