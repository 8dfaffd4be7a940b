"""On-device synthetic training data, soft targets (port of data/synthetic.py).

Ground-truth Θ = (pose, betas, camera) is sampled, posed by SMPL (the LBS
kernel on the card), projected, and rendered by the soft raster (the raster
forward kernel on the card); the part labels, the target silhouette and the
input image are derived from the raw class scores, as in the reference's
`targets='soft'` branch.

Sampling and rendering are split: `sample_draws` takes every random number
from an explicit `torch.Generator`, and `render_batch` is a deterministic
function of those draws. jax.random and torch give different numbers from
the same seed, so the tests hand the reference's own draws to
`render_batch` and compare the batches.

Only the reference's soft-target stream is ported: `targets='hard'`, a
background other than 'none', `color_jitter`, `shading` and `occluders` are
refused (ROADMAP.md, Queue 1 item 12).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import smpl as smpl_mod
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster

_LATER = "ROADMAP.md, Queue 1 item 12 (hard targets and appearance randomisation)"


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    pose_std: float = 0.25  # axis-angle std for body joints
    global_std: float = 0.15  # std for global orientation
    shape_std: float = 1.0
    cam_scale_range: tuple = (0.7, 1.1)
    cam_trans_std: float = 0.08
    image_noise: float = 0.05
    kp_visibility: float = 0.9  # fraction of keypoints marked visible
    targets: str = "soft"
    bg_mode: str = "none"
    color_jitter: float = 0.0
    shading: float = 0.0
    occluders: int = 0

    def __post_init__(self):
        for name, default in (
            ("targets", "soft"), ("bg_mode", "none"), ("color_jitter", 0.0),
            ("shading", 0.0), ("occluders", 0),
        ):
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"SyntheticConfig.{name}={getattr(self, name)!r} is not ported yet "
                    f"(only {name}={default!r}); it comes with {_LATER}"
                )


# The reference's fixed part palette, `jax.random.uniform(PRNGKey(1234),
# (n, 3), 0.15, 1.0)` with row 0 (background) set to (0.05, 0.05, 0.08).
# torch cannot reproduce jax.random, so the values are carried here; the
# 25-channel palette is the first 25 rows of the 32-channel one. A test pins
# both against the reference's `_part_palette`.
_PALETTE = np.array([
    (0.05, 0.05, 0.08),
    (0.8706705, 0.27027956, 0.6847037),
    (0.80946153, 0.47458872, 0.45208645),
    (0.7629649, 0.8398832, 0.23471469),
    (0.66578376, 0.96760327, 0.24213381),
    (0.17620583, 0.53669816, 0.61664516),
    (0.62234396, 0.80251664, 0.9806103),
    (0.58564687, 0.7142346, 0.7309466),
    (0.5888941, 0.24834198, 0.81569767),
    (0.92855597, 0.50464773, 0.6604995),
    (0.76905066, 0.9492862, 0.7323749),
    (0.8908315, 0.8770128, 0.5615391),
    (0.954786, 0.23374063, 0.98235154),
    (0.69552743, 0.6489928, 0.21419467),
    (0.3899466, 0.36157438, 0.48162353),
    (0.3679618, 0.6354374, 0.20773888),
    (0.90771496, 0.26552254, 0.16909525),
    (0.25754437, 0.9613707, 0.8328175),
    (0.71648467, 0.6438088, 0.7096087),
    (0.9493826, 0.15854377, 0.8158623),
    (0.22391182, 0.30179012, 0.61070025),
    (0.15346056, 0.8709317, 0.7677104),
    (0.92138034, 0.20894599, 0.16798307),
    (0.48216787, 0.80304325, 0.28650764),
    (0.63331574, 0.9865529, 0.23860893),
    (0.5550759, 0.57196575, 0.31721193),
    (0.2783551, 0.17181611, 0.23456614),
    (0.16237305, 0.34044984, 0.86889994),
    (0.80661875, 0.54635525, 0.74307936),
    (0.7807056, 0.48250175, 0.96225315),
    (0.46108657, 0.21494703, 0.8738845),
    (0.53518724, 0.37184802, 0.5377223),
], dtype=np.float32)


# Named eval distributions (the reference's `EVAL_SUITES`): 'plain' is the
# training stream; 'hard' and 'hardapp' need item 12 and are refused by
# `SyntheticConfig` when applied.
EVAL_SUITES = {
    "plain": (),
    "hard": ("targets=hard",),
    "hardapp": (
        "targets=hard",
        "bg_mode=texture",
        "color_jitter=0.08",
        "shading=0.6",
        "occluders=2",
    ),
}


def apply_overrides(cfg: SyntheticConfig, specs) -> SyntheticConfig:
    """`cfg` with CLI ``FIELD=VALUE`` overrides applied (the reference's
    `apply_overrides`): unknown fields raise ValueError, `cam_scale_range`
    parses as ``lo,hi``, and a value this port does not take yet raises
    NotImplementedError from `SyntheticConfig`."""
    valid = {f.name for f in dataclasses.fields(SyntheticConfig)}
    choices = {"targets": ("soft", "hard"), "bg_mode": ("none", "noise", "texture")}
    updates = {}
    for spec in specs:
        name, sep, value = spec.partition("=")
        if not sep or name not in valid:
            raise ValueError(
                f"synthetic override {spec!r}: expected FIELD=VALUE with FIELD among {sorted(valid)}"
            )
        try:
            if name == "cam_scale_range":
                parts = value.split(",")
                if len(parts) != 2:
                    raise ValueError("takes LO,HI (e.g. cam_scale_range=0.5,1.3)")
                updates[name] = (float(parts[0]), float(parts[1]))
            elif name in choices:
                if value not in choices[name]:
                    raise ValueError(f"takes one of {choices[name]}")
                updates[name] = value
            elif name == "occluders":
                updates[name] = int(value)
            else:
                updates[name] = float(value)
        except ValueError as e:
            raise ValueError(f"synthetic override {spec!r}: {e}") from None
    return dataclasses.replace(cfg, **updates)


def part_palette(num_channels: int) -> np.ndarray:
    """[num_channels, 3] float32 RGB per channel (0 = background, dark)."""
    if num_channels not in (25, 32):
        raise ValueError(
            f"the part palette is carried for 25 and 32 channels, not {num_channels}"
        )
    return _PALETTE[:num_channels].copy()


def sample_draws(
    gen: torch.Generator,
    batch: int,
    consts: net.ModelConsts,
    cfg: SyntheticConfig,
    image_size: int,
) -> dict[str, torch.Tensor]:
    """Every random number of one batch, from `gen`, on `gen`'s device:
    pose [B, J*3] (global orientation in the first 3), betas [B, num_betas],
    cam [B, 3] (scale, tx, ty), noise [B, S, S, 3] standard normal, and
    vis_u [B, K] uniform, the keypoint dropout draws."""
    dev = gen.device
    J = consts.smpl.num_joints
    K = consts.smpl.cocoplus_regressor.shape[0]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    pose = cfg.pose_std * normal(batch, J * 3)
    pose[:, :3] = cfg.global_std * normal(batch, 3)
    betas = cfg.shape_std * normal(batch, consts.smpl.num_betas)
    lo, hi = cfg.cam_scale_range
    scale = lo + (hi - lo) * uniform(batch, 1)
    trans = cfg.cam_trans_std * normal(batch, 2)
    return {
        "pose": pose,
        "betas": betas,
        "cam": torch.cat([scale, trans], dim=1),
        "noise": normal(batch, image_size, image_size, 3),
        "vis_u": uniform(batch, K),
    }


@torch.no_grad()
def render_batch(
    draws: dict[str, torch.Tensor],
    consts: net.ModelConsts,
    model_cfg: net.ModelConfig,
    cfg: SyntheticConfig,
    include_3d: bool = False,
) -> dict[str, torch.Tensor]:
    """One batch from `draws` (see `sample_draws`), on their device:

      image       [B, S, S, 3] float32 in [-1, 1]
      silhouette  [B, S, S]    float32 target silhouette (0/1)
      part_labels [B, S, S]    int32 target class map (0 = background)
      kp2d        [B, K, 2]    pixel keypoints
      kp_vis      [B, K]       visibility mask
      gt_pose / gt_betas / gt_cam (recovery diagnostics)
      gt_joints3d [B, J, 3], gt_verts [B, V, 3], gt_rotmats [B, J, 3, 3]
                  (the direct-supervision targets, with include_3d)

    The target render is stored as bf16, as the reference's target path
    (on the separable impl at matmul_precision 'default'); labels are
    argmaxes and thresholds of those scores, and the image is the bf16
    palette mix summed in float32.
    """
    size = model_cfg.image_size
    pose, betas, cam = draws["pose"], draws["betas"], draws["cam"]
    smpl_out = smpl_mod.smpl_forward(consts.smpl, pose, betas, impl=model_cfg.smpl_impl)
    verts2d = camera.project_pixel(smpl_out["verts"], cam, size)
    kp2d = camera.project_pixel(smpl_out["kp3d"], cam, size)

    target_raster = dataclasses.replace(model_cfg.raster, matmul_precision="default")
    score = raster.raster_scores_cf(
        verts2d, consts.part_layout, target_raster, impl=model_cfg.raster_impl,
        out_dtype=torch.bfloat16,
    )  # [B, C, S, S]
    bg = float(model_cfg.raster.bg_gamma)
    s_total = torch.sum(score, dim=1, dtype=torch.float32)
    best = torch.argmax(score, dim=1).to(torch.int32)
    mx = torch.amax(score, dim=1).float()
    part_labels = torch.where(mx > bg, best + 1, 0).to(torch.int32)
    silhouette = (s_total > bg).float()

    palette = torch.as_tensor(
        part_palette(model_cfg.raster.num_parts + 1), device=score.device
    )
    pal = palette[1:].to(score.dtype)  # [C, 3]
    mix = torch.sum(
        score[:, :, :, :, None] * pal[None, :, None, None, :], dim=1, dtype=torch.float32
    )  # [B, S, S, 3]
    image = (bg * palette[0] + mix) / (bg + s_total)[..., None]
    image = image + cfg.image_noise * draws["noise"]
    image = torch.clamp(image, 0.0, 1.0) * 2.0 - 1.0

    # Keypoints projected outside the crop are invisible, on top of the
    # random dropout.
    in_crop = torch.all((kp2d >= 0.0) & (kp2d <= size - 1.0), dim=-1)
    kp_vis = (in_crop & (draws["vis_u"] < cfg.kp_visibility)).float()
    out = {
        "image": image,
        "silhouette": silhouette,
        "part_labels": part_labels,
        "kp2d": kp2d,
        "kp_vis": kp_vis,
        "gt_pose": pose,
        "gt_betas": betas,
        "gt_cam": cam,
    }
    if include_3d:
        B, J = pose.shape[0], consts.smpl.num_joints
        out["gt_joints3d"] = smpl_out["joints"]
        out["gt_verts"] = smpl_out["verts"]
        # The stream samples axis-angle; rotation matrices are the target a
        # rot6d head can be supervised with.
        out["gt_rotmats"] = smpl_mod.batch_rodrigues(pose.reshape(B, J, 3))
    return out
