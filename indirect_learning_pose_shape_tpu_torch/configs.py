"""Run configuration (port of configs.py): `TrainConfig` and the presets.

A preset is a `TrainConfig` whose `.model` is the model, as in the
reference: 256² crops, a bf16 ResNet (BN folded into the convolutions on the
inference path), IEF with 3 iterations over (1024, 1024), σ=2 soft raster.

`TrainConfig` keeps the reference's field names. The fields this port
honours are `model`, `synthetic`, `batch_size`, `learning_rate`,
`lr_schedule`, `warmup_steps`, `grad_clip_norm`, `weight_decay`,
`num_steps`, `seed`, `loss_weights`, `steps_per_call`, `log_every`,
`ema_decay`, `checkpoint_every`, `checkpoint_dir`, `metrics_path`,
`tensorboard_dir`, `augment` (mirror and crop jitter on disk data,
data/augment.py), `pretrained` (a backbone npz of
`tools/import_resnet_weights.py`), `mean_params` (IEF's Θ₀ from a file),
`num_devices` (the data-parallel ranks; None = every launched rank) and
`render_devices` (ranks that share each image's rows, `parallel/render_sp.py`;
the mesh is then num_devices / render_devices by render_devices);
train.py says how each acts.

Every preset of the reference is here, and one the reference lacks:
`hmr2_vith`, HMR 2.0's ViT-H/16 and transformer head (`HMR2_VITH`).
"""

from __future__ import annotations

import dataclasses

from indirect_learning_pose_shape_tpu_torch.data.augment import AugmentConfig
from indirect_learning_pose_shape_tpu_torch.data.synthetic import SyntheticConfig
from indirect_learning_pose_shape_tpu_torch.models.encoder import EncoderConfig
from indirect_learning_pose_shape_tpu_torch.models.ief import IEFConfig
from indirect_learning_pose_shape_tpu_torch.models.network import ModelConfig
from indirect_learning_pose_shape_tpu_torch.models.transformer_head import TransformerHeadConfig
from indirect_learning_pose_shape_tpu_torch.models.vit import ViTConfig
from indirect_learning_pose_shape_tpu_torch.ops.raster import RasterConfig

@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = ModelConfig()
    synthetic: SyntheticConfig = SyntheticConfig()
    batch_size: int = 32
    learning_rate: float = 1e-4
    num_steps: int = 1000
    seed: int = 0
    loss_weights: tuple = (
        ("sil_bce", 1.0),
        ("sil_iou", 1.0),
        ("part_ce", 1.0),
        ("kp", 5.0),
        ("shape_reg", 1e-3),
        ("pose_reg", 1e-3),
        ("j3d", 0.0),
        ("v3d", 0.0),
        ("rotmat", 0.0),
        ("betas_l2", 0.0),
    )
    log_every: int = 10
    lr_schedule: str = "constant"  # 'constant' | 'cosine' (linear warm-up, cosine decay)
    warmup_steps: int = 200
    grad_clip_norm: float = 0.0  # 0 disables global-norm clipping
    weight_decay: float = 0.0  # 0 = Adam; > 0 = AdamW
    ema_decay: float = 0.0  # 0 disables the parameters' moving average
    steps_per_call: int = 1  # fused steps per `train.fused_step` call
    checkpoint_every: int = 0  # save every N steps and resume from the latest; 0 disables
    checkpoint_dir: str = "/tmp/ilps_ckpt"
    metrics_path: str | None = None  # JSONL of the logged steps' terms
    tensorboard_dir: str | None = None  # TensorBoard event files of the same
    augment: AugmentConfig = AugmentConfig()  # disk-data mirror + crop jitter
    pretrained: str | None = None  # backbone npz (models/pretrained.py)
    mean_params: str | None = None  # IEF's Θ₀: npz 'mean_theta' or .npy
    num_devices: int | None = None  # data-parallel ranks; None = all launched
    render_devices: int = 1  # ranks sharing each image's rows; 1 = off

    def __post_init__(self):
        if self.lr_schedule not in ("constant", "cosine"):
            raise ValueError(f"lr_schedule must be 'constant' or 'cosine', got {self.lr_schedule!r}")
        if self.steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {self.steps_per_call}")
        if not 0.0 <= self.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in [0, 1), got {self.ema_decay}")
        if self.checkpoint_every < 0:
            raise ValueError(f"checkpoint_every must be >= 0, got {self.checkpoint_every}")
        if self.num_devices is not None and self.num_devices < 1:
            raise ValueError(f"num_devices must be None or >= 1, got {self.num_devices}")
        if self.render_devices < 1:
            raise ValueError(f"render_devices must be >= 1, got {self.render_devices}")
        if self.render_devices > 1 and self.model.raster_impl in ("kernel", "torch"):
            raise ValueError(
                f"render_devices={self.render_devices} row-shards the separable raster, and "
                f"raster_impl={self.model.raster_impl!r} is another route: the reference's "
                "kernel route is never row-sharded (use 'auto' or 'separable')"
            )

    @property
    def loss_weight_dict(self) -> dict[str, float]:
        return dict(self.loss_weights)


def _model(image_size: int, depth: int = 18, num_parts: int = 24) -> ModelConfig:
    # The reference's presets: bf16 separable products and bf16 training
    # scores. Both act on the separable impl only; the default `auto` is the
    # kernels on the card (ops/raster.py).
    return ModelConfig(
        image_size=image_size,
        encoder=EncoderConfig(depth=depth, fold_bn_eval=True),
        ief=IEFConfig(),
        raster=RasterConfig(
            image_size=image_size,
            num_parts=num_parts,
            matmul_precision="default",
            train_score_dtype="bfloat16",
        ),
    )


# Reference CONFIG1_SINGLE: one 256² crop, batch 1.
CONFIG1_SINGLE = TrainConfig(model=_model(256), batch_size=1, num_steps=1)
# Reference CONFIG2_SMPL_BATCH: batch 64.
CONFIG2_SMPL_BATCH = TrainConfig(model=_model(256), batch_size=64)
# Reference CONFIG3_RENDER: the silhouette losses alone.
CONFIG3_RENDER = TrainConfig(
    model=_model(256), batch_size=32, loss_weights=(("sil_bce", 1.0), ("sil_iou", 1.0))
)
# ResNet-18, axis-angle: the flagship (reference CONFIG4_FULL).
CONFIG4_FULL = TrainConfig(model=_model(256), batch_size=32)
# The flagship at batch 128 with the learning rate scaled with the batch
# (reference CONFIG4_B128).
CONFIG4_B128 = TrainConfig(model=_model(256), batch_size=128, learning_rate=4e-4)
# ResNet-34 + continuous 6D rotations (reference CONFIG4_R34).
CONFIG4_R34 = TrainConfig(
    model=dataclasses.replace(_model(256, depth=34), ief=IEFConfig(rotation_format="rot6d")),
    batch_size=32,
)
# ResNet-50 + 6D rotations (reference CONFIG4_LARGE).
CONFIG4_LARGE = TrainConfig(
    model=dataclasses.replace(_model(256, depth=50), ief=IEFConfig(rotation_format="rot6d")),
    batch_size=32,
)
# 31 foreground part classes (reference CONFIG4_PARTS31), whose mirror flips
# the SMPL ids of the 31-part layout.
CONFIG4_PARTS31 = TrainConfig(
    model=_model(256, num_parts=31),
    batch_size=32,
    augment=AugmentConfig(part_convention="s31-smpl-prefix"),
)

# Data-parallel training over every launched rank (reference
# CONFIG5_DATA_PARALLEL): the flagship model at a global batch of 64.
CONFIG5_DATA_PARALLEL = TrainConfig(model=_model(256), batch_size=64, num_devices=None)

# The reference's best recipe (CONFIG4_MIXED): ResNet-34 + rot6d, cosine
# warm-up, clipping, and the indirect losses plus direct 3D supervision
# (the synthetic stream emits its 3D ground truth); direct betas replace
# the shape prior. It ships at 20000 steps.
CONFIG4_MIXED = TrainConfig(
    model=dataclasses.replace(_model(256, depth=34), ief=IEFConfig(rotation_format="rot6d")),
    batch_size=32,
    learning_rate=3e-4,
    lr_schedule="cosine",
    grad_clip_norm=1.0,
    num_steps=20000,
    loss_weights=(
        ("sil_bce", 1.0),
        ("sil_iou", 1.0),
        ("part_ce", 1.0),
        ("kp", 5.0),
        ("shape_reg", 0.0),
        ("pose_reg", 1e-3),
        ("j3d", 5.0),
        ("v3d", 0.0),
        ("rotmat", 1.0),
        ("betas_l2", 0.02),
    ),
)

# The reference's robust recipe (CONFIG4_ROBUST): config4_mixed's
# supervision trained on z-buffered hard targets under full appearance
# randomisation (textured backgrounds, palette jitter, shading, occluders);
# scored on the plain, hard and hardapp suites (tools/quality_eval.py).
CONFIG4_ROBUST = dataclasses.replace(
    CONFIG4_MIXED,
    synthetic=SyntheticConfig(
        targets="hard",
        bg_mode="texture",
        color_jitter=0.08,
        shading=0.6,
        occluders=2,
    ),
)

# HMR 2.0 (Goel et al., "Humans in 4D", ICCV 2023, arXiv 2305.20091) at its
# published widths: ViTPose's ViT-H/16 on columns 32:224 of the 256² crop
# (192 tokens; 32 blocks, 1280 wide, 16 heads, MLP 5120, drop path 0.55)
# and the 6-layer cross-attention decoder head (1024 wide, 8 heads of 64,
# context 1280), Θ in 6D rotations, AdamW at 1e-5 with weight decay 1e-4,
# batch 48. Departures from HMR 2.0, on this system's terms:
# - config4_mixed's indirect loss set (silhouette, parts, keypoints, direct
#   3D) replaces HMR 2.0's keypoint losses and its adversarial pose prior;
# - the weak-perspective projection replaces its focal-5000 perspective
#   camera;
# - seeded weights replace ViTPose's pretrained backbone;
# - the SMPL stand-in and its Θ₀ (`smpl.mean_params`) replace
#   `smpl_mean_params.npz`;
# - config4_mixed's global-norm clip at 1.0, its 20000-step budget and its
#   24-part σ=2 raster.
HMR2_VITH = TrainConfig(
    model=ModelConfig(
        image_size=256,
        encoder=ViTConfig(),
        ief=IEFConfig(rotation_format="rot6d", num_iterations=1),
        head=TransformerHeadConfig(),
        raster=_model(256).raster,
    ),
    batch_size=48,
    learning_rate=1e-5,
    weight_decay=1e-4,
    grad_clip_norm=1.0,
    num_steps=20000,
    loss_weights=CONFIG4_MIXED.loss_weights,
)

PRESETS = {
    "config1_single": CONFIG1_SINGLE,
    "config2_smpl_batch": CONFIG2_SMPL_BATCH,
    "config3_render": CONFIG3_RENDER,
    "config4_full": CONFIG4_FULL,
    "config4_b128": CONFIG4_B128,
    "config4_large": CONFIG4_LARGE,
    "config4_r34": CONFIG4_R34,
    "config4_mixed": CONFIG4_MIXED,
    "config4_robust": CONFIG4_ROBUST,
    "config4_parts31": CONFIG4_PARTS31,
    "config5_data_parallel": CONFIG5_DATA_PARALLEL,
    "hmr2_vith": HMR2_VITH,
}
