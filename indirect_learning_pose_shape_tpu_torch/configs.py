"""Run configuration (port of configs.py): `TrainConfig` and the presets.

A preset is a `TrainConfig` whose `.model` is the model, as in the
reference: 256² crops, a bf16 ResNet (BN folded into the convolutions on the
inference path), IEF with 3 iterations over (1024, 1024), σ=2 soft raster.

`TrainConfig` keeps the reference's field names. The fields this port
honours are `model`, `synthetic`, `batch_size`, `learning_rate`,
`num_steps`, `seed`, `loss_weights` and `log_every`. The others exist only
so that a non-default value is refused with the ROADMAP item that brings
it, never ignored. The reference's `augment` (disk data) is not carried.
"""

from __future__ import annotations

import dataclasses

from indirect_learning_pose_shape_tpu_torch.data.synthetic import SyntheticConfig
from indirect_learning_pose_shape_tpu_torch.models.encoder import EncoderConfig
from indirect_learning_pose_shape_tpu_torch.models.ief import IEFConfig
from indirect_learning_pose_shape_tpu_torch.models.network import ModelConfig
from indirect_learning_pose_shape_tpu_torch.ops.raster import RasterConfig

_OPTIMIZER = "ROADMAP.md, Queue 1 item 10 (the optimizer menu: cosine/warmup, AdamW, clipping, EMA, steps_per_call)"
_CHECKPOINTS = "ROADMAP.md, Queue 1 item 14 (checkpoints and metrics writers)"
_PRETRAINED = "ROADMAP.md, Queue 1 item 17 (pretrained weights and mean-parameter files)"
_MULTI_GPU = "ROADMAP.md, Queue 1 item 16 (multi-GPU)"

# Field -> (the only value this port takes, the ROADMAP item that brings others).
_NOT_YET = {
    "lr_schedule": ("constant", _OPTIMIZER),
    "warmup_steps": (200, _OPTIMIZER),
    "grad_clip_norm": (0.0, _OPTIMIZER),
    "weight_decay": (0.0, _OPTIMIZER),
    "ema_decay": (0.0, _OPTIMIZER),
    "steps_per_call": (1, _OPTIMIZER),
    "checkpoint_every": (0, _CHECKPOINTS),
    "checkpoint_dir": ("/tmp/ilps_ckpt", _CHECKPOINTS),
    "metrics_path": (None, _CHECKPOINTS),
    "tensorboard_dir": (None, _CHECKPOINTS),
    "pretrained": (None, _PRETRAINED),
    "mean_params": (None, _PRETRAINED),
    "num_devices": (None, _MULTI_GPU),
    "render_devices": (1, _MULTI_GPU),
}


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
    # Refused unless at these defaults (see _NOT_YET).
    lr_schedule: str = "constant"
    warmup_steps: int = 200
    grad_clip_norm: float = 0.0
    weight_decay: float = 0.0
    ema_decay: float = 0.0
    steps_per_call: int = 1
    checkpoint_every: int = 0
    checkpoint_dir: str = "/tmp/ilps_ckpt"
    metrics_path: str | None = None
    tensorboard_dir: str | None = None
    pretrained: str | None = None
    mean_params: str | None = None
    num_devices: int | None = None
    render_devices: int = 1

    def __post_init__(self):
        for name, (default, later) in _NOT_YET.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"TrainConfig.{name}={getattr(self, name)!r} is not ported yet "
                    f"(only {default!r}); it comes with {later}"
                )

    @property
    def loss_weight_dict(self) -> dict[str, float]:
        return dict(self.loss_weights)


def _model(image_size: int, depth: int = 18, num_parts: int = 24) -> ModelConfig:
    return ModelConfig(
        image_size=image_size,
        encoder=EncoderConfig(depth=depth, fold_bn_eval=True),
        ief=IEFConfig(),
        raster=RasterConfig(image_size=image_size, num_parts=num_parts),
    )


# ResNet-18, axis-angle: the flagship (reference CONFIG4_FULL).
CONFIG4_FULL = TrainConfig(model=_model(256), batch_size=32)
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
# 31 foreground part classes (reference CONFIG4_PARTS31, without its
# disk-data mirror convention).
CONFIG4_PARTS31 = TrainConfig(model=_model(256, num_parts=31), batch_size=32)

PRESETS = {
    "config4_full": CONFIG4_FULL,
    "config4_r34": CONFIG4_R34,
    "config4_large": CONFIG4_LARGE,
    "config4_parts31": CONFIG4_PARTS31,
}
