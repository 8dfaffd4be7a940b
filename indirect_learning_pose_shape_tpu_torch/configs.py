"""Model configurations of the inference presets (port of configs.py).

Each preset is the `model` of the reference's `TrainConfig` of the same
name: 256² crops, a BN-folded bf16 ResNet, IEF with 3 iterations over
(1024, 1024), σ=2 soft raster. The training half of the presets (batch
size, losses, optimizer, synthetic stream) comes with the training port.
"""

from __future__ import annotations

import dataclasses

from indirect_learning_pose_shape_tpu_torch.models.encoder import EncoderConfig
from indirect_learning_pose_shape_tpu_torch.models.ief import IEFConfig
from indirect_learning_pose_shape_tpu_torch.models.network import ModelConfig
from indirect_learning_pose_shape_tpu_torch.ops.raster import RasterConfig


def _model(image_size: int, depth: int = 18, num_parts: int = 24) -> ModelConfig:
    return ModelConfig(
        image_size=image_size,
        encoder=EncoderConfig(depth=depth, fold_bn_eval=True),
        ief=IEFConfig(),
        raster=RasterConfig(image_size=image_size, num_parts=num_parts),
    )


# ResNet-18, axis-angle: the flagship (reference CONFIG4_FULL).
CONFIG4_FULL = _model(256)
# ResNet-34 + continuous 6D rotations (reference CONFIG4_R34).
CONFIG4_R34 = dataclasses.replace(
    _model(256, depth=34), ief=IEFConfig(rotation_format="rot6d")
)
# ResNet-50 + 6D rotations (reference CONFIG4_LARGE).
CONFIG4_LARGE = dataclasses.replace(
    _model(256, depth=50), ief=IEFConfig(rotation_format="rot6d")
)
# 31 foreground part classes (reference CONFIG4_PARTS31).
CONFIG4_PARTS31 = _model(256, num_parts=31)

PRESETS = {
    "config4_full": CONFIG4_FULL,
    "config4_r34": CONFIG4_R34,
    "config4_large": CONFIG4_LARGE,
    "config4_parts31": CONFIG4_PARTS31,
}
