"""Inference entry points (port of predict.py's model path).

`load_model` builds the network from a seed or from a converted-weights
`.npz` (keys and layouts of `Model.state_dict()`, as
`utils.convert.jax_to_state_dict` writes them); `predict` runs the eval
forward; `render_silhouette` renders the soft part raster of a prediction.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch import configs
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib
from indirect_learning_pose_shape_tpu_torch.utils import convert


def load_model(
    cfg: net.ModelConfig,
    params_npz: Optional[str] = None,
    asset=None,
    seed: int = 0,
    device: torch.device | str = "cuda",
    ema: bool = False,
) -> tuple[net.Model, net.ModelConsts]:
    """(model, consts) on `device` (the card unless the caller asks for the
    CPU; raises without one): a fresh init from `seed`, overwritten by the
    weights in `params_npz` when given (strict key and shape check).

    ema=True (the EMA parameters of a trained run) needs checkpoints, which
    are not ported yet; a live run's EMA model is `train.ema_model`."""
    if ema:
        raise NotImplementedError(
            "loading EMA parameters needs a checkpoint; it comes with "
            f"{configs.CHECKPOINTS} (a live run's EMA model is train.ema_model)"
        )
    asset = asset if asset is not None else assets_lib.load_asset()
    model, consts = net.init(asset, cfg, seed=seed, device=device)
    if params_npz:
        with np.load(params_npz) as z:
            convert.load_state_arrays(model, {k: z[k] for k in z.files})
    return model, consts


def predict(model, consts, images, cfg: net.ModelConfig) -> dict:
    """images [B, S, S, 3] in [-1, 1] -> outputs (verts, kp2d, theta, ...)."""
    with torch.inference_mode():
        return net.forward(model, consts, images, cfg)


def render_silhouette(outputs: dict, consts, cfg: net.ModelConfig) -> dict:
    """Soft part probabilities and silhouette from predicted verts + camera."""
    verts2d = camera.project_pixel(outputs["verts"], outputs["cam"], cfg.image_size)
    with torch.inference_mode():
        return raster.soft_rasterize(
            verts2d, consts.part_layout, cfg.raster, impl=cfg.raster_impl
        )
