"""Inference entry points (port of predict.py's model path).

`load_model` builds the network from a seed, from a converted-weights
`.npz` (keys and layouts of `Model.state_dict()`, as
`utils.convert.jax_to_state_dict` writes them) or from a training
checkpoint (the model, or its EMA); `predict` runs the eval forward;
`render_silhouette` renders the soft part raster of a prediction.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib
from indirect_learning_pose_shape_tpu_torch.utils import convert
from indirect_learning_pose_shape_tpu_torch.utils.checkpoint import Checkpointer


def load_model(
    cfg: net.ModelConfig,
    params_npz: Optional[str] = None,
    asset=None,
    seed: int = 0,
    device: torch.device | str = "cuda",
    ema: bool = False,
    checkpoint_dir: Optional[str] = None,
    step: Optional[int] = None,
) -> tuple[net.Model, net.ModelConsts]:
    """(model, consts) on `device` (the card unless the caller asks for the
    CPU; raises without one): a fresh init from `seed`, overwritten by the
    weights in `params_npz` when given (strict key and shape check), or by
    the model of checkpoint `step` (default: the latest) in
    `checkpoint_dir`. Only the model and the EMA are read, so the load does
    not depend on how the run's optimizer was built.

    ema=True serves the checkpoint's EMA parameters with its live BN
    statistics, and refuses a checkpoint written without an EMA."""
    asset = asset if asset is not None else assets_lib.load_asset()
    model, consts = net.init(asset, cfg, seed=seed, device=device)
    if params_npz:
        with np.load(params_npz) as z:
            convert.load_state_arrays(model, {k: z[k] for k in z.files})
    if checkpoint_dir:
        saved = Checkpointer(checkpoint_dir).restore_partial(
            ("model", "ema"), step, map_location=consts.smpl.v_template.device
        )
        model.load_state_dict(saved["model"])
        if ema:
            if saved["ema"] is None:
                raise ValueError(
                    f"checkpoint {checkpoint_dir!r} holds no EMA parameters (the run trained "
                    "with ema_decay=0): train with ema_decay > 0, or load without ema"
                )
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(saved["ema"][k])
    elif ema:
        raise ValueError("ema=True needs a checkpoint_dir (a live run's EMA model is train.ema_model)")
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
