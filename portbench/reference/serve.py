"""A served request in plain PyTorch: the evaluation forward (BatchNorm on
its running statistics, unfolded) and the soft silhouette of the predicted
mesh, in blocks of crops so that it fits beside anything."""

from __future__ import annotations

import torch

from portbench.reference import model as model_lib
from portbench.reference import raster as raster_lib
from portbench.reference.precision import Precision, full_float32
from portbench.reference.train import Inputs

KEYS = ("theta", "verts", "kp2d")


@torch.no_grad()
def answer(weights: dict, inp: Inputs, cfg: dict, crops: torch.Tensor, silhouette: bool,
           prec: Precision, block: int = 32) -> dict:
    """crops [N, S, S, 3] float32 on the device -> {theta, verts, kp2d
    [, silhouette]} on the host."""
    parts = {k: [] for k in KEYS + (("silhouette",) if silhouette else ())}
    with full_float32():
        for i in range(0, crops.shape[0], block):
            out = model_lib.forward(weights, inp.body, crops[i : i + block], cfg, False, prec)
            for k in KEYS:
                parts[k].append(out[k].cpu())
            if silhouette:
                sil = raster_lib.silhouette(out["verts2d"], inp.parts, cfg["image_size"], cfg["sigma"],
                                            cfg["bg_gamma"], prec)
                parts["silhouette"].append(sil.cpu())
    return {k: torch.cat(v) for k, v in parts.items()}


@torch.no_grad()
def geometry(inp: Inputs, cfg: dict, theta: torch.Tensor, silhouette: bool, prec: Precision,
             block: int = 64) -> dict:
    """The head after the regressor, from a given Θ [N, theta_dim]: SMPL,
    the projection and the silhouette, on the host."""
    parts = {k: [] for k in ("verts", "kp2d") + (("silhouette",) if silhouette else ())}
    with full_float32():
        for i in range(0, theta.shape[0], block):
            out = model_lib.head(theta[i : i + block], inp.body, cfg, prec)
            parts["verts"].append(out["verts"].cpu())
            parts["kp2d"].append(out["kp2d"].cpu())
            if silhouette:
                sil = raster_lib.silhouette(out["verts2d"], inp.parts, cfg["image_size"], cfg["sigma"],
                                            cfg["bg_gamma"], prec)
                parts["silhouette"].append(sil.cpu())
    return {k: torch.cat(v) for k, v in parts.items()}
