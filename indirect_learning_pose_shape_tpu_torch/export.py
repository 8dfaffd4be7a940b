"""Serialized-model export (port of export.py): `torch.export` replaces the
reference's StableHLO artifact.

`export_forward` traces the inference forward, a preprocessed image batch
[batch, S, S, 3] float32 in [-1, 1] in, (theta, verts, kp2d) out, with
`torch.export.export` on `device`, and returns `torch.export.save` of the
`ExportedProgram` as bytes (a `.pt2` archive, the weights inside).
`export_forward_int8` does the same for the int8 encoder
(models/quantize.py, 'int8c' by default as the reference). A serving host
calls `load_exported(blob)(images)`: no model code is needed beyond torch.

The artifact runs the plain SMPL (`smpl_impl='torch'`): the port's kernels
are called through ctypes (ops/kernels/_build.py), which `torch.export`
cannot trace, as Pallas kernels cannot lower into the reference's portable
module (it pins `smpl_impl='xla'` for the same reason). The plain SMPL is
held to the kernel within 1e-4 (`chip_smoke.py`). The forward never
rasterizes, so no raster pin is needed. The program is exported on the
device it serves on, and its batch is fixed.

CLI front end: tools/export_model.py.
"""

from __future__ import annotations

import dataclasses
import io

import torch
from torch import nn

from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import quantize as quant


class _Forward(nn.Module):
    """images -> (theta, verts, kp2d), through the model, or through the int8
    encoder and the model's IEF (the float encoder is then not held)."""

    def __init__(self, model: net.Model, consts, cfg: net.ModelConfig, qenc=None, impl: str = "int8c"):
        super().__init__()
        self.consts, self.qenc, self.impl = consts, qenc, impl
        if qenc is None:
            self.model = model
        else:
            self.ief = model.ief
        self.cfg = dataclasses.replace(cfg, smpl_impl="torch")

    def forward(self, images: torch.Tensor):
        if self.qenc is None:
            out = net.forward(self.model, self.consts, images, self.cfg)
        else:
            out = quant.quantized_forward(self.qenc, self.ief, self.consts, images, self.cfg, self.impl)
        return out["theta"], out["verts"], out["kp2d"]


def _export(module: nn.Module, cfg: net.ModelConfig, batch: int, device) -> bytes:
    images = torch.zeros((batch, cfg.image_size, cfg.image_size, 3), device=device)
    with torch.no_grad():
        program = torch.export.export(module.eval(), (images,))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_forward(
    cfg: net.ModelConfig, model: net.Model, consts, batch: int, device: str = "cuda"
) -> bytes:
    """The eval forward with the model's weights inside, as bytes."""
    return _export(_Forward(model, consts, cfg), cfg, batch, device)


def export_forward_int8(
    cfg: net.ModelConfig,
    model: net.Model,
    consts,
    batch: int,
    calib_images: torch.Tensor | None = None,
    device: str = "cuda",
    impl: str = "int8c",
    qparams: dict | None = None,
) -> bytes:
    """The int8-encoder forward as bytes: the encoder quantized on
    `calib_images` (or the given `qparams`), its int8 weights and scales
    inside, run by `impl` ('int8c' by default; 'int8' per site)."""
    if qparams is None:
        qparams = quant.ptq_quantize(model.encoder, calib_images)
    qenc = quant.as_encoder(qparams, cfg.encoder, device)
    return _export(_Forward(model, consts, cfg, qenc, impl), cfg, batch, device)


def load_exported(blob: bytes):
    """An artifact's callable: images [batch, S, S, 3] -> (theta, verts, kp2d)."""
    return torch.export.load(io.BytesIO(blob)).module()
