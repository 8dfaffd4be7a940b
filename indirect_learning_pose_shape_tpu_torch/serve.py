"""Serving runtime: bucketed-batch inference (port of serve.py).

Requests of any batch size are padded up to the next of a small set of
bucket sizes, run, and sliced back. On the card this keeps the set of
shapes cuDNN and the kernels see small and fixed, so `warmup` can pay every
first-call cost (cuDNN algorithm choice, kernel build) before traffic.

    predictor = Predictor(cfg, model, consts)               # bf16 eval forward
    predictor = Predictor(cfg, model, consts, qparams=qp)   # int8 encoder
    predictor.warmup()
    out = predictor(images)          # images [N, S, S, 3] float32 in [-1, 1]

With `qparams` (models/quantize.py: `ptq_quantize` or `load_qparams`) the
encoder is the quantized one, run by `int8_impl` ('int8c' by default, the
reference's serving default; 'int8', 'sim', 'simc'), and the head is the
model's IEF, SMPL and projection (`quantize.quantized_forward`). The
qparams are moved to the card once, when the Predictor is built.

The forward runs under `torch.inference_mode()`. The Predictor turns TF32
off process-wide (`utils.precision.disable_tf32`): float32 products on the
card then match the reference's full-precision numbers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import quantize as quant
from indirect_learning_pose_shape_tpu_torch.utils.precision import disable_tf32

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


class Predictor:
    """Shape-bucketed eval forward; outputs are sliced to the true batch."""

    def __init__(
        self,
        cfg: net.ModelConfig,
        model: net.Model,
        consts: net.ModelConsts,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        qparams: Optional[dict] = None,
        int8_impl: str = "int8c",
    ):
        if not buckets or any(int(b) <= 0 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets!r}")
        disable_tf32()
        self.cfg = cfg
        self.model = model.eval()
        self.consts = consts
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.device = consts.smpl.v_template.device
        if int8_impl not in quant.IMPLS:
            raise ValueError(f"int8_impl must be one of {quant.IMPLS}, got {int8_impl!r}")
        self.int8_impl = int8_impl
        self.qenc = (
            None if qparams is None else quant.as_encoder(qparams, cfg.encoder, self.device)
        )

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch {n} exceeds largest bucket {self.buckets[-1]}; "
            "split the request or extend buckets"
        )

    def _run(self, images: torch.Tensor) -> dict:
        with torch.inference_mode():
            if self.qenc is None:
                return net.forward(self.model, self.consts, images, self.cfg)
            return quant.quantized_forward(
                self.qenc, self.model.ief, self.consts, images, self.cfg, self.int8_impl
            )

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Run every chosen bucket (all by default) once before traffic."""
        size = self.cfg.image_size
        for b in buckets or self.buckets:
            n = self.bucket_for(b)
            self._run(torch.zeros((n, size, size, 3), device=self.device))

    def __call__(self, images) -> dict:
        """images [N, S, S, 3] float32 in [-1, 1], any N within the buckets."""
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(images)
        images = images.to(self.device, torch.float32)
        n = images.shape[0]
        b = self.bucket_for(n)
        if b != n:
            pad = images.new_zeros((b - n,) + tuple(images.shape[1:]))
            images = torch.cat([images, pad])
        outputs = self._run(images.contiguous())
        if b != n:
            outputs = {k: v[:n] for k, v in outputs.items()}
        return outputs
