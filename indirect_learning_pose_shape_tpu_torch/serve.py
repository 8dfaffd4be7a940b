"""Serving runtime: bucketed-batch inference (port of serve.py).

Requests of any batch size are padded up to the next of a small set of
bucket sizes, run, and sliced back. On the card each bucket is one CUDA
graph of the forward, the counterpart of the reference's one jit entry per
bucket: `warmup` captures the chosen buckets before traffic (after an eager
call that pays every first-call cost: cuDNN algorithm choice, kernel
build), and a bucket never warmed is captured at its first request, as
`jax.jit` compiles at the first call. A request copies its images into the
bucket's input buffer (zeros past the request), replays the graph and
returns clones of its rows of the outputs, so an earlier request's outputs
never change when a later one replays. The buckets' graphs share one memory
pool: they replay one at a time, and each request's outputs are copied out
before the next replay, so a Predictor serves one request at a time (one
dispatcher thread, as the reference's). `graphs=False` runs the eager
forward on the card, for comparison; on the CPU the forward is always
eager.

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

A request is the span `serve.request` (`utils/tracing.py`), its host work
the child spans `serve.upload` (the images to the card), `serve.stage` (the
images padded with zeros to the bucket: into the bucket's buffer, or a new
one on the eager route), `graph.replay` (`serve.forward` on the eager
route) and `serve.clone`; it counts
`serve.requests`, `serve.rows`, `serve.padded_rows` and `serve.bucket.<b>`.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import quantize as quant
from indirect_learning_pose_shape_tpu_torch.utils import graphs as graphs_lib
from indirect_learning_pose_shape_tpu_torch.utils import tracing
from indirect_learning_pose_shape_tpu_torch.utils.precision import disable_tf32

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def _forward(model, consts, cfg, qenc, int8_impl: str, images: torch.Tensor) -> dict:
    """The eval forward of `images` [B, S, S, 3], through the quantized
    encoder `qenc` under `int8_impl` when there is one."""
    with torch.inference_mode():
        if qenc is None:
            return net.forward(model, consts, images, cfg)
        return quant.quantized_forward(qenc, model.ief, consts, images, cfg, int8_impl)


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
        graphs: bool = True,
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
        self._run = functools.partial(_forward, self.model, consts, cfg, self.qenc, int8_impl)
        self.graphs = graphs and graphs_lib.eager_reason(self.device) is None
        self._pool = None  # the buckets' shared graph memory pool, made at the first capture
        self._calls: dict[int, graphs_lib.CapturedCall] = {}

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"batch {n} exceeds largest bucket {self.buckets[-1]}; "
            "split the request or extend buckets"
        )

    def _call(self, b: int) -> graphs_lib.CapturedCall:
        """Bucket `b`'s captured forward, its input buffer `inputs["images"]`,
        captured on first use."""
        if b not in self._calls:
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            size, run = self.cfg.image_size, self._run  # a call holding `self` would be a cycle
            call = graphs_lib.CapturedCall(lambda x: run(x["images"]), self.device, pool=self._pool)
            call.stage({"images": torch.zeros((b, size, size, 3), device=self.device)})
            call()
            self._calls[b] = call
        return self._calls[b]

    def bucket_graph(self, b: int) -> Optional[graphs_lib.Graph]:
        """Bucket `b`'s graph, None before its capture or without graphs (its
        `seconds` and `pool_bytes` say what the capture cost)."""
        return self._calls[b].graph if b in self._calls else None

    def warmup(self, buckets: Optional[Sequence[int]] = None) -> None:
        """Capture every chosen bucket (all by default) before traffic; with
        eager forwards, run each once."""
        size = self.cfg.image_size
        for b in buckets or self.buckets:
            n = self.bucket_for(b)
            if self.graphs:
                self._call(n)
            else:
                self._run(torch.zeros((n, size, size, 3), device=self.device))

    def __call__(self, images) -> dict:
        """images [N, S, S, 3] float32 in [-1, 1], any N within the buckets."""
        with tracing.span("serve.request", root=True):
            with tracing.span("serve.upload"):
                if isinstance(images, np.ndarray):
                    images = torch.from_numpy(images)
                images = images.to(self.device, torch.float32)
            n = images.shape[0]
            b = self.bucket_for(n)
            tracing.count("serve.requests")
            tracing.count("serve.rows", n)
            tracing.count("serve.padded_rows", b - n)
            tracing.count(f"serve.bucket.{b}")
            call = self._call(b) if self.graphs else None
            with tracing.span("serve.stage"):
                x = images.new_empty((b, *images.shape[1:])) if call is None else call.inputs["images"]
                x[:n].copy_(images)
                x[n:].zero_()
            if call is None:
                with tracing.span("serve.forward"):
                    outputs = self._run(x)
            else:
                outputs = call()
            with tracing.span("serve.clone"):
                return {k: v[:n].clone() for k, v in outputs.items()}
