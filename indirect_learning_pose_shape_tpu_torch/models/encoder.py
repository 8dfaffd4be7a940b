"""ResNet image encoder (port of the reference's models/encoder.py).

ResNet-18/34 (basic blocks) and ResNet-50 (bottleneck blocks), with the
reference's parameter names (`stem`, `bn_stem`, `s{stage}b{block}.conv1 |
bn1 | … | proj | bn_proj`), so converted weights map key for key
(utils/convert.py). Convolutions go to cuDNN through `F.conv2d`: the
reference has no Pallas kernel in the encoder.

- Input is NHWC float32, as in the reference; it is viewed as NCHW with
  channels-last strides, cuDNN's fast layout, without a copy.
- Compute runs in `compute_dtype` (bf16 by default) with float32 parameters
  and BatchNorm statistics; the global average pool returns float32.
- Padding is symmetric, (k-1)//2, and max-pool is 3/2 with pad 1 (torch's
  alignment, which the reference also uses).
- `fold_bn_eval` folds each BatchNorm into its conv (weights scaled in
  float32, then cast) — the reference's `_conv_bn` eval fusion; it applies
  only when `train=False`.
- Training-mode BatchNorm (`encoder_apply(..., train=True)`) follows the
  reference's `_batch_norm`, not `nn.BatchNorm2d`: statistics in one float32
  pass (mean and mean of squares), the biased variance
  `max(E[x²] − E[x]², 0)`, running statistics `momentum·old +
  (1 − momentum)·new`, and the normalization as a float32 per-channel affine
  applied in the compute dtype. Gradients flow through the batch statistics
  by autograd of that formula. The reference returns a new state; here the
  running `mean`/`var` buffers are updated in place. Under a mesh
  (`parallel/mesh.py`) the statistics are those of the global batch, as
  XLA's global view gives the reference: the per-channel means are summed
  over the data group and divided by its size (`all_reduce_shared`, whose
  backward sums the cotangent, as SyncBatchNorm's does); at one rank they
  are the one-process statistics bit for bit.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from indirect_learning_pose_shape_tpu_torch.parallel import mesh as mesh_lib


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    depth: int = 18  # 18, 34 or 50
    width: int = 64  # stem channels
    compute_dtype: torch.dtype = torch.bfloat16
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    fold_bn_eval: bool = False

    @property
    def feature_dim(self) -> int:
        return self.width * 8 * (4 if self.depth >= 50 else 1)


_STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3), 50: (3, 4, 6, 3)}


def _conv_weight(gen: torch.Generator, k: int, cin: int, cout: int) -> nn.Parameter:
    std = math.sqrt(2.0 / (k * k * cin))
    return nn.Parameter(torch.randn((cout, cin, k, k), generator=gen) * std)


class BatchNorm(nn.Module):
    """Per-channel affine (`scale`, `bias`) over running (`mean`, `var`)."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def affine(self, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
        """(inv, shift) in float32: y = x·inv + shift."""
        inv = torch.rsqrt(self.var + eps) * self.scale
        return inv, self.bias - self.mean * inv


def _batch_norm_train(y: torch.Tensor, bn: BatchNorm, cfg: EncoderConfig, mesh=None) -> torch.Tensor:
    """Batch statistics (one float32 pass, biased variance; over the global
    batch under `mesh`); updates the running buffers of `bn` in place."""
    y32 = y.float()
    mean = y32.mean(dim=(0, 2, 3))
    meansq = torch.square(y32).mean(dim=(0, 2, 3))
    if mesh is not None:  # equal shards: the global mean is the mean of the means
        stats = mesh_lib.all_reduce_shared(torch.stack([mean, meansq]), mesh.data_group)
        mean, meansq = stats / mesh.n_data
    var = torch.clamp_min(meansq - torch.square(mean), 0.0)
    with torch.no_grad():
        m = cfg.bn_momentum
        bn.mean.copy_(m * bn.mean + (1 - m) * mean)
        bn.var.copy_(m * bn.var + (1 - m) * var)
    inv = torch.rsqrt(var + cfg.bn_eps) * bn.scale
    shift = bn.bias - mean * inv
    return y * inv.to(y.dtype)[:, None, None] + shift.to(y.dtype)[:, None, None]


def _conv_bn(x, w, bn: BatchNorm, stride: int, cfg: EncoderConfig, train: bool, mesh=None) -> torch.Tensor:
    """conv → BatchNorm: batch statistics when `train` (global under
    `mesh`), else the running ones, folded into one conv with a bias when
    cfg.fold_bn_eval."""
    pad = (w.shape[-1] - 1) // 2
    if train:
        return _batch_norm_train(F.conv2d(x, w.to(x.dtype), stride=stride, padding=pad), bn, cfg, mesh)
    inv, shift = bn.affine(cfg.bn_eps)
    if cfg.fold_bn_eval:
        w = w * inv[:, None, None, None]
    y = F.conv2d(x, w.to(x.dtype), stride=stride, padding=pad)
    if cfg.fold_bn_eval:
        return y + shift.to(y.dtype)[:, None, None]
    return y * inv.to(y.dtype)[:, None, None] + shift.to(y.dtype)[:, None, None]


class Block(nn.Module):
    def __init__(self, gen, cin: int, cout: int, bottleneck: bool, stride: int):
        super().__init__()
        self.stride = stride
        self.bottleneck = bottleneck
        if bottleneck:
            mid = cout // 4
            self.conv1 = _conv_weight(gen, 1, cin, mid)
            self.bn1 = BatchNorm(mid)
            self.conv2 = _conv_weight(gen, 3, mid, mid)
            self.bn2 = BatchNorm(mid)
            self.conv3 = _conv_weight(gen, 1, mid, cout)
            self.bn3 = BatchNorm(cout)
        else:
            self.conv1 = _conv_weight(gen, 3, cin, cout)
            self.bn1 = BatchNorm(cout)
            self.conv2 = _conv_weight(gen, 3, cout, cout)
            self.bn2 = BatchNorm(cout)
        self.has_proj = stride != 1 or cin != cout
        if self.has_proj:
            self.proj = _conv_weight(gen, 1, cin, cout)
            self.bn_proj = BatchNorm(cout)

    def run(self, x: torch.Tensor, cfg: EncoderConfig, train: bool, mesh=None) -> torch.Tensor:
        s = self.stride
        shortcut = (
            _conv_bn(x, self.proj, self.bn_proj, s, cfg, train, mesh) if self.has_proj else x
        )
        if self.bottleneck:
            y = F.relu(_conv_bn(x, self.conv1, self.bn1, 1, cfg, train, mesh))
            y = F.relu(_conv_bn(y, self.conv2, self.bn2, s, cfg, train, mesh))
            y = _conv_bn(y, self.conv3, self.bn3, 1, cfg, train, mesh)
        else:
            y = F.relu(_conv_bn(x, self.conv1, self.bn1, s, cfg, train, mesh))
            y = _conv_bn(y, self.conv2, self.bn2, 1, cfg, train, mesh)
        return F.relu(y + shortcut)


class Encoder(nn.Module):
    """ResNet backbone: He-normal conv weights drawn from `gen`, BN at
    identity. Blocks are attributes named as in the reference."""

    def __init__(self, cfg: EncoderConfig, gen: torch.Generator):
        super().__init__()
        if cfg.depth not in _STAGE_BLOCKS:
            raise ValueError(f"unsupported depth {cfg.depth}")
        self.cfg = cfg
        bottleneck = cfg.depth >= 50
        expansion = 4 if bottleneck else 1
        self.stem = _conv_weight(gen, 7, 3, cfg.width)
        self.bn_stem = BatchNorm(cfg.width)
        self.block_names = []
        cin = cfg.width
        for stage, n in enumerate(_STAGE_BLOCKS[cfg.depth]):
            cout = cfg.width * (2**stage) * expansion
            for b in range(n):
                stride = 2 if (b == 0 and stage > 0) else 1
                name = f"s{stage}b{b}"
                self.add_module(name, Block(gen, cin, cout, bottleneck, stride))
                self.block_names.append(name)
                cin = cout


def encoder_apply(enc: Encoder, images: torch.Tensor, train: bool = False, mesh=None) -> torch.Tensor:
    """images [B, H, W, 3] float32 in [-1, 1] -> features [B, D] float32.

    train=True normalizes with batch statistics (of the global batch under
    `mesh`) and updates the running statistics of every BatchNorm in place.
    """
    cfg = enc.cfg
    x = images.permute(0, 3, 1, 2).to(cfg.compute_dtype)  # NCHW, channels-last strides
    if not x.is_cuda:
        # Plain NCHW on the CPU: the CPU backward of a strided 1x1 conv on
        # channels-last input corrupts memory when run on several threads.
        x = x.contiguous()
    x = F.relu(_conv_bn(x, enc.stem, enc.bn_stem, 2, cfg, train, mesh))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for name in enc.block_names:
        x = getattr(enc, name).run(x, cfg, train, mesh)
    return torch.mean(x, dim=(2, 3), dtype=torch.float32)
