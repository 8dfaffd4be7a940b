"""The soft part raster, exact, in plain PyTorch:

    score[c, y, x] = Σ_{v in part c} exp(−((x − x_v)² + (y − y_v)²) / 2σ²)

The Gaussian factorises over the axes, so a class's score image is
Fyᵀ·Fx with Fx[v, x] = exp(−(x − x_v)²/2σ²): one float32 product per image
and class, over every vertex of the class (no cut-off), differentiated by
autograd. Vertices are grouped by class into rows padded with zeros.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.precision import Precision


@dataclasses.dataclass(frozen=True)
class Parts:
    index: torch.Tensor  # [C, n] vertex of each slot (0 on padding)
    mask: torch.Tensor  # [C, n] float32, 1 on real slots
    num_parts: int


def parts(labels: np.ndarray, num_parts: int, device) -> Parts:
    counts = np.bincount(labels, minlength=num_parts)
    n = int(counts.max())
    index = np.zeros((num_parts, n), np.int64)
    mask = np.zeros((num_parts, n), np.float32)
    for c in range(num_parts):
        idx = np.nonzero(labels == c)[0]
        index[c, : len(idx)] = idx
        mask[c, : len(idx)] = 1.0
    return Parts(torch.as_tensor(index, device=device), torch.as_tensor(mask, device=device), num_parts)


def scores(verts2d: torch.Tensor, p: Parts, size: int, sigma: float, prec: Precision) -> torch.Tensor:
    """verts2d [B, V, 2] pixels -> float32 scores [B, C, size, size]."""
    B, (C, n) = verts2d.shape[0], p.index.shape
    v = verts2d[:, p.index.reshape(-1)].reshape(B, C, n, 2)
    r = torch.arange(size, dtype=torch.float32, device=verts2d.device)
    k = 1.0 / (2.0 * sigma * sigma)
    fx = torch.exp(-torch.square(r - v[..., 0:1]) * k) * p.mask[..., None]  # [B, C, n, W]
    fy = torch.exp(-torch.square(r - v[..., 1:2]) * k)  # [B, C, n, H]
    return prec.mm(fy.transpose(-1, -2), fx)


def silhouette(verts2d: torch.Tensor, p: Parts, size: int, sigma: float, bg_gamma: float,
               prec: Precision) -> torch.Tensor:
    """The served silhouette: Σ_c score / (γ + Σ_c score), [B, size, size]."""
    s_total = scores(verts2d, p, size, sigma, prec).sum(dim=1)
    return s_total / (bg_gamma + s_total)
