"""What the soft raster needs on given data, whatever the kernel's design
(a frozen copy of `chip_smoke.raster_work` / `raster_bound`, corrected):
each real vertex ("slot") against the pixels of its own cut-off box, the
square of ±cutoff_sigmas·σ around it clipped to the canvas. The port's
kernels cull by 128-slot blocks and compute about twice these pairs; a
redesigned kernel is read against the same work.

- pairs: Σ over slots of its box's pixels;
- exps: Σ over slots of its box's columns + rows (the separable factors);
- g_pixels: the (image, class, pixel) triples inside the union of the
  class's slot boxes: the part of the cotangent the backward must read.

Least time: the larger of the bytes at HBM rate (forward: the slots read
once, the [B, C, H, W] float32 scores written once; backward: the slots
read, the cotangent inside the boxes read, the slot gradient written) and
the operations (the exponentials at the SFU rate, or one FMA a pair
forward and two backward at the float32 rate, whichever is longer).
"""

from __future__ import annotations

import torch

from portbench import work


def boxes(verts2d: torch.Tensor, size: int, cut: float):
    """Per slot (lo, hi) pixel index ranges, each [B, V, 2] float64, and
    extents [B, V, 2] (0 for a box off the canvas)."""
    v = verts2d.double()
    lo = torch.clamp(torch.ceil(v - cut), min=0)
    hi = torch.clamp(torch.floor(v + cut), max=size - 1)
    return lo, hi, (hi - lo + 1).clamp(min=0)


def raster_work(verts2d: torch.Tensor, labels: torch.Tensor, num_parts: int, size: int,
                sigma: float, cutoff_sigmas: float = 6.0) -> dict:
    """verts2d [B, V, 2] pixels of the real vertices, labels [V] class."""
    lo, hi, ext = boxes(verts2d, size, cutoff_sigmas * sigma)
    pairs = float((ext[..., 0] * ext[..., 1]).sum())
    exps = float(ext.sum())
    g_pixels = 0
    live = (ext[..., 0] > 0) & (ext[..., 1] > 0)
    n = size + 1
    for b in range(verts2d.shape[0]):
        keep = live[b]
        c = labels[keep].long()
        x0, x1 = lo[b, keep, 0].long(), hi[b, keep, 0].long() + 1
        y0, y1 = lo[b, keep, 1].long(), hi[b, keep, 1].long() + 1
        diff = torch.zeros(num_parts * n * n, dtype=torch.int32, device=verts2d.device)
        one = torch.ones_like(c, dtype=torch.int32)
        for y, x, s in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1), (y1, x1, 1)):
            diff.index_put_(((c * n + y) * n + x,), one * s, accumulate=True)
        cover = diff.reshape(num_parts, n, n).cumsum(1).cumsum(2)[:, :size, :size]
        g_pixels += int((cover > 0).sum())
    return {"pairs": pairs, "exps": exps, "g_pixels": g_pixels,
            "slots": verts2d.shape[0] * verts2d.shape[1], "canvas": verts2d.shape[0] * num_parts * size * size}


def bound_ms(w: dict, backward: bool) -> float:
    """The least time of one raster launch on the data `w` (`raster_work`)."""
    if backward:
        nbytes = 4 * (2 * w["slots"] + w["g_pixels"] + 2 * w["slots"])
        ops = max(w["exps"] / work.EXP_PER_S, 2 * w["pairs"] / work.FMA_PER_S)
    else:
        nbytes = 4 * (2 * w["slots"] + w["canvas"])
        ops = max(w["exps"] / work.EXP_PER_S, w["pairs"] / work.FMA_PER_S)
    return max(nbytes / work.HBM_BYTES_PER_S, ops) * 1e3
