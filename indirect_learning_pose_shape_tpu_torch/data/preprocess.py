"""On-device image preprocessing (port of data/preprocess.py).

A raw disk batch is cropped and resized on the tensors' device, batched
over B, with no host round-trip: the square crop box of each sample is
applied to its image (bilinear), its label mask (nearest) and its keypoints.

Convention: bbox = (cy, cx, size) in continuous source coordinates (pixel i
spans [i, i+1)): a square crop centred at (cy, cx) with side `size`, mapped
to [out_size, out_size]. Output index o samples source position
s = (c - size/2) + (o + 0.5)·size/out_size - 0.5.

`crop_resize` is the reference's `jax.image.scale_and_translate(...,
method='linear', antialias=False)`, computed as that function computes it:
triangle weights on the two nearest source pixels, renormalised by the sum
of the weights that fall inside the image, and zero for a sample outside
the band [-0.5, h - 0.5]. So a sample in [-0.5, 0) takes pixel 0's value
and one below -0.5 is 0. The host path (`data/native_preprocess.py`) zeroes
everything outside [0, h - 1] instead; the two agree only for boxes inside
the image, as the reference's two paths do.
"""

from __future__ import annotations

import numpy as np
import torch

# compute_weight_mat's threshold on the sum of a sample's weights.
_MIN_WEIGHT_SUM = 1000.0 * float(np.finfo(np.float32).eps)


def _linear_taps(center: torch.Tensor, size: torch.Tensor, out_size: int, n: int):
    """The two source indices [B, S, 2] (clamped into range) and their
    weights [B, S, 2] of each output sample along one axis of length `n`,
    in float32 in the reference's order: scale = S / size, translation
    -(c - size/2)·scale, s = (o + 0.5)/scale - translation/scale - 0.5."""
    scale = out_size / size
    trans = -(center - size / 2.0) * scale
    inv = 1.0 / scale
    o = torch.arange(out_size, dtype=torch.float32, device=size.device) + 0.5
    s = o * inv[:, None] - (trans * inv)[:, None] - 0.5  # [B, S]
    i0 = torch.floor(s)
    i1 = i0 + 1.0
    w = torch.stack([1.0 - (s - i0), 1.0 - (i1 - s)], dim=-1)
    idx = torch.stack([i0, i1], dim=-1)
    w = torch.where((idx >= 0) & (idx < n), w, 0.0)
    total = w.sum(dim=-1, keepdim=True)
    w = torch.where(total > _MIN_WEIGHT_SUM, w / torch.where(total != 0, total, 1.0), 0.0)
    band = ((s >= -0.5) & (s <= n - 0.5))[..., None]
    w = torch.where(band, w, 0.0)
    return idx.clamp(0, n - 1).long(), w


def crop_resize(images: torch.Tensor, bboxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Batched square crop + bilinear resize, in float32.

    images [B, H, W, C] (any numeric dtype), bboxes [B, 3] = (cy, cx, size)
    -> [B, out_size, out_size, C] on the images' 0-255 (or own) scale."""
    B, H, W, C = images.shape
    bboxes = bboxes.float()
    iy, wy = _linear_taps(bboxes[:, 0], bboxes[:, 2], out_size, H)
    ix, wx = _linear_taps(bboxes[:, 1], bboxes[:, 2], out_size, W)
    b = torch.arange(B, device=images.device)
    rows = images[b[:, None, None], iy].float()  # [B, S, 2, W, C]
    rows = torch.sum(rows * wy[..., None, None], dim=2)  # [B, S, W, C]
    cols = torch.gather(rows, 2, ix.reshape(B, 1, -1, 1).expand(B, out_size, -1, C))
    cols = cols.reshape(B, out_size, out_size, 2, C)  # [B, S, S, 2, C]
    return torch.sum(cols * wx[:, None, :, :, None], dim=3)


def crop_resize_mask(masks: torch.Tensor, bboxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """Nearest-neighbour crop + resize of integer masks [B, H, W] -> [B, S, S]
    (labels never blend): source index floor(c - size/2 + (o + 0.5)·step),
    step = size / S, in float32 in the reference's order (half-up rounding
    of the sample position); 0 (background) outside the source."""
    B, H, W = masks.shape
    bboxes = bboxes.float()
    cy, cx, size = bboxes[:, 0:1], bboxes[:, 1:2], bboxes[:, 2:3]
    step = size / out_size
    o = torch.arange(out_size, dtype=torch.float32, device=masks.device) + 0.5
    ysf = torch.floor(cy - size / 2.0 + o * step).long()  # [B, S]
    xsf = torch.floor(cx - size / 2.0 + o * step).long()
    b = torch.arange(B, device=masks.device)
    out = masks[b[:, None, None], ysf.clamp(0, H - 1)[:, :, None], xsf.clamp(0, W - 1)[:, None, :]]
    inside = ((ysf >= 0) & (ysf < H))[:, :, None] & ((xsf >= 0) & (xsf < W))[:, None, :]
    return torch.where(inside, out, torch.zeros_like(out))


def transform_keypoints(kp2d: torch.Tensor, bboxes: torch.Tensor, out_size: int) -> torch.Tensor:
    """(x, y) source-pixel keypoints [B, K, 2] through the crop: a keypoint
    on source index x lands on ((x + 0.5) - (c - size/2))·S/size - 0.5."""
    cy, cx, size = bboxes[..., 0:1], bboxes[..., 1:2], bboxes[..., 2:3]
    scale = out_size / size
    x = (kp2d[..., 0] + 0.5 - (cx - size / 2.0)) * scale - 0.5
    y = (kp2d[..., 1] + 0.5 - (cy - size / 2.0)) * scale - 0.5
    return torch.stack([x, y], dim=-1)


def normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 or float on [0, 255] -> float32 on [-1, 1]."""
    return images.float() / 127.5 - 1.0


def bbox_from_mask(masks: torch.Tensor, pad: float = 1.15) -> torch.Tensor:
    """Square boxes (cy, cx, size) [B, 3] around the nonzero pixels of each
    mask [B, H, W]: the tight box's centre, its longer side times `pad`, at
    least 8. An empty mask gives (H/2, W/2, max(H, W))."""
    B, H, W = masks.shape
    dev = masks.device
    m = masks > 0
    big = 1e9
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    y0 = torch.where(m, ys, big).amin(dim=(1, 2))
    y1 = torch.where(m, ys, -big).amax(dim=(1, 2))
    x0 = torch.where(m, xs, big).amin(dim=(1, 2))
    x1 = torch.where(m, xs, -big).amax(dim=(1, 2))
    empty = ~m.any(dim=2).any(dim=1)
    cy = torch.where(empty, H / 2.0, (y0 + y1 + 1.0) / 2.0)
    cx = torch.where(empty, W / 2.0, (x0 + x1 + 1.0) / 2.0)
    size = torch.where(
        empty, float(max(H, W)), torch.maximum(y1 - y0 + 1.0, x1 - x0 + 1.0) * pad
    )
    return torch.stack([cy, cx, torch.clamp(size, min=8.0)], dim=-1)
