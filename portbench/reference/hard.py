"""The z-buffered hard part raster of the robust stream's targets: a frozen
copy of the dense (exact) mode of the port's `ops/raster_hard.py`, which is
itself the reference package's eager design.

Each face is three edge functions and a depth plane, affine in pixel
coordinates, and a flat Lambertian shade. Every face is evaluated at every
pixel of every 32x32 tile in chunks of 64 faces: a max of depth (larger z
is nearer), then the class (and shade) of the faces whose depth equals the
buffer, equal depths going to the larger class id.
"""

from __future__ import annotations

import numpy as np
import torch

_NEG = -3.0e38
_TILE = 32
_CHUNK = 64


def face_class(faces: np.ndarray, vertex_class: np.ndarray) -> np.ndarray:
    """The majority class of a face's corners, corner 0's when all differ."""
    corner = np.asarray(vertex_class)[np.asarray(faces, np.int64)]
    a, b, c = corner[:, 0], corner[:, 1], corner[:, 2]
    return np.where(b == c, b, a).astype(np.int64)


def _coeffs(verts2d, verts_z, faces, with_shade: bool, light):
    tri = verts2d[:, faces]  # [B, F, 3, 2]
    tz = verts_z[:, faces]
    x, y = tri[..., 0], tri[..., 1]

    def edge(i, j):
        a = -(y[..., j] - y[..., i])
        b = x[..., j] - x[..., i]
        c = (y[..., j] - y[..., i]) * x[..., i] - (x[..., j] - x[..., i]) * y[..., i]
        return a, b, c

    e0, e1, e2 = edge(1, 2), edge(2, 0), edge(0, 1)
    area = e0[0] * x[..., 0] + e0[1] * y[..., 0] + e0[2]
    s = torch.sign(area)
    ok = torch.abs(area) > 1e-9
    inv = torch.where(ok, s / torch.clamp(torch.abs(area), min=1e-9), 0.0)
    out = []
    for a, b, c in (e0, e1, e2):
        out += [a * s, b * s, torch.where(ok, c * s, -1.0)]
    for k in range(3):
        out.append((e0[k] * tz[..., 0] + e1[k] * tz[..., 1] + e2[k] * tz[..., 2]) * inv)
    if with_shade:
        p = torch.cat([tri, tz[..., None]], dim=-1)
        n = torch.linalg.cross(p[:, :, 1] - p[:, :, 0], p[:, :, 2] - p[:, :, 0], dim=-1)
        n = torch.where(n[..., 2:3] < 0, -n, n)
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
        lt = light / torch.clamp(torch.linalg.vector_norm(light, dim=-1, keepdim=True), min=1e-9)
        shade = 0.25 + 0.75 * torch.clamp(torch.sum(n * lt[:, None, :], dim=-1), 0.0, 1.0)
    else:
        shade = torch.zeros_like(x[..., 0])
    out.append(shade)
    return torch.stack(out, dim=-1), ok


@torch.no_grad()
def hard_raster(verts2d, verts_z, faces: torch.Tensor, fclass: torch.Tensor, size: int,
                with_shade: bool = False, light=None) -> dict:
    """verts2d [B, V, 2], verts_z [B, V] -> part_labels [B, S, S] int32 (0
    background, class c as c + 1), silhouette float32 {0, 1}, shade."""
    dev = verts2d.device
    T = size // _TILE
    B, F = verts2d.shape[0], faces.shape[0]
    nt = T * T
    coeffs, ok = _coeffs(verts2d.float(), verts_z.float(), faces, with_shade, light)
    dead = torch.where(torch.arange(13, device=dev) == 2, -1.0, 0.0)
    coeffs = torch.where(ok[..., None], coeffs, dead)[:, None]  # [B, 1, F, 13]
    label = (fclass + 1).expand(B, F)[:, None]
    npad = -F % _CHUNK
    if npad:
        coeffs = torch.cat([coeffs, dead.expand(B, 1, npad, 13)], dim=2)
        label = torch.cat([label, label.new_zeros(B, 1, npad)], dim=2)
    off = torch.arange(_TILE, dtype=torch.float32, device=dev)
    t = torch.arange(nt, device=dev)
    px = (((t % T).float() * _TILE)[:, None] + off)[None, :, None, :]
    py = (((t // T).float() * _TILE)[:, None] + off)[None, :, None, :]

    def depth(cf):
        def plane(i):
            ax = cf[..., i, None] * px
            by = cf[..., i + 1, None] * py
            return (ax[..., None, :] + by[..., :, None]) + cf[..., i + 2, None, None]

        low = torch.minimum(torch.minimum(plane(0), plane(3)), plane(6))
        return torch.where(low >= 0.0, plane(9), _NEG)

    chunks = [slice(j, j + _CHUNK) for j in range(0, coeffs.shape[2], _CHUNK)]
    zbuf = torch.full((B, nt, _TILE, _TILE), _NEG, device=dev)
    for c in chunks:
        zbuf = torch.maximum(zbuf, depth(coeffs[:, :, c]).amax(dim=2))
    cwin = torch.zeros((B, nt, _TILE, _TILE), dtype=label.dtype, device=dev)
    swin = torch.zeros((B, nt, _TILE, _TILE), device=dev)
    for c in chunks:
        cf = coeffs[:, :, c]
        hit = depth(cf) >= zbuf[:, :, None]
        cwin = torch.maximum(cwin, torch.where(hit, label[:, :, c, None, None], 0).amax(dim=2))
        if with_shade:
            swin = torch.maximum(swin, torch.where(hit, cf[..., 12, None, None], 0.0).amax(dim=2))

    def image(a):
        return a.reshape(B, T, T, _TILE, _TILE).permute(0, 1, 3, 2, 4).reshape(B, size, size)

    covered = image(zbuf) > _NEG / 2
    return {
        "part_labels": torch.where(covered, image(cwin), 0).to(torch.int32),
        "silhouette": covered.float(),
        "shade": torch.where(covered, image(swin), 0.0),
    }
