"""Hard (z-buffered) triangle rasterizer for target generation (port of
ops/raster_hard.py).

The synthetic stream's `targets='hard'` renders ground-truth part labels and
silhouettes from the asset's faces with hard edges and true occlusion, so
the supervision does not come from the soft raster the model trains
through. Never differentiated: the inputs are detached.

The reference's design, in eager PyTorch: each face is 13 float32
coefficients (three edge functions and the depth plane, affine in pixel
coordinates, and a flat shade); the image is cut into square tiles; faces
are either all evaluated in every tile (dense, exact) or culled per tile to
`k_faces` slots by a bounding-box overlap test (faces past the budget are
dropped and counted in `overflow`); a loop over chunks of `chunk` face
slots carries the per-pixel state, so the temporaries are [B, tiles,
chunk, tile, tile] whatever the face count. Two passes, as in the
reference: a max-reduce of the depth (larger z is nearer), then the class
(and shade) of the faces whose depth equals the buffer; equal depths go to
the larger class id. Max is order-free, so the result does not depend on
`chunk`.

With `rows` (a `parallel/render_sp.Rows`) a render rank rasterises only
its band of tile rows: the tiles are numbered row-major, so a block of tile
rows is a band of image rows, and the band's outputs are the same rows of
the whole render. The number of tile rows must divide over the render axis.

On the card the dense mode is one hand-written kernel
(`ops/kernels/raster_hard_cuda.py`, `csrc/raster_hard.cu`) that consumes the
same prologue (`_face_coeffs`) and returns the eager dense outputs bitwise.
The route is chosen from the input: `impl='auto'` launches the kernel for a
CUDA tensor with `k_faces=None` and runs the eager code otherwise (CPU
tensors; `k_faces` set, whose face-order budget is the reference's
approximation); `impl='torch'` always runs the eager code, `impl='kernel'`
always the kernel (it raises for a CPU tensor or with `k_faces`).

`hard_raster_oracle` is a numpy copy of the reference's per-triangle loop,
for the tests.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.ops.kernels import raster_hard_cuda

_NEG = -3.0e38  # empty-pixel depth, below any real depth, float32-safe


@dataclasses.dataclass(frozen=True)
class HardConsts:
    """faces [F, 3] int64 vertex indices; face_class [F] int32 part class in
    [0, num_parts) (the raster labels a covered pixel class + 1, an
    uncovered one 0, as the soft targets)."""

    faces: torch.Tensor
    face_class: torch.Tensor


def build_hard_consts(
    faces: np.ndarray, vertex_class: np.ndarray, device: torch.device | str = "cpu"
) -> HardConsts:
    """Face classes from vertex classes: the majority of the three corners,
    corner 0's class when all three differ."""
    faces = np.asarray(faces, np.int64)
    corner = np.asarray(vertex_class, np.int32)[faces]  # [F, 3]
    a, b, c = corner[:, 0], corner[:, 1], corner[:, 2]
    face_class = np.where(b == c, b, a).astype(np.int32)
    return HardConsts(
        faces=torch.as_tensor(faces, device=device),
        face_class=torch.as_tensor(face_class, device=device),
    )


def _face_coeffs(verts2d, verts_z, hc: HardConsts, with_shade: bool, light):
    """Per-face coefficients [B, F, 13]: (a0,b0,c0, a1,b1,c1, a2,b2,c2,
    az,bz,cz, shade), with edge functions w_i(x, y) = a_i x + b_i y + c_i
    signed so that inside means every w_i >= 0, and depth z(x, y) = az x +
    bz y + cz. A degenerate face gets c_i = -1 (never inside). Also the
    faces' boxes (xmin, xmax, ymin, ymax) and `ok` (not degenerate).

    The three edges go through each operation together (the corners rolled
    into place): about half the launches of an edge at a time, and every
    element sees the same float32 operations in the same order, so the
    result is bitwise that form's (`portbench/reference/hard.py` keeps it)."""
    tri = verts2d[:, hc.faces]  # [B, F, 3, 2]
    tz = verts_z[:, hc.faces]  # [B, F, 3]
    x, y = tri[..., 0], tri[..., 1]

    # Edge k runs from corner k+1 to corner k+2 (it is opposite corner k):
    # w(p) = (xj - xi)(py - yi) - (yj - yi)(px - xi), so a = -(yj - yi),
    # b = xj - xi, c = (yj - yi)·xi - (xj - xi)·yi. w_k / area is the
    # barycentric λ_k. torch.roll, not an index list: nothing is copied from
    # the host, so the prologue captures in a CUDA graph.
    start = torch.roll(tri, -1, dims=2)  # corners 1, 2, 0
    d = torch.roll(tri, -2, dims=2) - start  # corners 2, 0, 1 less those
    dx, dy = d[..., 0], d[..., 1]
    a, b = -dy, dx  # [B, F, 3 edges]
    c = dy * start[..., 0] - dx * start[..., 1]
    area = a[..., 0] * x[..., 0] + b[..., 0] * y[..., 0] + c[..., 0]  # twice the signed area
    s = torch.sign(area)
    mag = torch.abs(area)
    ok = mag > 1e-9
    inv = torch.where(ok, s / torch.clamp(mag, min=1e-9), 0.0)

    s3 = s[..., None]
    edges = torch.stack([a * s3, b * s3, torch.where(ok[..., None], c * s3, -1.0)], dim=-1)  # [B, F, 3, 3]
    # z(p) = Σ λ_i z_i = (Σ w_i z_i) / area, for (az, bz, cz) at once.
    wz = torch.stack([a, b, c], dim=-2) * tz[..., None, :]  # [B, F, coefficient, edge]
    depth = ((wz[..., 0] + wz[..., 1]) + wz[..., 2]) * inv[..., None]

    if with_shade:
        # Flat Lambertian shade from the screen-space normal (pixels, pixels,
        # raw z), turned toward the viewer.
        p = torch.cat([tri, tz[..., None]], dim=-1)  # [B, F, 3, 3]
        n = torch.linalg.cross(p[:, :, 1] - p[:, :, 0], p[:, :, 2] - p[:, :, 0], dim=-1)
        n = torch.where(n[..., 2:3] < 0, -n, n)
        n = n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True), min=1e-9)
        l = light / torch.clamp(torch.linalg.vector_norm(light, dim=-1, keepdim=True), min=1e-9)
        l = l[None, None, :] if l.ndim == 1 else l[:, None, :]
        shade = 0.25 + 0.75 * torch.clamp(torch.sum(n * l, dim=-1), 0.0, 1.0)
    else:
        shade = torch.zeros_like(x[..., 0])
    lo, hi = tri.amin(dim=2), tri.amax(dim=2)  # [B, F, 2]
    bbox = (lo[..., 0], hi[..., 0], lo[..., 1], hi[..., 1])
    return torch.cat([edges.flatten(-2), depth, shade[..., None]], dim=-1), bbox, ok


def _use_kernel(impl: str, device: torch.device, k_faces: int | None) -> bool:
    """Whether `hard_raster` launches the kernel (module docstring)."""
    if impl not in ("auto", "kernel", "torch"):
        raise ValueError(f"hard raster impl must be 'auto' | 'kernel' | 'torch', got {impl!r}")
    if impl == "kernel" and k_faces is not None:
        raise ValueError("the hard raster kernel renders the dense mode only: k_faces must be None")
    return impl == "kernel" or (impl == "auto" and device.type == "cuda" and k_faces is None)


@torch.no_grad()
def hard_raster(
    verts2d: torch.Tensor,
    verts_z: torch.Tensor,
    hc: HardConsts,
    size: int,
    *,
    tile: int = 32,
    k_faces: int | None = None,
    chunk: int = 64,
    with_shade: bool = False,
    light=(0.35, -0.5, 0.79),
    rows=None,
    impl: str = "auto",
) -> dict[str, torch.Tensor]:
    """Z-buffered part-label render of verts2d [B, V, 2] (pixels) at depth
    verts_z [B, V] (larger is nearer), on verts2d's device.

    `k_faces` bounds the faces per tile (None: every face in every tile,
    exact). A tile that overlaps more faces than that drops the excess and
    counts it in `overflow`; a caller that sets k_faces checks overflow is 0.
    `light` is one direction [3] or one per image [B, 3], read only with
    `with_shade`. `impl` picks the route ('auto', 'kernel' or 'torch', module
    docstring); every route returns the same outputs.

    Returns part_labels [B, S, S] int32 (0 background, class c → c + 1),
    silhouette [B, S, S] float32 {0, 1}, zbuf [B, S, S] float32 (-3e38 where
    empty), shade [B, S, S] float32 (with_shade; 0 where empty) and overflow,
    an int32 scalar tensor: the most faces any tile dropped. With `rows`, the
    [B, S, S] outputs are the band's [B, S/n, S] and `overflow` the band's.
    """
    if size % tile:
        raise ValueError(f"size {size} must be a multiple of tile {tile}")
    use_kernel = _use_kernel(impl, verts2d.device, k_faces)
    T = size // tile
    ty0, tb = 0, T  # the first tile row rendered here, and how many
    if rows is not None:
        if T % rows.count:
            raise ValueError(
                f"{T} tile rows ({size} px / tile {tile}) not divisible by render axis {rows.count}"
            )
        tb = T // rows.count
        ty0 = rows.index * tb
    dev = verts2d.device
    verts2d = verts2d.detach().float()
    verts_z = verts_z.detach().float()
    if with_shade:  # a tensor on the card copies nothing from the host
        light = torch.as_tensor(light, dtype=torch.float32, device=dev)
    B, F = verts2d.shape[0], hc.faces.shape[0]
    nt = tb * T

    coeffs, (xmin, xmax, ymin, ymax), ok = _face_coeffs(verts2d, verts_z, hc, with_shade, light)
    if use_kernel:
        out = raster_hard_cuda.raster_hard_cuda(coeffs, ok, hc.face_class, tb * tile, size, ty0 * tile, with_shade)
        out["overflow"] = torch.zeros((), dtype=torch.int32, device=dev)
        return out
    fclass = hc.face_class.expand(B, F)

    if k_faces is not None and k_faces < F:
        # Culling: box ↔ tile overlap, then the first k_faces overlapping
        # faces of each tile in face order. A stable descending sort picks
        # them as lax.top_k does (lower index first among equal values);
        # torch.topk leaves that order unspecified.
        def spans(first, n, lo, hi):  # [B, n, F]: tile index within [floor(lo/tile), floor(hi/tile)]
            tids = torch.arange(first, first + n, dtype=torch.float32, device=dev)
            return (tids[None, :, None] >= torch.floor(lo / tile)[:, None, :]) & (
                tids[None, :, None] <= torch.floor(hi / tile)[:, None, :])

        visible = ok & (xmax >= 0.0) & (xmin <= size - 1.0) & (ymax >= 0.0) & (ymin <= size - 1.0)
        overlap = (
            spans(ty0, tb, ymin, ymax)[:, :, None, :] & spans(0, T, xmin, xmax)[:, None, :, :]
            & visible[:, None, None, :]
        ).reshape(B, nt, F)
        topval, topidx = torch.sort(overlap.float(), dim=-1, descending=True, stable=True)
        topval, topidx = topval[..., :k_faces], topidx[..., :k_faces]
        overflow = torch.clamp(torch.amax(overlap.sum(-1, dtype=torch.int32) - k_faces), min=0)
        slot_coeffs = torch.gather(
            coeffs[:, None].expand(B, nt, F, 13), 2, topidx[..., None].expand(B, nt, k_faces, 13)
        )
        slot_class = torch.gather(fclass[:, None].expand(B, nt, F), 2, topidx)
        slot_live = topval > 0.0
    else:
        slot_coeffs = coeffs[:, None]  # [B, 1, F, 13]: every face, every tile
        slot_class = fclass[:, None]
        slot_live = ok[:, None]
        overflow = torch.zeros((), dtype=torch.int32, device=dev)

    # A dead slot (degenerate, culled out or padding) gets w0 = -1 everywhere,
    # so it is never inside: the reference's `live` mask, folded in.
    # Made on the device: an indexed store of a Python number would copy it
    # from the host.
    dead = torch.where(torch.arange(13, device=dev) == 2, -1.0, 0.0)
    slot_coeffs = torch.where(slot_live[..., None], slot_coeffs, dead)
    npad = -slot_coeffs.shape[2] % chunk
    if npad:
        slot_coeffs = torch.cat([slot_coeffs, dead.expand(*slot_coeffs.shape[:2], npad, 13)], dim=2)
        slot_class = torch.cat([slot_class, slot_class.new_zeros(*slot_class.shape[:2], npad)], dim=2)
    slot_label = slot_class + 1

    # Pixel coordinates of tile t = (ty - ty0)*T + tx: columns tx*tile + ox,
    # rows ty*tile + oy. a·px + b·py + c is formed as (a·px) + (b·py) + c, the
    # reference's order, from the per-column and per-row products.
    off = torch.arange(tile, dtype=torch.float32, device=dev)
    t = torch.arange(nt, device=dev)
    px = ((t % T).float() * tile)[:, None] + off  # [nt, tile]
    py = ((t // T + ty0).float() * tile)[:, None] + off
    px, py = px[None, :, None, :], py[None, :, None, :]

    def eval_z(cf):
        """Depth of this chunk's faces at each tile's pixels, _NEG outside:
        [B, nt|1, chunk, 13] -> [B, nt, chunk, tile (y), tile (x)]."""

        def plane(i):
            ax = cf[..., i, None] * px  # [B, nt, chunk, tile]
            by = cf[..., i + 1, None] * py
            return (ax[..., None, :] + by[..., :, None]) + cf[..., i + 2, None, None]

        low = torch.minimum(plane(0), plane(3))
        low = torch.minimum(low, plane(6))
        return torch.where(low >= 0.0, plane(9), _NEG)

    chunks = [slice(j, j + chunk) for j in range(0, slot_coeffs.shape[2], chunk)]
    zbuf = torch.full((B, nt, tile, tile), _NEG, device=dev)
    for c in chunks:
        zbuf = torch.maximum(zbuf, eval_z(slot_coeffs[:, :, c]).amax(dim=2))
    cwin = torch.zeros((B, nt, tile, tile), dtype=torch.int32, device=dev)
    swin = torch.zeros((B, nt, tile, tile), device=dev) if with_shade else None
    for c in chunks:
        cf = slot_coeffs[:, :, c]
        hit = eval_z(cf) >= zbuf[:, :, None]
        cwin = torch.maximum(cwin, torch.where(hit, slot_label[:, :, c, None, None], 0).amax(dim=2))
        if with_shade:
            swin = torch.maximum(swin, torch.where(hit, cf[..., 12, None, None], 0.0).amax(dim=2))

    def detile(a):  # [B, ty*T + tx, oy, ox] -> [B, tb*tile, S]
        return a.reshape(B, tb, T, tile, tile).permute(0, 1, 3, 2, 4).reshape(B, tb * tile, size)

    zbuf = detile(zbuf)
    covered = zbuf > _NEG / 2
    out = {
        "part_labels": torch.where(covered, detile(cwin), 0).to(torch.int32),
        "silhouette": covered.float(),
        "zbuf": zbuf,
        "overflow": overflow.to(torch.int32),
    }
    if with_shade:
        out["shade"] = torch.where(covered, detile(swin), 0.0)
    return out


def hard_raster_oracle(
    verts2d: np.ndarray,
    verts_z: np.ndarray,
    faces: np.ndarray,
    face_class: np.ndarray,
    size: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Numpy z-buffer labeller of one image, in float64, one triangle at a
    time (the reference's oracle). Returns (part_labels [S, S] int32,
    zbuf [S, S] float32)."""
    v = np.concatenate(
        [np.asarray(verts2d, np.float64), np.asarray(verts_z, np.float64)[:, None]], axis=1
    )
    tri = v[np.asarray(faces, np.int64)]
    labels = np.zeros((size, size), np.int32)
    zbuf = np.full((size, size), -np.inf, np.float64)
    for f in range(len(tri)):
        t = tri[f]
        x0, x1 = int(np.floor(t[:, 0].min())), int(np.ceil(t[:, 0].max()))
        y0, y1 = int(np.floor(t[:, 1].min())), int(np.ceil(t[:, 1].max()))
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, size - 1), min(y1, size - 1)
        if x1 < x0 or y1 < y0:
            continue
        d = (t[1, 0] - t[0, 0]) * (t[2, 1] - t[0, 1]) - (t[2, 0] - t[0, 0]) * (t[1, 1] - t[0, 1])
        if abs(d) < 1e-9:
            continue
        xs, ys = np.meshgrid(
            np.arange(x0, x1 + 1, dtype=np.float64), np.arange(y0, y1 + 1, dtype=np.float64)
        )
        w1 = ((xs - t[0, 0]) * (t[2, 1] - t[0, 1]) - (t[2, 0] - t[0, 0]) * (ys - t[0, 1])) / d
        w2 = ((t[1, 0] - t[0, 0]) * (ys - t[0, 1]) - (xs - t[0, 0]) * (t[1, 1] - t[0, 1])) / d
        w0 = 1.0 - w1 - w2
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        z = w0 * t[0, 2] + w1 * t[1, 2] + w2 * t[2, 2]
        sub_z = zbuf[y0 : y1 + 1, x0 : x1 + 1]
        upd = inside & (z > sub_z)
        sub_z[upd] = z[upd]
        labels[y0 : y1 + 1, x0 : x1 + 1][upd] = int(face_class[f]) + 1
    return labels, zbuf.astype(np.float32)
