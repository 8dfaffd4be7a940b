"""Dense hard z-buffer raster: wrapper of the CUDA kernel `csrc/raster_hard.cu`.

The kernel consumes exactly the tensors of the eager path's prologue
(`ops/raster_hard._face_coeffs`): the per-face coefficients [B, F, 13], the
non-degenerate mask `ok` [B, F] and the faces' classes [F], and writes the
dense mode's four images, bitwise the eager dense path's (`hard_raster(...,
impl='torch')`). It renders the canvas rows `row0 .. row0 + height - 1`, so a
render rank's band (`parallel/render_sp.Rows`) is one launch too.

Conventions of `raster_cuda.py`: the inputs are checked (dtype, shape,
contiguity, then device) and anything else raises; the outputs are allocated
here, the kernel allocates nothing; it launches on the current stream, and a
refused launch raises. There is no CPU version: `hard_raster` keeps the eager
code for CPU tensors, for `k_faces`, and for `impl='torch'`.
"""

from __future__ import annotations

import ctypes

import torch

from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build

KERNEL = "raster_hard"
NUM_COEFFS = 13  # per face: three edge functions, the depth plane, the shade
# The culling test's slack (csrc/raster_hard.cu kRel, kAbs).
REL_TOL = 2.0**-20
ABS_TOL = 1e-30
_P, _I = ctypes.c_void_p, ctypes.c_int


def may_cover(coeffs: torch.Tensor, x0: int, x1: int, y0: int, y1: int) -> torch.Tensor:
    """The kernel's culling test (csrc/raster_hard.cu `may_cover`) of every
    face of coeffs [..., 13] against the pixels [x0, x1] x [y0, y1]: False
    only where no pixel there can evaluate inside, because an edge
    function's float32 maximum over the rectangle lies below -(REL_TOL·M +
    ABS_TOL), M = |a|·x1 + |b|·y1 + |c|. Evaluated in float32 as the kernel
    does, for tests. Unlike the vertices' box, it holds for slivers whose
    rounded edge functions are >= 0 at pixels far past their corners."""
    f32 = dict(dtype=torch.float32, device=coeffs.device)
    x0, x1, y0, y1 = (torch.tensor(float(v), **f32) for v in (x0, x1, y0, y1))
    keep = torch.ones(coeffs.shape[:-1], dtype=torch.bool, device=coeffs.device)
    for i in (0, 3, 6):
        a, b, c = coeffs[..., i], coeffs[..., i + 1], coeffs[..., i + 2]
        hi = (a * torch.where(a >= 0, x1, x0) + b * torch.where(b >= 0, y1, y0)) + c
        m = a.abs() * x1 + b.abs() * y1 + c.abs()
        keep &= ~(hi < -(REL_TOL * m + ABS_TOL))
    return keep


def _check(name: str, x: torch.Tensor, shape: tuple, dtype) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        want = str(dtype).removeprefix("torch.")
        raise ValueError(
            f"hard raster kernel: {name} must be contiguous {want} {shape}, got "
            f"{x.dtype} {tuple(x.shape)} (contiguous={x.is_contiguous()})"
        )


def raster_hard_cuda(
    coeffs: torch.Tensor,
    ok: torch.Tensor,
    face_class: torch.Tensor,
    height: int,
    width: int,
    row0: int = 0,
    with_shade: bool = False,
) -> dict[str, torch.Tensor]:
    """coeffs [B, F, 13] float32, ok [B, F] bool, face_class [F] int32 ->
    part_labels [B, height, width] int32, silhouette and zbuf float32 (and
    shade float32 with `with_shade`) of canvas rows row0 .. row0 + height - 1."""
    if coeffs.ndim != 3:
        raise ValueError(f"hard raster kernel: coeffs must be [B, F, {NUM_COEFFS}], got {tuple(coeffs.shape)}")
    B, F = coeffs.shape[:2]
    _check("coeffs", coeffs, (B, F, NUM_COEFFS), torch.float32)
    _check("ok", ok, (B, F), torch.bool)
    _check("face_class", face_class, (F,), torch.int32)
    if height < 0 or width < 0 or row0 < 0:
        raise ValueError(f"hard raster kernel: bad band height={height}, width={width}, row0={row0}")
    for name, x in (("coeffs", coeffs), ("ok", ok), ("face_class", face_class)):
        if not x.is_cuda or x.device != coeffs.device:
            raise ValueError(f"hard raster kernel: {name} must be a CUDA tensor on coeffs' device, got {x.device}")
    dev = coeffs.device
    out = {
        "part_labels": torch.empty((B, height, width), dtype=torch.int32, device=dev),
        "silhouette": torch.empty((B, height, width), dtype=torch.float32, device=dev),
        "zbuf": torch.empty((B, height, width), dtype=torch.float32, device=dev),
    }
    if with_shade:
        out["shade"] = torch.empty((B, height, width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch(
            "ilps_raster_hard",
            (_P, coeffs.data_ptr()), (_P, ok.data_ptr()), (_P, face_class.data_ptr()),
            (_P, out["part_labels"].data_ptr()), (_P, out["silhouette"].data_ptr()),
            (_P, out["zbuf"].data_ptr()), (_P, out["shade"].data_ptr() if with_shade else None),
            (_I, B), (_I, F), (_I, height), (_I, width), (_I, row0), (_P, stream),
        )
    _build.count(KERNEL)
    return out
