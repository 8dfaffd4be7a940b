"""ctypes binding of the native host-side preprocessor (port of
data/native_preprocess.py).

Source images of an image directory come in many sizes, so the step from
ragged images to fixed-size crops runs on the host: `native/preprocess.cc`
crops, resizes (bilinear for images, nearest for label masks) and
normalises, one thread per image. At first use it is compiled with

    g++ -O3 -fPIC -std=c++17 -ffp-contract=off -shared -o \
        build/ilps_torch_kernels/libilps_preprocess_<hash>.so native/preprocess.cc -lpthread

(the hash is of the source and the flags) and loaded with ctypes. Without a
C++ compiler, or without the source, the numpy versions below run instead;
they compute in float32 in the library's order (no fused multiply-adds:
`-ffp-contract=off`), so the two paths agree bitwise. `USE_NATIVE` says
which one ran.

Geometry: the sample of output index o is at source position
s = (c - size/2) + (o + 0.5)·size/S - 0.5; bilinear samples outside
[0, h - 1] are 0 and nearest ones round half up (floor(s + 0.5)), 0 outside
the image. The on-device path (`data/preprocess.py`) keeps the half-pixel
band of `jax.image.scale_and_translate` instead, so the two agree only for
boxes inside the image, as in the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from indirect_learning_pose_shape_tpu_torch.ops.kernels._build import BUILD_DIR, PACKAGE_DIR

SOURCE = PACKAGE_DIR.parent / "native" / "preprocess.cc"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared")

_lib: Optional[ctypes.CDLL] = None
_tried = False
USE_NATIVE = False

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libilps_preprocess_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it exists; raises when g++ is missing or
    fails. Written under a temporary name and renamed, so a concurrent
    process never loads a half-written file."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native preprocessor cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / out.name
        cmd = [cxx, *CXX_FLAGS, "-o", str(lib), str(SOURCE), "-lpthread"]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(lib, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    """The library, built on first use; None (the numpy versions) when it
    cannot be built here. Tried once per process."""
    global _lib, _tried, USE_NATIVE
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not SOURCE.is_file():
        return None
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    sig = [_u8p, _i64p, _i32p, _i32p, _f32p, ctypes.c_int, ctypes.c_int]
    lib.ilps_crop_resize_normalize.argtypes = [*sig, _f32p, ctypes.c_int]
    lib.ilps_crop_resize_mask.argtypes = [*sig, _u8p, ctypes.c_int]
    lib.ilps_bbox_from_mask.argtypes = [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_float, _f32p]
    for fn in (lib.ilps_crop_resize_normalize, lib.ilps_crop_resize_mask, lib.ilps_bbox_from_mask):
        fn.restype = None
    _lib = lib
    USE_NATIVE = True
    return lib


def _pack(images: Sequence[np.ndarray]):
    """Ragged uint8 images -> (flat buffer, element offsets, heights, widths)."""
    sizes = np.array([im.size for im in images], np.int64)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    heights = np.array([im.shape[0] for im in images], np.int32)
    widths = np.array([im.shape[1] for im in images], np.int32)
    flat = np.concatenate([np.ascontiguousarray(im, np.uint8).reshape(-1) for im in images])
    return flat, offsets, heights, widths


def _positions(center, size, out_size: int) -> np.ndarray:
    """Source positions of the output samples along one axis, float32, in
    the library's order: (c - size·0.5) + (o + 0.5)·(size / S) - 0.5."""
    c, size = np.float32(center), np.float32(size)
    step = size / np.float32(out_size)
    o = np.arange(out_size, dtype=np.float32)
    return (c - size * np.float32(0.5)) + (o + np.float32(0.5)) * step - np.float32(0.5)


def _np_crop_resize(img: np.ndarray, bbox, out_size: int, nearest: bool = False) -> np.ndarray:
    """The library's crop of one uint8 image [H, W, C] or mask [H, W]:
    float32 bilinear (lerp a + (b - a)·t, x then y) zero outside [0, h - 1],
    or nearest with half-up rounding (uint8, 0 outside the image)."""
    ys, xs = _positions(bbox[0], bbox[2], out_size), _positions(bbox[1], bbox[2], out_size)
    h, w = img.shape[:2]
    if nearest:
        yr = np.floor(ys + np.float32(0.5)).astype(np.int64)
        xr = np.floor(xs + np.float32(0.5)).astype(np.int64)
        out = img[np.clip(yr, 0, h - 1)[:, None], np.clip(xr, 0, w - 1)[None, :]]
        inside = ((yr >= 0) & (yr < h))[:, None] & ((xr >= 0) & (xr < w))[None, :]
        if out.ndim == 3:
            inside = inside[..., None]
        return np.where(inside, out, np.zeros_like(out))
    inside = ((ys >= 0) & (ys <= h - 1))[:, None] & ((xs >= 0) & (xs <= w - 1))[None, :]
    y0 = np.floor(np.clip(ys, 0, h - 1)).astype(np.int64)
    x0 = np.floor(np.clip(xs, 0, w - 1)).astype(np.int64)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    ty = (ys - y0.astype(np.float32))[:, None, None]
    tx = (xs - x0.astype(np.float32))[None, :, None]
    im = img.astype(np.float32).reshape(h, w, -1)

    def lerp(a, b, t):
        return a + (b - a) * t

    top = lerp(im[y0[:, None], x0[None, :]], im[y0[:, None], x1[None, :]], tx)
    bot = lerp(im[y1[:, None], x0[None, :]], im[y1[:, None], x1[None, :]], tx)
    out = np.where(inside[..., None], lerp(top, bot, ty), np.float32(0.0))
    return out.reshape((out_size, out_size) + img.shape[2:])


def crop_resize_normalize(
    images: Sequence[np.ndarray], bboxes: np.ndarray, out_size: int, num_threads: int = 0
) -> np.ndarray:
    """Ragged uint8 [H, W, 3] images and (cy, cx, size) boxes -> [B, S, S, 3]
    float32 on [-1, 1] (v / 127.5 - 1 as v · (1/127.5) - 1 in float32).
    `num_threads` 0 uses every core."""
    bboxes = np.ascontiguousarray(bboxes, np.float32)
    lib = _load()
    if lib is None:
        crops = np.stack([_np_crop_resize(im, bb, out_size) for im, bb in zip(images, bboxes)])
        return crops * (np.float32(1.0) / np.float32(127.5)) - np.float32(1.0)
    flat, offsets, heights, widths = _pack(images)
    out = np.empty((len(images), out_size, out_size, 3), np.float32)
    lib.ilps_crop_resize_normalize(
        flat.ctypes.data_as(_u8p), offsets.ctypes.data_as(_i64p),
        heights.ctypes.data_as(_i32p), widths.ctypes.data_as(_i32p),
        bboxes.ctypes.data_as(_f32p), len(images), out_size,
        out.ctypes.data_as(_f32p), num_threads or (os.cpu_count() or 1),
    )
    return out


def crop_resize_mask(
    masks: Sequence[np.ndarray], bboxes: np.ndarray, out_size: int, num_threads: int = 0
) -> np.ndarray:
    """Ragged uint8 [H, W] label masks -> [B, S, S] uint8 (nearest)."""
    bboxes = np.ascontiguousarray(bboxes, np.float32)
    lib = _load()
    if lib is None:
        return np.stack(
            [_np_crop_resize(m, bb, out_size, nearest=True) for m, bb in zip(masks, bboxes)]
        ).astype(np.uint8)
    flat, offsets, heights, widths = _pack(masks)
    out = np.empty((len(masks), out_size, out_size), np.uint8)
    lib.ilps_crop_resize_mask(
        flat.ctypes.data_as(_u8p), offsets.ctypes.data_as(_i64p),
        heights.ctypes.data_as(_i32p), widths.ctypes.data_as(_i32p),
        bboxes.ctypes.data_as(_f32p), len(masks), out_size,
        out.ctypes.data_as(_u8p), num_threads or (os.cpu_count() or 1),
    )
    return out


def _np_bbox_from_mask(mask: np.ndarray, pad: float) -> np.ndarray:
    """The library's box, in float32: centre (lo + hi + 1)·0.5, size
    max(8, longer extent · pad); (h/2, w/2, max(h, w)) when empty."""
    ys, xs = np.nonzero(mask)
    h, w = mask.shape
    if len(ys) == 0:
        return np.array([h * 0.5, w * 0.5, max(h, w)], np.float32)
    extent = max(ys.max() - ys.min() + 1, xs.max() - xs.min() + 1)
    size = max(np.float32(8.0), np.float32(extent) * np.float32(pad))
    return np.array(
        [(ys.max() + ys.min() + 1) * 0.5, (xs.max() + xs.min() + 1) * 0.5, size], np.float32
    )


def bbox_from_mask(mask: np.ndarray, pad: float = 1.15) -> np.ndarray:
    """(cy, cx, size) float32 around the nonzero pixels of a uint8 [H, W] mask."""
    mask = np.ascontiguousarray(mask, np.uint8)
    lib = _load()
    if lib is None:
        return _np_bbox_from_mask(mask, pad)
    out = np.empty(3, np.float32)
    lib.ilps_bbox_from_mask(
        mask.ctypes.data_as(_u8p), mask.shape[0], mask.shape[1], ctypes.c_float(pad),
        out.ctypes.data_as(_f32p),
    )
    return out
