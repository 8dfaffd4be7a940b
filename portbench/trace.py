"""The reduction of a `torch.profiler` run to the numbers the per-layer
metrics read.

Device items are grouped as `tools/profile_serve.category` groups them (a
frozen copy): the three named kernels, host-to-device copies, cuDNN
convolutions and cuBLAS GEMMs ("conv/gemm"), and "other" for the rest.
The device's busy time is the union of its kernel and copy intervals
inside the profiled stretch, not a sum of their times: overlapping items
count once. Each idle gap is named by the innermost host event that spans
its middle: what the host was doing while the device waited.
"""

from __future__ import annotations

import numpy as np
import torch

CATEGORIES = (
    ("raster kernel", ("raster_fwd_kernel",)),
    ("raster bwd kernel", ("raster_bwd_kernel",)),
    ("lbs kernel", ("lbs_forward_kernel",)),
    ("H2D copy", ("Memcpy HtoD",)),
    ("conv/gemm", ("conv", "gemm", "xmma", "cudnn", "cutlass")),
)
STRETCH = "portbench.stretch"


def category(name: str) -> str:
    lower = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in lower for k in keys):
            return cat
    return "other"


def _union(intervals: np.ndarray) -> np.ndarray:
    """Sorted disjoint [start, end] rows covering the rows of `intervals`."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def summarize(prof, units: int) -> dict:
    """The profiled stretch (the host span named `STRETCH`), per unit (step
    or request): device ms by category and by kernel, the busy and window
    seconds, and the breakdown (largest device items; idle time by the host
    activity under it)."""
    device, host, window = [], [], None
    for e in prof.events():
        start, end = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False) and end > start:
                device.append((e.name, start, end))
        elif e.name == STRETCH:
            window = (start, end)
        elif end > start:
            host.append((e.name, start, end))
    if window is None:
        raise RuntimeError(f"the profile holds no {STRETCH!r} span")
    w0, w1 = window
    device = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    by_kernel: dict[str, list] = {}
    for name, s, e in device:
        k = by_kernel.setdefault(name, [0.0, 0])
        k[0] += (e - s) / 1e3
        k[1] += 1
    by_cat: dict[str, float] = {}
    for name, (ms, _) in by_kernel.items():
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms / units
    busy = _union(np.asarray([(s, e) for _, s, e in device], np.float64).reshape(-1, 2))
    busy_us = float((busy[:, 1] - busy[:, 0]).sum()) if len(busy) else 0.0
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    return {
        "units": units,
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "by_category_ms": by_cat,
        "by_kernel_ms": {n: v[0] for n, v in by_kernel.items()},
        "launches": {n: v[1] for n, v in by_kernel.items()},
        "device_ops": [[n, v[0] / 1e3] for n, v in
                       sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:10]],
        "idle_gaps": _name_gaps(gaps, host),
    }


def _name_gaps(gaps: np.ndarray, host: list) -> list:
    """[[host activity, idle seconds]] of the ten activities under the most
    idle time; an activity is the innermost host event over a gap's middle."""
    if len(gaps) == 0:
        return []
    mid = (gaps[:, 0] + gaps[:, 1]) / 2
    order = np.argsort(mid)
    mid_sorted = mid[order]
    owner = np.full(len(gaps), -1)
    for i in sorted(range(len(host)), key=lambda i: host[i][1] - host[i][2]):  # longest first
        _, s, e = host[i]
        a, b = np.searchsorted(mid_sorted, [s, e])
        owner[order[a:b]] = i
    totals: dict[str, float] = {}
    for g, o in enumerate(owner):
        name = host[o][0] if o >= 0 else "(no host event)"
        totals[name] = totals.get(name, 0.0) + (gaps[g, 1] - gaps[g, 0]) / 1e6
    return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:10]]


def kernel_ms(summary: dict, key: str) -> tuple[float, int]:
    """Device ms and launches of the items whose name holds `key`."""
    ms = sum(v for n, v in summary["by_kernel_ms"].items() if key in n)
    n = sum(v for name, v in summary["launches"].items() if key in name)
    return ms, n
