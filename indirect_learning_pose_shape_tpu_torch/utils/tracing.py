"""Spans and counters of the port: where the host time of a training step
and of a served request goes, measured where the work happens.

Spans. `span(name)` is a context manager placed on host code at a layer's
boundary, around launches. The model's own spans (`vit.*`, `head.decoder`)
lie inside the step a CUDA graph captures: they record in an eager call and
at the capture, never at a replay, which runs no host code.
It records only while a `torch.profiler` session is active (one call,
`torch._C._autograd._profiler_enabled()`); otherwise it returns the shared
no-op `OFF` and records nothing. There is no other switch: a run is traced
by profiling it (`train.py --profile DIR`, the benchmark's `--trace 1`).
A recording span opens a `torch.profiler.record_function` range of its
name, so it lies in the profiler's trace on the clock of the card's kernels
and copies, and on leaving appends a record to a bounded buffer (the
newest `MAX_SPANS`): its id, name, parent's id, unit id and start and end
in ms of `time.perf_counter`. A span opened with `root=True` opens a unit
(one training step, one log write, one request, one silhouette): its id is
the unit's, and every span nested under it carries that unit id.

Counters. `count(name, n)` is always on: a dict increment, in the one
registry that also holds the kernel launch counts of
`ops/kernels/_build.py` (under `launch.`). A count made while a span
records is also added to that span's own `counts`, so a unit's counts are
those of its own work.

Reading: `spans()`, `last_units(root, n)` (the spans of a stretch),
`units(records, root)` (per unit: ms and counts by name), `self_ms` (each
span's ms less its children's), `summary()` (per name: count, total and
self ms; the counters) and `idle_by_span(prof)` (a finished profile's
device idle time, each gap named by the innermost program span over it,
on the profile's own clock).

Span names, by layer (`PERF.md` §3 says which metric reads each):

    train.step      train.reseed train.stale_check train.capture
                    train.copy_in train.advance train.clone graph.replay
    train.log       train.log.readback
    serve.request   serve.upload serve.stage graph.replay serve.forward
                    serve.clone
    serve.silhouette  silhouette.project silhouette.raster
    graph.capture
    vit.embed vit.blocks head.decoder   (the HMR 2.0 model's forward)

The roots, each opened with `root=True` where it is called: `train.step`,
`train.log`, `serve.request`, `serve.silhouette`. Counters:
`graph.captures`, `graph.replays`, `serve.requests`, `serve.rows`,
`serve.padded_rows`, `serve.bucket.<b>`, `launch.<kernel>`, and in the
HMR 2.0 model's forward `attn.calls.<backend>` (a
`scaled_dot_product_attention` call, by the backend it takes),
`vit.tokens` (the tokens the ViT encodes) and `vit.tokens.add_ln.kernel` /
`vit.tokens.add_ln.eager` (the rows the blocks' fused add + LayerNorm
normalised on its CUDA kernels / its plain twin).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Iterable, Optional

import numpy as np
import torch

MAX_SPANS = 1 << 16

_profiling = torch._C._autograd._profiler_enabled
_records: collections.deque = collections.deque(maxlen=MAX_SPANS)
_counts: dict[str, int] = {}
_names: set[str] = set()
_ids = itertools.count(1)


class _Local(threading.local):
    """Each thread's stack of open recording spans."""

    def __init__(self):
        self.stack: list = []


_local = _Local()


class _Off:
    """The span of an untraced run: enters and leaves, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    __slots__ = ("name", "root", "id", "parent", "unit", "start", "counts", "_range")

    def __init__(self, name: str, root: bool):
        self.name = name
        self.root = root
        self.counts: Optional[dict] = None

    def __enter__(self):
        stack = _local.stack
        up = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = up.id if up else None
        self.unit = self.id if self.root else (up.unit if up else None)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _local.stack.pop()
        _names.add(self.name)
        _records.append((self.id, self.name, self.parent, self.unit,
                         self.start / 1e6, end / 1e6, self.counts))
        return False


def span(name: str, root: bool = False):
    """A span of `name` around the block: recorded under a profiler, the
    shared no-op `OFF` otherwise. A `root` span opens a unit."""
    return _Span(name, root) if _profiling() else OFF


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`, and to the innermost recording span's own
    counts (which keep the launches a capture counts, though
    `graphs.record_launches` takes them back out of the registry)."""
    _counts[name] = _counts.get(name, 0) + n
    stack = _local.stack
    if stack:
        top = stack[-1]
        if top.counts is None:
            top.counts = {}
        top.counts[name] = top.counts.get(name, 0) + n


def counters(prefix: str = "") -> dict[str, int]:
    """The counters whose name starts with `prefix`, the prefix cut off."""
    k = len(prefix)
    return {name[k:]: n for name, n in _counts.items() if name.startswith(prefix)}


def reset_counts() -> None:
    """Clear every counter."""
    _counts.clear()


def set_counters(prefix: str, saved: dict[str, int]) -> None:
    """Put the counters under `prefix` back to `saved` (a `counters(prefix)`
    taken earlier); the others stay as they are."""
    for name in [name for name in _counts if name.startswith(prefix)]:
        del _counts[name]
    _counts.update({prefix + name: n for name, n in saved.items()})


def spans() -> list[dict]:
    """The recorded spans, oldest first by start: `id`, `name`, `parent`
    (id or None), `unit` (its root's id, or None outside any root), `start`
    and `end` (ms of `time.perf_counter`) and `counts`."""
    keys = ("id", "name", "parent", "unit", "start", "end", "counts")
    return sorted((dict(zip(keys, r)) for r in list(_records)), key=lambda s: s["start"])


def _is_root(s: dict) -> bool:
    return s["unit"] == s["id"]


def last_units(root: str, n: int, records: Optional[list] = None) -> list[dict]:
    """The spans of the last `n` units rooted at `root`, and of every unit
    of another root that starts after the first of them: a stretch of `n`
    steps or requests with the logs or silhouettes between them."""
    recs = spans() if records is None else records
    chosen = [s for s in recs if s["name"] == root and _is_root(s)][-n:] if n > 0 else []
    if not chosen:
        return []
    first = chosen[0]["start"]
    keep = {s["id"] for s in chosen}
    keep |= {s["id"] for s in recs if _is_root(s) and s["name"] != root and s["start"] >= first}
    return [s for s in recs if s["unit"] in keep]


def units(records: Iterable[dict], root: str) -> list[dict]:
    """Per unit rooted at `root` among `records`, in order of start: `ms`,
    the total ms of its spans by name, and `counts`, its spans' counts
    summed by name."""
    out: dict[int, dict] = {}
    recs = list(records)
    for s in recs:
        if s["name"] == root and _is_root(s):
            out[s["id"]] = {"ms": {}, "counts": {}}
    for s in recs:
        u = out.get(s["unit"])
        if u is None:
            continue
        u["ms"][s["name"]] = u["ms"].get(s["name"], 0.0) + s["end"] - s["start"]
        for name, n in (s["counts"] or {}).items():
            u["counts"][name] = u["counts"].get(name, 0) + n
    return list(out.values())


def self_ms(records: Iterable[dict]) -> dict[int, float]:
    """By span id: the span's ms less the part its children among `records`
    cover (spans of one thread nest, so its children do not overlap)."""
    recs = list(records)
    out = {s["id"]: s["end"] - s["start"] for s in recs}
    for s in recs:
        if s["parent"] in out:
            out[s["parent"]] -= s["end"] - s["start"]
    return out


def summary(records: Optional[list] = None) -> dict:
    """`spans`: per span name, `count`, `total_ms` and `self_ms` over
    `records` (every recorded span by default); `counters`: every counter."""
    recs = spans() if records is None else records
    own = self_ms(recs)
    out: dict[str, dict] = {}
    for s in recs:
        row = out.setdefault(s["name"], {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += s["end"] - s["start"]
        row["self_ms"] += own[s["id"]]
    return {"spans": out, "counters": dict(_counts)}


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted disjoint [start, end] rows covering the rows of `iv`."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.concatenate([[True], iv[1:, 0] > ends[:-1]])
    starts = iv[new, 0]
    last = np.concatenate([np.flatnonzero(new)[1:] - 1, [len(iv) - 1]])
    return np.stack([starts, ends[last]], axis=1)


def idle_by_span(prof) -> dict:
    """The device's idle time in a finished `torch.profiler` run, each part
    named by the innermost program span over it.

    The window is the profile's extent (its first event's start to its last
    event's end); busy is the union of its device kernels and copies (a
    range annotated on the host and mirrored on the device is not one).
    Program spans are its host events named as a `span` of this process
    has been. Returns `window_ms`, `idle_ms`, `by_span_ms`
    (idle ms by innermost span, largest first) and `no_span_ms` (idle time
    under no program span). Times come from the profile alone: one clock.
    """
    cuda = torch.autograd.DeviceType.CUDA
    device, program = [], []
    lo, hi = np.inf, -np.inf
    for e in prof.events():
        s, t = float(e.time_range.start), float(e.time_range.end)
        lo, hi = min(lo, s), max(hi, t)
        if t <= s:
            continue
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                device.append((s, t))
        elif e.name in _names:
            program.append((e.name, s, t))
    if not np.isfinite(lo):
        return {"window_ms": 0.0, "idle_ms": 0.0, "by_span_ms": {}, "no_span_ms": 0.0}
    busy = _union(np.asarray(device, np.float64).reshape(-1, 2))
    edges = np.concatenate([[lo], busy.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    # Cut the window at every gap edge and span edge: each piece is idle or
    # busy throughout and lies under one innermost span.
    cuts = np.unique(np.concatenate([gaps.reshape(-1)] + [np.asarray([s, t]) for _, s, t in program]))
    cuts = cuts[(cuts >= lo) & (cuts <= hi)]
    width = np.diff(cuts)
    mid = (cuts[:-1] + cuts[1:]) / 2
    idle = np.zeros(len(mid), bool)
    if len(gaps):
        g = np.searchsorted(gaps[:, 0], mid, side="right") - 1
        idle = (g >= 0) & (mid < gaps[np.maximum(g, 0), 1])
    owner = np.full(len(mid), -1)
    for i in sorted(range(len(program)), key=lambda i: program[i][1] - program[i][2]):  # longest first
        a, b = np.searchsorted(mid, program[i][1:])
        owner[a:b] = i
    named = idle & (owner >= 0)
    per_span = np.bincount(owner[named], weights=width[named], minlength=len(program))
    by_span: dict[str, float] = {}
    for (name, _, _), us in zip(program, per_span):
        if us > 0:
            by_span[name] = by_span.get(name, 0.0) + float(us) / 1e3
    return {
        "window_ms": (hi - lo) / 1e3,
        "idle_ms": float(width[idle].sum()) / 1e3,
        "by_span_ms": dict(sorted(by_span.items(), key=lambda kv: -kv[1])),
        "no_span_ms": float(width[idle & (owner < 0)].sum()) / 1e3,
    }
