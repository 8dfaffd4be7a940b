"""CUDA graphs: the port's counterpart of what `jax.jit` gives the reference.

The reference compiles its step and its serving forward into one XLA
executable each and dispatches it once a step or a request. On the card the
counterpart is a CUDA graph: the kernels of one call of the eager code are
recorded once and replayed with one launch. This module does the four things
the compiled entry points (`train.compile_fused_step`,
`train.compile_train_fns`, the per-bucket graphs of `serve.Predictor`)
share:

- `warm_up` runs a call on a side stream before capture, so that every
  first-use cost (the kernel library's build and its shared-memory opt-in,
  cuBLAS and cuDNN handles, NCCL communicators, lazily built optimizer state)
  is paid outside the capture;
- `capture` records one call on that stream into a memory pool, which
  several graphs may share (`torch.cuda.graph_pool_handle`) when they are
  replayed one at a time and each caller copies its outputs out before the
  next replay, as the Predictor's buckets are;
- `Graph.replay` launches the recorded call;
- the kernel launch counters (`ops/kernels/_build.py`) stay the launches
  the card ran: a capture's own counts are taken back and each replay adds
  them (`record_launches`, `Graph.replay`).

A capture records device work only: a call whose host code copies a host
value to the card, reads a device value on the host or synchronises fails
to capture, and the failure raises. Nothing here falls back to eager. The
check is the capturing thread's own (`capture_error_mode="thread_local"`):
another thread may go on with its CUDA work on its own stream meanwhile, as
`data/dataset.prefetch_to_device` pins and copies the next batch while a
disk step or an evaluation batch is captured.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterable, Optional

import torch

from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build

# One side stream per device: warm-ups and captures run there, so the state
# that CUDA libraries keep per stream is made once, by the warm-up.
_streams: dict[int, torch.cuda.Stream] = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    if index not in _streams:
        _streams[index] = torch.cuda.Stream(device=index)
    return _streams[index]


@contextlib.contextmanager
def _on(stream: torch.cuda.Stream):
    """Run the block on `stream`, ordered after and before the current one."""
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.stream(stream):
        yield
    torch.cuda.current_stream(stream.device).wait_stream(stream)


def warm_up(fn: Callable, device: torch.device):
    """Run `fn` once on the device's side stream and return its result: a
    real call (a training step) is its own warm-up."""
    with _on(side_stream(device)):
        return fn()


@contextlib.contextmanager
def record_launches(record: dict):
    """Fill `record` with the kernel launches the wrappers count inside the
    block, and take them back out of the global counts: a capture launches
    nothing on the card."""
    before = _build.counts()
    try:
        yield record
    finally:
        after = _build.counts()
        record.update({k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)})
        _build.set_counts(before)


class Graph:
    """A captured call: the graph, its static `outputs` (overwritten by
    every replay), the kernel launches of one replay, the capture's host
    seconds and the bytes it reserved for the pool."""

    def __init__(self, graph, outputs, launches: dict, seconds: float, pool_bytes: int):
        self.graph = graph
        self.outputs = outputs
        self.launches = dict(launches)
        self.seconds = seconds
        self.pool_bytes = pool_bytes

    def replay(self):
        """Launch the recorded call; returns the static outputs (clone what
        must outlive the next replay)."""
        self.graph.replay()
        for name, n in self.launches.items():
            _build.count(name, n)
        return self.outputs


def capture(
    fn: Callable,
    device: torch.device,
    pool=None,
    generators: Iterable[torch.Generator] = (),
) -> Graph:
    """Capture one call of `fn` (warmed up already, see `warm_up`) on the
    device's side stream into `pool` (None: a pool of the graph's own). Each
    generator in `generators` is registered with the graph: its draws in the
    call read the generator's seed and offset at each replay, so a caller
    that reseeds it before a replay gets the draws of an eager call from
    that seed. The call's host code runs once, now; a failed capture
    raises."""
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    t0 = time.perf_counter()
    launches: dict = {}
    with record_launches(launches):
        with torch.cuda.graph(graph, pool=pool, stream=side_stream(device), capture_error_mode="thread_local"):
            outputs = fn()
    torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return Graph(graph, outputs, launches, seconds, torch.cuda.memory_reserved(device) - reserved)


def same_tensors(a: Optional[list], b: list) -> bool:
    """Whether two lists hold the same tensor objects, in order: the test a
    compiled call makes before it replays, since a graph reads and writes
    the memory of the tensors it was captured with."""
    return a is not None and len(a) == len(b) and all(x is y for x, y in zip(a, b))
