"""CUDA graphs: the port's counterpart of what `jax.jit` gives the reference.

The reference compiles its step and its serving forward into one XLA
executable each and dispatches it once a step or a request. On the card the
counterpart is a CUDA graph: the kernels of one call of the eager code are
recorded once and replayed with one launch. `CapturedCall` owns such a call
from its first call to its replays, for every compiled entry point
(`train.compile_fused_step`, `train.compile_train_fns`,
`train.compile_data_step`, the evaluators' cached graphs, the per-bucket
graphs of `serve.Predictor`), and `eager_reason` says for each of them, and
for `train.fit`, whether a call runs as a graph or eagerly. Underneath:

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
  them (`record_launches`, `Graph.replay`);
- a capture is the span `graph.capture` and counts `graph.captures`, a
  replay the span `graph.replay` (the host's launch of the graph) and
  counts `graph.replays` (`utils/tracing.py`).

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
from typing import Any, Callable, Iterable, Optional

import torch

from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build
from indirect_learning_pose_shape_tpu_torch.utils import tracing

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
        with tracing.span("graph.replay"):
            self.graph.replay()
        tracing.count("graph.replays")
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
    with tracing.span("graph.capture"):
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
    tracing.count("graph.captures")
    return Graph(graph, outputs, launches, seconds, torch.cuda.memory_reserved(device) - reserved)


def same_tensors(a: Optional[list], b: list) -> bool:
    """Whether two lists hold the same tensor objects, in order: the test a
    compiled call makes before it replays, since a graph reads and writes
    the memory of the tensors it was captured with."""
    return a is not None and len(a) == len(b) and all(x is y for x, y in zip(a, b))


def eager_reason(device: torch.device, mesh=None, anomaly: bool = False, refuse: tuple = ()) -> Optional[str]:
    """Graph or eager: None where a call on `device` (under `mesh`) runs as
    a CUDA graph, else why it runs eagerly, in the words of `train.fit`'s
    first log line: on the CPU; under a mesh whose collectives run on the
    host (gloo), which a graph cannot record; with `anomaly` set (fit under
    `--debug-nans`), which checks every op on the host as it runs. A
    compiled entry point that promises a graph names itself and its eager
    step in `refuse`: a host mesh then raises ValueError, on any device."""
    host_mesh = mesh is not None and mesh.backend != "nccl"
    if host_mesh and refuse:
        name, eager = refuse
        raise ValueError(
            f"{name} captures the step as a CUDA graph, which cannot record the "
            f"{mesh.backend} backend's host collectives: run the eager {eager} "
            "(the train.fit_* loops do on such a mesh), or an NCCL mesh"
        )
    if torch.device(device).type != "cuda":
        return "CPU"
    if host_mesh:
        return f"{mesh.backend} mesh: host collectives"
    if anomaly:
        return "anomaly mode, --debug-nans"
    return None


class CapturedCall:
    """A call of `fn(inputs, *args)` as a CUDA graph on `device`, from its
    first call to its replays.

    - Staged inputs: `stage(batch)` copies a dict of tensors into static
      buffers (`inputs`) on the current stream, so the copies follow
      whatever that stream waits on (the prefetcher's copy event); buffers
      of other keys, shapes or dtypes are made anew and the graph dropped.
      A call that stages nothing gets `inputs` None.
    - Staleness: the call is captured again when `bound(*args)`, the
      tensors the graph reads or writes in place that a caller could
      replace, are not the ones it was captured with (`same_tensors`); the
      list is held meanwhile, so their memory is not reused.
    - Generators: each of `generators` is registered with the graph; the
      caller reseeds them before each call.
    - The first call (`record`) runs `fn` eagerly on the side stream as the
      warm-up and returns its result; the capture follows. `captures`
      counts them, and `graph` (its `seconds`, `pool_bytes`) is the last.
    - `pool`: a memory pool shared with other graphs (None: its own).

    Calling it runs `policy(self, *args)`, the caller's own work around the
    graph (reseeds, spans, the host's part of a step), or without one,
    `record(*args)` when `stale(*args)`, else a replay.

    `fn`, `bound` and `policy` must not hold what holds the call: a graph
    in a reference cycle is freed by the cyclic collector, which may run in
    the middle of another capture, and freeing a graph there breaks it."""

    def __init__(
        self,
        fn: Callable,
        device: torch.device,
        generators: Iterable[torch.Generator] = (),
        bound: Optional[Callable[..., list]] = None,
        pool=None,
        policy: Optional[Callable] = None,
    ):
        self.fn, self.device, self.generators = fn, device, tuple(generators)
        self.bound, self.pool, self.policy = bound, pool, policy
        self.inputs: Optional[dict[str, torch.Tensor]] = None
        self.graph: Optional[Graph] = None
        self.captures = 0
        self._held: Optional[list] = None

    def stage(self, batch: dict[str, torch.Tensor]) -> None:
        """Copy `batch` into the static input buffers (see the class)."""
        buffers = self.inputs
        if buffers is None or buffers.keys() != batch.keys() or any(
            v.shape != buffers[k].shape or v.dtype != buffers[k].dtype for k, v in batch.items()
        ):
            self.inputs = buffers = {k: torch.empty_like(v, device=self.device) for k, v in batch.items()}
            self.graph = None
        for k, v in batch.items():
            buffers[k].copy_(v)

    def stale(self, *args) -> bool:
        """Whether the next call must capture: no graph yet (or its inputs
        were made anew), or bound tensors replaced since its capture."""
        return self.graph is None or (
            self.bound is not None and not same_tensors(self._held, self.bound(*args))
        )

    def record(self, *args, between: Optional[Callable[[], None]] = None) -> Any:
        """The warm-up call, eager on the side stream, then `between()`,
        then the capture of the same call; returns the warm-up's result."""
        def run():
            return self.fn(self.inputs, *args)

        outputs = warm_up(run, self.device)
        if between is not None:
            between()
        self.graph = capture(run, self.device, self.pool, self.generators)
        self.captures += 1
        self._held = None if self.bound is None else self.bound(*args)
        return outputs

    def __call__(self, *args, **kwargs):
        if self.policy is not None:
            return self.policy(self, *args, **kwargs)
        return self.record(*args) if self.stale(*args) else self.graph.replay()
