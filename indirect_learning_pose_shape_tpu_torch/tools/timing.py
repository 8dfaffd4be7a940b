"""Device time of a call on the card, warm and cold.

`device_ms` replays calls captured in a CUDA graph between CUDA events, so
the number holds no host work; `events_ms` times calls queued back to back
between CUDA events, for work a graph cannot capture; `ColdTimer` times a
call as the main path finds its inputs, evicted from the L2 by the work
before it. Used by `chip_smoke.py`, `tools/lbs_ablation.py` and
`tools/profile_train.py`.
"""

from __future__ import annotations

import statistics

import torch

# Written before each cold call: more than twice the H100's 50 MB L2.
FLUSH_BYTES = 128 << 20


def device_ms(fn, replays: int, reps: int = 5, calls: int = 1) -> float:
    """Device ms per call of `fn`: `calls` calls captured in a CUDA graph,
    the graph replayed `replays` times between CUDA events, median over
    `reps` such runs. A replay carries no host work (no wrapper, no launch),
    so this is the device time of everything `fn` launches. Each replay
    costs the host several microseconds, so a call shorter than that needs
    `calls` > 1 to be timed at all."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture, as CUDA graphs require
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(replays):
            graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / (replays * calls))
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def events_ms(fn, iters: int, reps: int = 3) -> float:
    """Device ms per call of `fn` between CUDA events, median over `reps`
    runs of `iters` calls, for work that cannot be captured in a graph (an
    autograd backward, eager code that copies from the host). The calls are
    queued back to back, so the host's launches hide behind device work of
    a millisecond or more."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


class ColdTimer:
    """Device ms per call of a function run after a write of `nbytes` that
    evicts its inputs from the L2, with the write's own time (`flush_ms`,
    measured alone at the same `replays` and `calls`) subtracted."""

    def __init__(self, nbytes: int = FLUSH_BYTES, replays: int = 20, calls: int = 1):
        self.nbytes, self.replays, self.calls = nbytes, replays, calls
        self.buf = torch.empty(nbytes // 4, device="cuda")
        self.flush_ms = device_ms(self.buf.zero_, replays, calls=calls)

    def warm_ms(self, fn) -> float:
        """The same call replayed back to back, its inputs left in the L2."""
        return device_ms(fn, self.replays, calls=self.calls)

    def cold_ms(self, fn) -> float:
        return device_ms(lambda: (self.buf.zero_(), fn()), self.replays, calls=self.calls) - self.flush_ms
