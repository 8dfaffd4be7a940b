"""What a driver gets: the cell, the run's arguments and the set-up clock."""

from __future__ import annotations

import os
import time

import numpy as np


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc; 0 elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def sub_seed(seed: int, stream: int) -> int:
    """A seed for one of the run's inputs, independent of the others."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)[0] >> 1)


class Context:
    def __init__(self, spec, seed: int, seconds: float, trace: bool, device, started: float):
        self.spec = spec
        self.config, self.traffic, self.limits = spec.config, spec.traffic, spec.limits
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.started = started  # perf_counter() at process start
        self.setup: dict[str, float] = {}
        self._last = time.perf_counter()
        self.setup["process"] = self._last - started

    def phase(self, name: str) -> None:
        """Charge the time since the last phase to set-up phase `name`."""
        now = time.perf_counter()
        self.setup[name] = self.setup.get(name, 0.0) + now - self._last
        self._last = now

    def since_start(self) -> float:
        return time.perf_counter() - self.started
