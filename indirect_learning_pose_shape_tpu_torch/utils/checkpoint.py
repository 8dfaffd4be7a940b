"""Checkpoint and resume (port of utils/checkpoint.py, without orbax).

A checkpoint is one directory per step, `<directory>/<step>/`, holding one
`torch.save` of a dict of tensors and plain values (what `train.state_dict`
builds: the model's state_dict, the optimizer's and the schedule's, the
step, the stream's seed and the EMA). The file is written under a temporary
name and renamed into place, so a crash never leaves a half-written step
that `latest_step` would pick. Loading uses `weights_only=True` and a
`map_location`, so a checkpoint written on the card loads on the CPU.

`save` snapshots the state to host memory on the caller's thread (training
may then change the live tensors) and writes the file on a background
thread; `save(..., wait=True)`, the next `save` and `close` wait for it.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Iterable, Optional

import torch

_FILE = "state.pt"


def _snapshot(obj):
    """`obj` with every tensor copied to host memory (a copy on the CPU too)."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return obj


class Checkpointer:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, _FILE))
        )

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def _write(self, step: int, state: dict) -> None:
        try:
            step_dir = os.path.join(self.directory, str(step))
            os.makedirs(step_dir, exist_ok=True)
            tmp = os.path.join(step_dir, f".{_FILE}.tmp")
            torch.save(state, tmp)
            os.replace(tmp, os.path.join(step_dir, _FILE))
            for old in self._steps()[: -self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)))
        except Exception as e:  # re-raised on the caller's thread by wait()
            self._error = e

    def wait(self) -> None:
        """Block until the last save is on disk; raise its error if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def save(self, step: int, state: dict, wait: bool = False) -> None:
        self.wait()
        snapshot = _snapshot(state)
        self._writer = threading.Thread(target=self._write, args=(step, snapshot))
        self._writer.start()
        if wait:
            self.wait()

    def restore(self, step: Optional[int] = None, map_location: Any = "cpu") -> dict:
        """The saved dict of `step` (default: the latest), its tensors on
        `map_location`."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        path = os.path.join(self.directory, str(step), _FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint of step {step} in {self.directory}")
        return torch.load(path, map_location=map_location, weights_only=True)

    def restore_partial(
        self, keys: Iterable[str], step: Optional[int] = None, map_location: Any = "cpu"
    ) -> dict:
        """Only `keys` of the saved dict (evaluation takes "model" and "ema",
        so it does not depend on how the run's optimizer was built)."""
        full = self.restore(step, map_location)
        missing = [k for k in keys if k not in full]
        if missing:
            raise KeyError(f"checkpoint lacks keys {missing}")
        return {k: full[k] for k in keys}

    def close(self) -> None:
        self.wait()
