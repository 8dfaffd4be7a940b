"""Metrics writers and trace capture (port of utils/metrics.py).

Per-step scalars go to a JSONL file (`{"step", "wall_dt", term: value,
...}`, one line a write) and, optionally, to TensorBoard event files
written here without TensorBoard (a TFRecord stream of hand-encoded `Event`
protos), with a console line every `print_every` steps. A write is the
span `train.log`, its host transfer `train.log.readback`
(`utils/tracing.py`). `profile_trace` captures a `torch.profiler` Chrome
trace and the spans of the profiled block.
"""

from __future__ import annotations

import contextlib
import json
import os
import socket
import struct
import time
from typing import IO, Optional

import torch

from indirect_learning_pose_shape_tpu_torch.utils import tracing

# --- TensorBoard event-file encoding ----------------------------------------
# A TB scalar log is a TFRecord stream of serialized `Event` protos:
#   TFRecord frame: u64 len (LE) | u32 masked-crc32c(len bytes) | payload
#                   | u32 masked-crc32c(payload)
#   Event proto:    1: wall_time (double), 2: step (int64),
#                   3: file_version (string, first record only),
#                   5: summary { repeated 1: value { 1: tag (string),
#                                                    2: simple_value (float) } }

_CRC_TABLE = []


def _crc32c(data: bytes) -> int:
    if not _CRC_TABLE:
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint(num << 3 | wire)


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _event(wall_time: float, step: int = 0, scalars: Optional[dict] = None,
           file_version: Optional[str] = None) -> bytes:
    msg = _field(1, 1) + struct.pack("<d", wall_time)
    if step:
        msg += _field(2, 0) + _varint(step)
    if file_version is not None:
        msg += _len_field(3, file_version.encode())
    if scalars:
        summary = b"".join(
            _len_field(
                1,
                _len_field(1, tag.encode()) + _field(2, 5) + struct.pack("<f", float(v)),
            )
            for tag, v in scalars.items()
        )
        msg += _len_field(5, summary)
    return msg


def _tfrecord(payload: bytes) -> bytes:
    header = struct.pack("<Q", len(payload))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + payload
        + struct.pack("<I", _masked_crc(payload))
    )


class TensorBoardWriter:
    """Scalar event-file writer readable by TensorBoard."""

    _seq = 0  # uniquifier: two writers started in the same second stay apart

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        TensorBoardWriter._seq += 1
        self.path = os.path.join(
            logdir,
            f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}"
            f".{os.getpid()}.{TensorBoardWriter._seq}",
        )
        self._file: IO = open(self.path, "wb")
        self._file.write(_tfrecord(_event(time.time(), file_version="brain.Event:2")))

    def write(self, step: int, scalars: dict) -> None:
        self._file.write(_tfrecord(_event(time.time(), step, scalars)))
        self._file.flush()

    def close(self) -> None:
        self._file.close()


class MetricsWriter:
    """JSONL scalar writer with the wall time between writes (+ optional TB)."""

    def __init__(
        self,
        path: Optional[str] = None,
        print_every: int = 50,
        tensorboard_dir: Optional[str] = None,
    ):
        self._file: Optional[IO] = open(path, "a") if path else None
        self._tb = TensorBoardWriter(tensorboard_dir) if tensorboard_dir else None
        self._print_every = print_every
        self._last_time = time.perf_counter()

    def write(self, step: int, scalars: dict) -> dict[str, float]:
        """Record `scalars` (0-dim tensors on one device, or numbers) at
        `step`; returns them as floats. All values reach the host in one
        transfer (one `stack(...).tolist()`), not one synchronisation a key."""
        with tracing.span("train.log", root=True):
            return self._write(step, scalars)

    def _write(self, step: int, scalars: dict) -> dict[str, float]:
        names = list(scalars)
        with tracing.span("train.log.readback"):
            values = torch.stack(
                [torch.as_tensor(scalars[k], dtype=torch.float32).reshape(()) for k in names]
            ).tolist() if names else []
        floats = dict(zip(names, values))
        now = time.perf_counter()
        record = {"step": step, "wall_dt": now - self._last_time, **floats}
        self._last_time = now
        if self._file:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._tb:
            self._tb.write(step, floats)
        if self._print_every and step % self._print_every == 0:
            parts = " ".join(f"{k}={v:.4g}" for k, v in floats.items())
            print(f"step {step}: {parts} ({record['wall_dt'] * 1e3:.1f} ms)", flush=True)
        return floats

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()


@contextlib.contextmanager
def profile_trace(path: str):
    """Capture a `torch.profiler` trace of the block (host ops, the port's
    spans, and the card's kernels when there is one) into `path`/trace.json,
    a Chrome trace (chrome://tracing, Perfetto), and the block's spans into
    `path`/spans.json: `summary` (`tracing.summary` of the spans the block
    recorded, and the counters) and `idle_by_span` (the device's idle time
    by the innermost span over it)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    begin = time.perf_counter_ns() / 1e6
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(path, exist_ok=True)
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    recorded = [s for s in tracing.spans() if s["start"] >= begin]
    with open(os.path.join(path, "spans.json"), "w") as f:
        json.dump({"summary": tracing.summary(recorded), "idle_by_span": tracing.idle_by_span(prof)}, f, indent=1)
