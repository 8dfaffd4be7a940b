"""PyTorch port, metrics writers and debugging (`utils/metrics.py`,
`utils/debug.py`): the TensorBoard encoding byte for byte against the
reference's, CRC32C against known vectors, `MetricsWriter`'s JSONL and
event files (read back, every record's CRCs checked) with one host transfer
a write, the train CLI's --metrics/--tensorboard/--profile/--debug-nans, and
the NaN checks.
"""

import json
import os
import struct

import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.utils import metrics as jmetrics
from indirect_learning_pose_shape_tpu_torch import train
from indirect_learning_pose_shape_tpu_torch.utils import debug, metrics


def _records(path):
    """The TFRecord frames of an event file, each frame's two CRCs checked."""
    with open(path, "rb") as f:
        return _frames(f.read())


def _frames(data):
    out, i = [], 0
    while i < len(data):
        header = data[i : i + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[i + 8 : i + 12])[0] == metrics._masked_crc(header)
        payload = data[i + 12 : i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n : i + 16 + n])[0] == metrics._masked_crc(payload)
        out.append(payload)
        i += 16 + n
    return out


@pytest.mark.parametrize("data, crc", [
    (b"", 0x00000000), (b"123456789", 0xE3069283), (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43),
])
def test_crc32c_known_vectors(data, crc):
    """CRC-32C (Castagnoli): the check value of "123456789" and the RFC 3720
    test vectors, as the reference computes them."""
    assert metrics._crc32c(data) == crc == jmetrics._crc32c(data)


@pytest.mark.parametrize("kw", [
    dict(wall_time=1.5e9, file_version="brain.Event:2"),
    dict(wall_time=1.7e9 + 0.25, step=1, scalars={"total": 3.25}),
    dict(wall_time=12.0, step=300, scalars={"sil_bce": 0.6931, "kp": 1e-3, "hard_overflow": 0.0}),
    dict(wall_time=0.0, step=2**40, scalars={"x": float("nan"), "y": -np.float32(2.5)}),
])
def test_event_bytes_match_reference(kw):
    got = metrics._tfrecord(metrics._event(**kw))
    assert got == jmetrics._tfrecord(jmetrics._event(**kw))
    assert len(_frames(got)) == 1


def test_metrics_writer_tees_jsonl_and_tensorboard(tmp_path, capsys, monkeypatch):
    """Each write is one JSONL line {"step", "wall_dt", terms} and one event
    record; the scalars reach the host in one `tolist` (no per-key float);
    a console line every print_every steps."""
    calls = {"tolist": 0, "float": 0}
    tolist, to_float = torch.Tensor.tolist, torch.Tensor.__float__

    def counting_tolist(t):
        calls["tolist"] += 1
        return tolist(t)

    def counting_float(t):
        calls["float"] += 1
        return to_float(t)

    monkeypatch.setattr(torch.Tensor, "tolist", counting_tolist)
    monkeypatch.setattr(torch.Tensor, "__float__", counting_float)
    w = metrics.MetricsWriter(str(tmp_path / "m.jsonl"), print_every=2, tensorboard_dir=str(tmp_path / "tb"))
    for step in range(3):
        got = w.write(step, {"total": torch.tensor(1.0 + step), "kp": torch.tensor(0.5)})
        assert got == {"total": 1.0 + step, "kp": 0.5}
    w.close()
    assert calls == {"tolist": 3, "float": 0}
    lines = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1, 2]
    assert set(lines[0]) == {"step", "wall_dt", "total", "kp"} and lines[2]["total"] == 3.0
    (event_file,) = os.listdir(tmp_path / "tb")
    records = _records(tmp_path / "tb" / event_file)
    assert len(records) == 4  # the file version, then one a write
    assert records[2] == jmetrics._event(struct.unpack("<d", records[2][1:9])[0], 1, {"total": 2.0, "kp": 0.5})
    out = capsys.readouterr().out
    assert "step 0: total=1 kp=0.5" in out and "step 2: total=3" in out and "step 1:" not in out


def test_train_cli_writes_metrics_trace_and_checks_nans(tmp_path, capsys):
    """--metrics and --tensorboard get one record per logged step, --profile
    a Chrome trace, and --debug-nans turns on anomaly mode for the run."""
    argv = ["--preset", "config4_full", "--steps", "2", "--batch-size", "1", "--image-size", "32",
            "--log-every", "1", "--device", "cpu", "--metrics", str(tmp_path / "m.jsonl"),
            "--tensorboard", str(tmp_path / "tb"), "--profile", str(tmp_path / "trace"), "--debug-nans"]
    try:
        assert train.main(argv) == 0
        assert torch.is_anomaly_enabled()
    finally:
        debug.enable_nan_checks(False)
    lines = [json.loads(x) for x in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [0, 1] and all(np.isfinite(r["total"]) for r in lines)
    (event_file,) = os.listdir(tmp_path / "tb")
    assert len(_records(tmp_path / "tb" / event_file)) == 3
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert trace["traceEvents"]
    printed = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [{k: v for k, v in r.items() if k != "wall_dt"} for r in lines] == printed


def test_checked_and_assert_finite_raise_on_nan():
    good = debug.checked(lambda x: {"y": x * 2, "n": 3})
    assert torch.equal(good(torch.ones(2))["y"], torch.full((2,), 2.0))
    bad = debug.checked(lambda x: (x, x / 0.0 * 0.0))
    with pytest.raises(FloatingPointError, match=r"\[1\]"):
        bad(torch.ones(2))
    state = {"encoder": {"w": torch.ones(3)}, "ief": [torch.zeros(2), torch.tensor([1.0, float("inf")])]}
    with pytest.raises(FloatingPointError, match=r"state\['ief'\]\[1\]"):
        debug.assert_finite(state, "state")
    debug.assert_finite({"ok": torch.ones(2), "ints": torch.arange(3)}, "ok")
    try:
        debug.enable_nan_checks()
        assert torch.is_anomaly_enabled()
    finally:
        debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
