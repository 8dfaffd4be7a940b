"""The readers of the port's spans and counters (`utils/tracing.py`), on
fabricated span records: each reads its number from the profiled stretch
(the last `units` steps or requests, and the logs and silhouettes among
them), and reads nothing, without raising, from a program without the
tracer or without spans."""

import sys

import pytest

from indirect_learning_pose_shape_tpu_torch import utils
from indirect_learning_pose_shape_tpu_torch.utils import tracing
from portbench.spec import Spec

TRAIN = ("step_host_ms.train", "log_host_ms.train")
SERVE = ("upload_ms_p50.interactive", "request_host_ms_p50.interactive",
         "silhouette_host_ms_p50.interactive", "padded_share.interactive", "upload_ms.bulk")


class _Record:
    """Spans laid end to end from t = 0 ms, each root's children inside it."""

    def __init__(self):
        self.spans, self.t = [], 0.0

    def root(self, name, children=(), counts=None, ms=1.0):
        rid = len(self.spans) + 1
        start = self.t
        self.spans.append(None)
        for child, child_ms in children:
            self.spans.append({"id": len(self.spans) + 1, "name": child, "parent": rid, "unit": rid,
                               "start": self.t, "end": self.t + child_ms, "counts": None})
            self.t += child_ms
        self.t += ms
        self.spans[rid - 1] = {"id": rid, "name": name, "parent": None, "unit": rid, "start": start,
                               "end": self.t, "counts": counts}


def _read(monkeypatch, metric, record, units):
    monkeypatch.setattr(tracing, "spans", lambda: list(record.spans))
    return Spec(_cell(metric)).reader(metric).read({"summary": {"units": units}})


def _cell(metric):
    return {"train": "train.config4_full.soft_b32", "interactive": "serve.config4_full.interactive",
            "bulk": "serve.config4_full.bulk128"}[metric.split(".")[-1]]


def test_the_training_readers_read_the_stretch(monkeypatch):
    r = _Record()
    r.root("train.step", [("train.capture", 50.0)])  # the warm-up profile's step: not in the stretch
    for i in range(2):
        r.root("train.step", [("train.reseed", 0.5), ("train.stale_check", 0.25), ("graph.replay", 2.0),
                              ("train.advance", 0.25)], ms=0.5)
    r.root("train.log", [("train.log.readback", 3.0)], ms=1.0)
    assert _read(monkeypatch, "step_host_ms.train", r, 2) == pytest.approx(1.5)
    assert _read(monkeypatch, "log_host_ms.train", r, 2) == pytest.approx(0.5)
    assert _read(monkeypatch, "step_host_ms.train", r, 3) == pytest.approx((51.0 + 3.0) / 3)


def test_the_serving_readers_read_the_stretch(monkeypatch):
    r = _Record()
    r.root("serve.request", [("serve.upload", 9.0), ("graph.replay", 9.0)])  # before the stretch
    for n, b, upload in ((1, 1, 0.1), (3, 4, 0.3), (2, 2, 0.2)):
        r.root("serve.request", [("serve.upload", upload), ("serve.stage", 0.05), ("graph.replay", 0.4),
                                 ("serve.clone", 0.05)],
               counts={"serve.requests": 1, "serve.rows": n, "serve.padded_rows": b - n}, ms=0.1)
        r.root("serve.silhouette", [("silhouette.project", 0.1), ("silhouette.raster", 0.2)], ms=0.0)
    assert _read(monkeypatch, "upload_ms_p50.interactive", r, 3) == pytest.approx(0.2)
    assert _read(monkeypatch, "request_host_ms_p50.interactive", r, 3) == pytest.approx(0.2)
    assert _read(monkeypatch, "silhouette_host_ms_p50.interactive", r, 3) == pytest.approx(0.3)
    assert _read(monkeypatch, "padded_share.interactive", r, 3) == pytest.approx(100.0 / 7)
    assert _read(monkeypatch, "upload_ms.bulk", r, 3) == pytest.approx(0.2)
    assert _read(monkeypatch, "upload_ms.bulk", r, 4) == pytest.approx((9.0 + 0.6) / 4)


@pytest.mark.parametrize("metric", TRAIN + SERVE)
def test_a_reader_finds_nothing_without_spans_or_without_the_tracer(monkeypatch, metric):
    """No spans, or a program without `utils/tracing.py` (its parent
    commit's): the reader returns None."""
    assert _read(monkeypatch, metric, _Record(), 10) is None
    r = _Record()
    for root in ("train.step", "serve.request", "serve.silhouette") * 2:
        r.root(root, [("graph.replay", 1.0), ("serve.upload", 1.0)], counts={"serve.rows": 1})
    assert _read(monkeypatch, metric, r, 2) is not None
    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "indirect_learning_pose_shape_tpu_torch.utils.tracing", None)
    assert Spec(_cell(metric)).reader(metric).read({"summary": {"units": 2}}) is None
