"""PyTorch port, the tracer (`utils/tracing.py`): spans record only under a
profiler and lie in its trace, nested by parent and unit; counters always
count, the kernel launch counts among them under their old interface; the
reading functions on hand-made records and synthetic profiler events; the
spans of a CPU request, step and log write.

The graph routes' spans are checked on the card by
`test_graph_routes_emit_spans_on_the_card`, which skips without one:

    python -m pytest tests/test_torch_tracing.py -q -p no:cacheprovider --noconftest
"""

import copy
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from indirect_learning_pose_shape_tpu_torch import configs, predict, serve, train
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build
from indirect_learning_pose_shape_tpu_torch.utils import assets, graphs, metrics, tracing

SIZE = 32


@pytest.fixture(scope="module")
def asset():
    return assets.synthetic_asset(num_verts=864, seed=1)


@pytest.fixture(scope="module")
def tiny(asset):
    """A small training configuration and its model and constants on the
    CPU (each test takes a copy of the model)."""
    cfg = _cfg()
    model, consts = net.init(asset, cfg.model, seed=3, device="cpu")
    return cfg, model, consts


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _cfg():
    model = net.ModelConfig(
        image_size=SIZE,
        encoder=enc.EncoderConfig(depth=18, width=16, compute_dtype=torch.float32),
        ief=ief.IEFConfig(hidden_dims=(32,)),
        raster=raster.RasterConfig(image_size=SIZE, num_parts=24),
    )
    return configs.TrainConfig(model=model, batch_size=2, log_every=1)


def _profiled():
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    return profile(activities=acts)


def _clear():
    tracing._records.clear()


def _rec(id, name, parent, unit, start, end, counts=None):
    return {"id": id, "name": name, "parent": parent, "unit": unit, "start": start, "end": end,
            "counts": counts}


def test_without_a_profiler_nothing_is_recorded_and_counters_count():
    _clear()
    tracing.reset_counts()
    assert tracing.span("train.step") is tracing.OFF
    with tracing.span("train.step"), tracing.span("graph.replay"):
        tracing.count("graph.replays")
        tracing.count("serve.rows", 3)
    assert tracing.spans() == []
    assert tracing.counters() == {"graph.replays": 1, "serve.rows": 3}
    assert tracing.counters("serve.") == {"rows": 3}
    tracing.reset_counts()


def test_spans_nest_by_parent_and_unit_and_lie_in_the_profile():
    _clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("serve.request", root=True):
            with tracing.span("serve.upload"):
                torch.ones(4).sum()
            with tracing.span("graph.replay"):
                tracing.count("serve.rows", 2)
        with tracing.span("serve.silhouette", root=True):
            with tracing.span("silhouette.raster"):
                pass
    got = {s["name"]: s for s in tracing.spans()}
    req, sil = got["serve.request"], got["serve.silhouette"]
    assert req["parent"] is None and req["unit"] == req["id"]
    assert sil["parent"] is None and sil["unit"] == sil["id"] != req["unit"]
    for child in ("serve.upload", "graph.replay"):
        assert got[child]["parent"] == req["id"] and got[child]["unit"] == req["id"]
        assert req["start"] <= got[child]["start"] <= got[child]["end"] <= req["end"]
    assert got["silhouette.raster"]["unit"] == sil["id"]
    assert got["graph.replay"]["counts"] == {"serve.rows": 2} and req["counts"] is None
    events = {e.name: e for e in prof.events() if e.name in got}
    assert set(events) == set(got)
    outer = events["serve.request"].time_range
    for child in ("serve.upload", "graph.replay"):
        inner = events[child].time_range
        assert outer.start <= inner.start <= inner.end <= outer.end
    _clear()


def test_a_root_opens_its_unit_wherever_it_is_called():
    """The unit comes from `root=True` at the call, not from the name: a
    root under another root opens its own unit, a span under none has none."""
    _clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("graph.capture"):
            pass
        with tracing.span("train.step", root=True):
            with tracing.span("train.log", root=True):
                with tracing.span("train.log.readback"):
                    pass
        with tracing.span("train.step"):
            pass
    cap, step, log, back, plain = tracing.spans()
    assert cap["unit"] is None and plain["unit"] is None
    assert step["unit"] == step["id"] and log["unit"] == log["id"] and log["parent"] == step["id"]
    assert back["unit"] == log["id"]
    assert [s["id"] for s in tracing.last_units("train.step", 1)] == [step["id"], log["id"], back["id"]]
    _clear()


def test_reading_functions_on_a_hand_made_record():
    recs = [
        _rec(1, "train.step", None, 1, 0.0, 10.0),
        _rec(2, "graph.replay", 1, 1, 1.0, 4.0),
        _rec(3, "train.advance", 1, 1, 4.0, 5.0),
        _rec(4, "train.step", None, 4, 10.0, 18.0),
        _rec(5, "graph.replay", 4, 4, 11.0, 13.0),
        _rec(6, "train.log", None, 6, 18.0, 21.0),
        _rec(7, "train.log.readback", 6, 6, 18.5, 20.5, {"x": 2}),
        _rec(8, "train.step", None, 8, 21.0, 30.0),
        _rec(9, "graph.capture", None, None, 40.0, 41.0),
    ]
    own = tracing.self_ms(recs)
    assert own[1] == 6.0 and own[6] == 1.0 and own[2] == 3.0
    assert tracing.self_ms(recs[:2])[1] == 7.0
    last = tracing.last_units("train.step", 2, recs)
    assert [s["id"] for s in last] == [4, 5, 6, 7, 8]
    assert tracing.last_units("train.step", 0, recs) == [] == tracing.last_units("serve.request", 3, recs)
    assert len(tracing.last_units("train.step", 5, recs)) == 8
    steps = tracing.units(last, "train.step")
    assert steps == [{"ms": {"train.step": 8.0, "graph.replay": 2.0}, "counts": {}},
                     {"ms": {"train.step": 9.0}, "counts": {}}]
    assert tracing.units(last, "train.log") == [{"ms": {"train.log": 3.0, "train.log.readback": 2.0},
                                                  "counts": {"x": 2}}]
    s = tracing.summary(recs)["spans"]
    assert s["train.step"] == {"count": 3, "total_ms": 27.0, "self_ms": 21.0}
    assert s["graph.replay"] == {"count": 2, "total_ms": 5.0, "self_ms": 5.0}
    assert s["train.log"] == {"count": 1, "total_ms": 3.0, "self_ms": 1.0}
    assert s["graph.capture"]["count"] == 1


def test_idle_by_span_on_synthetic_events(monkeypatch):
    """Device busy 10-20 and 30-35 us in a 0-50 window: idle 0-10 (under
    train.reseed 0-5, then train.step), 20-30 (under graph.replay to 25,
    then nothing) and 35-50 (train.log to 45)."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA

    def ev(name, s, e, dev=cpu, ann=False):
        return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=s, end=e),
                                     device_type=dev, is_user_annotation=ann)

    events = [ev("train.step", 0, 25), ev("train.reseed", 0, 5), ev("graph.replay", 18, 25),
              ev("aten::copy_", 21, 22), ev("train.log", 35, 45), ev("outside", 45, 50),
              ev("kernel", 10, 20, cuda), ev("memcpy", 30, 33, cuda), ev("kernel", 32, 35, cuda),
              ev("graph.replay", 0, 50, cuda, ann=True)]
    prof = types.SimpleNamespace(events=lambda: events)
    monkeypatch.setattr(tracing, "_names", {"train.step", "train.reseed", "graph.replay", "train.log"})
    got = tracing.idle_by_span(prof)
    assert got["window_ms"] == pytest.approx(0.050)
    assert got["idle_ms"] == pytest.approx(0.035)
    assert got["by_span_ms"] == pytest.approx({"train.reseed": 0.005, "train.step": 0.005,
                                               "graph.replay": 0.005, "train.log": 0.010})
    assert got["no_span_ms"] == pytest.approx(0.010)
    empty = tracing.idle_by_span(types.SimpleNamespace(events=lambda: []))
    assert empty["idle_ms"] == 0.0 and empty["by_span_ms"] == {}
    busy = tracing.idle_by_span(types.SimpleNamespace(events=lambda: events[:1] + events[6:7]))
    assert busy["window_ms"] == pytest.approx(0.025) and busy["idle_ms"] == pytest.approx(0.015)
    full = tracing.idle_by_span(types.SimpleNamespace(events=lambda: [ev("kernel", 0, 9, cuda)]))
    assert full["window_ms"] == pytest.approx(0.009) and full["idle_ms"] == 0.0


def test_a_cpu_request_counts_its_rows_and_spans_its_upload(tiny):
    tcfg, model, consts = tiny
    cfg = tcfg.model
    p = serve.Predictor(cfg, copy.deepcopy(model), consts, buckets=(1, 2, 4))
    crops = np.random.RandomState(0).uniform(-1, 1, (3, SIZE, SIZE, 3)).astype(np.float32)
    _clear()
    before = tracing.counters("serve.")
    with _profiled():
        out = p(crops)
        predict.render_silhouette(out, consts, cfg)
    after = tracing.counters("serve.")
    moved = {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}
    assert moved == {"requests": 1, "rows": 3, "padded_rows": 1, "bucket.4": 1}
    got = {s["name"]: s for s in tracing.spans()}
    req = got["serve.request"]
    for child in ("serve.upload", "serve.stage", "serve.forward"):
        assert got[child]["parent"] == req["id"], child
    (unit,) = tracing.units(tracing.last_units("serve.request", 1), "serve.request")
    assert unit["counts"] == {"serve.requests": 1, "serve.rows": 3, "serve.padded_rows": 1, "serve.bucket.4": 1}
    sil = got["serve.silhouette"]
    assert sil["unit"] == sil["id"] and got["silhouette.raster"]["parent"] == sil["id"]
    _clear()


def test_the_cpu_step_and_the_log_write_emit_their_roots(tiny):
    cfg, model, consts = tiny
    ts = train.new_state(copy.deepcopy(model), cfg, seed=5)
    fn = train.compile_fused_step(cfg, consts)
    writer = metrics.MetricsWriter(print_every=0)
    _clear()
    with _profiled():
        terms = fn(ts)
        writer.write(ts.step - 1, terms)
    names = [s["name"] for s in tracing.spans()]
    assert names == ["train.step", "train.log", "train.log.readback"]
    (step,) = tracing.units(tracing.last_units("train.step", 1), "train.step")
    (log,) = tracing.units(tracing.last_units("train.step", 1), "train.log")
    assert set(log["ms"]) == {"train.log", "train.log.readback"} and step["ms"]["train.step"] > 0
    _clear()


def test_launch_counts_keep_their_interface_beside_other_counters():
    """`_build`'s launch counts are the registry's `launch.` counters: other
    counters never show in `counts()`, `set_counts` and `record_launches`
    leave them alone, and `reset_counts` clears the whole registry."""
    _build.reset_counts()
    tracing.count("graph.replays", 2)
    _build.count("lbs")
    assert _build.counts() == {"lbs": 1}
    assert tracing.counters() == {"graph.replays": 2, "launch.lbs": 1}
    record = {}
    with graphs.record_launches(record):
        _build.count("raster_fwd", 2)
        tracing.count("graph.captures")
    assert record == {"raster_fwd": 2} and _build.counts() == {"lbs": 1}
    assert tracing.counters() == {"graph.replays": 2, "graph.captures": 1, "launch.lbs": 1}
    _build.set_counts({"raster_bwd": 4})
    assert tracing.counters() == {"graph.replays": 2, "graph.captures": 1, "launch.raster_bwd": 4}
    _build.reset_counts()
    assert tracing.counters() == {} and _build.counts() == {}


@pytest.mark.card
def test_graph_routes_emit_spans_on_the_card(card, asset):
    """`compile_fused_step`'s captured call and the Predictor's bucket graphs: each step and each
    request holds its `graph.replay`, and nothing is captured after the
    warm-up."""
    cfg = _cfg()
    model, consts = net.init(asset, cfg.model, seed=3, device=card)
    ts = train.new_state(model, cfg, seed=5)
    fn = train.compile_fused_step(cfg, consts)
    assert isinstance(fn, graphs.CapturedCall)
    fn(ts)
    fn(ts)
    served, sconsts = net.init(asset, cfg.model, seed=4, device=card)
    p = serve.Predictor(cfg.model, served, sconsts, buckets=(1, 2, 4))
    p.warmup()
    captures = tracing.counters()["graph.captures"]
    rng = np.random.RandomState(0)
    _clear()
    with _profiled() as prof:
        for _ in range(3):
            fn(ts)
        for n in (1, 3, 4):
            p(rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32))
        torch.cuda.synchronize()
    assert tracing.counters()["graph.captures"] == captures
    steps = tracing.units(tracing.last_units("train.step", 3), "train.step")
    assert len(steps) == 3 and all(u["ms"].get("graph.replay", 0) > 0 for u in steps)
    assert all("train.capture" not in u["ms"] for u in steps)
    reqs = tracing.units(tracing.last_units("serve.request", 3), "serve.request")
    assert len(reqs) == 3 and all(u["ms"].get("graph.replay", 0) > 0 for u in reqs)
    assert [u["counts"]["serve.padded_rows"] for u in reqs] == [0, 1, 0]
    idle = tracing.idle_by_span(prof)
    assert 0 <= idle["idle_ms"] <= idle["window_ms"]
    assert sum(idle["by_span_ms"].values()) + idle["no_span_ms"] == pytest.approx(idle["idle_ms"])
    _clear()
