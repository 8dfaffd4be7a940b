"""PyTorch port, the compiled paths on the CPU: `train.compile_fused_step`,
`train.compile_train_fns` and the `Predictor` run their eager functions on
CPU states and equal them bitwise; the constants hoisted out of the step
give the arrays they gave before; the optimizer's rate binding and the
checkpoint it writes are device-neutral; a gloo mesh is refused; `fit`
names its route; the graph helper's launch accounting on a stub graph.

The graph routes run here under a stub capture (`stub_graphs`: the CPU
taken for a card, each replay a rerun of the captured call): the
`graphs.CapturedCall` that every compiled path uses, and the compiled
steps and the Predictor on it, against their eager functions. The CUDA
graphs themselves are captured only on the card, where `chip_smoke.py`'s
graphs phase holds them to the eager step bitwise.
"""

import copy
import dataclasses
import gc
import types
import weakref

import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu_torch import configs, evaluate, serve, train
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.ops import raster, raster_hard
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build
from indirect_learning_pose_shape_tpu_torch.utils import graphs

SIZE, BATCH = 32, 2


def _cfg(**kw):
    model = net.ModelConfig(
        image_size=SIZE,
        encoder=enc.EncoderConfig(depth=18, width=16, compute_dtype=torch.float32),
        ief=ief.IEFConfig(hidden_dims=(32,)),
        raster=raster.RasterConfig(image_size=SIZE, num_parts=24),
    )
    base = dict(model=model, batch_size=BATCH, lr_schedule="cosine", warmup_steps=1, num_steps=8,
                grad_clip_norm=1.0, ema_decay=0.9)
    return configs.TrainConfig(**{**base, **kw})


def _state(asset, cfg):
    model, consts = net.init(asset, cfg.model, seed=3, device="cpu")
    return train.new_state(model, cfg, seed=5), consts


def _assert_same_state(a, b):
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    for k in a.ema:
        assert torch.equal(a.ema[k], b.ema[k]), k
    assert a.step == b.step
    assert a.scheduler is None or a.scheduler.get_last_lr() == b.scheduler.get_last_lr()


@pytest.fixture
def stub_graphs(monkeypatch):
    """The graph routes on the CPU: `graphs.eager_reason` decides as for a
    card, the warm-up runs in place, and a stub capture keeps the call,
    which each replay runs again eagerly on what it was captured with, as
    a CUDA graph's replay reruns its kernels on the tensors they were
    captured on. Returns the generators that each capture registered."""
    registered = []
    decide = graphs.eager_reason
    monkeypatch.setattr(graphs, "eager_reason", lambda device, *args, **kw: decide(torch.device("cuda"), *args, **kw))
    monkeypatch.setattr(graphs, "warm_up", lambda fn, device: fn())

    def capture(fn, device, pool=None, generators=()):
        registered.append(tuple(generators))
        g = graphs.Graph(None, None, {}, 0.0, 0)
        g.graph = types.SimpleNamespace(replay=lambda: setattr(g, "outputs", fn()))
        return g

    monkeypatch.setattr(graphs, "capture", capture)
    return registered


def _fused_steps_match(asset, per_call, **kw):
    """Three steps through `compile_fused_step`: calls of `steps_per_call`
    steps, then a one-step remainder (`fn(ts, 1)`, as `fit` calls it);
    terms and state bitwise the eager `fused_step`'s. Returns the compiled
    step and both states."""
    cfg = _cfg(steps_per_call=per_call, **kw)
    ts_c, consts = _state(asset, cfg)
    ts_e, _ = _state(asset, cfg)
    fn = train.compile_fused_step(cfg, consts)
    for _ in range(2 // per_call):
        got, want = fn(ts_c), train.fused_step(ts_e, consts, cfg)
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want)
    got = fn(ts_c, 1)
    want = train.fused_step(ts_e, consts, dataclasses.replace(cfg, steps_per_call=1))
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert ts_c.step == 3
    _assert_same_state(ts_c, ts_e)
    return fn, ts_c, ts_e, consts, cfg


@pytest.mark.parametrize("per_call", [1, 2])
def test_compile_fused_step_on_cpu_is_fused_step(tiny_asset, per_call):
    """On the CPU `compile_fused_step` is the eager `fused_step`, bitwise
    (`_fused_steps_match`)."""
    fn, *_ = _fused_steps_match(tiny_asset, per_call)
    assert not isinstance(fn, graphs.CapturedCall)


@pytest.mark.parametrize("per_call", [1, 2])
def test_the_graph_route_of_compile_fused_step_is_fused_step(tiny_asset, stub_graphs, per_call):
    """The graph route (a stub capture): the batch's generator registered
    and reseeded by (seed, step) before each step, `_advance` after each,
    the steps bitwise the eager `fused_step`'s in one capture; a loaded
    checkpoint (new optimizer state tensors) captures again, and the steps
    after it still match. A constant rate: on the CPU the schedule sets
    the rate as a new number each step (on the card it fills a tensor),
    which the stale check would take for a replaced tensor."""
    fn, ts_c, ts_e, consts, cfg = _fused_steps_match(tiny_asset, per_call, lr_schedule="constant")
    assert isinstance(fn, graphs.CapturedCall) and fn.captures == 1 and len(stub_graphs[0]) == 1
    train.load_state_dict(ts_c, copy.deepcopy(train.state_dict(ts_e)))
    got, want = fn(ts_c, 1), train.fused_step(ts_e, consts, dataclasses.replace(cfg, steps_per_call=1))
    assert fn.captures == 2 and all(torch.equal(got[k], want[k]) for k in want)
    got, want = fn(ts_c, 1), train.fused_step(ts_e, consts, dataclasses.replace(cfg, steps_per_call=1))
    assert fn.captures == 2 and all(torch.equal(got[k], want[k]) for k in want)
    _assert_same_state(ts_c, ts_e)


def _train_fns_match(asset, steps=2, **kw):
    """`gen_fn(seed, step)` is `make_batch`'s batch, and `step_fn` the
    eager `train_step`, bitwise. Returns `step_fn` and both states."""
    cfg = _cfg(**kw)
    ts_c, consts = _state(asset, cfg)
    ts_e, _ = _state(asset, cfg)
    gen_fn, step_fn = train.compile_train_fns(cfg, consts)
    for step in range(steps):
        batch = gen_fn(7, step)
        want_batch = train.make_batch(7, step, BATCH, consts, cfg)
        assert all(torch.equal(batch[k], want_batch[k]) for k in want_batch)
        got, want = step_fn(ts_c, batch), train.train_step(ts_e, want_batch, consts, cfg)
        assert all(torch.equal(got[k], want[k]) for k in want)
    _assert_same_state(ts_c, ts_e)
    return step_fn, ts_c, ts_e, consts, cfg


def test_compile_train_fns_on_cpu(tiny_asset):
    """On the CPU both are the eager functions (`_train_fns_match`)."""
    _train_fns_match(tiny_asset)


def test_the_graph_route_of_compile_train_fns_is_eager(tiny_asset, stub_graphs):
    """The graph route (a stub capture): three batches and steps bitwise
    the eager ones, `step_fn` in one capture; a batch of another layout
    captures again (a constant rate, as for `compile_fused_step`)."""
    step_fn, ts_c, ts_e, consts, cfg = _train_fns_match(tiny_asset, steps=3, lr_schedule="constant")
    assert step_fn.captures == 1 and len(stub_graphs) == 2
    batch = {k: v[:1] for k, v in train.make_batch(7, 3, BATCH, consts, cfg).items()}
    got, want = step_fn(ts_c, batch), train.train_step(ts_e, batch, consts, cfg)
    assert step_fn.captures == 2 and all(torch.equal(got[k], want[k]) for k in want)
    _assert_same_state(ts_c, ts_e)


def test_a_captured_call_stages_replays_and_captures_anew(stub_graphs):
    """`graphs.CapturedCall` (a stub capture): the first call returns the
    warm-up's result and captures once, its generator registered; a batch
    of the same layout is copied into the same static buffers and replays,
    with the draws of the seed set before it; a new layout makes new
    buffers and captures again; so does a replaced bound tensor."""
    gen = torch.Generator()
    runs = []

    def fn(inputs, weights):
        runs.append(inputs)
        return inputs["x"] * weights[0] + torch.rand((), generator=gen)

    def eager(x, w, seed):
        return x * w + torch.rand((), generator=torch.Generator().manual_seed(seed))

    w = [torch.tensor(2.0)]
    call = graphs.CapturedCall(fn, torch.device("cpu"), (gen,), bound=list)
    x = torch.arange(3.0)
    call.stage({"x": x})
    buf = call.inputs["x"]
    assert buf is not x and torch.equal(buf, x)
    gen.manual_seed(1)
    assert torch.equal(call(w), eager(x, 2.0, 1))
    assert call.captures == 1 and len(runs) == 1 and stub_graphs == [(gen,)]
    x.add_(1)  # the buffer holds a copy
    assert torch.equal(buf, x - 1)
    call.stage({"x": x})
    assert call.inputs["x"] is buf and torch.equal(buf, x)
    gen.manual_seed(2)
    assert torch.equal(call(w), eager(x, 2.0, 2)) and call.captures == 1
    call.stage({"x": torch.arange(4.0)})
    assert call.inputs["x"] is not buf and call.graph is None
    call(w)
    call(w)
    assert call.captures == 2
    w[0] = torch.tensor(3.0)
    gen.manual_seed(3)
    assert torch.equal(call(w), eager(torch.arange(4.0), 3.0, 3)) and call.captures == 3


def test_gloo_mesh_is_refused(tiny_asset):
    """gloo's collectives run on the host, which a CUDA graph cannot
    record: both compiled entry points refuse the mesh, naming the eager
    step, and `fit` routes it to the eager step."""
    cfg = _cfg()
    _, consts = _state(tiny_asset, cfg)
    gloo = types.SimpleNamespace(backend="gloo", world=2)
    for compile_fn in (train.compile_fused_step, train.compile_train_fns):
        with pytest.raises(ValueError, match="eager train.fused_step"):
            compile_fn(cfg, consts, gloo)
    reason = graphs.eager_reason(consts.smpl.v_template.device, gloo, torch.is_anomaly_enabled())
    assert train._fit_route("compile_fused_step", "fused_step", reason, gloo) == "eager fused_step (CPU)"


def test_fit_route(tiny_asset, capsys):
    """`fit` says its route in its first log line: the graph on the card
    (alone or on an NCCL mesh), the eager step on the CPU, on gloo and
    under anomaly mode."""
    card = torch.device("cuda", 0)

    def route(mesh):  # as `train._run` asks for the synthetic stream
        reason = graphs.eager_reason(card, mesh, torch.is_anomaly_enabled())
        return train._fit_route("compile_fused_step", "fused_step", reason, mesh)

    nccl = types.SimpleNamespace(backend="nccl", world=2)
    assert route(None).startswith("graph: compile_fused_step")
    assert route(nccl).endswith("(NCCL mesh of 2)")
    assert "gloo" in route(types.SimpleNamespace(backend="gloo", world=2))
    with torch.autograd.detect_anomaly(check_nan=False):
        assert "--debug-nans" in route(None)
    train.fit(_cfg(num_steps=1), asset=tiny_asset, device="cpu")
    assert "fit: eager fused_step (CPU)" in capsys.readouterr().err


def test_rate_binding_and_portable_checkpoint(tiny_asset):
    """On the CPU the rate stays a number and the optimizer not capturable;
    a checkpoint stores the rate as a number; a checkpoint as a card run
    writes it (capturable groups, a rate tensor) loads on the CPU and
    resumes bitwise."""
    cfg = _cfg()
    ts, consts = _state(tiny_asset, cfg)
    group = ts.optimizer.param_groups[0]
    assert isinstance(group["lr"], float) and group["capturable"] is False
    train.fused_step(ts, consts, cfg)
    saved = copy.deepcopy(train.state_dict(ts))  # live tensors: a checkpoint is a copy
    assert all(isinstance(g["lr"], float) for g in saved["optimizer"]["param_groups"])
    assert all(isinstance(lr, float) for lr in saved["scheduler"]["_last_lr"])
    # A float64 rate tensor holds this run's rate exactly (the card's is
    # float32), so the resumed run can be held to this one bitwise.
    card = dict(saved, optimizer=dict(saved["optimizer"], param_groups=[
        {**g, "lr": torch.tensor(g["lr"], dtype=torch.float64), "capturable": True}
        for g in saved["optimizer"]["param_groups"]
    ]), scheduler=dict(saved["scheduler"], _last_lr=[
        torch.tensor(lr, dtype=torch.float64) for lr in saved["scheduler"]["_last_lr"]
    ]))
    resumed, _ = _state(tiny_asset, cfg)
    train.load_state_dict(resumed, card)
    group = resumed.optimizer.param_groups[0]
    assert isinstance(group["lr"], float) and group["capturable"] is False
    assert group["lr"] == ts.optimizer.param_groups[0]["lr"]
    for _ in range(2):
        want, got = train.fused_step(ts, consts, cfg), train.fused_step(resumed, consts, cfg)
        assert all(torch.equal(got[k], want[k]) for k in want)
    _assert_same_state(resumed, ts)


def test_hoisted_constants_are_the_arrays_they_were(tiny_asset):
    """The constants built once for capture (rot6d identity, palette, mean
    light, the hard raster's light) give bitwise what the per-call host
    copies gave: the constants themselves, the rot6d prior, the shaded
    draws' light, and the hard raster with a tuple or a tensor light."""
    cfg = dataclasses.replace(_cfg().model, ief=ief.IEFConfig(hidden_dims=(32,), rotation_format="rot6d"))
    model, consts = net.init(tiny_asset, cfg, seed=3, device="cpu")
    J = consts.smpl.num_joints
    identity6 = torch.tensor([1, 0, 0, 0, 1, 0], dtype=torch.float32)
    assert torch.equal(consts.identity6, identity6.repeat(J))
    images = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    out = net.forward(model, consts, images, cfg)
    assert torch.equal(out["pose_prior"], (out["pose"] - identity6.repeat(J))[:, 6:])

    dev = torch.device("cpu")
    for n in (25, 32):
        assert torch.equal(synthetic._device_palette(dev, n), torch.as_tensor(synthetic.part_palette(n)))
    assert torch.equal(synthetic._device_light(dev), torch.tensor(synthetic._LIGHT))
    scfg = dataclasses.replace(configs.CONFIG4_ROBUST.synthetic, color_jitter=0.0, occluders=0, bg_mode="none")
    draws = synthetic.sample_draws(torch.Generator().manual_seed(4), 2, consts, scfg, SIZE)
    gen = torch.Generator().manual_seed(4)
    for shape in ((2, J * 3), (2, 3), (2, consts.smpl.num_betas), (2, 1), (2, 2), (2, SIZE, SIZE, 3)):
        (torch.randn if shape != (2, 1) else torch.rand)(shape, generator=gen)
    torch.rand((2, consts.smpl.cocoplus_regressor.shape[0]), generator=gen)
    light = torch.tensor(synthetic._LIGHT) + 0.6 * torch.randn((2, 3), generator=gen)
    assert torch.equal(draws["light"], light)
    batch = synthetic.render_batch(draws, consts, cfg, scfg)
    assert batch["silhouette"].sum() > 0

    rng = np.random.RandomState(5)
    verts2d = torch.from_numpy(rng.uniform(0, SIZE, (2, tiny_asset.v_template.shape[0], 2)).astype(np.float32))
    z = torch.from_numpy(rng.randn(2, tiny_asset.v_template.shape[0]).astype(np.float32))
    light3 = (0.35, -0.5, 0.79)
    for k_faces in (None, 64):
        tup = raster_hard.hard_raster(verts2d, z, consts.hard, SIZE, k_faces=k_faces, with_shade=True, light=light3)
        ten = raster_hard.hard_raster(verts2d, z, consts.hard, SIZE, k_faces=k_faces, with_shade=True,
                                      light=torch.tensor(light3))
        plain = raster_hard.hard_raster(verts2d, z, consts.hard, SIZE, k_faces=k_faces)
        unlit = raster_hard.hard_raster(verts2d, z, consts.hard, SIZE, k_faces=k_faces, light=None)
        assert tup.keys() == ten.keys() and all(torch.equal(tup[k], ten[k]) for k in tup)
        assert all(torch.equal(plain[k], unlit[k]) for k in plain)
        assert torch.equal(plain["part_labels"], tup["part_labels"]) and tup["silhouette"].sum() > 0


def test_predictor_outputs_outlive_later_requests(tiny_asset):
    """A request's outputs are its own: a later request (another bucket,
    then the same one) leaves them as they were. On the CPU the Predictor
    runs its eager forward whatever `graphs` says."""
    cfg = _cfg().model
    model, consts = net.init(tiny_asset, cfg, seed=3, device="cpu")
    p = serve.Predictor(cfg, model, consts, buckets=(2, 4))
    assert p.graphs is False and p.bucket_graph(2) is None
    rng = np.random.RandomState(6)
    x = [rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32) for n in (2, 3, 2)]
    first = p(x[0])
    kept = {k: v.clone() for k, v in first.items()}
    p(x[1])
    p(x[2])
    assert all(torch.equal(first[k], kept[k]) for k in kept)


def test_the_graph_route_of_the_predictor_is_the_eager_one(tiny_asset, stub_graphs, monkeypatch):
    """The Predictor's bucket graphs (a stub capture): `warmup` captures
    each bucket once; requests of 4, then 3 (padded with zeros in the
    bucket's buffer over the 4th image), then 1, equal the eager
    Predictor's bitwise, and capture nothing more."""
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    cfg = _cfg().model
    model, consts = net.init(tiny_asset, cfg, seed=3, device="cpu")
    p_g = serve.Predictor(cfg, model, consts, buckets=(2, 4))
    p_e = serve.Predictor(cfg, model, consts, buckets=(2, 4), graphs=False)
    assert p_g.graphs and not p_e.graphs
    p_g.warmup()
    assert len(stub_graphs) == 2 and p_g.bucket_graph(4) is not None
    rng = np.random.RandomState(6)
    for n in (4, 3, 1):
        x = rng.uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)
        got, want = p_g(x), p_e(x)
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want), n
    assert len(stub_graphs) == 2


def test_captured_calls_are_freed_without_the_cyclic_collector(tiny_asset, monkeypatch):
    """A graph that the cyclic collector frees may be reset in the middle of
    another capture, which breaks that capture (seen on the card), so every
    captured call is freed when its last reference goes: a compiled step,
    a Predictor with its bucket calls, and the evaluators' cached calls at
    `clear_graphs`. Under a stub capture whose graph holds no function."""
    monkeypatch.setattr(graphs, "eager_reason", lambda device, *args, **kw: None)
    monkeypatch.setattr(graphs, "warm_up", lambda fn, device: fn())
    stub = types.SimpleNamespace(replay=lambda: None)
    monkeypatch.setattr(graphs, "capture", lambda fn, device, pool=None, generators=(): graphs.Graph(
        stub, fn(), {}, 0.0, 0))
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", object)
    cfg = _cfg(lr_schedule="constant")
    ts, consts = _state(tiny_asset, cfg)
    step_fn = train.compile_fused_step(cfg, consts)
    step_fn(ts)
    step_fn(ts)
    model, _ = net.init(tiny_asset, cfg.model, seed=4, device="cpu")
    p = serve.Predictor(cfg.model, model, consts, buckets=(2,))
    p(np.zeros((1, SIZE, SIZE, 3), np.float32))
    evaluate.clear_graphs()
    evaluate.evaluate(model, consts, dataclasses.replace(cfg, batch_size=1), 1)
    refs = [weakref.ref(x) for x in (step_fn, p, p._calls[2], *evaluate._graphs.values())]
    assert len(refs) == 4
    gc.disable()
    try:
        del step_fn, p
        evaluate.clear_graphs()
        assert [r() for r in refs] == [None] * 4
    finally:
        gc.enable()


def test_graph_launch_accounting():
    """A capture's kernel launches come out of the counts (the card ran
    none) and every replay adds them, so the counts stay the launches the
    card ran; a capture that raises leaves the counts as they were."""
    _build.reset_counts()
    _build.count("lbs")
    record = {}
    with graphs.record_launches(record):
        _build.count("lbs")
        _build.count("lbs")
        _build.count("raster_fwd")
    assert record == {"lbs": 2, "raster_fwd": 1}
    assert _build.counts() == {"lbs": 1}
    with pytest.raises(RuntimeError), graphs.record_launches({}):
        _build.count("raster_bwd")
        raise RuntimeError("capture failed")
    assert _build.counts() == {"lbs": 1}

    class StubGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    stub = StubGraph()
    g = graphs.Graph(stub, {"x": 1}, record, seconds=0.5, pool_bytes=1024)
    for _ in range(3):
        assert g.replay() == {"x": 1}
    assert stub.replays == 3
    assert _build.counts() == {"lbs": 7, "raster_fwd": 3}
    _build.reset_counts()
    assert graphs.same_tensors([g, stub], [g, stub]) and not graphs.same_tensors(None, [])
    a, b = torch.zeros(1), torch.zeros(1)
    assert not graphs.same_tensors([a], [b]) and not graphs.same_tensors([a], [a, b])
