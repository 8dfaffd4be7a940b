"""PyTorch port, the compiled disk steps and evaluators on the CPU:
`train.compile_data_step` runs the eager disk steps on CPU states and
equals them bitwise, and `fit_dataset` / `fit_preprocessed` name their
eager route; `_draw_augment` on one generator reseeded per step gives
`augment_draws`' draws; the mirror's tables, built once per device, give
the batch the per-call tables gave; the evaluators' graph cache captures
anew for a new model or new tensors (a stub capture), and the eager
evaluator's reseeded generator scores `make_batch`'s batches.

The CUDA graphs themselves are captured only on the card, where
`chip_smoke.py`'s graphs phase holds them to the eager routes bitwise.
"""

import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu_torch import configs, evaluate, train
from indirect_learning_pose_shape_tpu_torch.data import augment as aug
from indirect_learning_pose_shape_tpu_torch.data import dataset as ds
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.utils import graphs
from tests.test_torch_compiled import stub_graphs  # noqa: F401  (a fixture)

SIZE, SRC, BATCH, K = 32, 40, 2, 19


def _cfg(augment=True, **kw):
    model = net.ModelConfig(
        image_size=SIZE,
        encoder=enc.EncoderConfig(depth=18, width=8, compute_dtype=torch.float32),
        ief=ief.IEFConfig(hidden_dims=(16,)),
        raster=raster.RasterConfig(image_size=SIZE, num_parts=24),
    )
    return configs.TrainConfig(model=model, batch_size=BATCH, augment=aug.AugmentConfig(enabled=augment), **kw)


def _arrays(n=4, seed=0):
    """n raw examples at SRC²: noise images, a labelled box in each mask,
    keypoints inside the box."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((n, SRC, SRC), np.int32)
    for i in range(n):
        y, x = rng.randint(2, 14, 2)
        masks[i, y : y + 20, x : x + 16] = rng.randint(1, 25, (20, 16))
    return {
        "images": rng.randint(0, 256, (n, SRC, SRC, 3)).astype(np.uint8),
        "masks": masks,
        "kp2d": rng.uniform(10, 30, (n, K, 2)).astype(np.float32),
        "kp_vis": (rng.rand(n, K) > 0.3).astype(np.float32),
    }


def _raw(arrays, rows):
    return {k: torch.from_numpy(v[rows]) for k, v in arrays.items()}


def _assert_same_state(a, b):
    for (k, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), k
    for sa, sb in zip(a.optimizer.state.values(), b.optimizer.state.values()):
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
    assert a.step == b.step


@pytest.mark.parametrize("raw", [True, False])
def test_compile_data_step_on_cpu_is_the_eager_step(tiny_asset, raw):
    """Two augmented steps: `compile_data_step` on the CPU is
    `data_train_step` (raw batches) or `train_step` (preprocessed ones),
    terms and state bitwise; a gloo mesh is refused, naming the eager step."""
    cfg = _cfg()
    a, consts = train.init_state(cfg, tiny_asset, device="cpu")
    b, _ = train.init_state(cfg, tiny_asset, device="cpu")
    fn = train.compile_data_step(cfg, consts, raw=raw)
    arrays = _arrays()
    for step in range(2):
        batch = _raw(arrays, np.arange(BATCH) + step * BATCH)
        if not raw:
            batch = train.preprocess_raw_batch(batch, cfg)
        want = (train.data_train_step if raw else train.train_step)(b, batch, consts, cfg)
        got = fn(a, batch)
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
    _assert_same_state(a, b)
    gloo = types.SimpleNamespace(backend="gloo", world=2)
    eager = "train.data_train_step" if raw else "train.train_step"
    with pytest.raises(ValueError, match=f"eager {eager}"):
        train.compile_data_step(cfg, consts, gloo, raw=raw)


class _Preprocessed:
    """A host-preprocessed stream (the `ImageDirDataset` interface
    `fit_preprocessed` reads) over `_arrays`, cropped on the CPU."""

    augment = None

    def __init__(self, cfg):
        self.batch = {k: v.numpy() for k, v in train.preprocess_raw_batch(_raw(_arrays(), slice(0, BATCH)), cfg).items()}

    def batches(self, start_step=0):
        while True:
            yield self.batch


def test_disk_loops_name_their_route(tiny_asset, capsys):
    """On the CPU `fit_dataset` and `fit_preprocessed` keep the eager route
    and their first log line names it; on the card the route is the graph
    of `compile_data_step`, and gloo and anomaly mode stay eager."""
    cfg = _cfg(augment=False, num_steps=1)
    train.fit_dataset(_cfg(num_steps=1), ds.NpzDataset(_arrays(), BATCH), asset=tiny_asset, device="cpu")
    assert "fit: eager data_train_step (CPU)" in capsys.readouterr().err
    train.fit_preprocessed(cfg, _Preprocessed(cfg), asset=tiny_asset, device="cpu")
    assert "fit: eager train_step (CPU)" in capsys.readouterr().err
    card = torch.device("cuda", 0)

    def route(mesh, *names):  # as `train._run` asks for a disk loop
        return train._fit_route(*names, graphs.eager_reason(card, mesh, torch.is_anomaly_enabled()), mesh)

    raw_names, pre_names = ("compile_data_step", "data_train_step"), ("compile_data_step(raw=False)", "train_step")
    assert route(None, *raw_names) == "graph: compile_data_step, one CUDA graph replay a step"
    assert route(None, *pre_names).startswith("graph: compile_data_step(raw=False),")
    nccl = types.SimpleNamespace(backend="nccl", world=2)
    assert route(nccl, *raw_names).endswith("(NCCL mesh of 2)")
    gloo = types.SimpleNamespace(backend="gloo", world=2)
    assert route(gloo, *raw_names) == "eager data_train_step (gloo mesh: host collectives)"
    with torch.autograd.detect_anomaly(check_nan=False):
        assert route(None, *pre_names) == "eager train_step (anomaly mode, --debug-nans)"


def test_draw_augment_on_a_reseeded_generator_is_augment_draws():
    """One generator reseeded by (seed, step, 1) before each step, as the
    graph route reseeds its registered one, draws what a fresh generator of
    that seed draws (`augment_draws`), bitwise, step after step; the draws
    differ between steps."""
    cfg = _cfg()
    gen = torch.Generator()
    draws = []
    for step in range(4):
        gen.manual_seed(train.step_seed(7, step, train._AUGMENT_STREAM))
        got = train._draw_augment(gen, 8, cfg)
        want = train.augment_draws(7, step, 8, cfg, torch.device("cpu"))
        assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
        draws.append(got)
    assert all(not torch.equal(a["scale"], b["scale"]) for a, b in zip(draws, draws[1:]))


def _mirror_with_fresh_tables(raw, flip, cfg, num_parts):
    """`mirror_raw_batch` as it was before its tables were built once: both
    tables copied from the host on every call."""
    dev = raw["images"].device
    W = raw["images"].shape[2]
    f3 = flip[:, None, None]
    images = torch.where(flip[:, None, None, None], raw["images"].flip(2), raw["images"])
    label_perm = torch.as_tensor(
        aug.part_label_flip_perm(num_parts, cfg.part_convention, cfg.part_lr_pairs), device=dev)
    masks = raw["masks"].to(torch.int32)
    masks = torch.where(f3, label_perm[masks.flip(2).long()], masks)
    kperm = torch.as_tensor(aug.kp_flip_perm(raw["kp2d"].shape[1]), device=dev).long()
    kp_m = raw["kp2d"][:, kperm]
    kp_m = torch.stack([W - 1.0 - kp_m[..., 0], kp_m[..., 1]], dim=-1)
    kp2d = torch.where(f3, kp_m, raw["kp2d"])
    kp_vis = torch.where(flip[:, None], raw["kp_vis"][:, kperm], raw["kp_vis"])
    return dict(raw, images=images, masks=masks, kp2d=kp2d, kp_vis=kp_vis)


@pytest.mark.parametrize("convention, num_parts, num_kp", [
    ("smpl24", 24, 19), ("s31-smpl-prefix", 31, 17), ("custom", 6, 14),
])
def test_mirror_tables_built_once_give_the_same_batch(convention, num_parts, num_kp):
    """The tables come from a cache keyed by (parts, convention, pairs,
    keypoints, device), built at the first call and the same objects after;
    the mirrored batch is bitwise the one the per-call host tables gave."""
    cfg = aug.AugmentConfig(enabled=True, part_convention=convention,
                            part_lr_pairs=((1, 2), (3, 5)) if convention == "custom" else ())
    arrays = _arrays(4, seed=3)
    arrays["masks"] = np.minimum(arrays["masks"], num_parts)
    arrays["kp2d"], arrays["kp_vis"] = arrays["kp2d"][:, :num_kp], arrays["kp_vis"][:, :num_kp]
    raw = _raw(arrays, slice(None))
    flip = torch.tensor([True, False, True, True])
    got = aug.mirror_raw_batch(raw, flip, cfg, num_parts=num_parts)
    want = _mirror_with_fresh_tables(raw, flip, cfg, num_parts)
    assert all(torch.equal(got[k], want[k]) and got[k].dtype == want[k].dtype for k in want)
    tables = aug._flip_tables(num_parts, cfg, num_kp, torch.device("cpu"))
    assert aug._flip_tables(num_parts, cfg, num_kp, torch.device("cpu")) is tables
    assert tables[0].dtype == torch.int32 and tables[1].dtype == torch.int64


def test_eager_evaluator_scores_make_batch(tiny_asset):
    """The eager evaluator reseeds one generator by (seed, i) for batch i:
    its means are bitwise those of `_batch_metrics` on `make_batch`'s
    batches, summed in batch order."""
    cfg = _cfg(augment=False)
    model, consts = net.init(tiny_asset, cfg.model, seed=3, device="cpu")
    got = evaluate.evaluate(model, consts, cfg, num_batches=2, seed=11)
    sums = {}
    for i in range(2):
        m = evaluate._batch_metrics(model, consts, train.make_batch(11, i, BATCH, consts, cfg), cfg)
        sums = {k: sums.get(k, 0.0) + v for k, v in m.items()}
    assert got == {k: float(v / 2) for k, v in sums.items()}
    assert "pa_mpjpe" in got


def test_eval_graph_cache_captures_anew_for_new_tensors(tiny_asset, monkeypatch):
    """The evaluators' cache, with a stub capture and a stub batch on the
    CPU: a second call on the same model replays; a deep copy (as
    `train.ema_model` makes), a replaced parameter, another config or
    another quantized encoder each capture anew; at most 8 graphs are kept,
    the least recently used dropped first."""
    captured = []

    def capture(fn, device, pool=None, generators=()):
        stub = types.SimpleNamespace(replay=lambda: None)
        captured.append(graphs.Graph(stub, fn(), {}, 0.0, 0))
        return captured[-1]

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "warm_up", lambda fn, device: fn())
    monkeypatch.setattr(train, "_draw_batch", lambda *args: {})
    monkeypatch.setattr(evaluate, "_metrics_on_device", lambda *args: ({"n": torch.ones(())}, None))
    evaluate.clear_graphs()
    cfg = _cfg(augment=False)
    model, consts = net.init(tiny_asset, cfg.model, seed=3, device="cpu")
    cpu = torch.device("cpu")

    def run(m, c=cfg, qparams=None):
        runner = evaluate._runner("stream", m, consts, c, qparams, "int8", cpu, graphed=True)
        return runner(train.step_seed(11, 0))

    def held(call):  # the model, the consts and the qparams a call holds
        return call.bound()[:3]

    assert run(model) == {"n": torch.ones(())} and len(captured) == 1
    run(model)
    assert len(captured) == 1
    ema = copy.deepcopy(model)
    run(ema)
    assert len(captured) == 2
    lin = model.ief.layers[-1]
    lin.weight = torch.nn.Parameter(lin.weight.detach().clone())
    run(model)
    assert len(captured) == 3
    run(model, dataclasses.replace(cfg, batch_size=1))
    assert len(captured) == 4
    assert [held(e)[0] for e in evaluate._graphs.values()] == [ema, model, model]
    run(ema)  # a replay, and now the most recently used
    assert len(captured) == 4
    lru = next(iter(evaluate._graphs))
    for i in range(evaluate._GRAPHS_KEPT - 3):
        run(model, dataclasses.replace(cfg, seed=100 + i))
    assert len(evaluate._graphs) == 8 and lru in evaluate._graphs
    qp = types.SimpleNamespace()
    monkeypatch.setattr(evaluate.quant, "as_encoder", lambda qparams, cfg, device: None)
    run(model, qparams=qp)
    assert len(captured) == 10 and len(evaluate._graphs) == 8 and lru not in evaluate._graphs
    assert any(held(e)[0] is ema for e in evaluate._graphs.values())
    assert all(x is y for x, y in zip(held(next(reversed(evaluate._graphs.values()))), [model, consts, qp]))
    evaluate.clear_graphs()
    assert not evaluate._graphs


def test_the_graph_route_of_compile_data_step_is_the_eager_step(tiny_asset, stub_graphs):
    """`compile_data_step`'s graph route (a stub capture, see
    `stub_graphs`): each batch copied into the static inputs, the
    augmentation generator registered and reseeded by (seed, step, 1),
    three steps bitwise `data_train_step`'s in one capture; a batch of
    another layout captures again."""
    cfg = _cfg()
    a, consts = train.init_state(cfg, tiny_asset, device="cpu")
    b, _ = train.init_state(cfg, tiny_asset, device="cpu")
    fn = train.compile_data_step(cfg, consts)
    arrays = _arrays(n=8)
    for step, rows in enumerate((np.arange(BATCH), np.arange(BATCH) + BATCH, np.arange(BATCH) + 2 * BATCH, [6])):
        batch = _raw(arrays, rows)
        want, got = train.data_train_step(b, batch, consts, cfg), fn(a, batch)
        assert all(torch.equal(got[k], want[k]) for k in want), step
        assert fn.captures == (1 if step < 3 else 2)
    assert [len(g) for g in stub_graphs] == [1, 1]
    _assert_same_state(a, b)


def test_the_graph_route_of_the_evaluators_is_eager(tiny_asset, stub_graphs):
    """`evaluate` and `evaluate_dataset` through their cached captured calls
    (a stub capture) score what the eager route scores, the stream's
    generator reseeded by (seed, i) for batch i and the disk batches
    staged; the second `evaluate` replays only."""
    evaluate.clear_graphs()
    cfg = _cfg(augment=False)
    model, consts = net.init(tiny_asset, cfg.model, seed=3, device="cpu")
    for _ in range(2):
        assert evaluate.evaluate(model, consts, cfg, 2, seed=11) == evaluate.evaluate(
            model, consts, cfg, 2, seed=11, graphs=False)
    assert len(stub_graphs) == 1
    data = ds.NpzDataset(_arrays(n=4), BATCH)
    got = evaluate.evaluate_dataset(model, consts, cfg, data)
    assert got == evaluate.evaluate_dataset(model, consts, cfg, data, graphs=False)
    assert len(stub_graphs) == 2
    evaluate.clear_graphs()
