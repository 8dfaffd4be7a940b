"""PyTorch port, training and evaluation on disk data, against the JAX
reference on the CPU: `preprocess_raw_batch` with augmentation off and with
the reference's own draws injected; the refusal to mirror geometric 3D
targets; three disk steps from converted initial parameters against the
reference's `data_train_step`; `fit_dataset` resumed against a straight run
(bitwise, over a file and over shards); mixed supervision under the bare
and the gt_* names; image directories (the stream against the reference's
`ImageDirDataset` on the same host primitives, with and without augment,
and the refusal of an augment it would ignore); `evaluate_dataset` and
`evaluate_preprocessed` against the reference's; the CLIs on each source.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu import configs as jconfigs
from indirect_learning_pose_shape_tpu import evaluate as jeval
from indirect_learning_pose_shape_tpu import train as jtrain
from indirect_learning_pose_shape_tpu.data import augment as jaug
from indirect_learning_pose_shape_tpu.data import dataset as jds
from indirect_learning_pose_shape_tpu.data import image_dir as jimage_dir
from indirect_learning_pose_shape_tpu.models import encoder as jenc
from indirect_learning_pose_shape_tpu.models import ief as jief
from indirect_learning_pose_shape_tpu.models import network as jnet
from indirect_learning_pose_shape_tpu.ops import raster as jraster
from indirect_learning_pose_shape_tpu_torch import configs, evaluate, train
from indirect_learning_pose_shape_tpu_torch.data import augment as aug
from indirect_learning_pose_shape_tpu_torch.data import dataset as ds
from indirect_learning_pose_shape_tpu_torch.data import image_dir
from indirect_learning_pose_shape_tpu_torch.data import native_preprocess as npp
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.utils import convert

S, SRC, B, STEPS = 64, 80, 2, 3
# The crops differ from JAX's by its own CPU contraction's rounding (up to
# 2e-3 on the 0-255 scale, tests/test_torch_preprocess.py): 2e-5 on [-1, 1].
IMAGE_TOL = 2e-5


@pytest.fixture(scope="module")
def data(tmp_path_factory, tiny_asset):
    """A port-written dataset (8 examples at 80², tiny asset, with the 3D
    labels), its path, and the same split into shards of 3."""
    d = tmp_path_factory.mktemp("disk")
    path = str(d / "d.npz")
    arrays = ds.make_synthetic_dataset(path, 8, source_size=SRC, asset=tiny_asset, include_3d=True,
                                       device="cpu")
    ds.shard_npz(path, str(d / "shards"), 3)
    return {"path": path, "arrays": arrays, "shards": str(d / "shards"), "dir": d}


def _jcfg(augment=True):
    jmodel = jnet.ModelConfig(
        image_size=S,
        encoder=jenc.EncoderConfig(depth=18, width=16, compute_dtype=jnp.float32),
        ief=jief.IEFConfig(hidden_dims=(128,)),
        raster=jraster.RasterConfig(image_size=S, num_parts=24),
    )
    return jconfigs.TrainConfig(model=jmodel, batch_size=B, augment=jaug.AugmentConfig(enabled=augment))


def _cfg(augment=True, width=16, hidden=128):
    model = net.ModelConfig(
        image_size=S,
        encoder=enc.EncoderConfig(depth=18, width=width, compute_dtype=torch.float32),
        ief=ief.IEFConfig(hidden_dims=(hidden,)),
        raster=raster.RasterConfig(image_size=S, num_parts=24),
    )
    return configs.TrainConfig(model=model, batch_size=B, augment=aug.AugmentConfig(enabled=augment))


def _raw(arrays, idx, keys=("images", "masks", "kp2d", "kp_vis")):
    return {k: arrays[k][idx] for k in keys}


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _jax_draws(key, cfg, n):
    """The reference's augmentation draws from `key` (preprocess_raw_batch's
    split, mirror_raw_batch's Bernoulli, jitter_bboxes's uniforms)."""
    k_flip, k_box = jax.random.split(key)
    ks, kt = jax.random.split(k_box)
    return _t({
        "flip": jax.random.bernoulli(k_flip, cfg.flip_prob, (n,)),
        "scale": jax.random.uniform(ks, (n, 1), minval=1 - cfg.scale_jitter, maxval=1 + cfg.scale_jitter),
        "shift": jax.random.uniform(kt, (n, 2), minval=-cfg.trans_jitter, maxval=cfg.trans_jitter),
    })


@pytest.mark.parametrize("mode", ["plain", "augmented"])
def test_preprocess_raw_batch_matches_jax(data, mode):
    """Six samples, flipped and unflipped ones in one batch: labels,
    silhouettes, keypoints and visibility exact, images within IMAGE_TOL."""
    raw = _raw(data["arrays"], np.arange(6))
    jcfg = dataclasses.replace(_jcfg(mode == "augmented"), batch_size=6)
    key = jax.random.PRNGKey(11) if mode == "augmented" else None
    want = jax.tree.map(np.asarray, jtrain.preprocess_raw_batch(
        {k: jnp.asarray(v) for k, v in raw.items()}, None, jcfg, key=key))
    draws = _jax_draws(key, jcfg.augment, 6) if key is not None else None
    if draws is not None:
        assert 0 < int(draws["flip"].sum()) < 6
    got = train.preprocess_raw_batch(_t(raw), _cfg(mode == "augmented"), draws)
    assert set(got) == set(want)
    np.testing.assert_allclose(got["image"].numpy(), want["image"], atol=IMAGE_TOL, rtol=0)
    for k in ("silhouette", "part_labels", "kp2d", "kp_vis"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert got["part_labels"].dtype == torch.int32 and got["silhouette"].mean() > 0.02


@pytest.mark.parametrize("keys, refused", [
    (("joints3d",), True), (("rotmats", "betas"), True), (("verts3d",), True), (("betas",), False),
])
def test_mirror_with_3d_targets_is_refused(data, keys, refused):
    """Mirroring with geometric 3D targets is refused as the reference
    refuses it; betas alone are mirror-invariant and pass through."""
    arrays = dict(data["arrays"], verts3d=np.zeros((8, 5, 3), np.float32), betas=data["arrays"]["gt_betas"])
    raw = _raw(arrays, np.arange(2), ("images", "masks", "kp2d", "kp_vis") + keys)
    draws = aug.sample_draws(torch.Generator().manual_seed(0), 2, aug.AugmentConfig())
    if refused:
        with pytest.raises(ValueError) as got:
            train.preprocess_raw_batch(_t(raw), _cfg(), draws)
        with pytest.raises(ValueError) as want:
            jtrain.preprocess_raw_batch({k: jnp.asarray(v) for k, v in raw.items()}, None, _jcfg(),
                                        key=jax.random.PRNGKey(0))
        assert str(got.value) == str(want.value)
    else:
        out = train.preprocess_raw_batch(_t(raw), _cfg(), draws)
        assert torch.equal(out["betas"], torch.from_numpy(raw["betas"]))


@pytest.fixture(scope="module")
def steps(data, tiny_asset):
    """Three augmented disk steps of the reference's jitted disk step
    (`_data_step_jit`, what its `fit_dataset` runs) from its initial
    parameters (IEF output layer scaled down so the bodies stay in frame),
    and the port's from the same parameters on the same raw batches with
    the reference's draws injected, by each route: "eager" (`train_step` on
    `preprocess_raw_batch`) and "compile_data_step" (the fit loop's step,
    the draws injected where its graph draws them, `_draw_augment`)."""
    jcfg = _jcfg()
    ts, jconsts = jtrain.init_state(jcfg, tiny_asset)
    params = jax.tree.map(np.asarray, ts.params)
    last = params["ief"]["layers"][-1]
    last["w"] = (np.random.RandomState(0).randn(*last["w"].shape) * 2e-4).astype(np.float32)
    ts = dataclasses.replace(ts, params=jax.tree.map(jnp.asarray, params))
    state = jax.tree.map(np.asarray, ts.model_state)
    rng = np.asarray(ts.rng)
    raws = [_raw(data["arrays"], np.arange(B * i, B * i + B)) for i in range(STEPS)]
    ref = []
    for raw in raws:
        ts, terms = jtrain._data_step_jit(ts, {k: jnp.asarray(v) for k, v in raw.items()}, jconsts,
                                          jtrain._graph_cfg(jcfg), None)
        ref.append({k: float(v) for k, v in terms.items()})

    cfg = _cfg()
    draws = [_jax_draws(jax.random.fold_in(rng, i), jcfg.augment, B) for i in range(STEPS)]
    got = {}
    for route in ("eager", "compile_data_step"):
        model, consts = net.init(tiny_asset, cfg.model, seed=1, device="cpu")
        convert.load_jax_params(model, params, state)
        tstate = train.TrainState(model, train.make_optimizer(model, cfg), 0, 0)
        fn = train.compile_data_step(cfg, consts)
        got[route] = []
        for raw, d in zip(raws, draws):
            if route == "eager":
                terms = train.train_step(tstate, train.preprocess_raw_batch(_t(raw), cfg, d), consts, cfg)
            else:
                with pytest.MonkeyPatch.context() as mp:
                    mp.setattr(train, "_draw_augment", lambda gen, n, cfg, d=d: d)
                    terms = fn(tstate, _t(raw))
            got[route].append({k: float(v) for k, v in terms.items()})
    return ref, got


@pytest.mark.parametrize("route", ["eager", "compile_data_step"])
def test_data_train_step_loss_tracks_jax(steps, route):
    """The total loss of each of three steps within rtol 1e-3, and the first
    step's every term within 1e-4 relative (its inputs differ from JAX's by
    the crop's rounding alone), for the port's eager step and the fit
    loop's compiled one (on the CPU, the eager code a graph records)."""
    ref, got = steps[0], steps[1][route]
    assert set(got[0]) == set(ref[0])
    np.testing.assert_allclose([g["total"] for g in got], [r["total"] for r in ref], rtol=1e-3)
    for k, v in ref[0].items():
        np.testing.assert_allclose(got[0][k], v, rtol=1e-4, atol=1e-7, err_msg=k)
    assert got[-1]["total"] != got[0]["total"]


def test_data_train_step_draws_are_keyed_by_step(data, tiny_asset):
    """`data_train_step` is `train_step` on `preprocess_raw_batch` of the
    draws of (seed, step), bitwise; those draws differ from step to step and
    from the synthetic stream's generator."""
    cfg = _cfg(width=8, hidden=16)
    raw = _t(_raw(data["arrays"], np.arange(B)))
    a, consts = train.init_state(cfg, tiny_asset, device="cpu")
    b, _ = train.init_state(cfg, tiny_asset, device="cpu")
    for ts in (a, b):
        ts.step = 5
    ta = train.data_train_step(a, raw, consts, cfg)
    draws = train.augment_draws(b.seed, 5, B, cfg, torch.device("cpu"))
    tb = train.train_step(b, train.preprocess_raw_batch(raw, cfg, draws), consts, cfg)
    assert ta.keys() == tb.keys() and all(torch.equal(ta[k], tb[k]) for k in ta)
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    other = train.augment_draws(b.seed, 6, B, cfg, torch.device("cpu"))
    assert not torch.equal(draws["scale"], other["scale"])
    assert train.step_seed(0, 5, 1) != train.step_seed(0, 5)


@pytest.mark.parametrize("source", ["npz", "shards"])
def test_fit_dataset_resume_equals_straight_run(data, tiny_asset, tmp_path, source):
    """fit_dataset with augmentation to step 2 (checkpoint_every=2), resumed
    to 4, equals a straight run to 4 bitwise on the CPU: the same raw
    batches from the resumed step and the same draws. Each epoch is 4 steps
    over the file and 2 over the shards, so the runs cross epochs."""
    cfg = dataclasses.replace(_cfg(width=8, hidden=16), log_every=1)
    split = dataclasses.replace(cfg, checkpoint_every=2, checkpoint_dir=str(tmp_path / "ck"))
    path = data["path"] if source == "npz" else data["shards"]
    runs = {}
    for name, c, n in (("first", split, 2), ("resumed", split, 4), ("straight", cfg, 4)):
        logged = []
        runs[name] = train.fit_dataset(c, ds.open_dataset(path, B, seed=7), num_steps=n,
                                       asset=tiny_asset, device="cpu", log=logged.append)
        runs[name] += (logged,)
    (ts_r, terms_r, log_r), (ts_s, terms_s, log_s) = runs["resumed"], runs["straight"]
    assert ts_r.step == ts_s.step == 4 and [r["step"] for r in log_r] == [2, 3]
    assert terms_r == terms_s and log_r == log_s[2:]
    for k, v in ts_s.model.state_dict().items():
        assert torch.equal(v, ts_r.model.state_dict()[k]), k


def test_fit_dataset_mixed_supervision_bare_and_gt_names(data, tiny_asset):
    """The 3D targets under their bare names (joints3d, rotmats) or the gt_*
    names, and betas through its gt_betas alias: the same terms; a dataset
    with neither name is refused, naming both."""
    w = dict(configs.CONFIG4_FULL.loss_weights, j3d=5.0, rotmat=1.0, betas_l2=0.02)
    cfg = dataclasses.replace(_cfg(augment=False, width=8, hidden=16), loss_weights=tuple(w.items()))
    bare = data["arrays"]
    gt = {{"joints3d": "gt_joints3d", "rotmats": "gt_rotmats"}.get(k, k): v for k, v in bare.items()}
    assert train.dataset_pulls(cfg, frozenset(bare))["betas"] == "gt_betas"
    assert train.dataset_pulls(cfg, frozenset(gt))["joints3d"] == "gt_joints3d"
    terms = [train.fit_dataset(cfg, ds.NpzDataset(a, B), num_steps=1, asset=tiny_asset, device="cpu")[1]
             for a in (bare, gt)]
    assert {"j3d", "rotmat", "betas_l2"} <= set(terms[0]) and terms[0] == terms[1]
    missing = {k: v for k, v in bare.items() if k != "joints3d"}
    with pytest.raises(KeyError, match=r"\('gt_joints3d', 'joints3d'\)"):
        train.fit_dataset(cfg, ds.NpzDataset(missing, B), num_steps=1, asset=tiny_asset, device="cpu")


@pytest.fixture(scope="module")
def image_root(data):
    root = str(data["dir"] / "imgdir")
    image_dir.export_image_dir(data["arrays"], root)
    return root


@pytest.mark.parametrize("augment", [False, True])
def test_image_dir_stream_matches_reference(image_root, monkeypatch, augment):
    """The port's ImageDirDataset against the reference's on the same host
    primitives (the port's native_preprocess in both): order, flips,
    jitters and keypoints bitwise; deterministic and resumable."""
    import indirect_learning_pose_shape_tpu.data as jdata

    monkeypatch.setattr(jdata, "native_preprocess", npp, raising=False)
    monkeypatch.setitem(sys.modules, "indirect_learning_pose_shape_tpu.data.native_preprocess", npp)
    cfg = aug.AugmentConfig(enabled=True, flip_prob=0.5) if augment else None
    jcfg = jaug.AugmentConfig(enabled=True, flip_prob=0.5) if augment else None
    mine = image_dir.ImageDirDataset(image_root, 3, S, seed=2, augment=cfg)
    ref = jimage_dir.ImageDirDataset(image_root, 3, S, seed=2, augment=jcfg)
    got = [b for _, b in zip(range(4), mine.batches())]
    want = [b for _, b in zip(range(4), ref.batches())]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert got[0]["image"].shape == (3, S, S, 3) and got[0]["image"].dtype == np.float32
    resumed = next(mine.batches(start_step=3))
    for k in resumed:
        np.testing.assert_array_equal(resumed[k], got[3][k])


def test_fit_preprocessed_refuses_an_ignored_augment(image_root, tiny_asset):
    cfg = _cfg(width=8, hidden=16)
    plain = image_dir.ImageDirDataset(image_root, B, S)
    with pytest.raises(ValueError, match="does not augment"):
        train.fit_preprocessed(cfg, plain, num_steps=1, asset=tiny_asset, device="cpu")
    augmented = image_dir.ImageDirDataset(image_root, B, S, augment=cfg.augment)
    _, terms = train.fit_preprocessed(cfg, augmented, num_steps=2, asset=tiny_asset, device="cpu")
    assert np.isfinite(terms["total"])


@pytest.fixture(scope="module")
def eval_models(tiny_asset):
    jcfg = _jcfg(augment=False)
    params, state, jconsts = jnet.init(jax.random.PRNGKey(0), tiny_asset, jcfg.model)
    params, state = jax.tree.map(np.asarray, (params, state))
    last = params["ief"]["layers"][-1]
    last["w"] = (np.random.RandomState(0).randn(*last["w"].shape) * 2e-4).astype(np.float32)
    cfg = _cfg(augment=False)
    model, consts = net.init(tiny_asset, cfg.model, seed=1, device="cpu")
    convert.load_jax_params(model, params, state)
    return (params, state, jconsts, jcfg), (model, consts, cfg)


# Thresholded metrics: a flipped boundary pixel (2e-3 absolute); the others
# 1e-4 relative (on the image directory both see the same batches; on the
# file the crops differ by IMAGE_TOL).
THRESHOLDED = ("sil_iou", "part_acc", "miou")


def _close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        tol = 2e-3 if k in THRESHOLDED else 1e-4 * abs(w)
        assert abs(got[k] - w) <= tol, f"{k}: port {got[k]} vs reference {w}"


@pytest.mark.parametrize("source", ["npz", "shards"])
def test_evaluate_dataset_matches_jax(data, eval_models, source):
    (params, state, jconsts, jcfg), (model, consts, cfg) = eval_models
    path = data["path"] if source == "npz" else data["shards"]
    want = jeval.evaluate_dataset(params, state, jconsts, jcfg, jds.open_dataset(path, B), max_batches=2)
    got = evaluate.evaluate_dataset(model, consts, cfg, ds.open_dataset(path, B), max_batches=2)
    _close(got, want)
    assert {"pve", "mpjpe", "pa_mpjpe"} <= set(got) and want["sil_iou"] > 0.05


def test_evaluate_preprocessed_matches_jax(image_root, eval_models):
    (params, state, jconsts, jcfg), (model, consts, cfg) = eval_models
    dset = image_dir.ImageDirDataset(image_root, B, S)
    want = jeval.evaluate_preprocessed(params, state, jconsts, jcfg, dset, max_batches=3)
    got = evaluate.evaluate_preprocessed(model, consts, cfg, dset, max_batches=3)
    _close(got, want)
    assert "pve" not in got


_CLI = ["--preset", "config4_full", "--batch-size", "2", "--image-size", "32", "--device", "cpu"]


@pytest.mark.parametrize("source", ["npz", "shards", "image_dir"])
def test_train_cli_runs_on_disk_data(data, image_root, source, capsys):
    """The full-width ResNet-18 on the SMPL-sized asset, 32² crops, two
    augmented steps from each kind of source."""
    flag = {"npz": ["--dataset", data["path"]], "shards": ["--dataset", data["shards"]],
            "image_dir": ["--image-dir", image_root]}[source]
    assert train.main([*_CLI, *flag, "--augment", "--steps", "2", "--log-every", "1"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert [r["step"] for r in lines] == [0, 1] and np.isfinite(lines[-1]["total"])


@pytest.mark.parametrize("flags, message", [
    (["--dataset", "d.npz", "--synthetic", "pose_std=0.3"], "synthetic-stream training only"),
    (["--dataset", "d.npz", "--steps-per-call", "2"], "synthetic-stream training only"),
    (["--augment"], "applies to disk data"),
    (["--dataset", "d.npz", "--image-dir", "imgs"], "give one"),
])
def test_train_cli_refusals(flags, message, capsys):
    with pytest.raises(SystemExit):
        train.main([*_CLI, *flags])
    assert message in capsys.readouterr().err
