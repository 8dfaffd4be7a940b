"""PyTorch port, multi-GPU training (parallel/mesh.py, parallel/render_sp.py,
the mesh paths of train.py) on gloo ranks on the CPU.

One spawn of 2 ranks (`_ranks`) runs, on converted initial parameters:
- a data-parallel step (2 x 1 mesh) on an injected global batch of 4 whose
  keypoint visibility differs between the two shards; held to the port's
  one-process step (loss and terms rtol 1e-5, all-reduced gradients 1e-4
  normalised per leaf, BN running buffers 1e-5, parameters after the update
  equal to the one-process update from the rank's gradients) and to the JAX reference's `train_step` (single device, and its
  `compile_train_fns` over 2 of the conftest's 8 virtual CPU devices: loss
  rtol 1e-3, gradients 1e-3 normalised);
- a fused step on the synthetic stream (each rank's batch the rows of the
  one-process batch);
- `fit_dataset` with augmentation for 4 steps, straight and resumed at
  step 2 from rank 0's checkpoint;
- `fit_preprocessed` for 4 steps over an in-memory stream of preprocessed
  batches;
- sharded int8 serving: `quantize.quantized_forward` (int8, int8c) on the
  global request with the qparams read from one file, against the port's
  one process (1e-5) and the reference's single-device `quantized_forward`
  on the same file and converted parameters (`kp2d` within 2e-3, the limit
  of its tests/test_sharding.py);
- on a 1 x 2 render mesh: the row-sharded separable render and its vertex
  gradient against the local render, the SP train step against the DP one
  (same step-0 batch), and the hard raster in two tile bands at 64².

The rank functions live at module level (spawned ranks import this module
by name); the JAX reference is imported inside the fixture, so the ranks
never import JAX.
"""

import dataclasses

import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu_torch import configs, losses, train
from indirect_learning_pose_shape_tpu_torch.data import dataset as dataset_lib
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import quantize
from indirect_learning_pose_shape_tpu_torch.ops import raster, raster_hard
from indirect_learning_pose_shape_tpu_torch.parallel import mesh as mesh_lib
from indirect_learning_pose_shape_tpu_torch.parallel import render_sp
from indirect_learning_pose_shape_tpu_torch.utils import convert
from indirect_learning_pose_shape_tpu_torch.utils.assets import synthetic_asset

SIZE, BATCH, FIT_STEPS = 32, 4, 4
HARD_K_FACES = 64  # the culled hard raster: faces kept a tile


def _cfg(**kw) -> configs.TrainConfig:
    model = net.ModelConfig(
        image_size=SIZE,
        encoder=enc.EncoderConfig(depth=18, width=16, compute_dtype=torch.float32),
        ief=ief.IEFConfig(hidden_dims=(128,)),
        raster=raster.RasterConfig(image_size=SIZE, num_parts=24),
    )
    return dataclasses.replace(configs.TrainConfig(model=model, batch_size=BATCH), **kw)


def _sep(cfg: configs.TrainConfig) -> configs.TrainConfig:
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, raster_impl="separable"))


def _aug(cfg: configs.TrainConfig) -> configs.TrainConfig:
    return dataclasses.replace(cfg, augment=dataclasses.replace(cfg.augment, enabled=True))


def _asset():
    return synthetic_asset(num_verts=864, seed=1)


def _state(sd, cfg, device):
    model, consts = net.init(_asset(), cfg.model, device=device)
    convert.load_state_arrays(model, sd)
    return train.new_state(model, cfg), consts


def _snapshot(ts, terms):
    return {
        "terms": {k: float(v) for k, v in terms.items()},
        "grads": {k: p.grad.clone() for k, p in ts.model.named_parameters()},
        "state": {k: v.clone() for k, v in ts.model.state_dict().items()},
    }


# The arrays of a preprocessed batch (data/image_dir.ImageDirDataset's).
PREPROCESSED_KEYS = ("image", "silhouette", "part_labels", "kp2d", "kp_vis")
INT8_IMPLS = ("int8", "int8c")


class _Preprocessed:
    """An in-memory stream of preprocessed global batches, cycled, for
    `fit_preprocessed` (no augmentation of its own)."""

    augment = None

    def __init__(self, batches: list):
        self.stream = batches

    def batches(self, start: int = 0):
        step = start
        while True:
            yield self.stream[step % len(self.stream)]
            step += 1


def _fused(cfg, device):
    """One fused step from a fresh seed-0 state on the run's mesh."""
    ts, consts = train.init_state(cfg, _asset(), device)
    return float(train.fused_step(ts, consts, cfg, train._auto_mesh(cfg, device))["total"])


def _ranks(device, sd, batch, arrays, ckpt_dir, preprocessed, qpath):
    out = {}
    cfg = _cfg()
    mesh = mesh_lib.make_mesh(None, device)
    ts, consts = _state(sd, cfg, device)
    local = mesh_lib.shard_batch({k: torch.from_numpy(v) for k, v in batch.items()}, mesh)
    out["dp"] = _snapshot(ts, train.train_step(ts, local, consts, cfg, mesh))

    ts, consts = train.init_state(cfg, _asset(), device)
    out["stream_batch"] = train.make_batch(cfg.seed, 0, BATCH, consts, cfg, mesh)
    out["stream_total"] = float(train.fused_step(ts, consts, cfg, mesh)["total"])

    ds = dataset_lib.NpzDataset(arrays, BATCH)
    ts, values = train.fit_dataset(_aug(cfg), ds, FIT_STEPS, _asset(), device)
    out["fit"] = {"values": values, "state": ts.model.state_dict()}
    resumable = dataclasses.replace(_aug(cfg), checkpoint_every=2, checkpoint_dir=ckpt_dir)
    train.fit_dataset(resumable, ds, 2, _asset(), device)
    ts, values = train.fit_dataset(resumable, ds, FIT_STEPS, _asset(), device)
    out["resumed"] = {"values": values, "state": ts.model.state_dict(), "step": ts.step}
    staged, step = [], train._local_step

    def recorded_step(ts, b, *args):  # the rows each step takes
        staged.append(b["image"].clone())
        return step(ts, b, *args)

    train._local_step = recorded_step
    try:
        ts, values = train.fit_preprocessed(cfg, _Preprocessed(preprocessed), FIT_STEPS, _asset(), device)
    finally:
        train._local_step = step
    out["preprocessed"] = {"values": values, "state": ts.model.state_dict(), "staged": staged}

    # Sharded int8 serving: the whole request on every rank, qparams from one file.
    served, consts = _state(sd, cfg, device)
    qp = quantize.load_qparams(qpath)
    head, out["int8_rows"] = net.head_from_features, []

    def recorded_head(ief_, consts_, feat, *args):  # the rows this rank serves
        out["int8_rows"].append(feat.shape[0])
        return head(ief_, consts_, feat, *args)

    net.head_from_features = recorded_head
    try:
        for impl in INT8_IMPLS:
            with torch.no_grad():
                out[impl] = quantize.quantized_forward(
                    qp, served.model.ief, consts, torch.from_numpy(batch["image"]), cfg.model, impl, mesh
                )
    finally:
        net.head_from_features = head

    # The 1 x 2 render mesh: rows of every image over the two ranks.
    mesh2 = render_sp.render_mesh(1, 2, device)
    rows = render_sp.constrainer(mesh2)
    gen = torch.Generator().manual_seed(5)
    verts2d = torch.rand((2, 864, 2), generator=gen) * SIZE
    target = (torch.rand((2, SIZE, SIZE), generator=gen) > 0.5).float()
    out["sp_render"] = render_sp.rasterize_spatial(verts2d, consts.part_layout, cfg.model.raster, mesh2)
    out["sp_loss_grad"] = render_sp.spatial_render_loss_grad(
        verts2d, target, consts.part_layout, cfg.model.raster, mesh2
    )
    out["sp_total"] = _fused(_sep(dataclasses.replace(cfg, render_devices=2)), device)
    out["dp_sep_total"] = _fused(_sep(cfg), device)

    hard = _hard_case(consts)
    out["hard_band"] = raster_hard.hard_raster(*hard, with_shade=True, rows=rows)
    out["hard_band_culled"] = raster_hard.hard_raster(*hard, k_faces=HARD_K_FACES, rows=rows)
    out["rank"] = mesh.rank
    return out


def _hard_case(consts):
    """Two bodies at 64², the tiny asset's faces: (verts2d, z, consts, size)."""
    v = _asset().v_template[None] + 0.02 * np.random.RandomState(4).randn(2, 864, 3).astype(np.float32)
    v2d = ((v[..., :2] / (np.abs(v[..., :2]).max() + 0.3)) + 1.0) * 0.5 * 63
    return torch.from_numpy(v2d).float(), torch.from_numpy(v[..., 2]).float(), consts.hard, 64


@pytest.fixture(scope="module")
def runs(tiny_asset, tmp_path_factory):
    # JAX only here: spawned ranks import this module.
    import jax
    import jax.numpy as jnp

    from indirect_learning_pose_shape_tpu import configs as jconfigs
    from indirect_learning_pose_shape_tpu import train as jtrain
    from indirect_learning_pose_shape_tpu.data import synthetic as jsyn
    from indirect_learning_pose_shape_tpu.models import encoder as jenc
    from indirect_learning_pose_shape_tpu.models import ief as jief
    from indirect_learning_pose_shape_tpu.models import network as jnet
    from indirect_learning_pose_shape_tpu.models import quantize as jquant
    from indirect_learning_pose_shape_tpu.ops import raster as jraster
    from indirect_learning_pose_shape_tpu.parallel import mesh as jmesh

    jmodel = jnet.ModelConfig(
        image_size=SIZE,
        encoder=jenc.EncoderConfig(depth=18, width=16, compute_dtype=jnp.float32),
        ief=jief.IEFConfig(hidden_dims=(128,)),
        raster=jraster.RasterConfig(image_size=SIZE, num_parts=24),
    )
    jcfg = jconfigs.TrainConfig(model=jmodel, batch_size=BATCH)
    jts, jconsts = jtrain.init_state(jcfg, tiny_asset)
    params, state = jax.tree.map(np.asarray, (jts.params, jts.model_state))
    # Bodies in frame (a small output layer), predictions that vary per image.
    last = params["ief"]["layers"][-1]
    last["w"] = (np.random.RandomState(0).randn(*last["w"].shape) * 2e-4).astype(np.float32)
    batch = jax.tree.map(np.asarray, jax.jit(
        lambda k: jsyn.generate_batch(k, BATCH, jconsts, jmodel, jcfg.synthetic)
    )(jax.random.PRNGKey(3)))
    # Uneven visibility: shard 0 sees every keypoint, shard 1 three of each.
    vis = np.zeros_like(batch["kp_vis"])
    vis[:2] = 1.0
    vis[2:, :3] = 1.0
    batch["kp_vis"] = vis

    (jloss, (jterms, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p, s: jtrain.loss_and_metrics(p, s, jconsts, batch, jcfg), has_aux=True
    ))(params, state)
    mesh = jmesh.make_mesh(2)
    jts = dataclasses.replace(jts, params=jax.tree.map(jnp.asarray, params))
    _, jstep = jtrain.compile_train_fns(jcfg, jmesh.replicate_pytree(jconsts, mesh), mesh)
    _, jmesh_terms = jstep(jmesh.replicate_pytree(jts, mesh), jmesh.shard_batch_pytree(batch, mesh))
    ref = {
        "loss": float(jloss),
        "mesh_loss": float(jmesh_terms["total"]),
        "terms": {k: float(v) for k, v in jterms.items()},
        "grads": convert.jax_to_state_dict(jax.tree.map(np.asarray, jgrads), state),
    }

    sd = convert.jax_to_state_dict(params, state)
    cfg = _cfg()
    ts, consts = _state(sd, cfg, "cpu")
    tbatch = {k: torch.tensor(v) for k, v in batch.items()}
    one_sd = sd
    one = _snapshot(ts, train.train_step(ts, tbatch, consts, cfg))
    fresh, _ = _state(sd, cfg, "cpu")
    one["kp2d"] = net.forward(fresh.model, consts, tbatch["image"], cfg.model, train=True)["kp2d"].detach()

    arrays = dataset_lib.make_synthetic_dataset(None, 12, source_size=48, asset=_asset(), device="cpu")
    ts, values = train.fit_dataset(_aug(cfg), dataset_lib.NpzDataset(arrays, BATCH), FIT_STEPS, _asset(), "cpu")
    one["fit"] = {"values": values, "state": ts.model.state_dict()}
    ts, consts = train.init_state(cfg, _asset(), "cpu")
    one["stream_batch"] = train.make_batch(cfg.seed, 0, BATCH, consts, cfg)
    one["stream_total"] = float(train.fused_step(ts, consts, cfg)["total"])
    one["consts"] = consts
    one["sd"] = one_sd

    preprocessed = [
        {k: train.make_batch(cfg.seed, i, BATCH, consts, cfg)[k].numpy() for k in PREPROCESSED_KEYS}
        for i in range(FIT_STEPS)
    ]
    ts, values = train.fit_preprocessed(cfg, _Preprocessed(preprocessed), FIT_STEPS, _asset(), "cpu")
    one["preprocessed"] = {"values": values, "state": ts.model.state_dict(), "batches": preprocessed}

    # int8: the port calibrates and writes the file; the reference reads it.
    served, consts = _state(sd, cfg, "cpu")
    qpath = str(tmp_path_factory.mktemp("int8") / "q.npz")
    quantize.save_qparams(qpath, quantize.ptq_quantize(served.model.encoder, tbatch["image"]))
    jqp = jquant.load_qparams(qpath)
    for impl in INT8_IMPLS:
        with torch.no_grad():
            one[impl] = quantize.quantized_forward(
                quantize.load_qparams(qpath), served.model.ief, consts, tbatch["image"], cfg.model, impl
            )
        ref[impl] = np.asarray(
            jquant.quantized_forward(jqp, params["ief"], jconsts, batch["image"], jmodel, impl)["kp2d"]
        )

    ranks = mesh_lib.spawn(
        _ranks, 2, backend="gloo", device="cpu",
        args=(sd, batch, arrays, str(tmp_path_factory.mktemp("ckpt")), preprocessed, qpath),
    )
    return ref, one, ranks, tbatch


def _norm_err(a: torch.Tensor, b) -> float:
    b = torch.tensor(b) if isinstance(b, np.ndarray) else b
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


def test_dp_step_equals_one_process(runs):
    """The 2-rank step on the global batch: the loss and its terms (rtol
    1e-5), the all-reduced gradients (1e-4 normalised per leaf) and the BN
    running buffers (1e-5), on both ranks. The parameters after the update
    are the one-process update of the rank's gradients, bitwise: Adam's first
    step, lr·g/(|g| + eps), turns the rounding of a gradient near 0 into up
    to 2·lr, so the update is checked on the same gradients."""
    _, one, ranks, _ = runs
    for r in ranks:
        got = r["dp"]
        assert set(got["terms"]) == set(one["terms"])
        for k, v in one["terms"].items():
            np.testing.assert_allclose(got["terms"][k], v, rtol=1e-5, err_msg=k)
        for k, g in one["grads"].items():
            assert _norm_err(got["grads"][k], g) <= 1e-4, k
        for k, v in one["state"].items():
            if k.endswith((".mean", ".var")):
                np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
        ts, _ = _state(one["sd"], _cfg(), "cpu")
        for k, p in ts.model.named_parameters():
            p.grad = got["grads"][k].clone()
        train.apply_update(ts, _cfg())
        for k, p in ts.model.named_parameters():
            assert torch.equal(p.detach(), got["state"][k]), k
    for k, g in ranks[0]["dp"]["grads"].items():  # every rank updates from the same sum
        assert torch.equal(g, ranks[1]["dp"]["grads"][k]), k


def test_dp_keypoint_loss_is_the_global_ratio(runs):
    """The shards see 32 and 6 visible keypoints: the mean of per-rank
    keypoint_l2 ratios is not the global ratio, and the mesh step's `kp`
    is the global one (rtol 1e-5)."""
    _, one, ranks, tbatch = runs
    kp = [
        float(losses.keypoint_l2(one["kp2d"][rows], tbatch["kp2d"][rows], tbatch["kp_vis"][rows], SIZE))
        for rows in (slice(0, 2), slice(2, 4))
    ]
    glob = one["terms"]["kp"]
    assert abs(np.mean(kp) - glob) > 1e-2 * glob, (kp, glob)
    for r in ranks:
        np.testing.assert_allclose(r["dp"]["terms"]["kp"], glob, rtol=1e-5)


def test_dp_step_matches_jax(runs):
    """Against the reference on the same injected global batch and converted
    parameters: its single-device loss and terms and its 2-device mesh
    step's loss (rtol 1e-3), its gradients (1e-3 normalised per leaf)."""
    ref, _, ranks, _ = runs
    got = ranks[0]["dp"]
    np.testing.assert_allclose(got["terms"]["total"], ref["loss"], rtol=1e-3)
    np.testing.assert_allclose(got["terms"]["total"], ref["mesh_loss"], rtol=1e-3)
    for k, v in ref["terms"].items():
        np.testing.assert_allclose(got["terms"][k], v, rtol=1e-3, atol=1e-7, err_msg=k)
    assert set(got["grads"]) <= set(ref["grads"])
    for k, g in got["grads"].items():
        assert _norm_err(g, ref["grads"][k]) <= 1e-3, k


def test_stream_batch_is_rows_of_the_global_batch(runs):
    """`make_batch` under the mesh draws the global batch and renders the
    rank's rows: the rows of the one-process batch (images within 1e-5,
    labels on all but 0.5% of pixels: the bf16 target scores may round the
    other way at a class boundary); the fused step's loss within rtol 1e-4."""
    _, one, ranks, _ = runs
    for r, rows in zip(ranks, (slice(0, 2), slice(2, 4))):
        got, want = r["stream_batch"], one["stream_batch"]
        assert set(got) == set(want)
        for k in ("image", "kp2d", "kp_vis", "gt_pose", "gt_betas"):
            np.testing.assert_allclose(got[k].numpy(), want[k][rows].numpy(), atol=1e-5, err_msg=k)
        agree = (got["part_labels"] == want["part_labels"][rows]).float().mean()
        assert agree >= 0.995
        np.testing.assert_allclose(r["stream_total"], one["stream_total"], rtol=1e-4)


def _same_run(got: dict, want: dict) -> None:
    """A multi-rank `fit_*` run against one process's: the last terms (rtol
    1e-4) and the BN running buffers (1e-4 normalised per leaf). Parameters:
    Adam moves each by at most lr a step, and the rounding of a gradient
    near 0 can flip its sign, so each differs by at most 2·lr·steps, and on
    average by under lr / 100."""
    lr = _cfg().learning_rate
    for k, v in want["values"].items():
        np.testing.assert_allclose(got["values"][k], v, rtol=1e-4, err_msg=k)
    for k, v in want["state"].items():
        d = (got["state"][k] - v).abs()
        if k.endswith((".mean", ".var")):  # statistics of those parameters' activations
            assert _norm_err(got["state"][k], v) <= 1e-4, k
        else:
            assert float(d.max()) <= 2 * lr * FIT_STEPS and float(d.mean()) <= lr / 100, k


def test_fit_dataset_two_ranks_equals_one_process(runs):
    """`fit_dataset` with augmentation, 4 steps over 2 ranks (each staging
    its rows; the augmentation draws the global batch's) against one
    process (`_same_run`)."""
    _, one, ranks, _ = runs
    for r in ranks:
        _same_run(r["fit"], one["fit"])


def test_fit_preprocessed_two_ranks_equals_one_process(runs):
    """`fit_preprocessed`, 4 steps over 2 ranks, against one process
    (`_same_run`); each rank's steps took its rows of the stream's global
    batches (a rank on the whole batch would give the same terms: means of
    equal means, and Adam's update of a doubled gradient)."""
    _, one, ranks, _ = runs
    for r, rows in zip(ranks, (slice(0, 2), slice(2, 4))):
        _same_run(r["preprocessed"], one["preprocessed"])
        staged = r["preprocessed"]["staged"]
        assert len(staged) == FIT_STEPS
        for image, batch in zip(staged, one["preprocessed"]["batches"]):
            assert torch.equal(image, torch.from_numpy(batch["image"][rows]))


@pytest.mark.parametrize("impl", INT8_IMPLS)
def test_int8_serving_sharded_matches_single(runs, impl):
    """`quantized_forward` on the 2 x 1 mesh: each rank runs its rows and
    returns the whole request's outputs, within 1e-5 of the port's one
    process, and `kp2d`
    within the reference's 2e-3 of its single-device result on the same
    qparams file (tests/test_sharding.py)."""
    ref, one, ranks, _ = runs
    for r in ranks:
        assert r["int8_rows"] == [BATCH // 2] * len(INT8_IMPLS)  # each rank served its rows
        assert set(r[impl]) == set(one[impl])
        for k, v in one[impl].items():
            assert r[impl][k].shape == v.shape, k
            np.testing.assert_allclose(r[impl][k].numpy(), v.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(r[impl]["kp2d"].numpy(), ref[impl], rtol=2e-3, atol=2e-3)


def test_int8_serving_refuses_an_indivisible_batch():
    """A request the data axis does not divide is refused, naming both
    sizes, before any collective (a mesh object alone, no process group)."""
    cfg = _cfg().model
    model, consts = net.init(_asset(), cfg, device="cpu")
    qp = quantize.ptq_quantize(model.encoder, torch.zeros(2, SIZE, SIZE, 3))
    mesh = mesh_lib.Mesh(world=2, rank=0, n_data=2, n_render=1, device=torch.device("cpu"), backend="gloo",
                         world_group=None, data_group=None, render_group=None)
    with pytest.raises(ValueError, match=r"global batch 3 not divisible by the data axis \(2\)"):
        quantize.quantized_forward(qp, model.ief, consts, torch.zeros(3, SIZE, SIZE, 3), cfg, mesh=mesh)


def test_resumed_two_rank_run_equals_straight_run(runs):
    """Stopped at step 2 (rank 0's checkpoint) and resumed to 4 by every
    rank: bitwise the straight 2-rank run."""
    _, _, ranks, _ = runs
    for r in ranks:
        assert r["resumed"]["step"] == FIT_STEPS
        assert r["resumed"]["values"] == r["fit"]["values"]
        for k, v in r["fit"]["state"].items():
            assert torch.equal(r["resumed"]["state"][k], v), k


def test_row_sharded_render_equals_local(runs):
    """1 x 2 render mesh: each rank's rows of probs and silhouette within
    1e-6 of the local render; the BCE loss (rtol 1e-6) and its vertex
    gradient, summed over the render group, within 1e-5 of the local ones."""
    _, one, ranks, _ = runs
    consts, rcfg = one["consts"], _cfg().model.raster
    gen = torch.Generator().manual_seed(5)
    verts2d = (torch.rand((2, 864, 2), generator=gen) * SIZE).requires_grad_(True)
    target = (torch.rand((2, SIZE, SIZE), generator=gen) > 0.5).float()
    local = raster.soft_rasterize(verts2d, consts.part_layout, rcfg, impl="separable")
    loss = losses.silhouette_bce(local["silhouette"], target)
    (grad,) = torch.autograd.grad(loss, verts2d)
    for r in ranks:
        band = slice(r["rank"] * SIZE // 2, (r["rank"] + 1) * SIZE // 2)
        for k in ("probs", "silhouette"):
            assert r["sp_render"][k].shape[1] == SIZE // 2
            np.testing.assert_allclose(
                r["sp_render"][k].numpy(), local[k][:, band].detach().numpy(), atol=1e-6, err_msg=k
            )
        sp_loss, sp_grad = r["sp_loss_grad"]
        np.testing.assert_allclose(float(sp_loss), float(loss.detach()), rtol=1e-6)
        np.testing.assert_allclose(sp_grad.numpy(), grad.numpy(), atol=1e-5)


def test_sp_train_step_equals_dp_step(runs):
    """From fresh same-seed states on the step-0 batch, the 1 x 2 SP step
    (both renders row-sharded) and the 2 x 1 DP step, both on the separable
    raster: the same loss within rtol 1e-5."""
    _, _, ranks, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["sp_total"], r["dp_sep_total"], rtol=1e-5)


@pytest.mark.parametrize("k_faces", [None, HARD_K_FACES])
def test_hard_raster_bands_equal_dense(runs, k_faces):
    """The hard raster at 64² in two tile bands, every face in every tile
    or culled to `k_faces` a tile: each band's labels, silhouette, depth
    (and shade) equal to the whole render's rows exactly; a band's
    overflow is at most the whole render's."""
    _, one, ranks, _ = runs
    whole = raster_hard.hard_raster(*_hard_case(one["consts"]), k_faces=k_faces, with_shade=k_faces is None)
    key = "hard_band" if k_faces is None else "hard_band_culled"
    for r in ranks:
        band = slice(r["rank"] * 32, (r["rank"] + 1) * 32)
        for k in ("part_labels", "silhouette", "zbuf") + (("shade",) if k_faces is None else ()):
            assert torch.equal(r[key][k], whole[k][:, band]), k
        assert int(r[key]["overflow"]) <= int(whole["overflow"])
    assert whole["silhouette"].mean() > 0.05
