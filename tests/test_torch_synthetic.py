"""PyTorch port, synthetic soft-target batches: `render_batch` from the
reference's own draws against `generate_batch(key)` (SMPL and raster
through the Pallas kernels, interpret mode, at 128²), the palette table
against `_part_palette`, the draws, and the refusals.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.data import synthetic as jsyn
from indirect_learning_pose_shape_tpu.models import network as jnet
from indirect_learning_pose_shape_tpu.ops import raster as jraster
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import smpl
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster

SIZE, BATCH = 128, 3


@pytest.mark.parametrize("n", [25, 32])
def test_palette_matches_jax(n):
    want = np.asarray(jsyn._part_palette(n))
    got = synthetic.part_palette(n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_palette_refuses_other_channel_counts():
    with pytest.raises(ValueError, match="25 and 32"):
        synthetic.part_palette(10)


@pytest.mark.parametrize("field, value", [
    ("targets", "hard"), ("bg_mode", "texture"), ("color_jitter", 0.08),
    ("shading", 0.6), ("occluders", 2),
])
def test_unported_appearance_is_refused(field, value):
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        synthetic.SyntheticConfig(**{field: value})


@pytest.fixture(scope="module")
def batches(tiny_asset):
    """The reference's batch and the port's batch rendered from the
    reference's draws, plus the port's bf16 target scores."""
    jcfg = jnet.ModelConfig(
        image_size=SIZE, raster=jraster.RasterConfig(image_size=SIZE, num_parts=24),
        smpl_impl="pallas", raster_impl="pallas",
    )
    jconsts = jnet.build_consts(tiny_asset, jcfg)
    scfg = jsyn.SyntheticConfig()
    key = jax.random.PRNGKey(7)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda k: jsyn.generate_batch(k, BATCH, jconsts, jcfg, scfg, include_3d=True)
    )(key))
    # generate_batch's own splits: (theta, noise, visibility), then sample_theta's.
    k_theta, k_noise, k_vis = jax.random.split(key, 3)
    pose, betas, cam = jsyn.sample_theta(k_theta, BATCH, jconsts, scfg)
    draws = {
        "pose": pose, "betas": betas, "cam": cam,
        "noise": jax.random.normal(k_noise, (BATCH, SIZE, SIZE, 3)),
        "vis_u": jax.random.uniform(k_vis, (BATCH, 19)),
    }
    draws = {k: torch.from_numpy(np.asarray(v)) for k, v in draws.items()}

    cfg = net.ModelConfig(image_size=SIZE, raster=raster.RasterConfig(image_size=SIZE, num_parts=24))
    consts = net.build_consts(tiny_asset, cfg, device="cpu")
    got = synthetic.render_batch(draws, consts, cfg, synthetic.SyntheticConfig(), include_3d=True)
    with torch.no_grad():
        verts = smpl.smpl_forward(consts.smpl, draws["pose"], draws["betas"])["verts"]
        v2 = camera.project_pixel(verts, draws["cam"], SIZE)
        score = raster.raster_scores_cf(v2, consts.part_layout, cfg.raster, out_dtype=torch.bfloat16)
    return ref, got, score.float().numpy()


def test_render_batch_matches_jax(batches):
    ref, got, score = batches
    # The draws were rebuilt eagerly; inside the jitted generate_batch XLA
    # fuses std * normal and may round one ulp apart.
    for k in ("gt_pose", "gt_betas", "gt_cam"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(got["kp2d"].numpy(), ref["kp2d"], atol=1e-4)
    np.testing.assert_array_equal(got["kp_vis"].numpy(), ref["kp_vis"])
    assert got["part_labels"].dtype == torch.int32 and got["image"].dtype == torch.float32
    assert 0.05 < float(got["silhouette"].mean()) < 0.9  # bodies in frame

    # Labels and silhouette are exact except where bf16 rounding ties decide:
    # the two largest bf16 class scores equal, or the largest (or the class
    # sum) within one bf16 step of bg_gamma = 1.
    top2 = np.sort(score, axis=1)[:, -2:]
    tie = (top2[:, 1] == top2[:, 0]) | (np.abs(top2[:, 1] - 1.0) <= 2 ** -7)
    lab_diff = got["part_labels"].numpy() != ref["part_labels"]
    assert not (lab_diff & ~tie).any(), int((lab_diff & ~tie).sum())
    s_total = score.sum(axis=1)
    sil_diff = got["silhouette"].numpy() != ref["silhouette"]
    assert not (sil_diff & (np.abs(s_total - 1.0) > 1e-2)).any()
    assert lab_diff.mean() < 1e-3 and sil_diff.mean() < 1e-3
    # The bf16 palette mix rounds at other places in the two frameworks.
    np.testing.assert_allclose(got["image"].numpy(), ref["image"], atol=1e-2)


def test_include_3d_matches_jax(batches):
    """The direct-supervision targets (`include_3d`): SMPL joints and
    vertices of the sampled pose and shape, and the rotation matrices of
    the sampled axis-angle pose."""
    ref, got, _ = batches
    for k, atol in (("gt_joints3d", 1e-5), ("gt_verts", 1e-5), ("gt_rotmats", 1e-6)):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), ref[k], atol=atol, err_msg=k)


@pytest.mark.parametrize("specs", [
    ["pose_std=0.35"], ["cam_scale_range=0.5,1.3", "kp_visibility=0.8"], ["image_noise=0"],
])
def test_apply_overrides_matches_jax(specs):
    got = synthetic.apply_overrides(synthetic.SyntheticConfig(), specs)
    want = jsyn.apply_overrides(jsyn.SyntheticConfig(), specs)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_eval_suites_and_override_refusals():
    assert synthetic.EVAL_SUITES == jsyn.EVAL_SUITES
    base = synthetic.SyntheticConfig()
    assert synthetic.apply_overrides(base, synthetic.EVAL_SUITES["plain"]) == base
    for name in ("hard", "hardapp"):
        with pytest.raises(NotImplementedError, match="item 12"):
            synthetic.apply_overrides(base, synthetic.EVAL_SUITES[name])
    for bad in ("nope=1", "pose_std", "cam_scale_range=1", "targets=soft2", "pose_std=x"):
        with pytest.raises(ValueError, match="synthetic override"):
            synthetic.apply_overrides(base, [bad])


def test_sample_draws_are_seeded(tiny_asset):
    cfg = net.ModelConfig(image_size=32, raster=raster.RasterConfig(image_size=32))
    consts = net.build_consts(tiny_asset, cfg, device="cpu")
    scfg = dataclasses.replace(synthetic.SyntheticConfig(), cam_scale_range=(0.7, 0.8))
    a, b, c = (
        synthetic.sample_draws(torch.Generator().manual_seed(s), 4, consts, scfg, 32)
        for s in (5, 5, 6)
    )
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pose"], c["pose"])
    assert a["pose"].shape == (4, 72) and a["noise"].shape == (4, 32, 32, 3)
    assert a["vis_u"].shape == (4, 19) and a["betas"].shape == (4, tiny_asset.num_betas)
    assert float(a["cam"][:, 0].min()) >= 0.7 and float(a["cam"][:, 0].max()) <= 0.8
    # Global orientation is drawn with global_std, the body joints with pose_std.
    assert float(a["pose"][:, :3].abs().max()) < 6 * scfg.global_std
