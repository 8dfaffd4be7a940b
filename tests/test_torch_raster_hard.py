"""PyTorch port, hard targets and appearance: `raster_hard` against the JAX
reference and the float64 oracle (dense and culled modes, the overflow
count, the culling order), and the synthetic stream's `hard` and `hardapp`
batches rendered from the reference's own draws against its
`generate_batch`; the texture background against `jax.image.resize`; the
default stream bitwise as before.
"""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.data import synthetic as jsyn
from indirect_learning_pose_shape_tpu.models import network as jnet
from indirect_learning_pose_shape_tpu.ops import raster as jraster
from indirect_learning_pose_shape_tpu.ops import raster_hard as jrh
from indirect_learning_pose_shape_tpu_torch import configs, train
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.ops import raster, raster_hard

SIZE, BATCH = 64, 2
# Labels of two renders of the same vertices (JAX against the port, or the
# card against the CPU) may differ only at float32 rounding on shared edges;
# against the float64 oracle, as the reference's own test.
LABEL_AGREE = 0.999
ORACLE_AGREE = 0.995
SHADE_TOL = 1e-5


@pytest.fixture(scope="module")
def scene(tiny_asset):
    """Two jittered rest bodies filling a 64² canvas (the reference test's
    fixture), the hard consts of both frameworks, and a light per image."""
    rng = np.random.RandomState(42)
    v = tiny_asset.v_template[None] + 0.02 * rng.randn(BATCH, *tiny_asset.v_template.shape).astype(np.float32)
    v2d = (((v[..., :2] / (np.abs(v[..., :2]).max() + 0.3)) + 1.0) * 0.5 * (SIZE - 1)).astype(np.float32)
    vz = v[..., 2].astype(np.float32)
    light = np.array([0.35, -0.5, 0.79], np.float32) + 0.6 * rng.randn(BATCH, 3).astype(np.float32)
    vlabels = np.minimum(tiny_asset.part_labels(), 23)
    jhc = jrh.build_hard_consts(tiny_asset.faces, vlabels)
    hc = raster_hard.build_hard_consts(tiny_asset.faces, vlabels)
    return v2d, vz, light, jhc, hc


def _port(scene, **kw):
    v2d, vz, light, _, hc = scene
    out = raster_hard.hard_raster(torch.from_numpy(v2d), torch.from_numpy(vz), hc, SIZE,
                                  light=torch.from_numpy(light), **kw)
    return {k: v.numpy() for k, v in out.items()}


def _jax(scene, **kw):
    v2d, vz, light, jhc, _ = scene
    out = jax.jit(lambda a, b, l: jrh.hard_raster(a, b, jhc, SIZE, light=l, **kw))(v2d, vz, light)
    return {k: np.asarray(v) for k, v in out.items()}


def test_build_hard_consts_matches_jax(scene):
    *_, jhc, hc = scene
    np.testing.assert_array_equal(hc.faces.numpy(), np.asarray(jhc.faces))
    np.testing.assert_array_equal(hc.face_class.numpy(), np.asarray(jhc.face_class))
    assert hc.face_class.dtype == torch.int32
    # Majority of three corners, corner 0 when all differ.
    got = raster_hard.build_hard_consts(np.array([[0, 1, 2], [0, 1, 2], [0, 1, 2]]), np.array([5, 5, 7]))
    assert raster_hard.build_hard_consts(np.array([[0, 1, 2]]), np.array([4, 6, 6])).face_class.tolist() == [6]
    assert raster_hard.build_hard_consts(np.array([[0, 1, 2]]), np.array([3, 6, 7])).face_class.tolist() == [3]
    assert got.face_class.tolist() == [5, 5, 5]


def test_hard_raster_matches_jax_and_oracle(scene):
    """Dense mode with the shade: labels agree with JAX's on >= 99.9% of
    pixels and with the float64 oracle on >= 99.5%; silhouettes equal; the
    shade within 1e-5; no overflow."""
    got, want = _port(scene, with_shade=True), _jax(scene, with_shade=True)
    v2d, vz, _, _, hc = scene
    assert got["part_labels"].dtype == np.int32 and int(got["overflow"]) == 0
    assert 0.05 < (got["part_labels"] > 0).mean() < 0.9
    assert (got["part_labels"] == want["part_labels"]).mean() >= LABEL_AGREE
    np.testing.assert_array_equal(got["silhouette"], want["silhouette"])
    np.testing.assert_allclose(got["shade"], want["shade"], atol=SHADE_TOL)
    fg = got["silhouette"] > 0
    np.testing.assert_allclose(got["zbuf"][fg], want["zbuf"][fg], atol=1e-5)
    assert (got["shade"][~fg] == 0).all() and (got["shade"][fg] >= 0.25 - 1e-6).all()
    for i in range(BATCH):
        lab, _ = raster_hard.hard_raster_oracle(v2d[i], vz[i], hc.faces.numpy(), hc.face_class.numpy(), SIZE)
        assert (lab == got["part_labels"][i]).mean() >= ORACLE_AGREE
        np.testing.assert_array_equal(lab > 0, fg[i])


@pytest.mark.parametrize("chunk", [7, 64, 1000])
def test_culled_mode_equals_dense(scene, chunk):
    """K = F - 1 slots on 16² tiles keep every face a tile overlaps (the
    machinery on, nothing dropped): exactly the dense render, whatever the
    chunk."""
    F = int(scene[4].faces.shape[0])
    dense = _port(scene, with_shade=True)
    culled = _port(scene, with_shade=True, tile=16, k_faces=F - 1, chunk=chunk)
    assert int(culled["overflow"]) == 0
    for k in ("part_labels", "silhouette", "zbuf", "shade"):
        np.testing.assert_array_equal(culled[k], dense[k], err_msg=k)


def test_overflow_and_culling_order_match_jax(scene):
    """An undersized budget (8 faces a 32² tile) reports JAX's overflow, and
    the faces kept are lax.top_k's (the first overlapping ones in face
    order), so the culled renders agree."""
    got, want = _port(scene, tile=32, k_faces=8), _jax(scene, tile=32, k_faces=8)
    assert int(got["overflow"]) > 0 and int(got["overflow"]) == int(want["overflow"])
    assert (got["part_labels"] == want["part_labels"]).mean() >= LABEL_AGREE
    np.testing.assert_array_equal(got["silhouette"], want["silhouette"])


def test_stable_sort_picks_top_k_faces():
    """The culling's selection on ties: a stable descending sort of a 0/1
    overlap row gives lax.top_k's indices (lower index first)."""
    row = (np.random.RandomState(0).rand(3, 5, 40) > 0.6).astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(row), 7)
    _, got = torch.sort(torch.from_numpy(row), dim=-1, descending=True, stable=True)
    np.testing.assert_array_equal(got[..., :7].numpy(), np.asarray(want))


def test_texture_background_matches_jax_resize():
    """The 8x8 field enlarged to 64² by F.interpolate (bilinear, half-pixel
    centres, no antialias) equals jax.image.resize's bilinear within 1e-6,
    edge rows and columns included."""
    rng = np.random.RandomState(3)
    low = rng.rand(BATCH, 8, 8, 3).astype(np.float32)
    grain = rng.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
    got = synthetic._background(
        {"bg_low": torch.from_numpy(low), "bg_grain": torch.from_numpy(grain)}, "texture", SIZE
    ).numpy()
    up = jax.image.resize(low, (BATCH, SIZE, SIZE, 3), method="bilinear")
    want = np.asarray(jnp.clip(0.8 * up + 0.2 * grain, 0.0, 1.0))
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[:, [0, -1]], want[:, [0, -1]], atol=1e-6)
    np.testing.assert_allclose(got[:, :, [0, -1]], want[:, :, [0, -1]], atol=1e-6)


def _reference_draws(key, scfg, jconsts, C):
    """The reference `generate_batch`'s own random numbers, by its key splits,
    in the port's draw layout."""
    k_theta, k_noise, k_vis = jax.random.split(key, 3)
    pose, betas, cam = jsyn.sample_theta(k_theta, BATCH, jconsts, scfg)
    d = {"pose": pose, "betas": betas, "cam": cam,
         "noise": jax.random.normal(k_noise, (BATCH, SIZE, SIZE, 3)),
         "vis_u": jax.random.uniform(k_vis, (BATCH, 19))}
    k_pal, k_bg, k_light, k_occ = jax.random.split(jax.random.fold_in(key, 0x0A99), 4)
    if scfg.color_jitter:
        d["pal_noise"] = scfg.color_jitter * jax.random.normal(k_pal, (BATCH, C + 1, 3))
    if scfg.bg_mode == "texture":
        k_low, k_grain = jax.random.split(k_bg)
        d["bg_low"] = jax.random.uniform(k_low, (BATCH, 8, 8, 3))
        d["bg_grain"] = jax.random.uniform(k_grain, (BATCH, SIZE, SIZE, 3))
    if scfg.shading:
        d["light"] = jnp.array([0.35, -0.5, 0.79]) + 0.6 * jax.random.normal(k_light, (BATCH, 3))
    occ = []
    for i in range(scfg.occluders):
        k_pos, k_half, k_col = jax.random.split(jax.random.fold_in(k_occ, i), 3)
        occ.append((jax.random.uniform(k_pos, (BATCH, 2), maxval=float(SIZE)),
                    jax.random.uniform(k_half, (BATCH, 2), minval=0.04 * SIZE,
                                       maxval=scfg.occluder_size * SIZE),
                    jax.random.uniform(k_col, (BATCH, 1, 1, 3)).reshape(BATCH, 3)))
    if occ:
        for j, name in enumerate(("occ_centre", "occ_half", "occ_color")):
            d[name] = jnp.stack([o[j] for o in occ])
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("suite", ["hard", "hardapp"])
def test_render_batch_matches_jax(tiny_asset, suite):
    """The reference's batch and the port's, rendered from the reference's
    draws: labels on >= 99.9% of pixels, silhouettes and the masks that
    follow, keypoints; the image within 1e-5 where the labels agree."""
    specs = jsyn.EVAL_SUITES[suite]
    jcfg = jnet.ModelConfig(image_size=SIZE, raster=jraster.RasterConfig(image_size=SIZE),
                            smpl_impl="xla", raster_impl="xla")
    jconsts = jnet.build_consts(tiny_asset, jcfg)
    jscfg = jsyn.apply_overrides(jsyn.SyntheticConfig(), specs)
    key = jax.random.PRNGKey(5)
    ref = jax.tree.map(np.asarray, jax.jit(
        lambda k: jsyn.generate_batch(k, BATCH, jconsts, jcfg, jscfg))(key))

    cfg = net.ModelConfig(image_size=SIZE, raster=raster.RasterConfig(image_size=SIZE))
    consts = net.build_consts(tiny_asset, cfg, device="cpu")
    scfg = synthetic.apply_overrides(synthetic.SyntheticConfig(), specs)
    draws = _reference_draws(key, jscfg, jconsts, cfg.raster.num_parts)
    got = {k: v.numpy() for k, v in synthetic.render_batch(draws, consts, cfg, scfg).items()}

    assert set(got) == set(ref)
    agree = got["part_labels"] == ref["part_labels"]
    assert agree.mean() >= LABEL_AGREE and 0.05 < (ref["part_labels"] > 0).mean() < 0.9
    assert (got["silhouette"] != ref["silhouette"]).mean() <= 1 - LABEL_AGREE
    np.testing.assert_allclose(got["kp2d"], ref["kp2d"], atol=1e-4)
    np.testing.assert_array_equal(got["kp_vis"], ref["kp_vis"])
    np.testing.assert_allclose(got["image"][agree], ref["image"][agree], atol=1e-5)
    if suite == "hardapp":  # the background really is textured
        bg = ref["silhouette"] == 0
        assert np.stack([got["image"][i][bg[i]].std() for i in range(BATCH)]).min() > 0.1


def test_hard_overflow_rides_the_batch(tiny_asset):
    """With `hard_k_faces` the batch carries the culling's overflow (the
    reference drops it), and the step's terms log it; without, neither."""
    cfg = dataclasses.replace(
        configs.CONFIG4_FULL,
        model=net.ModelConfig(image_size=SIZE, raster=raster.RasterConfig(image_size=SIZE)),
        synthetic=synthetic.SyntheticConfig(targets="hard", hard_k_faces=8), batch_size=BATCH,
    )
    consts = net.build_consts(tiny_asset, cfg.model, device="cpu")
    batch = train.make_batch(0, 0, BATCH, consts, cfg)
    assert batch["hard_overflow"].dtype == torch.int32 and int(batch["hard_overflow"]) > 0
    dense = dataclasses.replace(cfg, synthetic=synthetic.SyntheticConfig(targets="hard"))
    assert "hard_overflow" not in train.make_batch(0, 0, BATCH, consts, dense)
    model, _ = net.init(tiny_asset, cfg.model, device="cpu")
    _, terms = train.loss_and_metrics(model, consts, batch, cfg)
    assert float(terms["hard_overflow"]) == float(batch["hard_overflow"])


def test_shading_requires_hard_targets(tiny_asset):
    cfg = net.ModelConfig(image_size=32, raster=raster.RasterConfig(image_size=32))
    consts = net.build_consts(tiny_asset, cfg, device="cpu")
    scfg = synthetic.SyntheticConfig(shading=0.5)
    draws = synthetic.sample_draws(torch.Generator().manual_seed(0), 1, consts, scfg, 32)
    with pytest.raises(ValueError, match="shading"):
        synthetic.render_batch(draws, consts, cfg, scfg)


# sha256 of the default stream's batch (seed 7, step 3, batch 2, 32², the
# tiny asset, config4_mixed's 3D targets) as the port drew it before the
# appearance draws existed.
_DEFAULT_STREAM_SHA256 = "c6827716a1565e21d24442176525abe1afc5c67efa24fdeda8e1299d11540d25"


def test_default_stream_is_unchanged(tiny_asset):
    """With every knob off the stream is bitwise what it was, so quality
    numbers stay comparable: the same draws (no appearance draws) and the same
    batch; hard targets alone draw nothing more."""
    model = dataclasses.replace(configs.CONFIG4_MIXED.model, image_size=32,
                                raster=raster.RasterConfig(image_size=32))
    cfg = dataclasses.replace(configs.CONFIG4_MIXED, model=model, batch_size=2)
    consts = net.build_consts(tiny_asset, cfg.model, device="cpu")
    batch = train.make_batch(7, 3, 2, consts, cfg)
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(batch[k].contiguous().numpy().tobytes())
    assert h.hexdigest() == _DEFAULT_STREAM_SHA256
    for scfg in (synthetic.SyntheticConfig(), synthetic.SyntheticConfig(targets="hard")):
        draws = synthetic.sample_draws(torch.Generator().manual_seed(1), 2, consts, scfg, 32)
        assert set(draws) == {"pose", "betas", "cam", "noise", "vis_u"}
    hard = dataclasses.replace(cfg, synthetic=synthetic.SyntheticConfig(targets="hard"))
    assert torch.equal(train.make_batch(7, 3, 2, consts, hard)["gt_pose"], batch["gt_pose"])
