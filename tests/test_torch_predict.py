"""PyTorch port, the predict CLI and its writers: `save_obj` byte-equal and
`shade_mesh` array-equal to the JAX reference's, `load_image_files` equal
to the reference's with and without masks, and `predict.main --demo --int8
--qparams --device cpu` on a small preset writing meshes and overlays.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu import predict as jpredict
from indirect_learning_pose_shape_tpu_torch import configs, predict
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import quantize as q
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib

SIZE = 32


def _mesh(tiny_asset, seed=0):
    rng = np.random.RandomState(seed)
    verts = (tiny_asset.v_template + 0.01 * rng.randn(*tiny_asset.v_template.shape)).astype(np.float32)
    verts2d = (verts[:, :2] * 20 + SIZE / 2).astype(np.float32)
    return verts, verts2d


def test_save_obj_bytes_equal_jax(tiny_asset, tmp_path):
    verts, _ = _mesh(tiny_asset)
    predict.save_obj(str(tmp_path / "port.obj"), verts, tiny_asset.faces)
    jpredict.save_obj(str(tmp_path / "jax.obj"), verts, tiny_asset.faces)
    assert (tmp_path / "port.obj").read_bytes() == (tmp_path / "jax.obj").read_bytes()


@pytest.mark.parametrize("light", [(0.35, -0.5, 0.79), (0.0, 0.0, 1.0)])
def test_shade_mesh_equals_jax(tiny_asset, light):
    verts, verts2d = _mesh(tiny_asset, seed=1)
    got = predict.shade_mesh(verts2d, verts[:, 2], tiny_asset.faces, SIZE, light)
    ref = jpredict.shade_mesh(verts2d, verts[:, 2], tiny_asset.faces, SIZE, light)
    np.testing.assert_array_equal(got, ref)
    assert (got > 0).mean() > 0.05


@pytest.mark.parametrize("with_mask", [True, False])
def test_load_image_files_equals_jax(tmp_path, with_mask):
    from PIL import Image

    rng = np.random.RandomState(0)
    paths, masks = [], []
    for i, (h, w) in enumerate(((80, 60), (50, 70))):
        mask = np.zeros((h, w), np.uint8)
        mask[10 + i : h - 12, 8 : w - 9 - i] = 3
        paths.append(str(tmp_path / f"im{i}.png"))
        masks.append(str(tmp_path / f"mask{i}.png"))
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(paths[-1])
        Image.fromarray(mask).save(masks[-1])
    m = masks if with_mask else None
    got = predict.load_image_files(paths, m, SIZE)
    ref = jpredict.load_image_files(paths, m, SIZE)
    assert got.shape == (2, SIZE, SIZE, 3) and got.dtype == np.float32
    # The same boxes and taps. The reference's native library is built with
    # -O3 -march=native, which contracts its lerps into FMAs; the port's is
    # built to equal its numpy version bitwise: up to 1e-5 apart on [-1, 1]
    # (1.3e-3 of a 0-255 level).
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="count"):
        predict.load_image_files(paths, masks[:1], SIZE)


def _small_preset():
    model = net.ModelConfig(
        image_size=SIZE,
        encoder=enc.EncoderConfig(depth=18, width=16, fold_bn_eval=True),
        ief=ief.IEFConfig(hidden_dims=(64,)),
        raster=raster.RasterConfig(image_size=SIZE),
    )
    return dataclasses.replace(configs.CONFIG4_FULL, model=model)


def _read_obj(path):
    lines = open(path).read().splitlines()
    v = np.array([[float(t) for t in ln.split()[1:]] for ln in lines if ln.startswith("v ")])
    f = np.array([[int(t) - 1 for t in ln.split()[1:]] for ln in lines if ln.startswith("f ")])
    return v, f


def test_main_demo_int8_writes_meshes_and_overlays(tiny_asset, tmp_path, monkeypatch, capsys):
    cfg = _small_preset()
    monkeypatch.setitem(configs.PRESETS, "config4_full", cfg)
    monkeypatch.setattr(assets_lib, "load_asset", lambda *a, **k: tiny_asset)
    qpath, out = str(tmp_path / "q.npz"), str(tmp_path / "vis")
    argv = ["--demo", "--num", "2", "--int8", "--qparams", qpath, "--out", out, "--device", "cpu"]
    assert predict.main(argv) == 0
    assert "wrote quantized encoder" in capsys.readouterr().out and os.path.exists(qpath)
    meshes = []
    for i in range(2):
        v, f = _read_obj(os.path.join(out, f"mesh_{i}.obj"))
        assert v.shape == (tiny_asset.num_verts, 3) and np.isfinite(v).all()
        np.testing.assert_array_equal(f, tiny_asset.faces)
        assert os.path.getsize(os.path.join(out, f"overlay_{i}.png")) > 1000
        meshes.append(open(os.path.join(out, f"mesh_{i}.obj")).read())

    # The CLI's meshes are `predict` with the file's qparams ('int8c') on
    # the demo images.
    model, consts = predict.load_model(cfg.model, asset=tiny_asset, seed=cfg.seed, device="cpu")
    images = predict.synthetic_images(consts, cfg.model, 2, seed=0)
    want = predict.predict(model, consts, images, cfg.model, qparams=q.load_qparams(qpath))
    v0, _ = _read_obj(os.path.join(out, "mesh_0.obj"))
    np.testing.assert_allclose(v0, want["verts"][0].numpy(), atol=1e-6)

    # A second run reads the file instead of calibrating, and writes the same meshes.
    assert predict.main(argv + ["--no-overlays"]) == 0
    assert "wrote quantized encoder" not in capsys.readouterr().out
    assert [open(os.path.join(out, f"mesh_{i}.obj")).read() for i in range(2)] == meshes


def test_predict_qparams_routes_through_int8(tiny_asset):
    cfg = _small_preset().model
    model, consts = predict.load_model(cfg, asset=tiny_asset, device="cpu")
    images = predict.synthetic_images(consts, cfg, 2, seed=3)
    qp = q.ptq_quantize(model.encoder, images)
    for impl in ("int8", "int8c"):
        got = predict.predict(model, consts, images, cfg, qparams=qp, int8_impl=impl)
        want = q.quantized_forward(qp, model.ief, consts, images, cfg, impl)
        for k in ("theta", "verts", "kp2d"):
            assert torch.equal(got[k], want[k].detach()), (impl, k)
    float_out = predict.predict(model, consts, images, cfg)
    assert not torch.equal(got["theta"], float_out["theta"])
