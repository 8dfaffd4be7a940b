"""PyTorch port, the serialized artifact (export.py, tools/export_model.py):
`torch.export` of the float forward and of the int8-encoder forward, saved
to bytes, loaded back and called, against the live forward on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu_torch import configs, export, predict
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import ief
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import quantize as q
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.tools import export_model
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib

SIZE = 32


def _preset():
    model = net.ModelConfig(
        image_size=SIZE,
        encoder=enc.EncoderConfig(depth=18, width=8, fold_bn_eval=True),
        ief=ief.IEFConfig(hidden_dims=(32,)),
        raster=raster.RasterConfig(image_size=SIZE),
    )
    return dataclasses.replace(configs.CONFIG4_FULL, model=model)


@pytest.mark.parametrize("kind", ["float", "int8c"])
def test_export_tool_roundtrip_matches_live(tiny_asset, tmp_path, monkeypatch, kind):
    """tools/export_model.py --device cpu writes an artifact; `load_exported`
    runs it, equal to the live forward with the plain SMPL within 1e-5."""
    cfg = _preset()
    monkeypatch.setitem(configs.PRESETS, "config4_full", cfg)
    monkeypatch.setattr(assets_lib, "load_asset", lambda *a, **k: tiny_asset)
    out = str(tmp_path / "m.pt2")
    argv = [out, "--batch", "2", "--device", "cpu"]
    if kind != "float":
        argv += ["--int8", "--int8-impl", kind]
    assert export_model.main(argv) == 0
    fn = export.load_exported(open(out, "rb").read())

    model, consts = predict.load_model(cfg.model, asset=tiny_asset, seed=cfg.seed, device="cpu")
    images = torch.from_numpy(np.random.RandomState(4).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32))
    plain = dataclasses.replace(cfg.model, smpl_impl="torch")
    qparams = None
    if kind != "float":
        calib = predict.synthetic_images(consts, cfg.model, 16, seed=17, synthetic_cfg=cfg.synthetic)
        qparams = q.ptq_quantize(model.encoder, calib)
    want = predict.predict(model, consts, images, plain, qparams=qparams, int8_impl=kind)
    with torch.no_grad():
        theta, verts, kp2d = fn(images)
    for got, k in ((theta, "theta"), (verts, "verts"), (kp2d, "kp2d")):
        np.testing.assert_allclose(got.numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


def test_export_forward_int8_takes_qparams(tiny_asset):
    """`export_forward_int8(qparams=...)` bakes those qparams in (a file's,
    not a fresh calibration's), here with bf16 sites, run per site ('int8')."""
    cfg = _preset().model
    model, consts = net.init(tiny_asset, cfg, seed=3, device="cpu")
    images = predict.synthetic_images(consts, cfg, 2, seed=5)
    qp = q.ptq_quantize(model.encoder, images, keep_sites=("s3",))
    blob = export.export_forward_int8(cfg, model, consts, 2, device="cpu", impl="int8", qparams=qp)
    fn = export.load_exported(blob)
    want = q.quantized_forward(qp, model.ief, consts, images, dataclasses.replace(cfg, smpl_impl="torch"), "int8")
    with torch.no_grad():
        theta, verts, _ = fn(images)
    np.testing.assert_allclose(theta.numpy(), want["theta"].detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(verts.numpy(), want["verts"].detach().numpy(), atol=1e-5)
