"""The HMR 2.0 cell and the ResNet-34 soft cell: they load through `Spec`,
the FLOP counts match hand counts, each new reader reads a synthetic
summary, the weights maker names the port's `state_dict`, and the driver
refuses a preset that differs from the configuration file, then runs the
cell at a tiny size on the CPU (a 64² crop, 12 tokens, width 64, the
864-vertex stand-in, batches of 2, float32 products: the limits are the
bf16 model's at its published size) with `correct` true."""

import dataclasses
import json
import os
import shutil

import pytest
import torch

from portbench import inputs, inputs_vit, run
from portbench.spec import ROOT, Spec
from portbench.work import flops, vit

from indirect_learning_pose_shape_tpu_torch import configs
from indirect_learning_pose_shape_tpu_torch.models import network as net

CELL = "train.hmr2_vith.soft_b48"
NEW = [CELL, "train.config4_mixed.soft_b32"]
READERS = ["mfu.hmr2", "attn_ms.hmr2", "attn_roofline.hmr2", "gemm_ms.hmr2", "other_ms.hmr2",
           "idle_share.hmr2", "attn_fused_share.hmr2"]
TINY_VIT = {"crop_cols": [8, 56], "width": 64, "depth": 2, "num_heads": 4, "head_dim": 16, "mlp_dim": 128,
            "tokens": 12}
TINY_HEAD = {"width": 64, "depth": 2, "num_heads": 4, "head_dim": 16, "mlp_dim": 64, "context_dim": 64}


def _config():
    return json.loads((ROOT / "portbench/configs/hmr2_vith.json").read_text())


def tiny_preset():
    """`hmr2_vith` at the tiny size, in float32."""
    p = configs.HMR2_VITH
    v, h = TINY_VIT, TINY_HEAD
    model = dataclasses.replace(
        p.model, image_size=64, raster=dataclasses.replace(p.model.raster, image_size=64),
        encoder=dataclasses.replace(p.model.encoder, crop_cols=tuple(v["crop_cols"]), width=v["width"],
                                    depth=v["depth"], num_heads=v["num_heads"], mlp_dim=v["mlp_dim"],
                                    compute_dtype=torch.float32),
        head=dataclasses.replace(p.model.head, compute_dtype=torch.float32, **{k: h[k] for k in TINY_HEAD}))
    return dataclasses.replace(p, model=model)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A benchmark root holding the HMR 2.0 cell at the tiny size."""
    tmp = tmp_path_factory.mktemp("bench")
    pb = tmp / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True)
    for sub in ("drivers", "metrics"):
        os.symlink(ROOT / "portbench" / sub, pb / sub)
    cfg = _config()
    cfg["vit"].update(TINY_VIT)
    cfg["head"].update(TINY_HEAD, context_dim=TINY_VIT["width"])
    cfg.update(image_size=64, asset={"num_verts": 864, "seed": 1})
    cfg["precision"].update(encoder="float32", head="float32")
    (pb / "configs/hmr2_vith.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "portbench/traffic/soft_b48.json").read_text())
    traffic.update(batch_size=2, warm_steps=1, trace_steps=1)
    (pb / "traffic/soft_b48.json").write_text(json.dumps(traffic))
    shutil.copy(ROOT / "portbench/limits" / f"{CELL}.json", pb / "limits")
    (tmp / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    return tmp


@pytest.mark.parametrize("workload", NEW)
def test_the_new_cells_load(workload):
    spec = Spec(workload)
    assert spec.workload["chips"] == 1
    assert {m["name"] for m in spec.end_to_end()} == {"train_img_per_s", "setup_s"}
    assert spec.per_layer() and spec.limits


def test_vit_h_forward_flops_by_hand():
    c = _config()
    # ViT-H/16 at 256x192: 192 tokens; a block's GEMMs 1280·(3·1280 + 1280 +
    # 2·5120) multiply-adds a token; attention 2·192²·80 a head, 16 heads;
    # the patch convolution 3·16²·1280 a token.
    n, d = 192, 1280
    blocks = 32 * n * d * (3 * d + d + 2 * 5120)
    attention = 32 * 16 * 2 * n * n * 80
    patch = n * 3 * 256 * d
    assert vit.vit_macs(c["vit"]) == {"patch": patch, "blocks": blocks, "attention": attention}
    assert 2 * blocks / 1e9 == pytest.approx(241.6, abs=0.1)
    assert 2 * attention / 1e9 == pytest.approx(6.04, abs=0.01)
    # The head: the cross-attention's keys and values, 6 x 192 x 1280 x 1024.
    kv = 6 * n * 1280 * 1024
    assert vit.head_macs(c["head"], n, 157)["kv"] == kv and 2 * kv / 1e9 == pytest.approx(3.02, abs=0.01)
    assert vit.forward_flops_per_image(c) / 1e9 == pytest.approx(251.1, abs=0.2)
    assert vit.train_flops_per_image(c) == pytest.approx(
        3 * vit.forward_flops_per_image(c) - 2 * patch + 4 * flops.lbs_flops())
    assert vit.attention_flops_per_image(c) == 3 * (32 * 16 * 4 * n * n * 80 + 6 * 8 * 4 * (1 + n) * 64)


def _summary(kernels: dict, units: int = 2) -> dict:
    from portbench import trace

    cats: dict = {}
    for n, ms in kernels.items():
        cats[trace.category(n)] = cats.get(trace.category(n), 0.0) + ms / units
    return {"units": units, "by_kernel_ms": dict(kernels), "by_category_ms": cats,
            "busy_s": 0.9, "window_s": 1.0}


@pytest.mark.parametrize("metric", READERS)
def test_each_new_reader_reads_a_synthetic_summary(metric):
    summary = _summary({"void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits<80>>": 4.0,
                        "void pytorch_flash::flash_bwd_dq_dk_dv_loop_seqk_parallel_kernel": 8.0,
                        "cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16_knob_3": 8.0,
                        "void cudnn::fusion::compute_dot_do_o<true>(void const*, void const*)": 2.0,
                        "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128": 200.0,
                        "nvjet_tst_256x128_64x4_1x4_h_bz_coopA_NNT": 60.0,
                        "void at::native::vectorized_elementwise_kernel<4>": 40.0})
    extras = {"attn_calls": {"attn.calls.flash_attention": 44, "vit.tokens": 9216},
              "attn_flops_per_step": 6e12}
    data = {"summary": summary, "extras": extras, "window": {"images_per_s": 300.0}, "config": _config()}
    value = Spec(CELL).reader(metric).read(data)
    expected = {"mfu.hmr2": 100 * vit.train_flops_per_image(_config()) * 300.0 / 989e12,
                "attn_ms.hmr2": 11.0, "attn_roofline.hmr2": 100 * 6e12 / 989e12 * 1e3 / 11.0,
                "gemm_ms.hmr2": 130.0, "other_ms.hmr2": 20.0, "idle_share.hmr2": 10.0,
                "attn_fused_share.hmr2": 100.0}[metric]
    assert value == pytest.approx(expected)
    if metric in ("attn_ms.hmr2", "attn_roofline.hmr2", "attn_fused_share.hmr2"):
        empty = {"summary": _summary({"sm90_xmma_gemm": 1.0}), "extras": {}, "window": data["window"],
                 "config": data["config"]}
        assert Spec(CELL).reader(metric).read(empty) is None
    if metric == "attn_fused_share.hmr2":
        data["extras"]["attn_calls"] = {"attn.calls.flash_attention": 3, "attn.calls.math": 1}
        assert Spec(CELL).reader(metric).read(data) == pytest.approx(75.0)


def test_the_weights_maker_names_the_ports_state_dict(root):
    cfg = json.loads((root / "portbench/configs/hmr2_vith.json").read_text())
    asset = inputs.port_asset(inputs.stand_in(**cfg["asset"]))
    model, _ = net.init(asset, tiny_preset().model, device="cpu")
    made = inputs_vit.make_weights(cfg, 5, "cpu")
    want = model.state_dict()
    assert {k: tuple(v.shape) for k, v in made.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert torch.equal(made["head.mean_theta"], want["head.mean_theta"])


def test_the_driver_refuses_a_preset_that_differs_from_its_file(root, monkeypatch):
    monkeypatch.setitem(configs.PRESETS, "hmr2_vith", tiny_preset())
    driver = Spec(CELL, root).driver()
    cfg, traffic = Spec(CELL, root).config, Spec(CELL, root).traffic
    got = driver.program_config(cfg, traffic, 3)
    assert got.model.encoder.drop_path == 0.55 and got.batch_size == 2 and got.weight_decay == 1e-4
    for wrong in (dict(learning_rate=1e-4), dict(model=dataclasses.replace(
            tiny_preset().model, encoder=dataclasses.replace(tiny_preset().model.encoder, mlp_dim=96)))):
        monkeypatch.setitem(configs.PRESETS, "hmr2_vith", dataclasses.replace(tiny_preset(), **wrong))
        with pytest.raises(ValueError, match="differs from its file"):
            driver.program_config(cfg, traffic, 3)
    monkeypatch.delitem(configs.PRESETS, "hmr2_vith")
    with pytest.raises(KeyError):
        driver.program_config(cfg, traffic, 3)


def test_the_cell_runs_and_reads_correct_at_a_tiny_size(root, monkeypatch):
    monkeypatch.setitem(configs.PRESETS, "hmr2_vith", tiny_preset())
    line = run.run_cell(CELL, 2**31 + 77, 0.3, True, "cpu", root=root, started=0.0)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"loss1_rel", "loss_rel", "grad_leaf", "change_leaf", "replay_grad_leaf",
                                   "replay_change_leaf", "tokens_rel", "head_rel"}
    calls = line["_info"]["run"]["counts_first_call"]
    assert calls["vit.tokens"] == 2 * 12  # the eager warm-up's forward; the CPU captures nothing
    assert sum(n for k, n in calls.items() if k.startswith("attn.calls.")) == 2 + 2 * 2
    assert {"mfu.hmr2", "idle_share.hmr2", "attn_fused_share.hmr2"} <= set(line["metrics"])
