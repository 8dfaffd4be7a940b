"""The FLOP and byte counters against hand counts."""

import numpy as np
import torch

from portbench import trace
from portbench.work import flops, raster


def test_resnet18_macs_by_hand():
    # ResNet-18 at 224²: 1.814 GMAC (He et al. 2016, Table 1: 1.8e9 FLOPs
    # counted as multiply-adds). By hand: the stem 118.0M, each stage's
    # 3x3 convs 4 x 115.6M (stage 1 with its strided first conv and 1x1
    # projection: the same 115.6M x 4 less the stride, plus the projection).
    stem = 112 * 112 * 3 * 64 * 49
    s0 = 4 * 56 * 56 * 64 * 64 * 9
    s1 = 28 * 28 * (64 * 128 + 3 * 128 * 128) * 9 + 28 * 28 * 64 * 128
    s2 = 14 * 14 * (128 * 256 + 3 * 256 * 256) * 9 + 14 * 14 * 128 * 256
    s3 = 7 * 7 * (256 * 512 + 3 * 512 * 512) * 9 + 7 * 7 * 256 * 512
    assert flops.encoder_macs(18, 224) == stem + s0 + s1 + s2 + s3
    assert abs(flops.encoder_macs(18, 224) / 1e9 - 1.814) < 0.01
    # At 256² every feature map is 8/7 wider on each side (up to rounding).
    assert abs(flops.encoder_macs(18, 256) / 1e9 - 2.37) < 0.02
    assert abs(flops.encoder_macs(34, 224) / 1e9 - 3.66) < 0.02


def test_train_flops_count_backward_but_not_the_stems_input_gradient():
    fwd = flops.encoder_macs(18, 256)
    stem = 128 * 128 * 3 * 64 * 49
    per_image = flops.train_flops_per_image(18, 256, 85, 0.0)
    assert per_image == 2 * (3 * fwd - stem) + 6 * flops.ief_macs(512, 85) + 4 * flops.lbs_flops()
    assert flops.ief_macs(512, 85) == 3 * ((512 + 85) * 1024 + 1024 * 1024 + 1024 * 85)


def test_raster_work_against_brute_force():
    gen = torch.Generator().manual_seed(0)
    size, C, sigma = 24, 3, 1.0
    verts = torch.rand(2, 40, 2, generator=gen) * 34 - 5  # some off the canvas
    labels = torch.randint(0, C, (40,), generator=gen)
    w = raster.raster_work(verts, labels, C, size, sigma, cutoff_sigmas=3.0)
    px = torch.arange(size, dtype=torch.float64)
    inside_x = (px[None, None, :] - verts[..., 0:1].double()).abs() <= 3.0
    inside_y = (px[None, None, :] - verts[..., 1:2].double()).abs() <= 3.0
    pairs = (inside_x.sum(-1) * inside_y.sum(-1)).sum()
    assert w["pairs"] == float(pairs)
    assert w["exps"] == float(inside_x.sum() + inside_y.sum())
    cover = inside_y[..., :, None] & inside_x[..., None, :]  # [B, V, H, W]
    union = torch.stack([cover[:, labels == c].any(1) for c in range(C)], 1)
    assert w["g_pixels"] == int(union.sum())
    fwd = raster.bound_ms(w, False)
    assert fwd >= 4 * (2 * 80 + 2 * C * size * size) / 3.35e12 * 1e3 - 1e-15


def test_union_counts_overlap_once():
    iv = np.array([[0.0, 2.0], [1.0, 3.0], [5.0, 6.0], [5.5, 5.7]])
    u = trace._union(iv)
    assert u.tolist() == [[0.0, 3.0], [5.0, 6.0]]
    assert trace.category("void raster_fwd_kernel<4>(float*)") == "raster kernel"
    assert trace.category("Memcpy HtoD (Pageable -> Device)") == "H2D copy"
    assert trace.category("sm90_xmma_gemm_bf16") == "conv/gemm"
    assert trace.category("vectorized_elementwise_kernel") == "other"
