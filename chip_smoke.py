#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA device

Phases, in order; any failed check raises and the script exits non-zero:

1. Device: requires CUDA, prints the card's name and power limit. TF32 is
   turned off for float32 matmuls and convolutions.
2. Build: compiles csrc/*.cu with nvcc, one process per source in parallel
   (ops/kernels/_build.py), and prints the build time.
3. Kernels against their plain twins, on the card: the fused LBS kernel on
   the SMPL-sized asset at B = 1, 8, 32, 64 and 128 (the serving buckets and
   the training batch; 64 is the bucket that reaches the plan's 4-items-
   per-thread tile), with and without the residuals: each output it
   writes against the plain version, a repeated launch bitwise equal, the
   gradient through its autograd Function, its time warm (graph replay,
   basis in L2) and cold (after an L2-flushing write, whose own time is
   subtracted) beside its bound and one float32 blend GEMM as a yardstick;
   the raster forward kernel at B=4, 256², 24 parts x
   384 slots (plus a case with half the vertices 5000 px off canvas, and
   one on a ragged 199² canvas), against the exact twin and the culled
   plain version; the raster backward
   kernel at B=4 with a random cotangent: normalised error against both,
   exact zeros for padding and off-canvas slots, bitwise-equal repeated
   runs. Prints each kernel's and twin's device time: each call captured in
   a CUDA graph and replayed, so no host launch cost is in the number.
4. Serving: a `Predictor` on the full-width config4_full model (ResNet-18
   bf16, IEF, SMPL, seed-0 weights) with both forward kernels on (`auto`),
   warmed up, answers requests of batch 1, 3, 8 and 32 and renders each
   request's soft silhouette. Checks output shapes and finiteness, that
   padding leaves real rows unchanged (against the images run alone in the
   same bucket and in bucket 1), that both kernels ran during the requests,
   and that the same requests with the plain twins forced agree. Prints the
   median latency per bucket.
5. Training: the config4_full step at B=32, 256² (`train.init_state`,
   `train.fused_step`: batch generation with the LBS and raster forward
   kernels, then forward, losses, backward through the raster backward
   kernel, Adam). After a warm-up, 10 timed steps are the counted main path:
   each step must launch the raster forward kernel twice, the raster
   backward kernel once and the LBS kernel twice. Prints the median ms/step
   and img/s. Then 20 steps on one fixed batch must lower the total loss;
   the first step's loss terms and gradients with the kernels must match
   the same step with the plain twins forced (with the bf16 encoder, its
   leaves within a small multiple of the noise floor that the twins' step
   shows when its pixel vertices are jittered by a few float32 ulps); and
   the raster kernels are held against the exact twins and the culled plain
   versions and timed on that step's own inputs (the predicted vertices,
   the loss's cotangent of the scores and a random one), beside the
   reference's separable formulation in float32 (the yardstick,
   `raster.separable_scores` at 'highest'), with their bound recounted from
   the step's data (`raster_bound`).
6. Separable raster (the reference's default route) on the same step's
   slots and cotangent: 'highest' against the exact twin, 'high', 'default'
   and the bf16 training scores against 'highest'; the bf16 forward and
   forward + backward timed beside the kernels; and the step's loss terms
   with `raster_impl='separable'` against the kernels'.
7. The config4_mixed recipe at full width (ResNet-34, rot6d, b32, cosine
   warm-up, clip 1.0, the 3D weights, EMA 0.999): after a warm-up, counted
   fused steps (2 LBS, 2 raster forward, 1 raster backward launches each),
   one call of 4 steps (`steps_per_call`), then `evaluate` on 4 x 32 images
   of the model (its own counted launches: 3 LBS and 2 raster forward a
   batch) and of its EMA, and of the model with the plain versions forced,
   which must agree with the kernels' metrics.
8. The config4_robust recipe at full width (config4_mixed's, on hard
   z-buffered targets with textured backgrounds, palette jitter, shading
   and occluders; EMA 0.999): the hard raster on the step's bodies against
   the CPU run of the same function and the float64 oracle, timed dense and
   culled; counted fused steps (2 LBS, 1 raster forward, 1 raster backward
   launches each; the hard raster replaces the target render) with one
   step's device time; a checkpoint saved, restored bitwise and timed;
   `train.fit` to step 2 with checkpoints, then resumed to 4 (the restored
   state bitwise the first run's, the resumed batch bitwise the straight
   run's, the losses at step 4 within RESUME_TOL of a straight 4-step run);
   the JSONL and TensorBoard files read back; `tools/quality_eval.py` on the
   checkpoint and its EMA on the plain, hard and hardapp suites (3 seeds x 1
   batch), and the kernels against the plain versions on hardapp.
9. Disk data at full width (config4_full's model, b32, 256² crops from a
   dataset at 320²): the native host preprocessor built with g++ and
   loaded (`USE_NATIVE`), bitwise against its numpy versions on 32 ragged
   images; a 128-example dataset written by `make_synthetic_dataset` (its
   seconds, size and launches: one LBS and one raster forward a chunk of
   64); one raw batch preprocessed on the card against the CPU (labels
   equal, images within PREPROCESS_TOL; augmentation off and with the same
   draws) and prefetched batches bitwise equal to plain copies;
   `fit_dataset` with augmentation for 8 steps across an epoch boundary
   (1 LBS, 1 raster forward, 1 raster backward launch a step; host ms/step,
   img/s, the prefetcher's H2D time and waits, a profiled window of disk
   steps); `fit_dataset` to step 4 with checkpoints, resumed to 8, against
   a straight run (raw batches and draws bitwise, loss terms within
   RESUME_TOL), over the file and over 4 shards; `evaluate_dataset` over 4
   batches (2 LBS and 1 raster forward launch a batch) and the kernels
   against the plain versions on its first batch; the image-directory path
   (`fit_preprocessed`, `evaluate_preprocessed`) where PIL imports, and a
   line saying which held.
10. int8 serving and tools, on step 4's serving model: `ptq_quantize` on
   16 synthetic images (seed 999), the qparams file read back bitwise, a
   `keep_sites=('stem',)` variant; a `Predictor(qparams)` per impl
   (int8, int8c, sim, simc) at batches 1, 8, 32, 128: each site's int8
   product (`torch._int_mm`) against its float32 twin on the same input,
   the impls against their twins end to end by cosine, int8c against the
   bf16 encoder (the reference's cosine and mean relative error bounds),
   padding, one LBS launch on every int8c request and one raster forward
   on every render, median latency per bucket (bf16, int8, int8c), the
   encoders' device time at 128 and profiled requests at 1 and 128;
   `evaluate` of int8 against sim on 2 x 32 images (3 LBS, 2 raster
   forward launches a batch); the `torch.export` artifacts (bf16, int8c)
   at batch 8 against the eager forward with the plain SMPL, seconds and
   MB; `predict.main --demo --num 4 --int8 --qparams` (4 meshes read back;
   overlays where matplotlib imports, else a line says they were not
   driven); `fit_to_silhouette` for 30 steps (the loss falls; exactly one
   LBS, raster forward and raster backward launch a step; a profiled
   window); `train.init_state` from a pretrained npz and a mean-parameter
   file written in the phase.

The last three lines of standard output are the kernel record
({"kernels": [...]}, with each kernel's launches on the config4_full
training main path, on the config4_mixed steps and in its evaluation, on
the config4_robust steps (`launches_robust`), on the disk steps
(`launches_disk`), in the dataset writer (`launches_dataset`), on the int8
requests and their evaluation (`launches_int8`) and in the example
(`launches_fit`), its
time, its plain twin's and, for the raster kernels, the float32 separable
yardstick's and the bf16 separable times at the training path's shapes,
and its bound; the LBS entry adds `by_batch`, its warm and cold times,
bound and blend GEMM at each batch of LBS_BATCHES with and without the
residuals),
the `nvidia-smi` name/power-limit line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
import json
import os
import statistics
import struct
import sys
import tempfile
import time

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch import configs, evaluate, losses, predict, serve, train
from indirect_learning_pose_shape_tpu_torch.data import dataset as dataset_lib
from indirect_learning_pose_shape_tpu_torch.data import native_preprocess, synthetic
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import smpl
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster, raster_hard
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build, lbs_cuda, raster_cuda
from indirect_learning_pose_shape_tpu_torch.tools import quality_eval
from indirect_learning_pose_shape_tpu_torch.tools.profile_serve import device_summary, smi_line
from indirect_learning_pose_shape_tpu_torch.tools.timing import ColdTimer, device_ms, events_ms
from indirect_learning_pose_shape_tpu_torch.utils import assets, metrics
from indirect_learning_pose_shape_tpu_torch.utils.checkpoint import Checkpointer
from indirect_learning_pose_shape_tpu_torch.utils.precision import disable_tf32

REQUESTS = (1, 3, 8, 32)
# The serving buckets and the training batch, one of each items-per-thread
# tile of the launch plan (ipt 1, 1, 2, 4, 8).
LBS_BATCHES = (1, 8, 32, 64, 128)
LBS_BATCH = 32  # the training forward's batch: the kernel record's `ms`
# LBS calls per captured graph: a call at B=1 is shorter than a replay's
# host cost.
LBS_CALLS = 10
RASTER_BATCH = 4
RAGGED_SIZE = 199
TOL = 1e-4
# A raster kernel against a plain version (the gradient, and either kernel
# against the culled plain version), after normalising by the largest entry.
GRAD_TOL = 2e-5
# The same on the training loss's own cotangent, where the culled tails are
# not negligible (see training_phase): 3.3e-4 measured on an H100.
CULL_TOL = 2e-3
TRAIN_WARMUP = 3
TRAIN_STEPS = 10  # counted steps, few: the whole run should stay near 70 s
# The bf16 step's noise-floor control: the twins' step against itself with
# the predicted pixel vertices multiplied by (1 + JITTER·N(0, 1)), a change
# of a few float32 ulps, once per seed in JITTER_SEEDS. The kernels' step
# must stay within FLOOR_MULTIPLE times the largest such encoder error.
JITTER = 1e-6
JITTER_SEEDS = (0, 1, 2)
FLOOR_MULTIPLE = 4.0
PER_STEP = {lbs_cuda.KERNEL: 2, raster_cuda.KERNEL: 2, raster_cuda.KERNEL_BWD: 1}
# Separable raster against 'highest', normalised by the largest score: the
# reference documents 5e-5 for 'high' and ~9e-3 for 'default' (an H100
# read 2.1e-6 and 6.4e-4); bf16 training scores held to 1e-2 (4.1e-3).
# Each backward on the step's loss cotangent is held to the same limit
# ('highest' and the bf16 scores against the exact twin's gradient, the
# first to GRAD_TOL; an H100 read 3.0e-7, 'high' 1.6e-6, 'default' 7.5e-4,
# bf16 1.1e-3).
SEP_HIGH_TOL = 5e-5
SEP_DEFAULT_TOL = 9e-3
SEP_BF16_TOL = 1e-2
# The config4_full step's loss terms with bf16 separable scores against the
# kernels' float32 scores, relative (an H100 read 3.1e-6 at worst).
SEP_STEP_TOL = 1e-4
MIXED_WARMUP = 3
MIXED_STEPS = 10
MIXED_CALL = 4  # steps_per_call of the one chunked call
EVAL_BATCHES = 4
# evaluate with the kernels against the plain versions: the thresholded
# metrics can flip boundary pixels (absolute), the others relative (an H100
# read 4.9e-6 and 4.1e-5 at worst).
EVAL_ABS = ("sil_iou", "part_acc", "miou")
EVAL_ABS_TOL = 1e-3
EVAL_REL_TOL = 1e-3
# The config4_robust phase: warm-up and counted fused steps; fit to step
# RESUME_K, resume to 2 * RESUME_K, against a straight run of 2 * RESUME_K.
ROBUST_WARMUP = 3
ROBUST_STEPS = 3
RESUME_K = 2
PER_STEP_ROBUST = {lbs_cuda.KERNEL: 2, raster_cuda.KERNEL: 1, raster_cuda.KERNEL_BWD: 1}
PER_EVAL_BATCH_HARD = {lbs_cuda.KERNEL: 3, raster_cuda.KERNEL: 1}  # hard targets: no target render
# The resumed run's loss terms at step 2k against the straight run's,
# relative: cuDNN's backward is not bitwise repeatable, so two runs of the
# same steps differ by its rounding (not bitwise as on the CPU).
RESUME_TOL = 1e-3
# The hard raster on the card against the CPU run of the same function, and
# against the float64 oracle (tests/test_raster_hard.py's limit).
HARD_AGREE = 0.999
ORACLE_AGREE = 0.995
HARD_K_FACES = 512  # the culled mode timed beside the dense one
# The CPU run is cut into pieces of this many images and face chunks of
# HARD_CPU_CHUNK, which keep its temporaries in the CPU's caches.
HARD_CPU_IMAGES = 2
HARD_CPU_CHUNK = 8
QUALITY_SEEDS = (123, 231, 312)
QUALITY_SUITES = ("plain", "hard", "hardapp")
# The disk phase: a dataset of DISK_EXAMPLES at DISK_SOURCE² written by the
# port (chunks of 64: one LBS and one raster forward launch each), trained on
# with augmentation for DISK_STEPS steps at config4_full's b32 (4 steps an
# epoch, so the run crosses an epoch boundary), resumed at DISK_STEPS / 2,
# over the file and over DISK_SHARDS shards; evaluated over DISK_EVAL
# batches.
DISK_EXAMPLES = 128
DISK_SOURCE = 320
DISK_STEPS = 8
DISK_SHARDS = 4
DISK_PROFILED = 4  # disk steps in the profiled window
DISK_EVAL = 4
NATIVE_IMAGES = 32  # ragged images of the host-path check
PER_STEP_DISK = {lbs_cuda.KERNEL: 1, raster_cuda.KERNEL: 1, raster_cuda.KERNEL_BWD: 1}  # no target render
PER_EVAL_BATCH_DISK = {lbs_cuda.KERNEL: 2, raster_cuda.KERNEL: 1}  # forward, ground truth SMPL
# The card's preprocess against the CPU's on the same raw batch (float32 of
# the same operations: an H100 is expected to read 0).
PREPROCESS_TOL = 1e-5

# The card's limits for bounds (H100 SXM, at its 700 W limit): HBM 3.35 TB/s
# and 67 TFLOP/s float32 outside the tensor cores (NVIDIA's data sheet);
# exponentials at the special-function units' 16 results per clock per SM
# (CUDA C++ Programming Guide, throughput table, compute capability 9.0) x
# 132 SMs x 1.98 GHz boost clock.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
EXP_PER_S = 16 * 132 * 1.98e9
FMA_PER_S = FP32_FLOP_PER_S / 2


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def request_ms(fn, reps: int) -> float:
    """Median host wall ms of `fn` ended by a synchronize (request latency)."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


def bound(nbytes: float, seconds_of_ops: float) -> dict:
    """bound_ms = the larger of the bytes' time at HBM rate and the ops' time."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {
        "bound_ms": max(t_bytes, seconds_of_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= seconds_of_ops else "operations",
    }


def lbs_bound(consts, B: int, residuals: bool = True) -> dict:
    """What the function needs over the V real vertices, none of the
    layouts' padding: each input read once (the 3 + 3·Kb + 3·Kp + J basis
    rows it uses, betas, pose features, rel) and each output written once
    (verts, and v_posed and T with the residuals); 2 FLOPs per multiply-add."""
    V, J = consts.num_verts, consts.num_joints
    Kb, Kp = consts.num_betas, (J - 1) * 9
    nbytes = 4 * (
        (3 + 3 * Kb + 3 * Kp + J) * V + B * (Kb + Kp + J * 12)
        + B * V * (3 + (3 + 12 if residuals else 0))
    )
    flops = 2 * B * V * (3 * Kb + 3 * Kp + 12 * J + 9)
    return bound(nbytes, flops / FP32_FLOP_PER_S)


def raster_work(vx: torch.Tensor, layout, rcfg) -> dict:
    """What the culled raster function needs on this data, counted in plain
    torch over real slots, each in its 128-slot block's box over real slots
    grown by the cutoff and clipped to the canvas:

    - pairs: (pixel, slot) pairs, each real slot against its box's pixels;
    - exps: each real slot's box columns + rows (the separable factors);
    - g_pixels: the pixels inside the union of each class's boxes, the part
      of the cotangent the backward has to read;
    - pairs_in_kernel_boxes: what the kernels compute instead, each real
      slot against the 32x8 tiles its block passes the culling test for."""
    C, S, H = layout.num_parts, layout.seg_size, rcfg.image_size
    B, nb = vx.shape[0], -(-S // raster_cuda.KV)
    cut = rcfg.cutoff_sigmas * rcfg.sigma
    box = raster_cuda.block_bboxes(vx.transpose(1, 2).contiguous(), layout.real, C, S)
    first = torch.arange(nb, device=vx.device) * raster_cuda.KV
    n_real = (layout.real[:, None] - first).clamp(0, raster_cuda.KV).reshape(-1).double()
    b = box.double()
    lo = torch.clamp(torch.ceil(b[..., 0::2] - cut), min=0)  # [B, blocks, (x, y)]
    hi = torch.clamp(torch.floor(b[..., 1::2] + cut), max=H - 1)
    extent = (hi - lo + 1).clamp(min=0)
    pairs = float((extent[..., 0] * extent[..., 1] * n_real).sum())
    exps = float((extent.sum(-1) * n_real).sum())

    xh, yh = raster_cuda.tile_hits(box, H, H, cut)
    tw = (H - torch.arange(0, H, raster_cuda.TW, device=vx.device)).clamp(max=raster_cuda.TW)
    th = (H - torch.arange(0, H, raster_cuda.TH, device=vx.device)).clamp(max=raster_cuda.TH)
    kpx = (xh * tw).sum(-1).double() * (yh * th).sum(-1).double()
    kernel_pairs = float((kpx * n_real).sum())

    r = torch.arange(H, device=vx.device, dtype=torch.float64)
    lo, hi = lo.reshape(B, C, nb, 2), hi.reshape(B, C, nb, 2)
    inside = torch.zeros(B, C, H, H, dtype=torch.bool, device=vx.device)
    for j in range(nb):
        xm = (r >= lo[:, :, j, 0:1]) & (r <= hi[:, :, j, 0:1])  # [B, C, W]
        ym = (r >= lo[:, :, j, 1:2]) & (r <= hi[:, :, j, 1:2])  # [B, C, H]
        inside |= ym[..., :, None] & xm[..., None, :]
    return {
        "pairs": int(pairs), "pairs_in_kernel_boxes": int(kernel_pairs),
        "exps": int(exps), "g_pixels": int(inside.sum()),
    }


def raster_bound(vx: torch.Tensor, layout, rcfg, work: dict, backward: bool) -> dict:
    """The least time of the culled raster function on this data (`work`,
    from `raster_work`), whatever the design: the largest of
    - bytes: the slots read once, and the scores written once (forward) or
      the cotangent inside the boxes read once and the slot gradient
      written once (backward), at HBM rate;
    - exponentials: the separable factors, at the SFU rate;
    - FMAs: 1 per pair (forward) or 2 (backward), at the float32 rate.
    `bound_ms_exp_per_pair` is the earlier figure of one exponential per
    pair, printed beside it to show why the bound moved."""
    B, N, _ = vx.shape
    C, H = layout.num_parts, rcfg.image_size
    moved = 2 * B * N + work["g_pixels"] if backward else B * C * H * H
    t_exp = work["exps"] / EXP_PER_S
    t_fma = (2 if backward else 1) * work["pairs"] / FMA_PER_S
    out = bound(4 * (2 * B * N + moved), max(t_exp, t_fma))
    out["ops_bound_by"] = "exponentials" if t_exp >= t_fma else "fma"
    out["bound_ms_exp_per_pair"] = work["pairs"] / EXP_PER_S * 1e3
    return {**out, **work}


@contextlib.contextmanager
def jittered_render(scale: float, seed: int):
    """Inside the block the training render sees its pixel vertices
    multiplied by (1 + scale·N(0, 1)), the noise drawn from `seed`: a change
    of a few float32 ulps, for the bf16 noise-floor control."""
    plain = raster.soft_rasterize_train
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def jittered(verts2d, *args, **kwargs):
        noise = torch.randn(verts2d.shape, device=verts2d.device, generator=gen)
        return plain(verts2d * (1 + scale * noise), *args, **kwargs)

    raster.soft_rasterize_train = jittered
    try:
        yield
    finally:
        raster.soft_rasterize_train = plain


class _CulledPlain(torch.autograd.Function):
    """The culled function the raster kernels compute, in plain torch, as an
    autograd pair: `raster_scores_culled_torch` forward,
    `raster_scores_bwd_culled_torch` backward; vx [B, C*S, 2]."""

    @staticmethod
    def forward(ctx, vx, real, num_parts, seg_size, rcfg):
        ctx.save_for_backward(vx, real)
        ctx.meta = (num_parts, seg_size, rcfg)
        return raster_cuda.raster_scores_culled_torch(vx, real, num_parts, seg_size, rcfg)

    @staticmethod
    def backward(ctx, g):
        vx, real = ctx.saved_tensors
        num_parts, seg_size, rcfg = ctx.meta
        dv = raster_cuda.raster_scores_bwd_culled_torch(vx, g.contiguous(), real, num_parts, seg_size, rcfg)
        return dv.transpose(1, 2), None, None, None, None


@contextlib.contextmanager
def culled_plain_raster():
    """Inside the block every raster score (`raster_cuda.raster_scores4`,
    whatever its impl) is the culled plain version, with its gradient."""
    kernel = raster_cuda.raster_scores4
    raster_cuda.raster_scores4 = lambda vx, real, num_parts, seg_size, rcfg, impl="kernel": _CulledPlain.apply(
        vx, real, num_parts, seg_size, rcfg
    )
    try:
        yield
    finally:
        raster_cuda.raster_scores4 = kernel


def norm_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    return max_err(a, b) / (float(b.abs().max()) + 1e-12)


def lbs_inputs(consts, B: int, rng):
    """pose, betas and the kernel's inputs exactly as smpl_forward_rotmats
    builds them (betas, pose features, rigid rows)."""
    pose = torch.tensor(rng.randn(B, 72).astype(np.float32) * 0.4, device="cuda")
    betas = torch.tensor(rng.randn(B, 10).astype(np.float32), device="cuda")
    rotmats = smpl.batch_rodrigues(pose.reshape(B, 24, 3))
    pose_feat = (rotmats[:, 1:] - torch.eye(3, device="cuda")).reshape(B, -1)
    v_shaped = consts.v_template + (betas @ consts.shapedirs_flat).reshape(B, -1, 3)
    joints_rest = torch.einsum("jv,bvi->bji", consts.J_regressor, v_shaped)
    _, rel = smpl.rigid_transform_chain(rotmats, joints_rest, consts.parents)
    return pose, betas, pose_feat, rel


def blend_gemm(consts, betas, pose_feat):
    """The yardstick for the blend alone: the zero-padded coefficients
    [B, kbp + kpp] times the basis [kbp + kpp, 3·Vp] as one float32
    `torch.matmul` (TF32 off). Timed here only; the port never calls it."""
    Vp = consts.num_verts_padded
    kbp, kpp = consts.shapedirs_p.shape[0] // 3, consts.posedirs_p.shape[0] // 3
    basis = torch.cat(
        [consts.shapedirs_p.reshape(3, kbp, Vp), consts.posedirs_p.reshape(3, kpp, Vp)], dim=1
    ).transpose(0, 1).reshape(kbp + kpp, 3 * Vp).contiguous()
    coef = torch.cat([
        torch.nn.functional.pad(betas, (0, kbp - betas.shape[1])),
        torch.nn.functional.pad(pose_feat, (0, kpp - pose_feat.shape[1])),
    ], dim=1)
    return lambda: torch.matmul(coef, basis)


def lbs_phase(asset, rng, smi) -> dict:
    """The LBS kernel at each batch of LBS_BATCHES, with and without the
    residuals. Returns the kernel record's numbers: `ms`, `plain_ms` and the
    bound at LBS_BATCH with residuals (the training forward's launch), the
    largest error, and every point under `by_batch`."""
    consts = smpl.smpl_consts(asset, device="cuda")
    timer = ColdTimer(replays=20, calls=LBS_CALLS)
    print(f"[kernels] lbs: L2 flush, a {timer.nbytes >> 20} MB write, {timer.flush_ms:.4f} ms alone")
    points, worst = [], 0.0
    for B in LBS_BATCHES:
        pose, betas, pose_feat, rel = lbs_inputs(consts, B, rng)
        want = lbs_cuda.lbs_planar_torch(consts, betas, pose_feat, rel)
        for residuals in (True, False):
            got = lbs_cuda.lbs_planar(consts, betas, pose_feat, rel, residuals)
            again = lbs_cuda.lbs_planar(consts, betas, pose_feat, rel, residuals)
            torch.cuda.synchronize()
            errs = {}
            for name, g, a, w in zip(("verts", "v_posed", "T"), got, again, want):
                if not residuals and name != "verts":
                    check(g is None, f"lbs kernel B={B} without residuals wrote {name}")
                    continue
                check(bool(torch.isfinite(g).all()), f"lbs kernel B={B} {name} not finite")
                check(torch.equal(g, a), f"lbs kernel B={B} residuals={residuals}: {name} differs between runs")
                errs[name] = max_err(g, w)
                check(errs[name] <= TOL, f"lbs kernel B={B} residuals={residuals}: {name} max abs err {errs[name]} > {TOL}")
            worst = max(worst, *errs.values())

            def run(res=residuals):
                return lbs_cuda.lbs_planar(consts, betas, pose_feat, rel, res)

            ms, cold_ms = timer.warm_ms(run), timer.cold_ms(run)
            pt = {"B": B, "residuals": residuals, "ms": ms, "cold_ms": cold_ms,
                  **lbs_bound(consts, B, residuals), "max_abs_err": max(errs.values())}
            points.append(pt)
            print(
                f"[kernels] lbs B={B} residuals={residuals}: max abs err "
                + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                + f"; repeated launch bitwise equal; warm {ms:.4f} ms, cold {cold_ms:.4f} ms; "
                f"bound {pt['bound_ms']:.4f} ms ({pt['bound_by']}) [{smi}]"
            )

        # Gradient of the autograd Function vs autograd of the twin.
        grads = {}
        for impl in ("kernel", "torch"):
            p = pose.clone().requires_grad_(True)
            b = betas.clone().requires_grad_(True)
            v = smpl.smpl_forward(consts, p, b, impl=impl)["verts"]
            grads[impl] = torch.autograd.grad((v * v).sum(), (p, b))
        grad_err = 0.0
        for gk, gt in zip(grads["kernel"], grads["torch"]):
            scale = float(gt.abs().max()) + 1e-9
            grad_err = max(grad_err, max_err(gk, gt) / scale)
        check(grad_err <= TOL, f"lbs gradient at B={B} (normalised) err {grad_err} > {TOL}")

        gemm_ms = timer.warm_ms(blend_gemm(consts, betas, pose_feat))
        plain_ms = device_ms(lambda: lbs_cuda.lbs_planar_torch(consts, betas, pose_feat, rel), 20)
        for pt in points[-2:]:
            pt.update(blend_gemm_ms=gemm_ms, plain_ms=plain_ms, grad_err=grad_err)
        print(
            f"[kernels] lbs B={B}: normalised grad err {grad_err:.3e}; plain twin {plain_ms:.4f} ms, "
            f"blend GEMM [{B}, {consts.shapedirs_p.shape[0] // 3 + consts.posedirs_p.shape[0] // 3}] x "
            f"[.., {3 * consts.num_verts_padded}] {gemm_ms:.4f} ms"
        )
    del timer
    torch.cuda.empty_cache()
    main_pt = next(p for p in points if p["B"] == LBS_BATCH and p["residuals"])
    return {
        "max_abs_err": worst, "ms": main_pt["ms"], "plain_ms": main_pt["plain_ms"],
        **lbs_bound(consts, LBS_BATCH), "by_batch": points,
    }


def posed_verts2d(model_consts, asset, cfg, rng):
    """Realistic raster inputs: posed bodies projected at the serving camera
    (B=4), and the same with half the vertices 5000 px off canvas."""
    pose = torch.tensor(rng.randn(RASTER_BATCH, 72).astype(np.float32) * 0.3, device="cuda")
    betas = torch.tensor(rng.randn(RASTER_BATCH, 10).astype(np.float32), device="cuda")
    verts = smpl.smpl_forward(model_consts.smpl, pose, betas, impl="torch")["verts"]
    cam = torch.tensor(
        np.c_[rng.uniform(0.7, 1.1, RASTER_BATCH), rng.uniform(-0.2, 0.2, (RASTER_BATCH, 2))],
        dtype=torch.float32, device="cuda",
    )
    verts2d = camera.project_pixel(verts, cam, cfg.image_size)
    far = verts2d.clone()
    far[:, : asset.num_verts // 2] = 5000.0
    return verts2d, far


def raster_cases(rcfg, verts2d, far):
    """(name, vertices, raster config) of the B=4 kernel checks: the posed
    bodies, the same with half the vertices off canvas, and the posed bodies
    on a ragged 199² canvas (odd width, no tile or region divides it)."""
    ragged = dataclasses.replace(rcfg, image_size=RAGGED_SIZE)
    return (("on-canvas", verts2d, rcfg), ("half off-canvas", far, rcfg),
            (f"{RAGGED_SIZE}^2 canvas", verts2d, ragged))


def raster_phase(model_consts, cfg, verts2d, far) -> dict:
    layout = model_consts.part_layout
    C, S = layout.num_parts, layout.seg_size
    rcfg = cfg.raster
    real = layout.real
    errs = []
    for name, v2, rc in raster_cases(rcfg, verts2d, far):
        vx = raster.gather_class_sorted(v2, layout)
        kern = raster_cuda.raster_scores4(vx, real, C, S, rc)
        twin = raster_cuda.raster_scores4(vx, real, C, S, rc, impl="torch")
        culled = raster_cuda.raster_scores_culled_torch(vx, real, C, S, rc)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kern).all()), f"raster kernel ({name}) not finite")
        bad = (kern - twin).abs() > TOL + TOL * twin.abs()
        err = max_err(kern, twin)
        check(not bool(bad.any()), f"raster kernel ({name}) vs twin: max abs err {err}")
        c_err = norm_err(kern, culled)
        check(c_err <= GRAD_TOL, f"raster kernel ({name}) vs culled plain version: normalised err {c_err}")
        errs.append(err)
        print(
            f"[kernels] raster {name}: max abs err {err:.3e} against the exact twin (max score "
            f"{float(twin.max()):.2f}), normalised {c_err:.3e} against the culled plain version"
        )

    vx = raster.gather_class_sorted(verts2d, layout)
    ms = device_ms(lambda: raster_cuda.raster_scores4(vx, real, C, S, rcfg), 20)
    plain_ms = device_ms(lambda: raster_cuda.raster_scores4(vx, real, C, S, rcfg, impl="torch"), 2)
    print(
        f"[kernels] raster B={RASTER_BATCH} {rcfg.image_size}^2 C={C} S={S}: "
        f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms"
    )
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


def raster_bwd_phase(model_consts, cfg, verts2d, far, rng) -> dict:
    """The backward kernel against the exact and the culled plain versions
    on a random cotangent: normalised error, exact zeros for padding and
    off-canvas slots, bitwise repeatability."""
    layout = model_consts.part_layout
    C, S, real = layout.num_parts, layout.seg_size, layout.real
    rcfg = cfg.raster
    size = rcfg.image_size
    g = torch.tensor(rng.randn(RASTER_BATCH, C, size, size).astype(np.float32), device="cuda")
    errs = []
    for name, v2, rc in raster_cases(rcfg, verts2d, far):
        vx = raster.gather_class_sorted(v2, layout)
        vt = vx.transpose(1, 2).contiguous()
        gc = g[:, :, : rc.image_size, : rc.image_size].contiguous()
        kern = raster_cuda.raster_bwd_cuda(vt, gc, real, C, S, rc)
        again = raster_cuda.raster_bwd_cuda(vt, gc, real, C, S, rc)
        twin = raster_cuda.raster_scores_bwd_torch(vx, gc, C, S, rc)
        culled = raster_cuda.raster_scores_bwd_culled_torch(vx, gc, real, C, S, rc)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kern).all()), f"raster backward kernel ({name}) not finite")
        check(torch.equal(kern, again), f"raster backward kernel ({name}) differs between runs")
        err = norm_err(kern, twin)
        check(err <= GRAD_TOL, f"raster backward kernel ({name}) vs twin: normalised err {err}")
        c_err = norm_err(kern, culled)
        check(c_err <= GRAD_TOL, f"raster backward kernel ({name}) vs culled plain version: normalised err {c_err}")
        check(float(kern.abs().max()) > 0, f"raster backward kernel ({name}) is all zero")
        off = (vx[..., 0] > 4000).unsqueeze(1).expand(-1, 2, -1)  # off canvas, padding too
        check(bool((kern[off] == 0).all()), f"raster backward kernel ({name}): off-canvas slots not 0")
        errs.append(max_err(kern, twin))
        print(
            f"[kernels] raster backward {name}: normalised err {err:.3e} against the exact twin, "
            f"{c_err:.3e} against the culled plain version (max |dv| {float(twin.abs().max()):.3f}), "
            f"{int(off.sum())} off-canvas and padding entries exactly 0, repeated run bitwise equal"
        )
    vx = raster.gather_class_sorted(verts2d, layout)
    vt = vx.transpose(1, 2).contiguous()
    ms = device_ms(lambda: raster_cuda.raster_bwd_cuda(vt, g, real, C, S, rcfg), 20)
    plain_ms = device_ms(lambda: raster_cuda.raster_scores_bwd_torch(vx, g, C, S, rcfg), 2)
    print(
        f"[kernels] raster backward B={RASTER_BATCH} {size}^2 C={C} S={S}: "
        f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms"
    )
    return {"max_abs_err": max(errs)}


def request(p, cfg, consts, images):
    out = p(images)
    rend = predict.render_silhouette(out, consts, cfg)
    return out, rend


def serving_phase(cfg, model, consts, rng, smi) -> dict:
    p = serve.Predictor(cfg, model, consts)
    t0 = time.perf_counter()
    p.warmup()
    torch.cuda.synchronize()
    print(f"[serve] warmup of buckets {p.buckets}: {time.perf_counter() - t0:.2f} s")

    size, J, C = cfg.image_size, 24, cfg.raster.num_parts
    V = consts.smpl.num_verts
    reqs = {
        n: rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32) for n in REQUESTS
    }

    # --- The main path, counted: requests + their silhouettes. -------------
    _build.reset_counts()
    results = {n: request(p, cfg, consts, x) for n, x in reqs.items()}
    torch.cuda.synchronize()
    launches = _build.counts()
    print(f"[serve] kernel launches during {len(REQUESTS)} requests: {launches}")
    for name in (lbs_cuda.KERNEL, raster_cuda.KERNEL):
        check(
            launches.get(name, 0) >= len(REQUESTS),
            f"kernel {name} launched {launches.get(name, 0)} times for {len(REQUESTS)} requests",
        )

    for n, (out, rend) in results.items():
        shapes = {
            "theta": (n, 85), "pose": (n, 72), "pose_prior": (n, 69),
            "rotmats": (n, J, 3, 3), "betas": (n, 10), "cam": (n, 3),
            "verts": (n, V, 3), "joints": (n, J, 3), "kp3d": (n, 19, 3),
            "kp2d": (n, 19, 2),
        }
        for k, shape in shapes.items():
            check(tuple(out[k].shape) == shape, f"{k} shape {tuple(out[k].shape)} != {shape}")
            check(bool(torch.isfinite(out[k]).all()), f"{k} not finite (batch {n})")
        check(tuple(rend["silhouette"].shape) == (n, size, size), "silhouette shape")
        check(tuple(rend["probs"].shape) == (n, size, size, C + 1), "probs shape")
        sil = rend["silhouette"]
        check(bool(torch.isfinite(sil).all()), "silhouette not finite")
        check(float(sil.amax()) > 0.5, "silhouette has no foreground")

    # Padding leaves real rows unchanged: each row of the 3-image request
    # (bucket 4) against its image alone, padded into the same bucket and
    # run in bucket 1 (other cuDNN shapes for the bf16 encoder). Every output
    # is compared; kp2d in units of half the image (pixels / 127.5 at 256²),
    # the units of the camera it is projected with.
    x3 = reqs[3]
    out3 = results[3][0]
    alone = serve.Predictor(cfg, model, consts, buckets=(4,))
    half = 0.5 * (size - 1)
    pad_err = alone_b1_err = 0.0
    for i in range(3):
        o_same = alone(x3[i : i + 1])
        o_b1 = p(x3[i : i + 1])
        for k, v in out3.items():
            unit = half if k == "kp2d" else 1.0
            pad_err = max(pad_err, max_err(v[i : i + 1], o_same[k]) / unit)
            alone_b1_err = max(alone_b1_err, max_err(v[i : i + 1], o_b1[k]) / unit)
    check(pad_err <= TOL, f"padded rows differ from the same images alone: {pad_err}")
    check(alone_b1_err <= TOL, f"padded rows differ from the images in bucket 1: {alone_b1_err}")
    print(
        f"[serve] padded request vs images alone, all outputs: max abs err {pad_err:.3e} "
        f"in the same bucket, {alone_b1_err:.3e} in bucket 1"
    )

    # The same requests with the plain twins forced, on the card.
    cfg_t = dataclasses.replace(cfg, smpl_impl="torch", raster_impl="torch")
    p_t = serve.Predictor(cfg_t, model, consts)
    v_err = s_err = 0.0
    for n, x in reqs.items():
        out_t, rend_t = request(p_t, cfg_t, consts, x)
        out, rend = results[n]
        v_err = max(v_err, max_err(out["verts"], out_t["verts"]))
        s_err = max(s_err, max_err(rend["silhouette"], rend_t["silhouette"]))
    check(v_err <= TOL and s_err <= TOL, f"kernel vs twin serving: verts {v_err}, sil {s_err}")
    print(f"[serve] kernels vs plain twins on the same requests: verts {v_err:.3e}, silhouette {s_err:.3e}")

    for n, x in reqs.items():
        fwd = request_ms(lambda: p(x), 20)
        full = request_ms(lambda: request(p, cfg, consts, x), 20)
        print(
            f"[serve] request batch {n} (bucket {p.bucket_for(n)}): median {full:.3f} ms "
            f"with silhouette, {fwd:.3f} ms forward only [{smi}]"
        )
    return launches


def training_phase(asset, smi) -> dict:
    """The config4_full training step on the card; returns what the kernel
    record needs: launches on the main path, and the raster kernels held
    against their twins, timed and bounded on that step's own inputs."""
    cfg = configs.CONFIG4_FULL
    B, size = cfg.batch_size, cfg.model.image_size
    ts, consts = train.init_state(cfg, asset=asset, device="cuda")
    with torch.no_grad():  # keep the seed-0 bodies in frame (see main)
        ts.model.ief.layers[-1].weight.mul_(0.01)
    init_model = copy.deepcopy(ts.model)
    t0 = time.perf_counter()
    for _ in range(TRAIN_WARMUP):
        train.fused_step(ts, consts, cfg)
    torch.cuda.synchronize()
    print(f"[train] config4_full B={B} {size}^2: warm-up of {TRAIN_WARMUP} steps {time.perf_counter() - t0:.2f} s")

    # --- The main path, counted: fused steps (generate a batch, update). ---
    _build.reset_counts()
    times, totals = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        terms = train.fused_step(ts, consts, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        totals.append(float(terms["total"]))
    launches = _build.counts()
    print(f"[train] kernel launches during {TRAIN_STEPS} steps: {launches}")
    for name, per in PER_STEP.items():
        check(
            launches.get(name, 0) == per * TRAIN_STEPS,
            f"kernel {name} launched {launches.get(name, 0)} times in {TRAIN_STEPS} steps, "
            f"not {per} per step",
        )
    check(all(np.isfinite(totals)), f"non-finite training loss: {totals}")
    med = statistics.median(times)
    print(
        f"[train] median {med:.3f} ms/step ({B / med * 1e3:.1f} img/s), p90 "
        f"{float(np.percentile(times, 90)):.3f} ms, over {TRAIN_STEPS} steps [{smi}]"
    )

    # --- One fixed batch: 20 steps from the initial weights lower the loss.
    batch = train.make_batch(cfg.seed, 10**6, B, consts, cfg)
    fixed = train.new_state(copy.deepcopy(init_model), cfg, cfg.seed)
    fixed_loss = [float(train.train_step(fixed, batch, consts, cfg)["total"]) for _ in range(20)]
    check(fixed_loss[-1] < fixed_loss[0], f"20 steps on one batch did not lower the loss: {fixed_loss}")
    print(f"[train] 20 steps on one batch: total loss {fixed_loss[0]:.5f} -> {fixed_loss[-1]:.5f}")

    # --- Step 1 with the kernels against the plain twins forced. ----------
    # The loss terms and the gradients of the leaves after the encoder (IEF,
    # mean_theta) are held to the tolerances in both steps, and so is every
    # leaf in the step with the encoder in float32. In bf16 the encoder's
    # backward rounds each gradient to 8 bits, so tiny differences after the
    # encoder flip some roundings: there the encoder's leaves are held to
    # FLOOR_MULTIPLE times the noise floor that the jittered twins' step
    # shows against the twins' step (JITTER). The floor is printed for both.
    cfg_t = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, smpl_impl="torch", raster_impl="torch")
    )
    enc_f32 = dataclasses.replace(cfg.model.encoder, compute_dtype=torch.float32)

    def step1(c, enc_cfg):
        m = copy.deepcopy(init_model)
        m.encoder.cfg = enc_cfg  # the encoder module carries its own config
        total, t = train.loss_and_metrics(m, consts, batch, c)
        total.backward()
        return {k: p.grad for k, p in m.named_parameters()}, {k: float(v.detach()) for k, v in t.items()}

    for label, enc_cfg in (("bf16", cfg.model.encoder), ("float32 encoder", enc_f32)):
        (gk, tk), (gt, tt) = step1(cfg, enc_cfg), step1(cfg_t, enc_cfg)
        if label == "bf16":
            kernel_terms = tk
        term_err = max(abs(tk[k] - v) / max(abs(v), 1e-12) for k, v in tt.items())
        errs = {k: norm_err(gk[k], g) for k, g in gt.items()}
        head = max(e for k, e in errs.items() if not k.startswith("encoder."))
        enc_err = max(e for k, e in errs.items() if k.startswith("encoder."))
        check(term_err <= 1e-4, f"step 1 ({label}), kernels vs twins: loss terms rel err {term_err}")
        check(head <= 1e-3, f"step 1 ({label}), kernels vs twins: IEF gradients err {head}")
        floor = 0.0
        for seed in JITTER_SEEDS:
            with jittered_render(JITTER, seed):
                gj, _ = step1(cfg_t, enc_cfg)
            floor = max(floor, max(norm_err(gj[k], g) for k, g in gt.items() if k.startswith("encoder.")))
        if label == "bf16":
            check(floor > 0, "step 1 (bf16): the jittered twins' step equals the twins' step")
            check(
                enc_err <= FLOOR_MULTIPLE * floor,
                f"step 1 ({label}), kernels vs twins: encoder gradients err {enc_err} > "
                f"{FLOOR_MULTIPLE} x the noise floor {floor}",
            )
        else:
            check(enc_err <= 1e-3, f"step 1 ({label}), kernels vs twins: encoder gradients err {enc_err}")
        print(
            f"[train] step 1 ({label}), kernels vs plain twins on one batch: loss terms rel err "
            f"{term_err:.3e}; gradients normalised per leaf: IEF and mean_theta {head:.3e}, "
            f"encoder {enc_err:.3e}; noise floor of the encoder's gradients (twins with the "
            f"pixel vertices jittered by {JITTER:g} relative, worst of {len(JITTER_SEEDS)} draws) {floor:.3e}"
        )

    # --- The raster kernels on this step's own inputs. ---------------------
    layout, rcfg = consts.part_layout, cfg.model.raster
    C, S, real = layout.num_parts, layout.seg_size, layout.real
    m = copy.deepcopy(init_model)
    out = net.forward_train(m, consts, batch["image"], cfg.model, probs=False)
    check(float(out["silhouette"].detach().amax()) > 0.5, "the predicted silhouette has no foreground")
    targets = {k: batch[k] for k in ("silhouette", "part_labels", "kp2d", "kp_vis")}
    total, _ = losses.total_loss(out, targets, cfg.loss_weight_dict, size)
    (g,) = torch.autograd.grad(total, out["score_cp"])
    g = g.reshape(B, C, size, size).contiguous()
    g_rand = torch.randn(g.shape, device=g.device, generator=torch.Generator(g.device).manual_seed(0))
    vx = raster.gather_class_sorted(out["verts2d"].detach(), layout)
    vt = vx.transpose(1, 2).contiguous()
    with torch.no_grad():
        fk = raster_cuda.raster_fwd_cuda(vt, real, C, S, rcfg)
        ft = raster_cuda.raster_scores4(vx, real, C, S, rcfg, impl="torch")
        fc = raster_cuda.raster_scores_culled_torch(vx, real, C, S, rcfg)
        bk = {"loss": raster_cuda.raster_bwd_cuda(vt, g, real, C, S, rcfg),
              "random": raster_cuda.raster_bwd_cuda(vt, g_rand, real, C, S, rcfg)}
        bt = {"loss": raster_cuda.raster_scores_bwd_torch(vx, g, C, S, rcfg),
              "random": raster_cuda.raster_scores_bwd_torch(vx, g_rand, C, S, rcfg)}
        bc = {"loss": raster_cuda.raster_scores_bwd_culled_torch(vx, g, real, C, S, rcfg),
              "random": raster_cuda.raster_scores_bwd_culled_torch(vx, g_rand, real, C, S, rcfg)}
    torch.cuda.synchronize()
    check(not bool(((fk - ft).abs() > TOL + TOL * ft.abs()).any()),
          f"raster kernel vs twin at B={B}: max abs err {max_err(fk, ft)}")
    f_cerr = norm_err(fk, fc)
    check(f_cerr <= GRAD_TOL, f"raster kernel vs culled plain version at B={B}: normalised err {f_cerr}")
    print(
        f"[train] raster forward kernel at B={B} on the step's vertices: max abs err "
        f"{max_err(fk, ft):.3e} against the exact twin, normalised {f_cerr:.3e} against the culled "
        f"plain version; the culling's own error (culled vs exact) {max_err(fc, ft):.3e} max abs"
    )
    # Each kernel is held to the culled plain version, the function it
    # computes, on both cotangents. On the loss's own cotangent the culling
    # itself shows against the exact twin: the part-CE term's cotangent,
    # -1/(P·score of the label), is largest where scores are tiny, so the
    # Gaussian tails the culled sum leaves out (each below exp(-18) of its
    # peak) come back multiplied by it. The reference's Pallas backward
    # culls the same way (its boxes keep the padding).
    for name in ("loss", "random"):
        k_c, k_t, c_t = norm_err(bk[name], bc[name]), norm_err(bk[name], bt[name]), norm_err(bc[name], bt[name])
        check(k_c <= GRAD_TOL, f"raster backward kernel vs culled plain version at B={B}, {name} cotangent: {k_c}")
        exact_tol = CULL_TOL if name == "loss" else GRAD_TOL
        check(k_t <= exact_tol, f"raster backward kernel vs twin at B={B}, {name} cotangent: normalised err {k_t}")
        check(c_t <= CULL_TOL, f"culled plain version vs twin at B={B}, {name} cotangent: normalised err {c_t}")
        check(float(bk[name].abs().max()) > 0, f"raster backward kernel: the {name} cotangent's gradient is all zero")
        print(
            f"[train] raster backward kernel at B={B}, {name} cotangent: normalised err {k_c:.3e} "
            f"against the culled plain version, {k_t:.3e} against the exact twin; the culling's own "
            f"error (culled vs exact) {c_t:.3e}"
        )
    print(f"[train] loss cotangent |g| up to {float(g.abs().max()):.3g}, median {float(g.abs().median()):.3g}")

    work = raster_work(vx, layout, rcfg)
    f32 = dataclasses.replace(rcfg, matmul_precision="highest")  # the float32 yardstick
    fwd = {"max_abs_err": max_err(fk, ft), **raster_bound(vx, layout, rcfg, work, backward=False)}
    bwd = {"max_abs_err": max_err(bk["loss"], bt["loss"]), **raster_bound(vx, layout, rcfg, work, backward=True)}
    with torch.no_grad():
        fwd["ms"] = device_ms(lambda: raster_cuda.raster_fwd_cuda(vt, real, C, S, rcfg), 20)
        fwd["plain_ms"] = device_ms(lambda: raster_cuda.raster_scores4(vx, real, C, S, rcfg, impl="torch"), 1, reps=3)
        bwd["ms"] = device_ms(lambda: raster_cuda.raster_bwd_cuda(vt, g, real, C, S, rcfg), 20)
        bwd["plain_ms"] = device_ms(lambda: raster_cuda.raster_scores_bwd_torch(vx, g, C, S, rcfg), 1, reps=3)
        fwd["library_ms"] = device_ms(lambda: raster.separable_scores(vx, C, S, f32), 10)
        sep_f = raster.separable_scores(vx, C, S, f32)
    v_req = vx.detach().clone().requires_grad_(True)
    sep = raster.separable_scores(v_req, C, S, f32)
    bwd["library_ms"] = events_ms(lambda: torch.autograd.grad(sep, v_req, g, retain_graph=True), 10)
    (sep_b,) = torch.autograd.grad(sep, v_req, g)
    del sep
    print(
        f"[train] separable torch yardstick at B={B}: forward max abs err {max_err(sep_f, ft):.3e} "
        f"against the exact twin, backward (loss cotangent) normalised "
        f"{norm_err(sep_b.transpose(1, 2), bt['loss']):.3e}"
    )
    for name, r in (("forward", fwd), ("backward", bwd)):
        print(
            f"[train] raster {name} on the step's prediction, B={B}: kernel {r['ms']:.4f} ms, "
            f"separable torch {r['library_ms']:.4f} ms, twin {r['plain_ms']:.4f} ms; bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; operations by {r['ops_bound_by']}; one exp per "
            f"pair would read {r['bound_ms_exp_per_pair']:.4f} ms); pairs: {r['pairs']} needed, "
            f"{r['pairs_in_kernel_boxes']} computed ({r['pairs_in_kernel_boxes'] / r['pairs']:.2f}x); "
            f"{r['exps']} factor exponentials, {r['g_pixels']} cotangent pixels inside the boxes [{smi}]"
        )
    sep = separable_phase(
        cfg, consts, vx, g, ft, bt["loss"], (fwd["ms"], bwd["ms"]), kernel_terms,
        lambda c: step1(c, cfg.model.encoder)[1], smi,
    )
    fwd["separable_bf16_ms"], bwd["separable_bf16_fwd_bwd_ms"] = sep
    return {"launches": launches, "raster_fwd": fwd, "raster_bwd": bwd, "ms_per_step": med}


def separable_phase(cfg, consts, vx, g, exact, exact_grad, kernel_ms, kernel_terms, step_terms, smi):
    """The reference's default raster, `raster.separable_scores`, at B=32 on
    the config4_full step's predicted slots `vx` and loss cotangent `g`:
    'highest' against the exact twin's scores `exact`; 'high', 'default'
    and the bf16 training scores against 'highest'; the bf16 forward and
    forward + backward timed beside the kernels' `kernel_ms`; and the step's
    loss terms with `raster_impl='separable'` (the presets' bf16 scores)
    against the kernel step's `kernel_terms`. Returns the two bf16 times."""
    layout, rcfg = consts.part_layout, cfg.model.raster
    C, S, B = layout.num_parts, layout.seg_size, vx.shape[0]

    def sep(precision, v=vx, out_dtype=None):
        rc = dataclasses.replace(rcfg, matmul_precision=precision)
        return raster.separable_scores(v, C, S, rc, out_dtype)

    with torch.no_grad():
        scores = {p: sep(p) for p in raster.PRECISIONS}
        bf16 = sep(rcfg.matmul_precision, out_dtype=torch.bfloat16)
    hi = scores["highest"]
    bad = (hi - exact).abs() > TOL + TOL * exact.abs()
    check(not bool(bad.any()), f"separable 'highest' vs the exact twin at B={B}: max abs err {max_err(hi, exact)}")
    errs = {p: norm_err(scores[p], hi) for p in ("high", "default")}
    errs["bf16 training scores"] = norm_err(bf16.float(), hi)
    for name, tol in (("high", SEP_HIGH_TOL), ("default", SEP_DEFAULT_TOL), ("bf16 training scores", SEP_BF16_TOL)):
        check(errs[name] <= tol, f"separable {name} vs 'highest' at B={B}: normalised err {errs[name]} > {tol}")
    print(
        f"[separable] B={B} on the step's slots: 'highest' max abs err {max_err(hi, exact):.3e} against "
        f"the exact twin; normalised against 'highest' (max score {float(hi.max()):.3f}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
    )

    g16 = g.to(torch.bfloat16)
    v_req = vx.detach().clone().requires_grad_(True)

    def slot_grad(precision, out_dtype=None):
        cot = g16 if out_dtype == torch.bfloat16 else g
        (d,) = torch.autograd.grad(sep(precision, v_req, out_dtype), v_req, cot)
        return d.transpose(1, 2)

    grads = {p: slot_grad(p) for p in raster.PRECISIONS}
    grad_errs = {
        "'highest' vs the exact twin": (norm_err(grads["highest"], exact_grad), GRAD_TOL),
        "'high' vs 'highest'": (norm_err(grads["high"], grads["highest"]), SEP_HIGH_TOL),
        "'default' vs 'highest'": (norm_err(grads["default"], grads["highest"]), SEP_DEFAULT_TOL),
        "bf16 training scores vs the exact twin": (
            norm_err(slot_grad(rcfg.matmul_precision, torch.bfloat16), exact_grad), SEP_BF16_TOL),
    }
    for name, (err, tol) in grad_errs.items():
        check(err <= tol, f"separable slot gradient {name} at B={B}: normalised err {err} > {tol}")
    print(
        f"[separable] slot gradient on the loss cotangent at B={B}, normalised: "
        + ", ".join(f"{k} {v[0]:.3e}" for k, v in grad_errs.items())
    )
    with torch.no_grad():
        fwd_ms = device_ms(lambda: sep(rcfg.matmul_precision, out_dtype=torch.bfloat16), 20)

    def fwd_bwd():
        out = sep(rcfg.matmul_precision, v_req, torch.bfloat16)
        return torch.autograd.grad(out, v_req, g16)

    fwd_bwd_ms = events_ms(fwd_bwd, 10)
    print(
        f"[separable] bf16 training scores at B={B}: forward {fwd_ms:.4f} ms (raster forward kernel "
        f"{kernel_ms[0]:.4f} ms), forward + backward on the loss cotangent {fwd_bwd_ms:.4f} ms (the "
        f"kernels {kernel_ms[0] + kernel_ms[1]:.4f} ms) [{smi}]"
    )

    cfg_s = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, raster_impl="separable"))
    terms = step_terms(cfg_s)
    term_err = {k: abs(terms[k] - v) / max(abs(v), 1e-12) for k, v in kernel_terms.items()}
    worst = max(term_err, key=term_err.get)
    check(
        term_err[worst] <= SEP_STEP_TOL,
        f"config4_full step 1 with raster_impl='separable' vs the kernels: {worst} rel err {term_err[worst]}",
    )
    print(
        f"[separable] config4_full step 1 with raster_impl='separable' (bf16 scores) vs the kernels: "
        f"loss terms rel err " + ", ".join(f"{k} {v:.2e}" for k, v in sorted(term_err.items()))
    )
    return fwd_ms, fwd_bwd_ms


def mixed_phase(asset, smi) -> dict:
    """config4_mixed at full width (ResNet-34, rot6d, b32, 256², cosine
    warm-up, clip 1.0, the 3D weights) with an EMA of decay 0.999: counted
    fused steps, one call of MIXED_CALL steps, then `evaluate` of the model
    and its EMA, and of the model with the plain versions forced."""
    cfg = dataclasses.replace(configs.CONFIG4_MIXED, ema_decay=0.999)
    B = cfg.batch_size
    ts, consts = train.init_state(cfg, asset=asset, device="cuda")
    with torch.no_grad():  # keep the seed-0 bodies in frame (see main)
        ts.model.ief.layers[-1].weight.mul_(0.01)
    ts = train.new_state(ts.model, cfg, cfg.seed)  # the EMA starts at the scaled weights
    for _ in range(MIXED_WARMUP):
        train.fused_step(ts, consts, cfg)
    torch.cuda.synchronize()

    # --- Counted: fused steps of the mixed recipe. --------------------------
    _build.reset_counts()
    times, totals = [], []
    for _ in range(MIXED_STEPS):
        t0 = time.perf_counter()
        terms = train.fused_step(ts, consts, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        totals.append(float(terms["total"]))
    launches = _build.counts()
    for name, per in PER_STEP.items():
        check(launches.get(name, 0) == per * MIXED_STEPS,
              f"config4_mixed: kernel {name} launched {launches.get(name, 0)} times in {MIXED_STEPS} steps")
    check(all(np.isfinite(totals)), f"config4_mixed: non-finite loss {totals}")
    check(all(k in terms for k in ("j3d", "rotmat", "betas_l2")), f"config4_mixed: 3D terms missing: {sorted(terms)}")
    med = statistics.median(times)
    print(
        f"[mixed] config4_mixed B={B} {cfg.model.image_size}^2 (ResNet-34, rot6d, cosine, clip "
        f"{cfg.grad_clip_norm}, EMA {cfg.ema_decay}): launches over {MIXED_STEPS} steps {launches}; "
        f"median {med:.3f} ms/step ({B / med * 1e3:.1f} img/s), p90 {float(np.percentile(times, 90)):.3f} ms; "
        f"loss {totals[0]:.4f} -> {totals[-1]:.4f}; terms "
        + ", ".join(f"{k} {float(v):.4g}" for k, v in sorted(terms.items())) + f" [{smi}]"
    )

    chunk = dataclasses.replace(cfg, steps_per_call=MIXED_CALL)
    step0 = ts.step
    _build.reset_counts()
    t0 = time.perf_counter()
    terms = train.fused_step(ts, consts, chunk)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    call_launches = _build.counts()
    check(ts.step == step0 + MIXED_CALL, f"steps_per_call={MIXED_CALL} took {ts.step - step0} steps")
    for name, per in PER_STEP.items():
        check(call_launches.get(name, 0) == per * MIXED_CALL,
              f"steps_per_call={MIXED_CALL}: kernel {name} launched {call_launches.get(name, 0)} times")
    check(bool(np.isfinite(float(terms["total"]))), "steps_per_call: non-finite loss")
    print(f"[mixed] one call of steps_per_call={MIXED_CALL}: {call_ms:.3f} ms, launches {call_launches}")

    # --- evaluate: the model, its EMA, and the model with plain versions. ---
    _build.reset_counts()
    metrics = {"model": evaluate.evaluate(ts.model, consts, cfg, EVAL_BATCHES)}
    eval_launches = _build.counts()
    per_batch = {lbs_cuda.KERNEL: 3, raster_cuda.KERNEL: 2}  # batch, forward, ground truth SMPL
    for name, per in per_batch.items():
        check(eval_launches.get(name, 0) == per * EVAL_BATCHES,
              f"evaluate: kernel {name} launched {eval_launches.get(name, 0)} times in {EVAL_BATCHES} batches")
    check(eval_launches.get(raster_cuda.KERNEL_BWD, 0) == 0, "evaluate launched the raster backward kernel")
    metrics["EMA"] = evaluate.evaluate(train.ema_model(ts), consts, cfg, EVAL_BATCHES)
    plain = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, smpl_impl="torch", raster_impl="torch"))
    metrics["plain versions"] = evaluate.evaluate(ts.model, consts, plain, EVAL_BATCHES)
    for label, m in metrics.items():
        check(all(np.isfinite(v) for v in m.values()), f"evaluate ({label}): non-finite metric {m}")
        for k in ("sil_iou", "part_acc", "miou"):
            check(0.0 <= m[k] <= 1.0, f"evaluate ({label}): {k} = {m[k]} outside [0, 1]")
        print(f"[eval] {label}, {EVAL_BATCHES} x {B} images: " + ", ".join(f"{k} {v:.5f}" for k, v in sorted(m.items())))
    k_m, p_m = metrics["model"], metrics["plain versions"]
    diff = {k: abs(k_m[k] - p_m[k]) / (1.0 if k in EVAL_ABS else max(abs(p_m[k]), 1e-12)) for k in k_m}
    for k, d in diff.items():
        tol = EVAL_ABS_TOL if k in EVAL_ABS else EVAL_REL_TOL
        check(d <= tol, f"evaluate, kernels vs plain versions: {k} differs by {d} > {tol}")
    print(
        "[eval] kernels vs plain versions: " + ", ".join(f"{k} {v:.2e}" for k, v in sorted(diff.items()))
        + f" (absolute for {', '.join(EVAL_ABS)}, relative otherwise); eval launches {eval_launches}"
    )
    return {"launches": launches, "ms_per_step": med, "eval_launches": eval_launches}


def same_state(a, b, devices: bool, where: str = "") -> None:
    """Check two nested state dicts bitwise equal, and each pair of tensors
    on one device when `devices`."""
    if torch.is_tensor(a):
        check(torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(a.cpu(), b.cpu()), f"restored state differs at {where}")
        check(not devices or a.device == b.device, f"restored state at {where} on {b.device}, not {a.device}")
    elif isinstance(a, dict):
        check(isinstance(b, dict) and set(a) == set(b), f"restored state's keys differ at {where}")
        for k in a:
            same_state(a[k], b[k], devices, f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"restored state's lengths differ at {where}")
        for i, (x, y) in enumerate(zip(a, b)):
            same_state(x, y, devices, f"{where}[{i}]")
    else:
        check(a == b, f"restored state differs at {where}: {a!r} != {b!r}")


@contextlib.contextmanager
def scaled_init():
    """Inside the block `train.init_state` (so `train.fit`) starts from the
    seed-0 model with its IEF output layer scaled by 0.01 (see main), the
    EMA starting there too."""
    plain = train.init_state

    def scaled(cfg, *args, **kwargs):
        ts, consts = plain(cfg, *args, **kwargs)
        with torch.no_grad():
            ts.model.ief.layers[-1].weight.mul_(0.01)
        return train.new_state(ts.model, cfg, cfg.seed), consts

    train.init_state = scaled
    try:
        yield
    finally:
        train.init_state = plain


@contextlib.contextmanager
def batches_at(step: int, store: list):
    """Inside the block each batch `train.make_batch` makes for `step` is
    appended to `store`."""
    plain = train.make_batch

    def recording(seed, s, *args):
        batch = plain(seed, s, *args)
        if s == step:
            store.append(batch)
        return batch

    train.make_batch = recording
    try:
        yield
    finally:
        train.make_batch = plain


def tb_records(path: str) -> int:
    """The number of records of a TensorBoard event file, each record's
    length and payload CRC32C checked."""
    with open(path, "rb") as f:
        data = f.read()
    n, i = 0, 0
    while i < len(data):
        header = data[i : i + 8]
        (size,) = struct.unpack("<Q", header)
        payload = data[i + 12 : i + 12 + size]
        check(struct.unpack("<I", data[i + 8 : i + 12])[0] == metrics._masked_crc(header),
              f"{path}: record {n} length CRC")
        check(struct.unpack("<I", data[i + 12 + size : i + 16 + size])[0] == metrics._masked_crc(payload),
              f"{path}: record {n} payload CRC")
        n, i = n + 1, i + 16 + size
    return n


def hard_raster_phase(cfg, consts, smi) -> dict:
    """The hard raster at the robust step's batch, on its own bodies (batch 0
    of the stream): against the CPU run of the same function and, on one
    image, the float64 oracle; timed dense (as the step runs it) and with
    HARD_K_FACES slots a tile, whose overflow is printed."""
    B, S, scfg = cfg.batch_size, cfg.model.image_size, cfg.synthetic
    gen = torch.Generator(device="cuda").manual_seed(train.step_seed(cfg.seed, 0))
    draws = synthetic.sample_draws(gen, B, consts, scfg, S)
    verts = smpl.smpl_forward(consts.smpl, draws["pose"], draws["betas"], impl=cfg.model.smpl_impl)["verts"]
    v2, vz, light = camera.project_pixel(verts, draws["cam"], S), verts[..., 2], draws["light"]
    card = raster_hard.hard_raster(v2, vz, consts.hard, S, with_shade=True, light=light)
    torch.cuda.synchronize()
    hc_cpu = raster_hard.HardConsts(consts.hard.faces.cpu(), consts.hard.face_class.cpu())
    t0 = time.perf_counter()
    pieces = [
        raster_hard.hard_raster(v2[i : i + HARD_CPU_IMAGES].cpu(), vz[i : i + HARD_CPU_IMAGES].cpu(), hc_cpu,
                                S, chunk=HARD_CPU_CHUNK, with_shade=True, light=light[i : i + HARD_CPU_IMAGES].cpu())
        for i in range(0, B, HARD_CPU_IMAGES)
    ]
    cpu_s = time.perf_counter() - t0
    cpu = {k: torch.cat([p[k] for p in pieces]) for k in ("part_labels", "silhouette", "shade")}
    labels = card["part_labels"].cpu()
    fg = float(card["silhouette"].mean())
    check(0.01 < fg < 0.9, f"hard raster: silhouette covers {fg} of the pixels")
    agree = float((labels == cpu["part_labels"]).double().mean())
    check(agree >= HARD_AGREE, f"hard raster, card vs CPU at B={B}: labels agree on {agree} < {HARD_AGREE}")
    check(torch.equal(card["silhouette"].cpu(), cpu["silhouette"]), f"hard raster, card vs CPU at B={B}: silhouettes differ")
    shade_err = max_err(card["shade"].cpu(), cpu["shade"])
    lab, _ = raster_hard.hard_raster_oracle(
        v2[0].cpu().numpy(), vz[0].cpu().numpy(), hc_cpu.faces.numpy(), hc_cpu.face_class.numpy(), S
    )
    o_agree = float((lab == labels[0].numpy()).mean())
    check(o_agree >= ORACLE_AGREE, f"hard raster vs the float64 oracle: labels agree on {o_agree} < {ORACLE_AGREE}")
    print(
        f"[robust] hard raster B={B} {S}^2, {consts.hard.faces.shape[0]} faces, silhouette {fg:.4f} of the "
        f"pixels: card vs CPU labels agree on {agree:.6f}, silhouettes equal, shade max abs err "
        f"{shade_err:.3e} (CPU run {cpu_s:.1f} s); image 0 vs the float64 oracle {o_agree:.6f}"
    )

    def run(k=None):
        return raster_hard.hard_raster(v2, vz, consts.hard, S, k_faces=k, with_shade=True, light=light)

    culled = run(HARD_K_FACES)
    overflow = int(culled["overflow"])
    c_agree = float((culled["part_labels"] == card["part_labels"]).double().mean())
    dense_ms, culled_ms = events_ms(run, 3), events_ms(lambda: run(HARD_K_FACES), 3)
    print(
        f"[robust] hard raster B={B} {S}^2 with shade: dense {dense_ms:.3f} ms; k_faces={HARD_K_FACES} "
        f"{culled_ms:.3f} ms, overflow {overflow} faces, labels as dense on {c_agree:.6f} [{smi}]"
    )
    return {"dense_ms": dense_ms, "k_faces_ms": culled_ms, "k_faces_overflow": overflow,
            "card_vs_cpu": agree, "oracle": o_agree}


def robust_phase(asset, smi) -> dict:
    """config4_robust at full width (ResNet-34, rot6d, b32, 256², hard
    targets, textured backgrounds, palette jitter, shading, occluders) with
    an EMA of decay 0.999, from the scaled seed-0 weights: the hard raster
    checked and timed; counted fused steps (2 LBS, 1 raster forward, 1 raster
    backward launches each); a checkpoint's save and restore; `fit` to step
    RESUME_K, resumed to 2 * RESUME_K, against a straight run; the metrics
    files read back; `tools/quality_eval.py` on the checkpoint and its EMA on
    each suite, and the kernels against the plain versions on one."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(configs.CONFIG4_ROBUST, ema_decay=0.999)
    B, k = cfg.batch_size, RESUME_K
    with scaled_init():
        ts, consts = train.init_state(cfg, asset=asset, device="cuda")
    hard = hard_raster_phase(cfg, consts, smi)

    for _ in range(ROBUST_WARMUP):
        train.fused_step(ts, consts, cfg)
    torch.cuda.synchronize()
    # --- Counted: fused steps of the robust recipe. --------------------------
    _build.reset_counts()
    times, totals = [], []
    for _ in range(ROBUST_STEPS):
        t0 = time.perf_counter()
        terms = train.fused_step(ts, consts, cfg)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        totals.append(float(terms["total"]))
    launches = _build.counts()
    for name, per in PER_STEP_ROBUST.items():
        check(launches.get(name, 0) == per * ROBUST_STEPS,
              f"config4_robust: kernel {name} launched {launches.get(name, 0)} times in {ROBUST_STEPS} steps")
    check(all(np.isfinite(totals)), f"config4_robust: non-finite loss {totals}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train.fused_step(ts, consts, cfg)
        torch.cuda.synchronize()
    dev = device_summary(prof, 1)
    med = statistics.median(times)
    print(
        f"[robust] config4_robust B={B} (ResNet-34, rot6d, hard targets, hardapp appearance, EMA "
        f"{cfg.ema_decay}): launches over {ROBUST_STEPS} steps {launches}; median {med:.3f} ms/step "
        f"({B / med * 1e3:.1f} img/s), device {dev['device_ms']:.3f} ms and {dev['kernels']:.0f} kernels "
        f"in one profiled step; loss {totals[0]:.4f} -> {totals[-1]:.4f} [{smi}]"
    )

    with tempfile.TemporaryDirectory(prefix="ilps_robust_") as work:
        # --- A checkpoint of this state: save, restore, bitwise. -------------
        ckpt = Checkpointer(os.path.join(work, "timing"))
        t0 = time.perf_counter()
        ckpt.save(ts.step, train.state_dict(ts))
        snapshot_s = time.perf_counter() - t0
        ckpt.wait()
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        saved = ckpt.restore(map_location="cuda")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        same_state(train.state_dict(ts), saved, devices=False)
        mb = os.path.getsize(os.path.join(work, "timing", str(ts.step), "state.pt")) / 1e6
        print(
            f"[robust] checkpoint of step {ts.step}: {mb:.1f} MB; save {save_s:.3f} s ({snapshot_s:.3f} s "
            f"blocking the caller, the rest on the writer thread), restore to the card {restore_s:.3f} s; "
            f"restored state bitwise equal"
        )
        del saved

        # --- fit to k, resume to 2k, against a straight 2k. -----------------
        base = dataclasses.replace(cfg, num_steps=2 * k, log_every=1)
        split = dataclasses.replace(
            base, checkpoint_every=k, checkpoint_dir=os.path.join(work, "split"),
            metrics_path=os.path.join(work, "metrics.jsonl"), tensorboard_dir=os.path.join(work, "tb"),
        )
        with scaled_init():
            ts_k, _ = train.fit(split, num_steps=k, asset=asset, device="cuda")
            fresh, _ = train.init_state(split, asset=asset, device="cuda")
        train.load_state_dict(fresh, Checkpointer(split.checkpoint_dir).restore(map_location="cpu"))
        check(fresh.step == k, f"restored step {fresh.step} != {k}")
        same_state(train.state_dict(ts_k), train.state_dict(fresh), devices=True)
        del fresh, ts_k
        first_resumed, first_straight = [], []
        with scaled_init(), batches_at(k, first_resumed):
            ts_r, terms_r = train.fit(split, asset=asset, device="cuda")
        with scaled_init(), batches_at(k, first_straight):
            ts_s, terms_s = train.fit(base, asset=asset, device="cuda")
        check(ts_r.step == ts_s.step == 2 * k, f"steps {ts_r.step}, {ts_s.step} != {2 * k}")
        check(len(first_resumed) == len(first_straight) == 1, "the batch of the resumed step was not made once")
        (b_r,), (b_s,) = first_resumed, first_straight
        check(set(b_r) == set(b_s) and all(torch.equal(b_r[key], b_s[key]) for key in b_s),
              f"the resumed run's batch of step {k} differs from the straight run's")
        rel = {t: abs(terms_r[t] - v) / max(abs(v), 1e-6) for t, v in terms_s.items()}
        worst = max(rel, key=rel.get)
        check(set(terms_r) == set(terms_s) and rel[worst] <= RESUME_TOL,
              f"resumed vs straight run at step {2 * k}: {worst} rel err {rel[worst]} > {RESUME_TOL}")
        print(
            f"[robust] fit to step {k} (checkpoint_every={k}), restored state bitwise equal to the run's "
            f"(parameters, BN statistics, Adam moments and counts, schedule, EMA, step, seed); resumed to "
            f"{2 * k}: its batch of step {k} bitwise the straight run's; loss terms at step {2 * k} against "
            f"the straight run's: worst {worst} rel err {rel[worst]:.3e} (tolerance {RESUME_TOL:g})"
        )
        del ts_r, ts_s, first_resumed, first_straight, b_r, b_s

        # --- The metrics files: one line and one event a logged step. --------
        with open(split.metrics_path) as f:
            lines = [json.loads(x) for x in f.read().splitlines()]
        check([r["step"] for r in lines] == list(range(2 * k)), f"metrics JSONL steps {[r['step'] for r in lines]}")
        events = sorted(os.listdir(split.tensorboard_dir))
        records = [tb_records(os.path.join(split.tensorboard_dir, e)) for e in events]
        check(records == [1 + k, 1 + k], f"TensorBoard files {events}: records {records}, not {1 + k} each")
        print(f"[robust] metrics: {len(lines)} JSONL lines, TensorBoard files with {records} records, every CRC valid")

        # --- tools/quality_eval.py on the checkpoint and its EMA. -----------
        summaries, q_launches = {}, {}
        for suite in QUALITY_SUITES:
            for ema in (False, True):
                argv = ["--preset", "config4_robust", "--checkpoint", split.checkpoint_dir, "--eval-suite", suite,
                        "--batches", "1", "--seeds", *map(str, QUALITY_SEEDS)] + (["--ema"] if ema else [])
                out = io.StringIO()
                _build.reset_counts()
                with contextlib.redirect_stdout(out):
                    check(quality_eval.main(argv) == 0, f"quality_eval {argv} failed")
                q_launches[suite, ema] = _build.counts()
                res = json.loads(out.getvalue().strip().splitlines()[-1])
                summaries[suite, ema] = res["metrics"]
                for m, v in res["metrics"].items():
                    check(np.isfinite(v["mean"]) and np.isfinite(v["pm"]), f"quality_eval {suite}: {m} {v}")
                print(
                    f"[quality] step {2 * k} {'EMA' if ema else 'model'}, suite {suite}, "
                    f"{len(QUALITY_SEEDS)} seeds x 1 x {B} images: "
                    + ", ".join(f"{m} {v['mean']:.5f}±{v['pm']:.5f}" for m, v in sorted(res["metrics"].items()))
                )
        check(summaries["plain", False] != summaries["hardapp", False],
              "quality_eval: the plain and hardapp suites scored the same stream")
        n = len(QUALITY_SEEDS)
        for (suite, ema), got in q_launches.items():
            want = {lbs_cuda.KERNEL: 3 * n, raster_cuda.KERNEL: 2 * n} if suite == "plain" else {
                name: per * n for name, per in PER_EVAL_BATCH_HARD.items()}
            check(all(got.get(name, 0) == c for name, c in want.items()) and not got.get(raster_cuda.KERNEL_BWD),
                  f"quality_eval {suite}: launches {got}, not {want}")

        cfg_q, _ = evaluate.eval_config(configs.CONFIG4_ROBUST, suite="hardapp")
        model, consts_q = predict.load_model(cfg_q.model, asset=asset, device="cuda",
                                             checkpoint_dir=split.checkpoint_dir)
        plain = dataclasses.replace(cfg_q, model=dataclasses.replace(cfg_q.model, smpl_impl="torch", raster_impl="torch"))
        _, k_sum = quality_eval.protocol(model, consts_q, cfg_q, QUALITY_SEEDS, 1)
        _, p_sum = quality_eval.protocol(model, consts_q, plain, QUALITY_SEEDS, 1)
        diff = {m: abs(k_sum[m]["mean"] - p_sum[m]["mean"]) / (1.0 if m in EVAL_ABS else max(abs(p_sum[m]["mean"]), 1e-12))
                for m in k_sum}
        for m, d in diff.items():
            check(d <= (EVAL_ABS_TOL if m in EVAL_ABS else EVAL_REL_TOL),
                  f"quality_eval hardapp, kernels vs plain versions: {m} differs by {d}")
        print(
            "[quality] hardapp, kernels vs plain versions: " + ", ".join(f"{m} {v:.2e}" for m, v in sorted(diff.items()))
            + f" (absolute for {', '.join(EVAL_ABS)}, relative otherwise); launches per call {q_launches['hardapp', False]}"
        )
    torch.cuda.empty_cache()
    print(f"[robust] phase in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "ms_per_step": med, "device_ms": dev["device_ms"], "hard": hard,
            "checkpoint_s": {"save": save_s, "snapshot": snapshot_s, "restore": restore_s, "mb": mb}}


@contextlib.contextmanager
def measuring_prefetch(store: list):
    """Inside the block each `dataset.prefetch_to_device` measures into a
    `PrefetchStats` appended to `store`."""
    plain = dataset_lib.prefetch_to_device

    def prefetch(*args, **kwargs):
        store.append(dataset_lib.PrefetchStats())
        return plain(*args, stats=store[-1], **kwargs)

    dataset_lib.prefetch_to_device = prefetch
    try:
        yield
    finally:
        dataset_lib.prefetch_to_device = plain


@contextlib.contextmanager
def recording_disk_steps(store: dict):
    """Inside the block `train.data_train_step` records, under its step, the
    raw batch it was given and the augmentation draws it made, both copied
    to host memory, into store["raw"] and store["draws"]."""
    plain_step, plain_draws = train.data_train_step, train.augment_draws

    def draws(seed, step, *args):
        d = plain_draws(seed, step, *args)
        store.setdefault("draws", {})[step] = {k: v.cpu() for k, v in d.items()}
        return d

    def step(ts, raw, *args):
        store.setdefault("raw", {})[ts.step] = {k: v.cpu() for k, v in raw.items()}
        return plain_step(ts, raw, *args)

    train.data_train_step, train.augment_draws = step, draws
    try:
        yield
    finally:
        train.data_train_step, train.augment_draws = plain_step, plain_draws


def native_check(rng) -> dict:
    """The native host preprocessor built with g++ and loaded, bitwise
    against its numpy versions on NATIVE_IMAGES ragged images."""
    t0 = time.perf_counter()
    lib = native_preprocess.build()
    native_preprocess._load()
    build_s = time.perf_counter() - t0
    check(native_preprocess.USE_NATIVE, "the native preprocessor was not built and loaded on the card host")
    imgs = [rng.randint(0, 256, (200 + 17 * i, 180 + 13 * (i % 7), 3)).astype(np.uint8) for i in range(NATIVE_IMAGES)]
    masks = [np.zeros(im.shape[:2], np.uint8) for im in imgs]
    for i, m in enumerate(masks):
        m[20 + i : 150 + i, 30 : 120 + i] = 1 + i % 24
    masks[1][:] = 0  # an empty mask: the full frame
    boxes = np.stack([native_preprocess.bbox_from_mask(m) for m in masks])
    want_boxes = np.stack([native_preprocess._np_bbox_from_mask(m, 1.15) for m in masks])
    check(np.array_equal(boxes, want_boxes), "native bbox_from_mask differs from the numpy version")
    boxes[2], boxes[3] = (10.0, 5.0, 300.0), (250.0, 200.0, 120.0)  # past the border
    t0 = time.perf_counter()
    out = native_preprocess.crop_resize_normalize(imgs, boxes, 256)
    crop_ms = (time.perf_counter() - t0) * 1e3
    want = np.stack([native_preprocess._np_crop_resize(im, b, 256) for im, b in zip(imgs, boxes)])
    check(np.array_equal(out, want * (np.float32(1.0) / np.float32(127.5)) - np.float32(1.0)),
          "native crop_resize_normalize differs from the numpy version")
    mask_out = native_preprocess.crop_resize_mask(masks, boxes, 256)
    want_masks = np.stack([native_preprocess._np_crop_resize(m, b, 256, nearest=True) for m, b in zip(masks, boxes)])
    check(np.array_equal(mask_out, want_masks), "native crop_resize_mask differs from the numpy version")
    print(
        f"[disk] native preprocessor {lib.name}: built and loaded in {build_s:.2f} s (USE_NATIVE "
        f"{native_preprocess.USE_NATIVE}); bbox_from_mask, crop_resize_normalize and crop_resize_mask bitwise "
        f"equal to the numpy versions on {NATIVE_IMAGES} ragged images; {NATIVE_IMAGES} crops to 256^2 in "
        f"{crop_ms:.1f} ms on {os.cpu_count()} threads"
    )
    return {"build_s": build_s, "crop_ms": crop_ms}


def disk_phase(asset, smi) -> dict:
    """config4_full at full width (b32, 256² crops) on a disk dataset at
    320² written by the port: the native host preprocessor; the writer's
    time and launches; one raw batch preprocessed on the card against the
    CPU (augmentation off and on, the same draws) and prefetched batches
    bitwise equal to plain copies; `fit_dataset` with augmentation for
    DISK_STEPS steps (one LBS, one raster forward and one raster backward
    launch each), a profiled window of disk steps, the prefetcher's
    copies and waits and the preprocess's device time; resumed at half way
    against the straight run, over the file and over shards;
    `evaluate_dataset`, and the kernels against the plain versions on its
    first batch; the image-directory path where PIL imports."""
    from torch.profiler import ProfilerActivity, profile

    t_phase = time.perf_counter()
    rng = np.random.RandomState(8)
    native = native_check(rng)
    cfg = dataclasses.replace(
        configs.CONFIG4_FULL, log_every=1,
        augment=dataclasses.replace(configs.CONFIG4_FULL.augment, enabled=True),
    )
    B, size, half = cfg.batch_size, cfg.model.image_size, DISK_STEPS // 2
    cuda = torch.device("cuda")
    with tempfile.TemporaryDirectory(prefix="ilps_disk_") as work:
        # --- The writer: the port's generator at 320², kernels on the card. --
        path = os.path.join(work, "d.npz")
        _build.reset_counts()
        t0 = time.perf_counter()
        arrays = dataset_lib.make_synthetic_dataset(path, DISK_EXAMPLES, source_size=DISK_SOURCE, asset=asset)
        write_s = time.perf_counter() - t0
        dataset_launches = _build.counts()
        chunks = -(-DISK_EXAMPLES // 64)
        for name in (lbs_cuda.KERNEL, raster_cuda.KERNEL):
            check(dataset_launches.get(name, 0) == chunks,
                  f"make_synthetic_dataset: kernel {name} launched {dataset_launches.get(name, 0)} times in {chunks} chunks")
        check(arrays["images"].shape == (DISK_EXAMPLES, DISK_SOURCE, DISK_SOURCE, 3) and arrays["images"].dtype == np.uint8
              and "gt_pose" in arrays and "gt_betas" in arrays, f"dataset arrays {sorted(arrays)}")
        fg = float((arrays["masks"] > 0).mean())
        check(fg > 0.01, f"the dataset's masks are {fg:.4f} foreground")
        mb = os.path.getsize(path) / 1e6
        print(
            f"[disk] make_synthetic_dataset: {DISK_EXAMPLES} examples at {DISK_SOURCE}^2 in {write_s:.2f} s "
            f"({DISK_EXAMPLES / write_s:.1f} examples/s, np.savez_compressed included), {mb:.1f} MB on disk, "
            f"foreground {fg:.3f}; launches {dataset_launches} ({chunks} chunks) [{smi}]"
        )
        del arrays

        # --- One raw batch: the card against the CPU; prefetch vs copies. ---
        ds = dataset_lib.NpzDataset(path, B, seed=cfg.seed)
        keys = ("images", "masks", "kp2d", "kp_vis")
        raw_np = {k: v for k, v in next(ds.batches()).items() if k in keys}
        raw_cpu = {k: torch.from_numpy(v) for k, v in raw_np.items()}
        raw_dev = {k: v.to(cuda) for k, v in raw_cpu.items()}
        draws = train.augment_draws(cfg.seed, 0, B, cfg, torch.device("cpu"))
        check(0 < int(draws["flip"].sum()) < B, "the injected draws do not mix flipped and unflipped items")
        errs = {}
        for label, d in (("plain", None), ("augmented", draws)):
            got = train.preprocess_raw_batch(raw_dev, cfg, None if d is None else {k: v.to(cuda) for k, v in d.items()})
            want = train.preprocess_raw_batch(raw_cpu, cfg, d)
            for k in ("part_labels", "silhouette", "kp_vis"):
                check(torch.equal(got[k].cpu(), want[k]), f"preprocess ({label}) on the card: {k} differs from the CPU")
            errs[label] = {k: max_err(got[k].cpu(), want[k]) for k in ("image", "kp2d")}
            for k, e in errs[label].items():
                check(e <= PREPROCESS_TOL, f"preprocess ({label}) on the card: {k} max abs err {e} > {PREPROCESS_TOL}")
        draws_dev = {k: v.to(cuda) for k, v in draws.items()}
        pre_ms = events_ms(lambda: train.preprocess_raw_batch(raw_dev, cfg, draws_dev), 10)
        staged = [b for _, b in zip(range(6), ds.batches())]
        prefetched = dataset_lib.prefetch_to_device(iter(staged), size=2, device=cuda)
        for i, (got, np_batch) in enumerate(zip(prefetched, staged)):
            for k, v in np_batch.items():
                check(torch.equal(got[k], torch.from_numpy(v).to(cuda)), f"prefetched batch {i} {k} differs from a plain copy")
        print(
            f"[disk] one raw batch of {B} at {DISK_SOURCE}^2 -> {size}^2 crops: preprocess on the card vs the CPU, "
            f"labels, silhouettes and visibility equal, max abs err " + "; ".join(
                f"{label} {', '.join(f'{k} {e:.2e}' for k, e in es.items())}" for label, es in errs.items())
            + f" (tolerance {PREPROCESS_TOL:g}); augmented preprocess {pre_ms:.3f} device ms; 6 prefetched "
            f"batches bitwise equal to plain .to('cuda') copies"
        )

        # --- fit_dataset: the run timed and counted. -------------------------
        measured, stamps = [], []
        _build.reset_counts()
        with scaled_init(), measuring_prefetch(measured):
            ts_s, terms = train.fit_dataset(cfg, ds, num_steps=DISK_STEPS, asset=asset, device="cuda",
                                            log=lambda rec: stamps.append(time.perf_counter()))
        launches = _build.counts()
        for name, per in PER_STEP_DISK.items():
            check(launches.get(name, 0) == per * DISK_STEPS,
                  f"fit_dataset: kernel {name} launched {launches.get(name, 0)} times in {DISK_STEPS} steps, not {per} per step")
        check(np.isfinite(terms["total"]), f"fit_dataset: non-finite loss {terms}")
        # Each logged step ends in the writer's host transfer, a synchronize.
        times = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
        med, p90 = statistics.median(times), float(np.percentile(times, 90))
        (stats,) = measured
        torch.cuda.synchronize()
        h2d = [a.elapsed_time(b) for a, b in stats.h2d_events]
        wait_ms = [w * 1e3 for w in stats.wait_s[1:]]  # the first wait includes the first load

        # --- A profiled window of disk steps (data_train_step, prefetched). -
        with scaled_init():
            ts_p, consts = train.init_state(cfg, asset=asset, device="cuda")
        pulls = train.dataset_pulls(cfg, ds.keys)
        batches = dataset_lib.prefetch_to_device(
            ({k: b[src] for k, src in pulls.items()} for b in ds.batches()), device=cuda)
        for _ in range(2):
            train.data_train_step(ts_p, next(batches), consts, cfg)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(DISK_PROFILED):
                train.data_train_step(ts_p, next(batches), consts, cfg)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / DISK_PROFILED
        batches.close()
        dev = device_summary(prof, DISK_PROFILED)
        del ts_p
        print(
            f"[disk] fit_dataset config4_full B={B} {size}^2 crops from {DISK_SOURCE}^2, --augment, {DISK_STEPS} steps "
            f"({ds.steps_per_epoch()} an epoch): launches {launches}; host median {med:.3f} ms/step, p90 {p90:.3f} ms "
            f"({B / med * 1e3:.1f} img/s) over steps 1-{DISK_STEPS - 1}; profiled window of {DISK_PROFILED} steps: "
            f"device {dev['device_ms']:.3f} ms/step, wall {wall:.3f} ms, busy share {dev['device_ms'] / wall:.3f}, "
            f"{dev['kernels']:.0f} kernels, by category {json.dumps({k: round(v, 3) for k, v in dev['by_category_ms'].items()})}; "
            f"H2D {statistics.median(h2d):.3f} ms/batch (median of {len(h2d)}), prefetch wait median "
            f"{statistics.median(wait_ms):.3f} ms, max {max(wait_ms):.3f} ms a step; preprocess {pre_ms:.3f} device ms "
            f"[{smi}]"
        )

        # --- Resume at half way against the straight run: file and shards. --
        shard_dir = os.path.join(work, "shards")
        dataset_lib.shard_npz(path, shard_dir, -(-DISK_EXAMPLES // DISK_SHARDS))
        for source, data in (("file", ds), ("shards", dataset_lib.open_dataset(shard_dir, B, seed=cfg.seed))):
            straight = {}
            with scaled_init(), recording_disk_steps(straight):
                _, terms_s = train.fit_dataset(cfg, data, num_steps=DISK_STEPS, asset=asset, device="cuda")
            split = dataclasses.replace(cfg, checkpoint_every=half, checkpoint_dir=os.path.join(work, f"ck_{source}"))
            resumed = {}
            with scaled_init():
                train.fit_dataset(split, data, num_steps=half, asset=asset, device="cuda")
                with recording_disk_steps(resumed):
                    ts_r, terms_r = train.fit_dataset(split, data, num_steps=DISK_STEPS, asset=asset, device="cuda")
            check(ts_r.step == DISK_STEPS and sorted(resumed["raw"]) == list(range(half, DISK_STEPS)),
                  f"{source}: the resumed run took steps {sorted(resumed['raw'])}")
            for step in range(half, DISK_STEPS):
                for what in ("raw", "draws"):
                    a, b = resumed[what][step], straight[what][step]
                    check(set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a),
                          f"{source}: the resumed run's {what} of step {step} differ from the straight run's")
            rel = {t: abs(terms_r[t] - v) / max(abs(v), 1e-6) for t, v in terms_s.items()}
            worst = max(rel, key=rel.get)
            check(set(terms_r) == set(terms_s) and rel[worst] <= RESUME_TOL,
                  f"{source}: resumed vs straight at step {DISK_STEPS}: {worst} rel err {rel[worst]} > {RESUME_TOL}")
            print(
                f"[disk] {source} ({len(getattr(data, 'paths', [path]))} file(s)): fit_dataset to step {half} with "
                f"checkpoints, resumed to {DISK_STEPS}: raw batches and augmentation draws of steps {half}-{DISK_STEPS - 1} "
                f"bitwise the straight run's; loss terms at step {DISK_STEPS}: worst {worst} rel err {rel[worst]:.3e} "
                f"(tolerance {RESUME_TOL:g})"
            )
            del ts_r

        # --- evaluate_dataset, and the kernels against the plain versions. --
        _build.reset_counts()
        consts_e = net.build_consts(asset, cfg.model, cuda)
        m = evaluate.evaluate_dataset(ts_s.model, consts_e, cfg, ds, max_batches=DISK_EVAL)
        eval_launches = _build.counts()
        for name, per in PER_EVAL_BATCH_DISK.items():
            check(eval_launches.get(name, 0) == per * DISK_EVAL,
                  f"evaluate_dataset: kernel {name} launched {eval_launches.get(name, 0)} times in {DISK_EVAL} batches")
        check(not eval_launches.get(raster_cuda.KERNEL_BWD), "evaluate_dataset launched the raster backward kernel")
        check(all(np.isfinite(v) for v in m.values()) and {"pve", "mpjpe", "pa_mpjpe"} <= set(m),
              f"evaluate_dataset: {m}")
        plain = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, smpl_impl="torch", raster_impl="torch"))
        k1 = evaluate.evaluate_dataset(ts_s.model, consts_e, cfg, ds, max_batches=1)
        p1 = evaluate.evaluate_dataset(ts_s.model, consts_e, plain, ds, max_batches=1)
        diff = {k: abs(k1[k] - p1[k]) / (1.0 if k in EVAL_ABS else max(abs(p1[k]), 1e-12)) for k in k1}
        for k, d in diff.items():
            check(d <= (EVAL_ABS_TOL if k in EVAL_ABS else EVAL_REL_TOL),
                  f"evaluate_dataset, kernels vs plain versions: {k} differs by {d}")
        print(
            f"[disk] evaluate_dataset, {DISK_EVAL} x {B} images (epoch 0, running-statistics BN): "
            + ", ".join(f"{k} {v:.5f}" for k, v in sorted(m.items())) + f"; launches {eval_launches}; first batch, "
            "kernels vs plain versions: " + ", ".join(f"{k} {v:.2e}" for k, v in sorted(diff.items()))
            + f" (absolute for {', '.join(EVAL_ABS)}, relative otherwise)"
        )

        # --- The image-directory path, where PIL imports. -------------------
        try:
            import PIL  # noqa: F401
        except ImportError:
            print("[disk] image directories: PIL does not import here, so the image-directory path was not driven")
        else:
            from indirect_learning_pose_shape_tpu_torch.data import image_dir

            root = os.path.join(work, "imgs")
            with np.load(path) as z:
                image_dir.export_image_dir({k: z[k][: 2 * B] for k in keys}, root)
            idd = image_dir.ImageDirDataset(root, B, size, seed=cfg.seed, augment=cfg.augment)
            with scaled_init():
                ts_i, terms_i = train.fit_preprocessed(cfg, idd, num_steps=2, asset=asset, device="cuda")
            mi = evaluate.evaluate_preprocessed(ts_i.model, consts_e, cfg, image_dir.ImageDirDataset(root, B, size))
            check(np.isfinite(terms_i["total"]) and all(np.isfinite(v) for v in mi.values()),
                  f"image directory: {terms_i}, {mi}")
            print(
                f"[disk] image directories: PIL imports; {2 * B} examples exported, fit_preprocessed 2 augmented steps "
                f"(loss {terms_i['total']:.4f}), evaluate_preprocessed: "
                + ", ".join(f"{k} {v:.5f}" for k, v in sorted(mi.items()))
            )
    torch.cuda.empty_cache()
    print(f"[disk] phase in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "dataset_launches": dataset_launches, "ms_per_step": med, "p90": p90,
            "device_ms": dev["device_ms"], "busy": dev["device_ms"] / wall, "native": native}


# The int8 serving and tools phase: request batches (each its own bucket),
# the reference's feature bounds (tests/test_quantize.py), evaluation and
# export sizes, the example's steps. The reference holds int8 to sim
# within 1e-3 at width 16; at full width one requantization step that the
# float32 sum order moves (sim) changes the next sites' inputs, and the
# flips grow through the blocks. The reference's own int8 and sim part the
# same way at full width on the CPU (tests/test_torch_quantize.py,
# `test_full_width_int8_vs_sim_gap_matches_reference`), so the int8 product
# is held to its float32 twin per site, on the same input, and the paths
# end to end by cosine.
INT8_BUCKETS = (1, 8, 32, 128)
INT8_SIM_TOL = 1e-3  # each site's int8 product vs its float32 twin: allclose rtol = atol
INT8_TWIN_GAP = 1e-4  # int8 vs sim and int8c vs simc end to end: 1 - cosine
INT8_COS_MIN = 0.99  # int8c vs the bf16 encoder
INT8_REL_MAX = 0.2  # int8c vs the bf16 encoder: mean relative error
INT8_EVAL_BATCHES = 2
EXPORT_BATCH = 8
FIT_STEPS = 30
PER_FIT_STEP = {lbs_cuda.KERNEL: 1, raster_cuda.KERNEL: 1, raster_cuda.KERNEL_BWD: 1}


def int8_site_errors(qenc, images: torch.Tensor) -> tuple[float, float]:
    """Along the per-site int8 path, each conv's int8 product (`_int_mm`)
    against its float32 twin ('sim') on the same input, both through
    `quantize.site_conv`: (the largest excess over allclose(rtol = atol =
    INT8_SIM_TOL), the largest abs difference)."""
    from indirect_learning_pose_shape_tpu_torch.models import quantize as quant

    worst = [float("-inf"), 0.0]

    def conv_op(x, site, stride, stem):
        q = qenc.site(site)
        a = quant.site_conv(q, x, stride, stem, "int8")
        b = quant.site_conv(q, x, stride, stem, "sim")
        d = (a - b).abs()
        worst[0] = max(worst[0], (d - INT8_SIM_TOL * b.abs()).max().item())
        worst[1] = max(worst[1], d.max().item())
        return a

    with torch.inference_mode():
        qenc.walk(images, conv_op)
    return worst[0], worst[1]


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a * b).sum() / (a.norm() * b.norm()))


def int8_phase(cfg, model, consts, asset, smi) -> dict:
    """The int8 serving path and the tools around it, on config4_full's
    serving model: `ptq_quantize` on 16 synthetic images (seed 999) and the
    qparams file read back bitwise (and a `keep_sites=('stem',)` variant);
    `Predictor(qparams)` per impl at batches 1, 8, 32, 128 (features against
    the float32-sum twins and the bf16 encoder, padding, the kernels'
    launches on every request and render, latency per bucket, the int8
    encoder's device time at 128); `evaluate` of int8 against sim; the
    `torch.export` artifacts against the eager forward; the `predict` CLI
    writing meshes (and overlays where matplotlib imports);
    `fit_to_silhouette` for FIT_STEPS steps; `train.init_state` from a
    pretrained npz and a mean-parameter file written here."""
    from indirect_learning_pose_shape_tpu_torch import export
    from indirect_learning_pose_shape_tpu_torch.examples import fit_to_silhouette
    from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
    from indirect_learning_pose_shape_tpu_torch.models import pretrained
    from indirect_learning_pose_shape_tpu_torch.models import quantize as quant

    t_phase = time.perf_counter()
    tcfg = configs.CONFIG4_FULL
    dev = consts.smpl.v_template.device
    size = cfg.image_size
    lbs_k, fwd_k = lbs_cuda.KERNEL, raster_cuda.KERNEL
    with tempfile.TemporaryDirectory(prefix="ilps_int8_") as work:
        # --- Quantize; the file read back bitwise. ---------------------------
        calib = predict.synthetic_images(consts, cfg, 16, seed=999, synthetic_cfg=tcfg.synthetic)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qp = quant.ptq_quantize(model.encoder, calib)
        torch.cuda.synchronize()
        q_s = time.perf_counter() - t0
        qpath = os.path.join(work, "q.npz")
        quant.save_qparams(qpath, qp)
        back = quant.load_qparams(qpath)
        check(set(back) == set(qp), "qparams file: sites differ")
        for site, d in qp.items():
            check(set(back[site]) == set(d), f"qparams file: {site} fields differ")
            for k, v in d.items():
                check(back[site][k].dtype == v.dtype and torch.equal(back[site][k], v.cpu()),
                      f"qparams file: {site}::{k} not read back bitwise")
        qp_keep = quant.ptq_quantize(model.encoder, calib, keep_sites=("stem",))
        check({s for s, d in qp_keep.items() if "w_bf16" in d} == {"stem"}, "keep_sites=('stem',): kept sites")
        print(f"[int8] ptq_quantize on 16 images: {q_s:.3f} s, {len(qp)} sites, "
              f"{os.path.getsize(qpath) / 1e6:.2f} MB file read back bitwise; keep_sites=('stem',) keeps the stem")

        # --- Predictors per impl; requests from the stream (seed 5). --------
        reqs = {n: predict.synthetic_images(consts, cfg, n, seed=5).cpu().numpy() for n in INT8_BUCKETS}
        p_bf16 = serve.Predictor(cfg, model, consts)
        preds = {impl: serve.Predictor(cfg, model, consts, qparams=qp, int8_impl=impl) for impl in quant.IMPLS}
        preds["int8c keep stem"] = serve.Predictor(cfg, model, consts, qparams=qp_keep, int8_impl="int8c")
        for p in (p_bf16, *preds.values()):
            p.warmup(INT8_BUCKETS)
        torch.cuda.synchronize()

        # The main path, counted: int8c requests and their renders.
        p8c = preds["int8c"]
        _build.reset_counts()
        results = {}
        for n, x in reqs.items():
            before = _build.counts()
            out = p8c(x)
            torch.cuda.synchronize()
            mid = _build.counts()
            rend = predict.render_silhouette(out, consts, cfg)
            torch.cuda.synchronize()
            after = _build.counts()
            check(mid.get(lbs_k, 0) == before.get(lbs_k, 0) + 1, f"int8c request {n}: LBS launches {before} -> {mid}")
            check(after.get(fwd_k, 0) == mid.get(fwd_k, 0) + 1, f"int8c render {n}: raster launches {mid} -> {after}")
            results[n] = (out, rend)
        launches = _build.counts()
        print(f"[int8] kernel launches during {len(reqs)} int8c requests and renders: {launches}")

        # The same requests with the plain versions forced: the LBS kernel
        # against plain SMPL on the same features, the raster kernel against
        # the plain raster on the same vertices.
        cfg_t = dataclasses.replace(cfg, smpl_impl="torch", raster_impl="torch")
        p_t = serve.Predictor(cfg_t, model, consts, qparams=qp, int8_impl="int8c")
        v_err = s_err = 0.0
        for n, x in reqs.items():
            out, rend = results[n]
            v_err = max(v_err, max_err(out["verts"], p_t(x)["verts"]))
            s_err = max(s_err, max_err(rend["silhouette"], predict.render_silhouette(out, consts, cfg_t)["silhouette"]))
            check(v_err <= TOL and s_err <= TOL, f"int8c request {n}, kernels vs plain: verts {v_err}, sil {s_err}")
        print(f"[int8] kernels vs plain versions on the int8c requests ({', '.join(map(str, reqs))}): "
              f"verts {v_err:.3e}, silhouette {s_err:.3e} (max abs, bound {TOL})")
        del p_t

        site_excess = site_err = 0.0
        feat_err = {"int8 vs sim": 0.0, "int8c vs simc": 0.0}
        twin_cos = {"int8 vs sim": 1.0, "int8c vs simc": 1.0}
        cos_min, rel_max = 1.0, 0.0
        for n, x in reqs.items():
            xd = torch.from_numpy(x).to(dev)
            excess, err = int8_site_errors(preds["int8"].qenc, xd)
            check(excess <= INT8_SIM_TOL, f"int8 product vs float32 twin at batch {n}: beyond rtol = atol = {INT8_SIM_TOL}")
            site_excess, site_err = max(site_excess, excess), max(site_err, err)
            with torch.inference_mode():
                f = {impl: preds[impl].qenc(xd, impl) for impl in quant.IMPLS}
                f_bf16 = enc.encoder_apply(model.encoder, xd)
            for label, (a, b) in (("int8 vs sim", ("int8", "sim")), ("int8c vs simc", ("int8c", "simc"))):
                feat_err[label] = max(feat_err[label], (f[a] - f[b]).abs().max().item())
                twin_cos[label] = min(twin_cos[label], cosine(f[a], f[b]))
                check(1.0 - twin_cos[label] <= INT8_TWIN_GAP,
                      f"{label} at batch {n}: 1 - cosine {1.0 - twin_cos[label]} > {INT8_TWIN_GAP}")
            cos = cosine(f["int8c"], f_bf16)
            rel = float((f["int8c"] - f_bf16).abs().mean() / (f_bf16.abs().mean() + 1e-9))
            cos_min, rel_max = min(cos_min, cos), max(rel_max, rel)
            out, rend = results[n]
            for k in ("verts", "kp2d", "theta"):
                check(bool(torch.isfinite(out[k]).all()), f"int8c {k} not finite at batch {n}")
            check(tuple(out["verts"].shape) == (n, consts.smpl.num_verts, 3), f"int8c verts shape at {n}")
            check(bool(torch.isfinite(rend["silhouette"]).all()), f"int8c silhouette not finite at {n}")
        check(cos_min > INT8_COS_MIN and rel_max < INT8_REL_MAX,
              f"int8c vs bf16 features: cosine {cos_min}, mean relative error {rel_max}")
        with torch.inference_mode():
            xk = torch.from_numpy(reqs[8]).to(dev)
            fk = preds["int8c keep stem"].qenc(xk, "int8c")
            check(bool(torch.isfinite(fk).all()), "keep_sites=('stem',) features not finite")
        print(f"[int8] int8 product vs float32 twin per site, same input: max abs {site_err:.3e} "
              f"(allclose rtol = atol = {INT8_SIM_TOL}); features end to end, max abs / 1 - cosine "
              f"(bound {INT8_TWIN_GAP}): "
              + ", ".join(f"{k} {feat_err[k]:.3e} / {1.0 - twin_cos[k]:.3e}" for k in feat_err)
              + f"; int8c vs bf16: cosine >= {cos_min:.5f}, mean relative error <= {rel_max:.4f}")

        # Padding: the 3 first images of the 8-image stream in bucket 4 vs alone in bucket 1.
        p4 = serve.Predictor(cfg, model, consts, buckets=(1, 4), qparams=qp, int8_impl="int8c")
        x3 = reqs[8][:3]
        out3 = p4(x3)
        half = 0.5 * (size - 1)
        pad_err = 0.0
        for i in range(3):
            o1 = p4(x3[i : i + 1])
            for k, v in out3.items():
                pad_err = max(pad_err, max_err(v[i : i + 1], o1[k]) / (half if k == "kp2d" else 1.0))
        check(pad_err <= TOL, f"int8c padded rows differ from the images alone: {pad_err}")
        print(f"[int8] int8c padded request (bucket 4) vs images alone (bucket 1), all outputs: {pad_err:.3e}")

        lat = {}
        for n, x in reqs.items():
            row = {label: request_ms(lambda p=p: request(p, cfg, consts, x), 20)
                   for label, p in (("bf16", p_bf16), ("int8", preds["int8"]), ("int8c", p8c))}
            lat[n] = row
            print(f"[int8] request batch {n}, median ms with silhouette: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in row.items()) + f" [{smi}]")
        big = INT8_BUCKETS[-1]
        xb = torch.from_numpy(reqs[big]).to(dev)
        with torch.inference_mode():
            enc_ms = {
                "bf16": events_ms(lambda: enc.encoder_apply(model.encoder, xb), 5),
                "int8": events_ms(lambda: p8c.qenc(xb, "int8"), 5),
                "int8c": events_ms(lambda: p8c.qenc(xb, "int8c"), 5),
            }
        print(f"[int8] encoder device ms at batch {big}: " + ", ".join(f"{k} {v:.3f}" for k, v in enc_ms.items())
              + f" [{smi}]")
        from torch.profiler import ProfilerActivity, profile

        for n in (1, big):
            x = reqs[n]
            for label, p in (("bf16", p_bf16), ("int8c", p8c)):
                request(p, cfg, consts, x)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        request(p, cfg, consts, x)
                    torch.cuda.synchronize()
                summ = device_summary(prof, 5)
                print(f"[int8] profiled request batch {n}, {label}: device {summ['device_ms']:.3f} ms, "
                      f"{summ['kernels']:.1f} device items, by category "
                      + json.dumps({k: round(v, 4) for k, v in summ["by_category_ms"].items()})
                      + "; largest: " + json.dumps([[round(ms, 4), name[:60], k] for ms, name, k in summ["top"][:5]]))

        # --- Evaluation: int8 against sim. ----------------------------------
        ecfg = tcfg
        _build.reset_counts()
        m8 = evaluate.evaluate(model, consts, ecfg, INT8_EVAL_BATCHES, qparams=qp, int8_impl="int8")
        eval_launches = _build.counts()
        for name, per in {lbs_k: 3, fwd_k: 2}.items():  # batch, forward, ground truth
            check(eval_launches.get(name, 0) == per * INT8_EVAL_BATCHES,
                  f"int8 evaluate: kernel {name} launched {eval_launches.get(name, 0)} times")
        ms = evaluate.evaluate(model, consts, ecfg, INT8_EVAL_BATCHES, qparams=qp, int8_impl="sim")
        diff = {k: abs(m8[k] - ms[k]) / (1.0 if k in EVAL_ABS else max(abs(ms[k]), 1e-12)) for k in m8}
        for k, d in diff.items():
            tol = EVAL_ABS_TOL if k in EVAL_ABS else EVAL_REL_TOL
            check(np.isfinite(m8[k]) and d <= tol, f"int8 evaluate vs sim: {k} differs by {d} > {tol}")
        print(f"[int8] evaluate int8, {INT8_EVAL_BATCHES} x {ecfg.batch_size}: "
              + ", ".join(f"{k} {v:.5f}" for k, v in sorted(m8.items()))
              + "; vs sim: " + ", ".join(f"{k} {v:.2e}" for k, v in sorted(diff.items()))
              + f"; launches {eval_launches}")
        for k, v in eval_launches.items():
            launches[k] = launches.get(k, 0) + v

        # --- Export: the artifacts against the eager forward, plain SMPL. ---
        plain = dataclasses.replace(cfg, smpl_impl="torch")
        xe = torch.from_numpy(reqs[8]).to(dev)
        exp = {}
        for label, build in (
            ("bf16", lambda: export.export_forward(cfg, model, consts, EXPORT_BATCH, device=dev)),
            ("int8c", lambda: export.export_forward_int8(cfg, model, consts, EXPORT_BATCH, device=dev, qparams=qp)),
        ):
            t0 = time.perf_counter()
            blob = build()
            secs = time.perf_counter() - t0
            fn = export.load_exported(blob)
            with torch.inference_mode():
                theta, verts, kp2d = fn(xe)
            eager = serve.Predictor(plain, model, consts, buckets=(EXPORT_BATCH,),
                                    qparams=None if label == "bf16" else qp)(xe)
            err = max(max_err(theta, eager["theta"]), max_err(verts, eager["verts"]),
                      max_err(kp2d, eager["kp2d"]) / half)
            check(err <= TOL, f"export {label}: artifact vs eager {err}")
            exp[label] = {"seconds": secs, "mb": len(blob) / 1e6, "err": err}
            print(f"[int8] export {label} at batch {EXPORT_BATCH}: {secs:.2f} s, {len(blob) / 1e6:.1f} MB, "
                  f"artifact vs eager (plain SMPL) {err:.3e}")

        # --- The predict CLI. ----------------------------------------------
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            mpl = False
        else:
            mpl = True
        vis = os.path.join(work, "vis")
        cli_q = os.path.join(work, "cli_q.npz")
        argv = ["--demo", "--num", "4", "--int8", "--qparams", cli_q, "--out", vis, "--device", str(dev)]
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as said:
            check(predict.main(argv + ([] if mpl else ["--no-overlays"])) == 0, "predict CLI exit code")
        cli_s = time.perf_counter() - t0
        check(os.path.exists(cli_q), "predict CLI did not write its qparams")
        for i in range(4):
            with open(os.path.join(vis, f"mesh_{i}.obj")) as f:
                verts = [ln for ln in f if ln.startswith("v ")]
            check(len(verts) == consts.smpl.num_verts, f"mesh_{i}.obj has {len(verts)} vertices")
            if mpl:
                check(os.path.getsize(os.path.join(vis, f"overlay_{i}.png")) > 1000, f"overlay_{i}.png")
        print(f"[int8] predict --demo --num 4 --int8 --qparams: {cli_s:.2f} s, 4 meshes of "
              f"{consts.smpl.num_verts} vertices; " + said.getvalue().strip().splitlines()[-1])
        if not mpl:
            print("[int8] overlays: matplotlib does not import here, so the overlay writer was not driven")

        # --- The example: SMPL, raster forward and backward kernels. --------
        prob = fit_to_silhouette.make_problem(asset, 128, 4, dev)
        params = fit_to_silhouette.initial_params(4, dev)
        fit_to_silhouette.step(prob, params, 0.05)  # warm-up
        params = fit_to_silhouette.initial_params(4, dev)
        torch.cuda.synchronize()
        _build.reset_counts()
        t0 = time.perf_counter()
        history = fit_to_silhouette.fit(prob, params, FIT_STEPS, 0.05)
        fit_ms = (time.perf_counter() - t0) * 1e3 / FIT_STEPS
        fit_launches = _build.counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fit_to_silhouette.fit(prob, params, 5, 0.05)
        fit_dev = device_summary(prof, 5)
        for name, per in PER_FIT_STEP.items():
            check(fit_launches.get(name, 0) == per * FIT_STEPS,
                  f"fit_to_silhouette: kernel {name} launched {fit_launches.get(name, 0)} times in {FIT_STEPS} steps")
        check(history[-1] < history[0], f"fit_to_silhouette: loss did not fall {history[0]} -> {history[-1]}")

        # One step's loss and gradients on the same problem, kernels against
        # plain SMPL with the culled plain raster (the function the raster
        # kernels compute) within GRAD_TOL, and against the exact plain
        # raster within CULL_TOL: the BCE cotangent, large where the
        # prediction is near 0 or 1, multiplies the tails the culling leaves out.
        def step1(p):
            return fit_to_silhouette.loss_and_grads(p, fit_to_silhouette.initial_params(4, dev))

        plain_prob = dataclasses.replace(prob, smpl_impl="torch", raster_impl="torch")
        lk, gk = step1(prob)
        with culled_plain_raster():
            lc, gc = step1(plain_prob)
        lt, gt = step1(plain_prob)
        fit_err = {}
        for label, (l, g), tol in (("culled plain", (lc, gc), GRAD_TOL), ("exact plain", (lt, gt), CULL_TOL)):
            errs = {"loss": abs(float(lk) - float(l)) / abs(float(l)), **{k: norm_err(gk[k], v) for k, v in g.items()}}
            check(max(errs.values()) <= tol, f"fit_to_silhouette step 1, kernels vs {label}: {errs} > {tol}")
            fit_err[label] = errs
        print("[int8] fit_to_silhouette step 1, kernels vs plain versions, loss rel / gradients normalised: "
              + "; ".join(f"{label} (bound {tol}) " + ", ".join(f"{k} {v:.3e}" for k, v in fit_err[label].items())
                          for label, tol in (("culled plain", GRAD_TOL), ("exact plain", CULL_TOL))))
        print(f"[int8] fit_to_silhouette (128², B=4): loss {history[0]:.4f} -> {history[-1]:.4f} in {FIT_STEPS} "
              f"steps, {fit_ms:.3f} ms/step host wall, launches {fit_launches}; profiled: device "
              f"{fit_dev['device_ms']:.3f} ms, {fit_dev['kernels']:.1f} device items a step [{smi}]")

        # --- Weight import: init_state from the files written here. ---------
        donor = enc.Encoder(tcfg.model.encoder, torch.Generator().manual_seed(7))
        enc_path = os.path.join(work, "enc18.npz")
        pretrained.save_encoder_npz(enc_path, *pretrained.encoder_trees(donor), 18)
        theta0 = np.random.RandomState(7).randn(tcfg.model.ief.theta_dim).astype(np.float32)
        mean_path = os.path.join(work, "mean.npz")
        np.savez(mean_path, mean_theta=theta0)
        ts, _ = train.init_state(dataclasses.replace(tcfg, pretrained=enc_path, mean_params=mean_path), asset, device=dev)
        got = ts.model.encoder.state_dict()
        for k, v in donor.state_dict().items():
            check(torch.equal(got[k].cpu(), v), f"init_state pretrained: {k} differs from the file")
        check(np.array_equal(ts.model.ief.mean_theta.detach().cpu().numpy(), theta0), "init_state mean_params")
        print(f"[int8] init_state from a pretrained npz and a mean-parameter file: {len(got)} encoder tensors "
              "and mean_theta equal the files'")
    torch.cuda.empty_cache()
    print(f"[int8] phase in {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "fit_launches": fit_launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device found (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    smi = smi_line()
    disable_tf32()
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: {smi}")
    print(
        f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off "
        f"(matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32})"
    )

    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.2f} s")

    rng = np.random.RandomState(0)
    asset = assets.load_asset()
    cfg = configs.CONFIG4_FULL.model
    model, consts = predict.load_model(cfg, asset=asset, seed=0, device="cuda")
    # Untrained BN statistics leave the encoder's features ~13 in magnitude,
    # and with the reference's 1e-3 output-layer init the three IEF steps then
    # move the camera off the crop, so every silhouette would be empty. A
    # 100x smaller output layer keeps the seed-0 bodies in frame (and the
    # predictions image-dependent), so the raster kernel renders real bodies.
    with torch.no_grad():
        model.ief.layers[-1].weight.mul_(0.01)

    lbs = lbs_phase(asset, rng, smi)
    verts2d, far = posed_verts2d(consts, asset, cfg, rng)
    ras4 = raster_phase(consts, cfg, verts2d, far)
    bwd4 = raster_bwd_phase(consts, cfg, verts2d, far, rng)
    serve_launches = serving_phase(cfg, model, consts, rng, smi)
    tr = training_phase(asset, smi)
    mixed = mixed_phase(asset, smi)
    robust = robust_phase(asset, smi)
    disk = disk_phase(asset, smi)
    int8 = int8_phase(cfg, model, consts, asset, smi)

    def entry(name, source, replaces, **numbers):
        return dict(
            name=name, route="cuda",
            source=f"indirect_learning_pose_shape_tpu_torch/csrc/{source}",
            replaces=f"indirect_learning_pose_shape_tpu/ops/kernels/{replaces}",
            launches=tr["launches"].get(name, 0),
            launches_serve=serve_launches.get(name, 0),
            launches_mixed=mixed["launches"].get(name, 0),
            launches_eval=mixed["eval_launches"].get(name, 0),
            launches_robust=robust["launches"].get(name, 0),
            launches_disk=disk["launches"].get(name, 0),
            launches_dataset=disk["dataset_launches"].get(name, 0),
            launches_int8=int8["launches"].get(name, 0),
            launches_fit=int8["fit_launches"].get(name, 0),
            **{"library_ms": None, **numbers},
        )

    fwd, bwd = tr["raster_fwd"], tr["raster_bwd"]
    fwd["max_abs_err"] = max(fwd["max_abs_err"], ras4["max_abs_err"])
    bwd["max_abs_err"] = max(bwd["max_abs_err"], bwd4["max_abs_err"])
    kernels = [
        entry(lbs_cuda.KERNEL, "lbs.cu", "lbs_pallas.py:37", **lbs),
        entry(raster_cuda.KERNEL, "raster_fwd.cu", "raster_pallas.py:73", **fwd),
        entry(raster_cuda.KERNEL_BWD, "raster_bwd.cu", "raster_pallas.py:103", **bwd),
    ]
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
