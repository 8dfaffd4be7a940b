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
   Then both forward kernels at full width against the float64 numpy
   oracle (`utils/oracle.py`, `oracle_phase`): SMPL through the LBS kernel
   on 4 posed bodies, and one body's 256² soft raster through the raster
   forward kernel, at the limits of the port's CPU oracle tests.
4. Serving: a `Predictor` on the full-width config4_full model (ResNet-18
   bf16, IEF, SMPL, seed-0 weights) with both forward kernels on (`auto`),
   warmed up, answers requests of batch 1, 3, 8 and 32 and renders each
   request's soft silhouette. Checks output shapes and finiteness, that
   padding leaves real rows unchanged (against the images run alone in the
   same bucket and in bucket 1), that both kernels ran during the requests,
   and that the same requests with the plain twins forced agree. Prints the
   median latency per bucket. The Predictor runs its route on the card:
   each bucket a CUDA graph, captured by `warmup`.
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
6. The compiled paths (`graphs_phase`): `train.compile_fused_step` at
   config4_full b32, 5 graphed steps (the first the eager warm-up step and
   the capture, then 4 replays) against 5 eager `fused_step`s from the same
   state: every step's terms and the final parameters, BN buffers, Adam
   moments and counts, rates and EMA bitwise, each call's launches exactly
   the eager step's (2 LBS, 2 raster forward, 1 raster backward a replay),
   one capture; host wall per step of both routes (20 each, in turns), the
   capture seconds and the graph pool's bytes. The same, 3 steps each, for
   config4_mixed and config4_robust with EMA 0.999 (cosine rate, clip,
   rot6d, shading, the hard raster). `train.compile_train_fns`: 3 graphed
   batches and graphed steps on them against `make_batch` and
   `train_step`, bitwise. `train.fit` on the graph route
   checkpointed, stopped after step 3, resumed from step 2 and captured
   again, against a straight graphed run: bitwise. NCCL at world 1: the
   graphed step through the mesh (its all-reduces in the graph) against the
   graphed no-mesh step, bitwise. The disk steps on the phase's own
   64-example 320² dataset (config4_full b32, augmented):
   `train.compile_data_step` (`fit_dataset`'s route) 5 graphed steps
   against 5 eager `data_train_step`s on the same prefetched batches, terms
   and state bitwise, 1 LBS, 1 raster forward, 1 raster backward launch a
   replay, the draws different every step, host wall both routes in turns;
   where PIL imports, `compile_data_step(raw=False)` (`fit_preprocessed`'s
   route) against `train_step` on an image directory; NCCL world 1: the
   graphed disk step through the mesh against no mesh, bitwise. The
   evaluators' graphs against `graphs=False`, every metric bitwise, bf16
   and int8c: `evaluate` on the plain and hardapp suites (one capture a
   case, launches exactly the eager route's), host ms a batch both routes
   and the cost of the eager PA-MPJPE tail (the SVD cannot be captured),
   `evaluate_dataset`, `evaluate_preprocessed` where PIL imports, and an
   EMA model made anew after a step captured anew. The `Predictor`'s
   bucket graphs at 1, 4,
   8, 32, 128 (and a padded 3), bf16 and int8c: every output bitwise the
   eager Predictor's, an earlier request's outputs unchanged by later
   replays, 1 LBS launch a request, request median and p90 both routes.
7. The presets no other phase trains (`presets_phase`): config1_single
   (b1), config2_smpl_batch (b64), config3_render (b32, the silhouette
   losses alone), config4_r34, config4_large (ResNet-50 bottleneck, rot6d),
   config4_parts31 (31 classes, 7 with no vertex) at b32 and config4_b128,
   each at full width (256², V=6890, its depth and parts, seed-0 weights,
   IEF output x 0.01): `train.fit` for 3 steps, its route line naming the
   graph and its state bitwise an eager run's; `compile_fused_step`'s 2
   replays after the warm-up and capture against eager `fused_step`s,
   terms and state bitwise, each replay's launches the eager step's (2
   LBS, 2 raster forward, 1 raster backward); the graphed step's host wall,
   img/s, device ms over back-to-back replays, capture seconds, pool and
   fit's peak memory above what earlier phases hold. For config3_render, config4_parts31 and config4_b128
   both raster kernels on the step's own inputs and loss cotangent against
   the culled plain versions (exact zeros in the empty classes' planes and
   the padding slots' gradient), timed beside their bound. Then
   config4_large's model served through a `Predictor` at buckets 1 and 32:
   shapes, graphed against eager bitwise, padding, the float32 encoder
   across buckets. Each preset's graphs are freed before the next.
   Then the recorded recipes (`recipes_phase`): `tools/recipe_parity.py`'s
   r34_indirect_5k (config4_r34, cosine 3e-4, clip 1.0, shape_reg 3e-3;
   from the tool's own seed-0 init) cut to RECIPE_STEPS steps on the kernel
   route, saved, loaded back and scored on one seed x RECIPE_EVAL_BATCHES
   plain batches: the route line naming `fit`'s graph, the launches of the
   run exactly RECIPE_STEPS eager steps' (2 LBS, 2 raster forward, 1 raster
   backward) plus the evaluation's (3 LBS, 2 raster forward a batch), every
   metric finite, the logged total at the last step below step 0's; the
   tool's JSON line printed on a line of its own. No quality claim at this
   horizon: the 5000-step runs are the tool's.
8. Separable raster (the reference's default route) on the training
   phase's slots and cotangent: 'highest' against the exact twin, 'high', 'default'
   and the bf16 training scores against 'highest'; the bf16 forward and
   forward + backward timed beside the kernels; and the step's loss terms
   with `raster_impl='separable'` against the kernels'.
9. The config4_mixed recipe at full width (ResNet-34, rot6d, b32, cosine
   warm-up, clip 1.0, the 3D weights, EMA 0.999): after a warm-up, counted
   fused steps (2 LBS, 2 raster forward, 1 raster backward launches each),
   one call of 4 steps (`steps_per_call`), then `evaluate` on 4 x 32 images
   of the model (its own counted launches: 3 LBS and 2 raster forward a
   batch) and of its EMA, and of the model with the plain versions forced,
   which must agree with the kernels' metrics.
10. The config4_robust recipe at full width (config4_mixed's, on hard
   z-buffered targets with textured backgrounds, palette jitter, shading
   and occluders; EMA 0.999): the hard raster on the step's bodies, its
   kernel (`csrc/raster_hard.cu`) bitwise against the eager dense path,
   and against the CPU run of the same function and the float64 oracle,
   timed (the kernel alone and the whole call, at B=32 and 128, beside the
   eager dense path and the kernel's byte bound) and culled; counted fused
   steps (2 LBS, 1 raster forward, 1 raster backward, 1 hard raster
   launches each; the hard raster replaces the target render) with one
   step's device time; a checkpoint saved, restored bitwise and timed;
   `train.fit` to step 2 with checkpoints, then resumed to 4 (the restored
   state bitwise the first run's, the resumed run's batch of step 2 (its
   eager warm-up before the capture) bitwise the stream's `make_batch`,
   the losses at step 4 within RESUME_TOL of a straight 4-step run);
   the JSONL and TensorBoard files read back; `tools/quality_eval.py` on the
   checkpoint and its EMA on the plain, hard and hardapp suites (3 seeds x 1
   batch), and the kernels against the plain versions on hardapp.
11. The ViT blocks' add + LayerNorm kernels (`add_ln_phase`) at ViT-H's
   [48·192, 1280] in three variants (a drop-path scale a sample, none, no
   branch): the op through autograd on card tensors against its plain twin
   (x' bitwise, h and dy within one bf16 ulp, dx within 1e-5, dγ and dβ
   within 1e-4, a second backward bitwise, one launch of each kernel a
   call); each kernel timed beside its byte bound and the eager chain it
   replaced; one graphed `hmr2_vith` step at b48 launching 64 of each
   kernel a replay, with no row on the twin.
12. Disk data at full width (config4_full's model, b32, 256² crops from a
   dataset at 320²): the native host preprocessor built with g++ and
   loaded (`USE_NATIVE`), bitwise against its numpy versions on 32 ragged
   images; a 128-example dataset written by `make_synthetic_dataset` (its
   seconds, size and launches: one LBS and one raster forward a chunk of
   64); one raw batch preprocessed on the card against the CPU (labels
   equal, images within PREPROCESS_TOL; augmentation off and with the same
   draws) and prefetched batches bitwise equal to plain copies;
   `fit_dataset` with augmentation for 8 steps across an epoch boundary on
   its graph route (its route line checked; 1 LBS, 1 raster forward, 1
   raster backward launch a step; host ms/step, img/s, the prefetcher's
   H2D time and waits, a profiled window of eager disk steps);
   `fit_dataset` to step 4 with checkpoints, resumed (captured again) to
   8, against a straight run (state and terms bitwise), over the file and
   over 4 shards; `evaluate_dataset` over 4
   batches (2 LBS and 1 raster forward launch a batch) and the kernels
   against the plain versions on its first batch; the image-directory path
   (`fit_preprocessed`, `evaluate_preprocessed`) where PIL imports, and a
   line saying which held.
13. int8 serving and tools, on step 4's serving model: `ptq_quantize` on
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
14. Multi-GPU training on the one card (`parallel_phase`, last):
   config5_data_parallel (ResNet-18, global batch 64, 256²). NCCL at world
   size 1 in this process: step 1 through the mesh against the no-mesh
   step (rtol 1e-6; it reads bitwise), 3 steps each way in turns (host
   wall, the mesh's cost), the gradient all-reduce timed, 2/2/1 launches a
   step. Then PAR_RANKS gloo ranks sharing the card (`mesh.spawn`; the
   parent built the kernels): step 1 on a rank's rows against one process
   on the global batch (float32 encoder: terms 1e-5, the whole gradient
   1e-4, each leaf within FLOOR_MULTIPLE x the reduction-order floor of one
   process on the batch with its halves swapped, BN buffers 1e-5, the
   update bitwise; bf16: BF16_TOL), the kernels against their plain
   versions on the rank's path, counted DP steps (2/2/1 launches a rank a
   step, host wall, all-reduce bytes and ms), a 1 x PAR_RANKS render mesh
   (separable rows and vertex gradient vs local, the SP step's loss vs the
   one-process separable step within SP_LOSS_TOL, 2/0/0 launches, the hard
   raster in tile bands equal to dense, LBS vs plain); the bf16 step's
   gradients against one process that does the mesh's arithmetic
   (`partitioned_bn`: BN statistics as the mean of the half-batch means,
   alone and with each conv and normalisation per half; the latter holds
   the rank to 1e-4 over the whole gradient and per leaf to FLOOR_MULTIPLE
   x the larger of the jittered floor and the statistics floor, the first
   process against one process); sharded int8 serving (`quantized_forward`
   with a mesh, int8 and int8c, a request of 32: qparams calibrated on rank
   0 and replicated, the gathered outputs against one process, one LBS
   launch a rank a call, host ms a call); then
   `torchrun --nproc_per_node 1 -m ...train --preset config5_data_parallel`.
   Times of ranks sharing one card are no multi-GPU rate.

The last three lines of standard output are the kernel record
({"kernels": [...]}, with each kernel's launches on the config4_full
training main path, per replay of the graphed config4_full step
(`launches_graph_replay`), per replay of the graphed disk step
(`launches_disk_graph_replay`) and of a graphed plain-suite evaluation
batch (`launches_eval_graph_replay`), per replay of each preset's graphed
step in the presets phase (`launches_presets`) and in config4_large's
served requests there (`launches_presets_serve`), in the recipes phase's
run and its evaluation (`launches_recipes`), on the config4_mixed steps and in its evaluation, on
the config4_robust steps (`launches_robust`), on the disk steps
(`launches_disk`), in the dataset writer (`launches_dataset`), on the int8
requests and their evaluation (`launches_int8`), in the example
(`launches_fit`) and on the parallel phase's counted steps per rank
(`launches_parallel_nccl`, `_dp`, `_sp`), in rank 0's sharded int8 calls
(`launches_parallel_int8`) and in the oracle checks (`launches_oracle`),
and for the ViT's add + LayerNorm kernels per replay of the graphed
hmr2_vith step (`launches_hmr2_graph_replay`, the backward's reduction
`launches_hmr2_graph_replay_reduce`) and the eager chain's `eager_ms`; its
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
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from indirect_learning_pose_shape_tpu_torch import configs, evaluate, losses, predict, serve, train
from indirect_learning_pose_shape_tpu_torch.data import dataset as dataset_lib
from indirect_learning_pose_shape_tpu_torch.data import native_preprocess, synthetic
from indirect_learning_pose_shape_tpu_torch.models import encoder as encoder_lib
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import smpl
from indirect_learning_pose_shape_tpu_torch.models import vit as vit_mod
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster, raster_hard
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build, lbs_cuda, raster_cuda, raster_hard_cuda
from indirect_learning_pose_shape_tpu_torch.ops.kernels import vit_add_ln_cuda as add_ln
from indirect_learning_pose_shape_tpu_torch.parallel import mesh as mesh_lib
from indirect_learning_pose_shape_tpu_torch.parallel import render_sp
from indirect_learning_pose_shape_tpu_torch.tools import quality_eval, recipe_parity
from indirect_learning_pose_shape_tpu_torch.tools.profile_serve import device_summary, smi_line
from indirect_learning_pose_shape_tpu_torch.tools.timing import ColdTimer, device_ms, events_ms
from indirect_learning_pose_shape_tpu_torch.utils import assets, metrics, oracle, tracing
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
# Hard targets: the hard raster's kernel renders them, no soft target render.
PER_STEP_ROBUST = {lbs_cuda.KERNEL: 2, raster_cuda.KERNEL: 1, raster_cuda.KERNEL_BWD: 1, raster_hard_cuda.KERNEL: 1}
PER_EVAL_BATCH = {lbs_cuda.KERNEL: 3, raster_cuda.KERNEL: 2}  # batch, forward, ground truth SMPL
PER_EVAL_BATCH_HARD = {lbs_cuda.KERNEL: 3, raster_cuda.KERNEL: 1, raster_hard_cuda.KERNEL: 1}
# The resumed run's loss terms at step 2k against the straight run's,
# relative: cuDNN's backward is not bitwise repeatable, so two runs of the
# same steps differ by its rounding (not bitwise as on the CPU).
RESUME_TOL = 1e-3
# The hard raster on the card against the CPU run of the same function, and
# against the float64 oracle (tests/test_raster_hard.py's limit). Its kernel
# is held to the eager dense path on the card bitwise.
HARD_AGREE = 0.999
ORACLE_AGREE = 0.995
HARD_K_FACES = 512  # the culled mode timed beside the dense one
# The CPU run is cut into pieces of this many images and face chunks of
# HARD_CPU_CHUNK, which keep its temporaries in the CPU's caches.
HARD_CPU_IMAGES = 2
HARD_CPU_CHUNK = 8
HARD_BATCHES = (32, 128)  # the kernel's timed batches
# The ViT blocks' add + LayerNorm kernels (csrc/vit_add_ln.cu) at ViT-H's
# residual stream at the hmr2_vith batch of 48 ([48·192, 1280]), in the
# three variants of a step's 64 sites: a drop-path scale a sample (63 sites
# in training), no scale, no branch (block 0's norm1). Held to the plain twin
# at tests/test_torch_vit_add_ln.py's limits: x' bitwise, h and dy within one
# bf16 ulp (of a magnitude of at least ADD_LN_ULP_FLOOR), dx within 1e-5 and
# dγ, dβ within 1e-4 (relative norms).
ADD_LN_SHAPE = (48, 192, 1280)
ADD_LN_VARIANTS = ("drop_path", "no_drop_path", "no_y")
ADD_LN_ULP_FLOOR = 2.0**-10
ADD_LN_DX_TOL = 1e-5
ADD_LN_DGAMMA_TOL = 1e-4
ADD_LN_SITES = 64  # a ViT-H step's LayerNorm sites on the op: 2 a block, 32 blocks
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

# The float64 oracle checks at full width, at the limits of the port's CPU
# oracle tests (tests/test_torch_smpl.py, tests/test_torch_oracle.py: the
# reference's 2e-3 on probabilities).
ORACLE_BODIES = 4
ORACLE_SEED = 1  # its own draws: the later phases' inputs stay as they were
SMPL_ORACLE_TOL = 2e-4
RASTER_ORACLE_TOL = 2e-3

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


@contextlib.contextmanager
def partitioned_bn(parts: int, per_block: bool = False):
    """Inside the block, train-mode conv → BatchNorm in one process takes the
    arithmetic of a data mesh of `parts` ranks over its equal row blocks:
    the statistics are the mean of the blocks' means (a rank's all-reduce
    divided by n_data). With `per_block` each conv and each normalisation
    also runs on each block, as on a rank (its cuDNN shapes, and the bf16
    per-channel sums of the normalisation's backward over a block)."""
    plain = encoder_lib._conv_bn

    def partitioned(x, w, bn, stride, cfg, train, mesh=None):
        if not train or mesh is not None:
            return plain(x, w, bn, stride, cfg, train, mesh)
        pad = (w.shape[-1] - 1) // 2
        if per_block:
            ys = [F.conv2d(h, w.to(h.dtype), stride=stride, padding=pad) for h in x.chunk(parts)]
        else:
            ys = list(F.conv2d(x, w.to(x.dtype), stride=stride, padding=pad).chunk(parts))
        stats = sum(
            torch.stack([y.float().mean(dim=(0, 2, 3)), torch.square(y.float()).mean(dim=(0, 2, 3))])
            for y in ys
        )
        mean, meansq = stats / parts
        var = torch.clamp_min(meansq - torch.square(mean), 0.0)
        with torch.no_grad():
            m = cfg.bn_momentum
            bn.mean.copy_(m * bn.mean + (1 - m) * mean)
            bn.var.copy_(m * bn.var + (1 - m) * var)
        inv = torch.rsqrt(var + cfg.bn_eps) * bn.scale
        shift = bn.bias - mean * inv

        def norm(y):
            return y * inv.to(y.dtype)[:, None, None] + shift.to(y.dtype)[:, None, None]

        return torch.cat([norm(y) for y in ys]) if per_block else norm(torch.cat(ys))

    encoder_lib._conv_bn = partitioned
    try:
        yield
    finally:
        encoder_lib._conv_bn = plain


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


def oracle_phase(model_consts, asset, cfg, smi) -> dict:
    """The LBS and raster forward kernels at full width against the float64
    numpy oracle (`utils/oracle.py`): SMPL through the LBS kernel on
    ORACLE_BODIES posed bodies (V = 6890) against `oracle.smpl_forward` per
    body, and the first body's soft raster through the forward kernel (the
    config's size, parts, σ and γ) against `oracle.soft_rasterize` on the
    same pixel vertices. Returns the launches of its one call of each."""
    t_phase = time.perf_counter()
    n, S, rcfg = ORACLE_BODIES, cfg.image_size, cfg.raster
    dev = model_consts.smpl.v_template.device
    rng = np.random.RandomState(ORACLE_SEED)
    pose = (rng.randn(n, 72) * 0.3).astype(np.float32)
    betas = rng.randn(n, 10).astype(np.float32)
    cam = torch.tensor([[0.9, 0.05, -0.05]], device=dev)
    _build.reset_counts()
    with torch.no_grad():
        got = smpl.smpl_forward(model_consts.smpl, torch.tensor(pose, device=dev),
                                torch.tensor(betas, device=dev), impl="kernel")
        v2 = camera.project_pixel(got["verts"][:1], cam, S)
        rend = raster.soft_rasterize(v2, model_consts.part_layout, rcfg, impl="kernel")
    torch.cuda.synchronize()
    launches = _build.counts()
    check(launches == {lbs_cuda.KERNEL: 1, raster_cuda.KERNEL: 1}, f"oracle phase launches {launches}")
    errs = dict.fromkeys(("verts", "joints", "kp3d"), 0.0)
    for i in range(n):
        want = oracle.smpl_forward(asset, pose[i], betas[i])
        for k in errs:
            errs[k] = max(errs[k], float(np.abs(got[k][i].cpu().double().numpy() - want[k]).max()))
    check(max(errs.values()) <= SMPL_ORACLE_TOL, f"LBS kernel SMPL vs the float64 oracle: {errs}")
    labels = np.minimum(asset.part_labels(), rcfg.num_parts - 1)
    t0 = time.perf_counter()
    want = oracle.soft_rasterize(v2[0].cpu().numpy(), labels, S, rcfg.num_parts, rcfg.sigma, rcfg.bg_gamma)
    oracle_s = time.perf_counter() - t0
    r_errs = {k: float(np.abs(rend[k][0].cpu().double().numpy() - want[k]).max()) for k in ("probs", "silhouette")}
    fg = float(want["silhouette"].mean())
    check(fg > 0.01, f"oracle raster: silhouette covers {fg} of the pixels")
    check(max(r_errs.values()) <= RASTER_ORACLE_TOL, f"raster kernel vs the float64 oracle: {r_errs}")
    print(
        f"[oracle] LBS kernel SMPL on {n} bodies (V={asset.num_verts}) vs float64 oracle.smpl_forward: max abs "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (limit {SMPL_ORACLE_TOL}); raster forward kernel, one image {S}^2, {rcfg.num_parts} parts, "
        f"sigma {rcfg.sigma}, gamma {rcfg.bg_gamma}, silhouette {fg:.4f} of the pixels, vs float64 "
        f"oracle.soft_rasterize: max abs probs {r_errs['probs']:.3e}, silhouette {r_errs['silhouette']:.3e} "
        f"(limit {RASTER_ORACLE_TOL}); the oracle's raster took {oracle_s:.1f} s of host time "
        f"({S * S} x {asset.num_verts} float64 pairs) [{smi}]"
    )
    print(f"[oracle] phase in {time.perf_counter() - t_phase:.1f} s")
    return launches


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


def same_state(a, b, devices: bool, where: str = "", what: str = "restored state") -> None:
    """Check two nested state dicts bitwise equal, and each pair of tensors
    on one device when `devices`."""
    if torch.is_tensor(a):
        check(torch.is_tensor(b) and a.dtype == b.dtype and a.shape == b.shape
              and torch.equal(a.cpu(), b.cpu()), f"{what} differs at {where}")
        check(not devices or a.device == b.device, f"{what} at {where} on {b.device}, not {a.device}")
    elif isinstance(a, dict):
        check(isinstance(b, dict) and set(a) == set(b), f"{what}'s keys differ at {where}")
        for k in a:
            same_state(a[k], b[k], devices, f"{where}[{k!r}]", what)
    elif isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"{what}'s lengths differ at {where}")
        for i, (x, y) in enumerate(zip(a, b)):
            same_state(x, y, devices, f"{where}[{i}]", what)
    else:
        check(a == b, f"{what} differs at {where}: {a!r} != {b!r}")


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
def first_drawn_batch(store: list):
    """Inside the block a copy of the first batch the step draws on the host
    (`train._draw_batch`) is appended to `store`. On `fit`'s graph route that
    is the batch of the run's first step, its eager warm-up; the later
    batches are drawn by graph replays."""
    plain = train._draw_batch

    def recording(*args, **kwargs):
        batch = plain(*args, **kwargs)
        if not store:
            store.append({k: v.clone() for k, v in batch.items()})
        return batch

    train._draw_batch = recording
    try:
        yield
    finally:
        train._draw_batch = plain


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


def hard_bodies(cfg, consts, B: int):
    """Batch 0 of the stream's bodies at batch B: (verts2d, z, lights)."""
    S, scfg = cfg.model.image_size, cfg.synthetic
    gen = torch.Generator(device="cuda").manual_seed(train.step_seed(cfg.seed, 0))
    draws = synthetic.sample_draws(gen, B, consts, scfg, S)
    verts = smpl.smpl_forward(consts.smpl, draws["pose"], draws["betas"], impl=cfg.model.smpl_impl)["verts"]
    return camera.project_pixel(verts, draws["cam"], S), verts[..., 2], draws["light"]


def hard_kernel_bytes(B: int, F: int, S: int) -> int:
    """The kernel's least traffic: its four [B, S, S] outputs written, the
    coefficients [B, F, 13], `ok` [B, F] and the classes [F] read once."""
    return B * S * S * 16 + B * F * (13 * 4 + 1) + F * 4


def hard_raster_phase(cfg, consts, smi) -> dict:
    """The hard raster at the robust step's batch, on its own bodies (batch 0
    of the stream): the kernel route bitwise against the eager dense path
    (`impl='torch'`); against the CPU run of the same function and, on one
    image, the float64 oracle; the kernel alone and the whole call (the
    torch prologue, `_face_coeffs`, and the kernel) timed in a CUDA graph
    at each of HARD_BATCHES beside the eager dense path and the kernel's
    byte bound; the culled mode with HARD_K_FACES slots a tile timed, its
    overflow printed."""
    B, S = cfg.batch_size, cfg.model.image_size
    F = consts.hard.faces.shape[0]
    v2, vz, light = hard_bodies(cfg, consts, B)
    _build.reset_counts()
    card = raster_hard.hard_raster(v2, vz, consts.hard, S, with_shade=True, light=light)
    check(_build.counts() == {raster_hard_cuda.KERNEL: 1}, f"hard raster on the card launched {_build.counts()}")
    eager = raster_hard.hard_raster(v2, vz, consts.hard, S, with_shade=True, light=light, impl="torch")
    for k in ("part_labels", "silhouette", "zbuf", "shade", "overflow"):
        check(torch.equal(card[k], eager[k]),
              f"hard raster kernel vs the eager dense path at B={B}: {k} differs in "
              f"{int((card[k] != eager[k]).sum())} elements")
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
        f"[robust] hard raster B={B} {S}^2, {F} faces, silhouette {fg:.4f} of the pixels: kernel vs the eager "
        f"dense path bitwise (labels, silhouette, zbuf, shade, overflow); card vs CPU labels agree on "
        f"{agree:.6f}, silhouettes equal, shade max abs err {shade_err:.3e} (CPU run {cpu_s:.1f} s); image 0 "
        f"vs the float64 oracle {o_agree:.6f}"
    )

    def run(k=None, impl="auto"):
        return raster_hard.hard_raster(v2, vz, consts.hard, S, k_faces=k, with_shade=True, light=light, impl=impl)

    culled = run(HARD_K_FACES)
    overflow = int(culled["overflow"])
    c_agree = float((culled["part_labels"] == card["part_labels"]).double().mean())
    culled_ms = events_ms(lambda: run(HARD_K_FACES), 3)
    print(
        f"[robust] hard raster B={B} {S}^2 with shade: k_faces={HARD_K_FACES} {culled_ms:.3f} ms, overflow "
        f"{overflow} faces, labels as dense on {c_agree:.6f} [{smi}]"
    )
    by_batch = {}
    for nb in HARD_BATCHES:
        if nb != B:
            v2, vz, light = hard_bodies(cfg, consts, nb)
        coeffs, _, ok = raster_hard._face_coeffs(v2, vz, consts.hard, True, light)
        kernel_ms = device_ms(lambda: raster_hard_cuda.raster_hard_cuda(
            coeffs, ok, consts.hard.face_class, S, S, 0, True), 20)
        call_ms = device_ms(run, 20)
        eager_ms = events_ms(lambda: run(impl="torch"), 1 if nb > B else 3)
        bound_ms = hard_kernel_bytes(nb, F, S) / HBM_BYTES_PER_S * 1e3
        by_batch[nb] = {"ms": kernel_ms, "call_ms": call_ms, "eager_ms": eager_ms, "bound_ms": bound_ms}
        print(
            f"[robust] hard raster B={nb} {S}^2 dense with shade: kernel {kernel_ms:.4f} ms (bound {bound_ms:.4f} "
            f"ms, bytes at 3.35 TB/s: {bound_ms / kernel_ms:.1%}), whole call in a graph (prologue + kernel) "
            f"{call_ms:.4f} ms, eager dense path {eager_ms:.3f} ms ({eager_ms / call_ms:.0f}x) [{smi}]"
        )
    del coeffs, ok
    ms = by_batch[B]
    return {"ms": ms["ms"], "call_ms": ms["call_ms"], "eager_ms": ms["eager_ms"], "bound_ms": ms["bound_ms"],
            "bound_by": "bytes", "by_batch": by_batch, "max_abs_err": 0.0, "k_faces_ms": culled_ms,
            "k_faces_overflow": overflow, "card_vs_cpu": agree, "oracle": o_agree}


def add_ln_bytes(R: int, D: int, branch: bool) -> tuple[int, int]:
    """The add + LayerNorm kernels' least traffic over R rows of D, forward
    and backward. Forward: x read (4 B an element), h written (2 B), and
    with a branch y read (2 B) and x' written (4 B); the rows' mean and rstd
    written, γ and β read. Backward: x' (4 B) and dh (2 B) read, dx (4 B)
    written, and with a branch dres read (4 B) and dy written (2 B); the
    rows' mean and rstd and γ read, dγ and dβ written. The γ/β partials'
    scratch, which the design adds, is not counted."""
    fwd = R * D * (12 if branch else 6) + R * 8 + D * 8
    bwd = R * D * (16 if branch else 10) + R * 8 + D * 12
    return fwd, bwd


def bf16_ulp_ok(a: torch.Tensor, b: torch.Tensor, floor: float = ADD_LN_ULP_FLOOR) -> bool:
    """Every element of the bf16 tensors a and b within one bf16 ulp of the
    larger magnitude, taken as at least `floor`."""
    a, b = a.float(), b.float()
    m = torch.maximum(torch.maximum(a.abs(), b.abs()), torch.tensor(floor, device=a.device))
    _, e = torch.frexp(m)
    return bool(((a - b).abs() <= torch.ldexp(torch.ones_like(a), e - 8)).all())


def rel_norm(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.double() - b.double()) / torch.linalg.vector_norm(b.double()))


def add_ln_inputs(variant: str):
    """x [48, 192, 1280] float32, the branch y (bf16; None for 'no_y'), the
    scales s [B] (a strided column, as the model's; every third sample
    dropped; None without drop path), a LayerNorm away from identity and the
    cotangents dh (bf16) and dres (float32; None for 'no_y')."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    B, N, D = ADD_LN_SHAPE
    x = torch.randn(ADD_LN_SHAPE, device="cuda", generator=gen)
    y = None if variant == "no_y" else (torch.randn(ADD_LN_SHAPE, device="cuda", generator=gen) * 0.5).bfloat16()
    s = None
    if variant == "drop_path":
        keep = (torch.arange(B, device="cuda") % 3 != 1).float()
        s = torch.stack([keep / 0.6, keep / 0.7], dim=1)[:, 1]
    norm = torch.nn.LayerNorm(D, eps=1e-6, device="cuda")
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(D, device="cuda", generator=gen))
        norm.bias.copy_(0.1 * torch.randn(D, device="cuda", generator=gen))
    dh = torch.randn(ADD_LN_SHAPE, device="cuda", generator=gen).bfloat16()
    dres = None if y is None else torch.randn(ADD_LN_SHAPE, device="cuda", generator=gen)
    return x, y, s, norm, dh, dres


def add_ln_grads(fn, x, y, s, norm, dh, dres):
    """x', h and the gradients (x, γ, β, and y with a branch) of
    fn(x, y, s, norm, bf16) for the cotangents dh of h and dres of x'."""
    x = x.detach().requires_grad_()
    y = None if y is None else y.detach().requires_grad_()
    xo, h = fn(x, y, s, norm, torch.bfloat16)
    outs, cots = ([h], [dh]) if y is None else ([xo, h], [dres, dh])
    g = torch.autograd.grad(outs, [x, norm.weight, norm.bias] + ([] if y is None else [y]), cots)
    return xo.detach(), h.detach(), g


def add_ln_eager(x, y, s, norm, dtype):
    """The eager chain the op replaced at each site: the add, then
    `layer_norm_to` (float32 LayerNorm, cast)."""
    if y is not None:
        y = y.float()
        x = x + (y if s is None else y * s[:, None, None])
    return x, vit_mod.layer_norm_to(x, norm, dtype)


def add_ln_phase(asset, smi) -> dict:
    """The ViT blocks' add + LayerNorm kernels at [48, 192, 1280] in each of
    ADD_LN_VARIANTS: the op (`add_layer_norm`, forward and autograd's
    backward) held to the plain twin on the same card tensors, its second
    backward bitwise the first, one launch of each kernel a call; each
    kernel timed alone (graph replays) beside its byte bound and the eager
    chain it replaced (graph replays, forward and forward + backward). Then one
    graphed hmr2_vith step at its b48: the launches of a replay
    (ADD_LN_SITES of each kernel) and the rows the op normalised on the
    kernels in the first call (none on the twin)."""
    t_phase = time.perf_counter()
    R, D = ADD_LN_SHAPE[0] * ADD_LN_SHAPE[1], ADD_LN_SHAPE[2]
    twin = lambda x, y, s, n, dt: add_ln.add_ln_torch(x, y, s, n.weight, n.bias, n.eps, dt)[:2]  # noqa: E731
    by_variant = {}
    for variant in ADD_LN_VARIANTS:
        x, y, s, norm, dh, dres = add_ln_inputs(variant)
        _build.reset_counts()
        kxo, kh, kg = add_ln_grads(add_ln.add_layer_norm, x, y, s, norm, dh, dres)
        torch.cuda.synchronize()
        launches = _build.counts()
        rows = tracing.counters(add_ln.COUNTER)
        want = {"vit_add_ln_fwd": 1, "vit_add_ln_bwd": 1, "vit_add_ln_bwd_reduce": 1}
        check(launches == want, f"add+LN {variant}: one call launched {launches}, not {want}")
        check(rows == {"kernel": R}, f"add+LN {variant}: rows counted {rows}, not {R} on the kernels")
        again = add_ln_grads(add_ln.add_layer_norm, x, y, s, norm, dh, dres)[2]
        check(all(torch.equal(a, b) for a, b in zip(kg, again)), f"add+LN {variant}: two backward calls differ")
        txo, th, tg = add_ln_grads(twin, x, y, s, norm, dh, dres)
        check(torch.equal(kxo, txo), f"add+LN {variant}: x' differs from the eager sum")
        check(bf16_ulp_ok(kh, th), f"add+LN {variant}: h beyond one bf16 ulp of the twin's")
        err = {"dx": rel_norm(kg[0], tg[0]), "dgamma": rel_norm(kg[1], tg[1]), "dbeta": rel_norm(kg[2], tg[2])}
        check(err["dx"] <= ADD_LN_DX_TOL, f"add+LN {variant}: dx rel err {err['dx']} > {ADD_LN_DX_TOL}")
        for k in ("dgamma", "dbeta"):
            check(err[k] <= ADD_LN_DGAMMA_TOL, f"add+LN {variant}: {k} rel err {err[k]} > {ADD_LN_DGAMMA_TOL}")
        if y is not None:
            own = (kg[0] if s is None else kg[0] * s[:, None, None]).bfloat16()
            check(torch.equal(kg[3], own), f"add+LN {variant}: dy is not the bf16 rounding of g·s")
            check(bf16_ulp_ok(kg[3], tg[3]), f"add+LN {variant}: dy beyond one bf16 ulp of the twin's")
        w, b = norm.weight.detach(), norm.bias.detach()
        xo, _, mean, rstd = add_ln.add_ln_cuda(x, y, s, w, b, norm.eps, torch.bfloat16)
        ydt = None if y is None else torch.bfloat16
        fwd_ms = device_ms(lambda: add_ln.add_ln_cuda(x, y, s, w, b, norm.eps, torch.bfloat16), 20)
        bwd_ms = device_ms(lambda: add_ln.add_ln_bwd_cuda(dh, dres, xo, mean, rstd, w, s, ydt), 20)
        xr = x.detach().requires_grad_()
        yr = None if y is None else y.detach().requires_grad_()
        with torch.no_grad():
            eager_fwd_ms = device_ms(lambda: add_ln_eager(x, y, s, norm, torch.bfloat16), 20)

        def eager_step():
            xo_e, h_e = add_ln_eager(xr, yr, s, norm, torch.bfloat16)
            outs, cots = ([h_e], [dh]) if yr is None else ([xo_e, h_e], [dres, dh])
            torch.autograd.grad(outs, [xr, norm.weight, norm.bias] + ([] if yr is None else [yr]), cots)

        eager_ms = device_ms(eager_step, 20)  # autograd's backward captured with its forward
        fb, bb = add_ln_bytes(R, D, y is not None)
        by_variant[variant] = {
            "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_bound_ms": fb / HBM_BYTES_PER_S * 1e3,
            "bwd_bound_ms": bb / HBM_BYTES_PER_S * 1e3, "eager_fwd_ms": eager_fwd_ms, "eager_ms": eager_ms,
            **err,
        }
        v = by_variant[variant]
        print(
            f"[add_ln] {variant} [{R}, {D}]: x' bitwise, h and dy within one bf16 ulp of the twin, dx rel err "
            f"{err['dx']:.2e}, dgamma {err['dgamma']:.2e}, dbeta {err['dbeta']:.2e}, backward repeats bitwise; "
            f"forward {fwd_ms:.4f} ms (bound {v['fwd_bound_ms']:.4f} ms, {fb / 1e6:.1f} MB: "
            f"{v['fwd_bound_ms'] / fwd_ms:.1%}), backward + reduction {bwd_ms:.4f} ms (bound "
            f"{v['bwd_bound_ms']:.4f} ms, {bb / 1e6:.1f} MB: {v['bwd_bound_ms'] / bwd_ms:.1%}); the eager chain "
            f"{eager_fwd_ms:.4f} ms forward, {eager_ms:.4f} ms forward + backward against the kernels' "
            f"{fwd_ms + bwd_ms:.4f} [{smi}]"
        )
        del x, y, s, norm, dh, dres, kxo, kh, kg, again, txo, th, tg, xo, mean, rstd, xr, yr
        torch.cuda.empty_cache()
    # --- One graphed hmr2_vith step: the kernels' launches a replay. --------
    cfg = configs.PRESETS["hmr2_vith"]
    ts, consts = train.init_state(cfg, asset=asset, device="cuda")
    fn = train.compile_fused_step(cfg, consts)
    _build.reset_counts()
    fn(ts)  # the eager warm-up step and the capture
    torch.cuda.synchronize()
    rows = tracing.counters(add_ln.COUNTER)
    check(rows.get("kernel", 0) > 0 and rows.get("eager", 0) == 0,
          f"hmr2_vith: the op's rows in the first call {rows}, none may run on the twin")
    _build.reset_counts()
    fn(ts)
    torch.cuda.synchronize()
    replay = {k: n for k, n in _build.counts().items() if k.startswith("vit_add_ln")}
    want = {k: ADD_LN_SITES for k in ("vit_add_ln_fwd", "vit_add_ln_bwd", "vit_add_ln_bwd_reduce")}
    check(fn.captures == 1 and replay == want, f"hmr2_vith: a replay launched {replay}, not {want}")
    print(
        f"[add_ln] hmr2_vith B={cfg.batch_size}: a graphed step's replay launched {replay}; the first call "
        f"normalised {rows} rows [{smi}]"
    )
    del fn, ts, consts
    torch.cuda.empty_cache()
    print(f"[add_ln] phase in {time.perf_counter() - t_phase:.1f} s")
    return {"by_variant": by_variant, "hmr2_replay": replay}


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
            fresh, consts = train.init_state(split, asset=asset, device="cuda")
        train.load_state_dict(fresh, Checkpointer(split.checkpoint_dir).restore(map_location="cpu"))
        check(fresh.step == k, f"restored step {fresh.step} != {k}")
        same_state(train.state_dict(ts_k), train.state_dict(fresh), devices=True)
        del fresh, ts_k
        first_resumed = []
        with scaled_init(), first_drawn_batch(first_resumed):
            ts_r, terms_r = train.fit(split, asset=asset, device="cuda")
        with scaled_init():
            ts_s, terms_s = train.fit(base, asset=asset, device="cuda")
        check(ts_r.step == ts_s.step == 2 * k, f"steps {ts_r.step}, {ts_s.step} != {2 * k}")
        # The straight run draws step k's batch in a graph replay, which
        # the graphs phase holds bitwise to make_batch's.
        (b_r,), b_s = first_resumed, train.make_batch(split.seed, k, split.batch_size, consts, split)
        check(set(b_r) == set(b_s) and all(torch.equal(b_r[key], b_s[key]) for key in b_s),
              f"the resumed run's batch of step {k} differs from the stream's (make_batch)")
        rel = {t: abs(terms_r[t] - v) / max(abs(v), 1e-6) for t, v in terms_s.items()}
        worst = max(rel, key=rel.get)
        check(set(terms_r) == set(terms_s) and rel[worst] <= RESUME_TOL,
              f"resumed vs straight run at step {2 * k}: {worst} rel err {rel[worst]} > {RESUME_TOL}")
        print(
            f"[robust] fit to step {k} (checkpoint_every={k}), restored state bitwise equal to the run's "
            f"(parameters, BN statistics, Adam moments and counts, schedule, EMA, step, seed); resumed to "
            f"{2 * k}: its batch of step {k} bitwise the stream's; loss terms at step {2 * k} against "
            f"the straight run's: worst {worst} rel err {rel[worst]:.3e} (tolerance {RESUME_TOL:g})"
        )
        del ts_r, ts_s, first_resumed, b_r, b_s, consts

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


def routed(fn, want: str):
    """`fn()` with its standard error kept; checks that the run named the
    route `want` in its first `fit:` line."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        out = fn()
    lines = [x for x in err.getvalue().splitlines() if x.startswith("fit: ")]
    check(bool(lines) and lines[0].startswith(f"fit: {want}"), f"route line {lines[:1]}, not 'fit: {want}...'")
    return out


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
            ts_s, terms = routed(lambda: train.fit_dataset(
                cfg, ds, num_steps=DISK_STEPS, asset=asset, device="cuda",
                log=lambda rec: stamps.append(time.perf_counter())), "graph: compile_data_step,")
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
            f"({ds.steps_per_epoch()} an epoch) on the graph route: launches {launches}; host median {med:.3f} ms/step, "
            f"p90 {p90:.3f} ms ({B / med * 1e3:.1f} img/s) over steps 1-{DISK_STEPS - 1} (step 1 is the capture); "
            f"eager data_train_step, profiled window of {DISK_PROFILED} steps: "
            f"device {dev['device_ms']:.3f} ms/step, wall {wall:.3f} ms, busy share {dev['device_ms'] / wall:.3f}, "
            f"{dev['kernels']:.0f} kernels, by category {json.dumps({k: round(v, 3) for k, v in dev['by_category_ms'].items()})}; "
            f"H2D {statistics.median(h2d):.3f} ms/batch (median of {len(h2d)}), prefetch wait median "
            f"{statistics.median(wait_ms):.3f} ms, max {max(wait_ms):.3f} ms a step; preprocess {pre_ms:.3f} device ms "
            f"[{smi}]"
        )

        # --- Resume at half way against the straight run: file and shards. --
        shard_dir = os.path.join(work, "shards")
        dataset_lib.shard_npz(path, shard_dir, -(-DISK_EXAMPLES // DISK_SHARDS))
        # The graph route: the resumed run captures anew from the restored
        # state, and its steps must be the straight run's bitwise.
        for source, data in (("file", ds), ("shards", dataset_lib.open_dataset(shard_dir, B, seed=cfg.seed))):
            with scaled_init():
                ts_t, terms_s = train.fit_dataset(cfg, data, num_steps=DISK_STEPS, asset=asset, device="cuda")
            split = dataclasses.replace(cfg, checkpoint_every=half, checkpoint_dir=os.path.join(work, f"ck_{source}"))
            with scaled_init():
                train.fit_dataset(split, data, num_steps=half, asset=asset, device="cuda")
                ts_r, terms_r = train.fit_dataset(split, data, num_steps=DISK_STEPS, asset=asset, device="cuda")
            check(ts_r.step == DISK_STEPS, f"{source}: the resumed run ended at step {ts_r.step}")
            same_state(run_state(ts_t), run_state(ts_r), True, source, "resumed graphed disk run")
            check(terms_r == terms_s, f"{source}: resumed terms {terms_r} != straight {terms_s}")
            print(
                f"[disk] {source} ({len(getattr(data, 'paths', [path]))} file(s)): fit_dataset (graph route) to step "
                f"{half} with checkpoints, resumed and captured again to {DISK_STEPS}: state (parameters, BN buffers, "
                f"Adam, rates) and the terms at step {DISK_STEPS} bitwise the straight graphed run's "
                f"(total {terms_s['total']:.6f})"
            )
            del ts_r, ts_t

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
                ts_i, terms_i = routed(lambda: train.fit_preprocessed(
                    cfg, idd, num_steps=2, asset=asset, device="cuda"), "graph: compile_data_step(raw=False),")
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


# The parallel phase: config5_data_parallel (ResNet-18, global batch 64,
# 256²) through the port's mesh code. The machine has one card, so NCCL runs
# at world size 1 (in this process), and the multi-rank paths run as
# PAR_RANKS gloo ranks that share the card: their step times are no
# multi-GPU rate. PAR_STEPS counted steps each, after one warm-up.
PAR_RANKS = 2
PAR_STEPS = 3
PAR_RENDER_IMAGES = 8  # images of the row-sharded render checks
PAR_HARD_IMAGES = 4  # images of the hard raster's band check
PER_STEP_SP = {lbs_cuda.KERNEL: 2}  # SP renders on the separable route: no raster kernel
# Sharded int8 serving: a global request of 32 (16 a rank), timed over
# PAR_INT8_CALLS calls; one LBS launch a rank a call; kp2d within the
# reference's limit (tests/test_sharding.py), in pixels.
PAR_INT8_BATCH = 32
PAR_INT8_CALLS = 5
PAR_INT8_IMPLS = ("int8", "int8c")
PER_CALL_INT8 = {lbs_cuda.KERNEL: 1}
INT8_KP2D_TOL = 2e-3
SP_LOSS_TOL = 2e-3  # the reference's limit, SP loss vs the 1-D loss
# The rank's step against one process with the bf16 encoder: loss terms, the
# gradients' global error and the BN buffers within a few units of bf16
# roundoff (2^-8 = 3.9e-3). An ulp of a float32 BN statistic (the mean of
# the ranks' means is not the mean of the batch to the last bit) can flip
# the bf16 rounding of a channel's scale, so the bf16 step is held no closer
# than that; the float32 step is held to the reduction-order floor.
BF16_TOL = 1e-2


def step1(model, consts, batch, cfg, mesh=None) -> tuple[dict, dict, dict]:
    """Step 1's loss terms, gradients (summed over the mesh under one) and BN
    buffers from `model` on `batch`; the model's buffers move."""
    model.zero_grad(set_to_none=True)
    total, terms = train.loss_and_metrics(model, consts, batch, cfg, mesh)
    total.backward()
    if mesh is not None:
        mesh_lib.all_reduce_grads(model.parameters(), mesh)
    return (
        {k: float(v.detach()) for k, v in terms.items()},
        {k: p.grad for k, p in model.named_parameters()},
        {k: b.clone() for k, b in model.named_buffers()},
    )


def term_err(got: dict, want: dict) -> float:
    check(set(got) == set(want), f"loss terms differ: {sorted(got)} vs {sorted(want)}")
    return max(abs(got[k] - v) / max(abs(v), 1e-12) for k, v in want.items())


def leaf_errs(got: dict, want: dict) -> tuple[float, float]:
    """Max normalised gradient error over (IEF and mean_theta, encoder) leaves."""
    errs = {k: norm_err(got[k], g) for k, g in want.items()}
    return (max(e for k, e in errs.items() if not k.startswith("encoder.")),
            max(e for k, e in errs.items() if k.startswith("encoder.")))


def global_err(got: dict, want: dict) -> float:
    """|got - want| / |want| over every leaf at once (the clip's global norm)."""
    d = torch.sqrt(sum(torch.sum((got[k] - g).double() ** 2) for k, g in want.items()))
    return float(d / torch.sqrt(sum(torch.sum(g.double() ** 2) for g in want.values())))


def grad_errs(got: dict, want: dict) -> dict:
    head, enc = leaf_errs(got, want)
    return {"head": head, "encoder": enc, "global": global_err(got, want)}


def scaled_state(cfg, asset, device):
    ts, consts = train.init_state(cfg, asset, device)
    with torch.no_grad():  # keep the seed-0 bodies in frame (see main)
        ts.model.ief.layers[-1].weight.mul_(0.01)
    return train.new_state(ts.model, cfg, cfg.seed), consts


def timed_steps(ts, consts, cfg, mesh, n: int) -> list[float]:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        train.fused_step(ts, consts, cfg, mesh)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


@contextlib.contextmanager
def timed_grad_reduce(record: list):
    """Inside the block each gradient all-reduce of a step appends (bytes,
    host ms between synchronizes) to `record`."""
    plain = mesh_lib.all_reduce_grads

    def timed(params, m, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = plain(params, m, *args, **kwargs)
        torch.cuda.synchronize()
        record.append((n, (time.perf_counter() - t0) * 1e3))
        return n

    mesh_lib.all_reduce_grads = timed
    try:
        yield
    finally:
        mesh_lib.all_reduce_grads = plain


def reduce_stats(record: list) -> dict:
    return {"reduce_bytes": record[-1][0], "reduce_ms": statistics.median(r[1] for r in record)}


def nccl_world1(asset, smi) -> dict:
    """NCCL at world size 1, in this process: step 1 of config5_data_parallel
    through the mesh (every collective runs) against the no-mesh step from
    the same state and seed (rtol 1e-6; bitwise where the order is the
    same), then PAR_STEPS steps each way, in turns, host wall per step."""
    cfg = configs.CONFIG5_DATA_PARALLEL
    B = cfg.batch_size
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"), rank=0, world_size=1)
        try:
            mesh = mesh_lib.make_mesh(None, "cuda")
            check(mesh.world == 1 and mesh.backend == "nccl", f"NCCL mesh: {mesh}")
            ts, consts = scaled_state(cfg, asset, "cuda")
            init_model = copy.deepcopy(ts.model)
            batch = train.make_batch(cfg.seed, 0, B, consts, cfg)
            mbatch = train.make_batch(cfg.seed, 0, B, consts, cfg, mesh)
            check(all(torch.equal(mbatch[k], v) for k, v in batch.items()), "NCCL world 1: the mesh's batch differs")
            tp, gp, bp = step1(copy.deepcopy(init_model), consts, batch, cfg)
            tm, gm, bm = step1(copy.deepcopy(init_model), consts, mbatch, cfg, mesh)
            t_err = term_err(tm, tp)
            g_err = max(leaf_errs(gm, gp))
            b_err = max(max_err(bm[k], v) for k, v in bp.items())
            bitwise = all(torch.equal(gm[k], g) for k, g in gp.items()) and t_err == 0.0
            check(t_err <= 1e-6 and g_err <= 1e-6 and b_err <= 1e-6,
                  f"NCCL world 1 vs no mesh: terms {t_err}, gradients {g_err}, BN buffers {b_err}")

            runs = {"plain": [], "mesh": []}
            states = {k: train.new_state(copy.deepcopy(init_model), cfg, cfg.seed) for k in runs}
            for k in runs:  # one warm-up step each
                timed_steps(states[k], consts, cfg, mesh if k == "mesh" else None, 1)
            launches, record = {}, []
            for k in ("plain", "mesh", "mesh", "plain"):
                _build.reset_counts()
                runs[k] += timed_steps(states[k], consts, cfg, mesh if k == "mesh" else None, PAR_STEPS)
                if k == "mesh":
                    launches = _build.counts()
            with timed_grad_reduce(record):  # apart: its synchronizes would stretch the steps above
                timed_steps(states["mesh"], consts, cfg, mesh, PAR_STEPS)
            stats = reduce_stats(record)
            for name, per in PER_STEP.items():
                check(launches.get(name, 0) == per * PAR_STEPS,
                      f"NCCL world 1: kernel {name} launched {launches.get(name, 0)} times in {PAR_STEPS} steps")
            ms = {k: statistics.median(v) for k, v in runs.items()}
            print(
                f"[parallel] NCCL world 1, config5_data_parallel B={B}: step 1 through the mesh vs no mesh: "
                f"terms rel err {t_err:.3e}, gradients {g_err:.3e} normalised, BN buffers {b_err:.3e}"
                f"{' (bitwise equal)' if bitwise else ''}; host wall per step (median of {2 * PAR_STEPS}, "
                f"in turns): no mesh {ms['plain']:.3f} ms, mesh {ms['mesh']:.3f} ms (DP machinery "
                f"{ms['mesh'] - ms['plain']:+.3f} ms); the gradient all-reduce {stats['reduce_bytes'] / 1e6:.3f} "
                f"MB in {stats['reduce_ms']:.3f} ms (between synchronizes, {PAR_STEPS} more steps); "
                f"launches in {PAR_STEPS} mesh steps {launches} [{smi}]"
            )
        finally:
            dist.destroy_process_group()
    return {"launches": launches, "ms": ms, "bitwise": bitwise}


def sharded_int8(model, consts, request, cfg, mesh) -> dict:
    """Sharded int8 serving on this rank: qparams calibrated on rank 0 (the
    other ranks calibrate on zeros) and replicated, then for each impl the
    whole request through `quantized_forward(..., mesh)` against one process
    on it: errors, the rank's launches in one call, host ms a call."""
    from indirect_learning_pose_shape_tpu_torch.models import quantize as quant

    with torch.no_grad():
        calib = request if mesh.rank == 0 else torch.zeros_like(request)
        qenc = quant.as_encoder(quant.ptq_quantize(model.encoder, calib), cfg.model.encoder, mesh.device)
        mesh_lib.replicate(qenc, mesh)
        out = {}
        for impl in PAR_INT8_IMPLS:
            def call(m=mesh):
                return quant.quantized_forward(qenc, model.ief, consts, request, cfg.model, impl, m)

            one = call(None)
            _build.reset_counts()
            got = call()
            torch.cuda.synchronize()
            launches = _build.counts()
            out[impl] = {
                "shapes": all(got[k].shape == v.shape for k, v in one.items()) and set(got) == set(one),
                **{k: max_err(got[k], one[k]) for k in ("kp2d", "verts", "theta")},
                "launches": launches, "ms": request_ms(call, PAR_INT8_CALLS),
            }
    return out


def parallel_rank(device) -> dict:
    """One of PAR_RANKS gloo ranks on the card: the data-parallel step on its
    rows against the one-process step on the global batch, the kernels
    against their plain versions, counted steps with the all-reduce timed,
    then the 1 x PAR_RANKS render mesh. Returns numbers; raises on a check."""
    disable_tf32()
    asset = assets.load_asset()
    cfg = configs.CONFIG5_DATA_PARALLEL
    B = cfg.batch_size
    mesh = mesh_lib.make_mesh(None, device)
    out = {"rank": mesh.rank}
    ts, consts = scaled_state(cfg, asset, device)
    init_model = copy.deepcopy(ts.model)
    glob = train.make_batch(cfg.seed, 0, B, consts, cfg)
    local = mesh_lib.shard_batch(glob, mesh)
    mine = train.make_batch(cfg.seed, 0, B, consts, cfg, mesh)
    out["batch_err"] = max(max_err(mine[k].float(), v.float()) for k, v in local.items())

    # Step 1 on this rank's rows vs one process on the global batch, and the
    # floor of float32 reduction order: one process on the global batch with
    # its halves swapped (the same function, summed in another order).
    enc32 = dataclasses.replace(cfg.model.encoder, compute_dtype=torch.float32)
    swap = torch.cat([torch.arange(B // 2, B), torch.arange(0, B // 2)]).to(device)
    swapped = {k: v[swap] if v.ndim else v for k, v in glob.items()}
    for label, enc_cfg in (("f32", enc32), ("bf16", cfg.model.encoder)):
        m1, mm, ms = copy.deepcopy(init_model), copy.deepcopy(init_model), copy.deepcopy(init_model)
        m1.encoder.cfg = mm.encoder.cfg = ms.encoder.cfg = enc_cfg
        t1, g1, b1 = step1(m1, consts, glob, cfg)
        tm, gm, bm = step1(mm, consts, local, cfg, mesh)
        ts_, gs, _ = step1(ms, consts, swapped, cfg)
        out[label] = {"terms": term_err(tm, t1), "bn": max(max_err(bm[k], v) for k, v in b1.items()),
                      **grad_errs(gm, g1), "order": {"terms": term_err(ts_, t1), **grad_errs(gs, g1)}}
        if label == "f32":
            # The update of the summed gradients is the one-process update of them.
            grads = {k: g.clone() for k, g in gm.items()}
            sm = train.new_state(mm, cfg, cfg.seed)
            train.apply_update(sm, cfg)
            mu = copy.deepcopy(init_model)
            for k, p in mu.named_parameters():
                p.grad = grads[k]
            su = train.new_state(mu, cfg, cfg.seed)
            train.apply_update(su, cfg)
            out["update_bitwise"] = all(
                torch.equal(p, dict(mm.named_parameters())[k]) for k, p in mu.named_parameters()
            )
            # The kernels against their plain versions on this rank's path.
            cfg_t = dataclasses.replace(
                cfg, model=dataclasses.replace(cfg.model, smpl_impl="torch", raster_impl="torch")
            )
            mt = copy.deepcopy(init_model)
            mt.encoder.cfg = enc32
            with culled_plain_raster():
                tt, gt, _ = step1(mt, consts, local, cfg_t, mesh)
            out["plain"] = {"terms": term_err(tm, tt), **grad_errs(gm, gt)}
        else:
            floor = (0.0, 0.0)  # (IEF, encoder)
            for seed in JITTER_SEEDS:
                mj = copy.deepcopy(init_model)
                mj.encoder.cfg = enc_cfg
                with jittered_render(JITTER, seed):
                    _, gj, _ = step1(mj, consts, glob, cfg)
                floor = tuple(map(max, floor, leaf_errs(gj, g1)))
            # The bf16 gap: one process on the global batch with the mesh's
            # BN statistics (the mean of the half-batch means), and with each
            # conv and normalisation run per half too.
            halves = {}
            for name, per_block in (("half_means", False), ("per_block", True)):
                mh = copy.deepcopy(init_model)
                mh.encoder.cfg = enc_cfg
                with partitioned_bn(mesh.n_data, per_block):
                    _, halves[name], _ = step1(mh, consts, glob, cfg)
            out[label].update(
                floor=floor, stats_floor=leaf_errs(halves["half_means"], g1),
                **{name: grad_errs(gm, g) for name, g in halves.items()},
            )

    # Counted data-parallel steps, the gradient all-reduce timed.
    st = train.new_state(copy.deepcopy(init_model), cfg, cfg.seed)
    timed_steps(st, consts, cfg, mesh, 1)
    _build.reset_counts()
    times = timed_steps(st, consts, cfg, mesh, PAR_STEPS)
    launches, record = _build.counts(), []
    with timed_grad_reduce(record):  # apart: its synchronizes would stretch the steps above
        timed_steps(st, consts, cfg, mesh, PAR_STEPS)
    out["dp"] = {"launches": launches, "ms": statistics.median(times), **reduce_stats(record)}
    out["int8"] = sharded_int8(init_model, consts, glob["image"][:PAR_INT8_BATCH], cfg, mesh)

    # The 1 x PAR_RANKS render mesh: each rank renders a band of rows.
    mesh2 = render_sp.render_mesh(1, PAR_RANKS, device)
    rows = render_sp.constrainer(mesh2)
    layout, S = consts.part_layout, cfg.model.image_size
    n = PAR_RENDER_IMAGES
    sm_out = smpl.smpl_forward(consts.smpl, glob["gt_pose"][:n], glob["gt_betas"][:n])
    v2 = camera.project_pixel(sm_out["verts"], glob["gt_cam"][:n], S)
    rcfg = dataclasses.replace(cfg.model.raster, matmul_precision="highest")
    band = rows.band(S)
    sp = render_sp.rasterize_spatial(v2, layout, rcfg, mesh2)
    v_req = v2.detach().clone().requires_grad_(True)
    ref = raster.soft_rasterize(v_req, layout, rcfg, impl="separable")
    loss = losses.silhouette_bce(ref["silhouette"], glob["silhouette"][:n])
    (grad,) = torch.autograd.grad(loss, v_req)
    sp_loss, sp_grad = render_sp.spatial_render_loss_grad(v2, glob["silhouette"][:n], layout, rcfg, mesh2)
    out["sp_render"] = {
        "fwd": max(max_err(sp[k], ref[k][:, band].detach()) for k in ("probs", "silhouette")),
        "loss": abs(float(sp_loss) - float(loss.detach())) / abs(float(loss.detach())),
        "grad_abs": max_err(sp_grad, grad), "grad": norm_err(sp_grad, grad),
    }
    # The SP train step against the one-process step on the separable route.
    sp_cfg = dataclasses.replace(cfg, render_devices=PAR_RANKS)
    sep_cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, raster_impl="separable"))
    s1 = train.new_state(copy.deepcopy(init_model), sep_cfg, cfg.seed)
    one_loss = float(train.fused_step(s1, consts, sep_cfg)["total"])
    ssp = train.new_state(copy.deepcopy(init_model), sp_cfg, cfg.seed)
    sp_mesh = train._auto_mesh(sp_cfg, device)
    check(sp_mesh.n_render == PAR_RANKS and sp_mesh.n_data == 1, f"SP mesh {sp_mesh}")
    step_loss = float(train.fused_step(ssp, consts, sp_cfg, sp_mesh)["total"])
    _build.reset_counts()
    times = timed_steps(ssp, consts, sp_cfg, sp_mesh, PAR_STEPS)
    launches, record = _build.counts(), []
    with timed_grad_reduce(record):
        timed_steps(ssp, consts, sp_cfg, sp_mesh, PAR_STEPS)
    out["sp"] = {"loss": step_loss, "one_loss": one_loss, "launches": launches,
                 "ms": statistics.median(times), **reduce_stats(record)}
    # The hard raster in tile bands, and the LBS kernel on this path.
    h = PAR_HARD_IMAGES
    dense = raster_hard.hard_raster(v2[:h], sm_out["verts"][:h, :, 2], consts.hard, S, with_shade=True)
    banded = raster_hard.hard_raster(v2[:h], sm_out["verts"][:h, :, 2], consts.hard, S, with_shade=True, rows=rows)
    out["hard_equal"] = all(torch.equal(banded[k], dense[k][:, band]) for k in ("part_labels", "silhouette", "shade"))
    out["hard_fg"] = float(dense["silhouette"].mean())
    kern = smpl.smpl_forward(consts.smpl, mine["gt_pose"], mine["gt_betas"], impl="kernel")
    plain = smpl.smpl_forward(consts.smpl, mine["gt_pose"], mine["gt_betas"], impl="torch")
    out["lbs_err"] = max(max_err(kern[k], plain[k]) for k in ("verts", "joints"))
    return out


def torchrun_cli(extra: tuple = ()) -> list[dict]:
    """`torchrun --standalone --nproc_per_node 1 -m ...train --preset
    config5_data_parallel --steps 2`: `train.main` joins the NCCL group that
    torchrun describes (one card here, so one rank); returns its logged
    JSON lines."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "indirect_learning_pose_shape_tpu_torch.train", "--preset", "config5_data_parallel",
           "--steps", "2", "--log-every", "1", *extra]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0, f"torchrun train failed ({proc.returncode}):\n{proc.stderr[-3000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def parallel_phase(asset, smi) -> dict:
    """NCCL at world size 1, then PAR_RANKS gloo ranks sharing the card
    (`parallel_rank`), then the training CLI under torchrun; checks and
    prints what they return."""
    t_phase = time.perf_counter()
    nccl = nccl_world1(asset, smi)
    torch.cuda.empty_cache()
    ranks = mesh_lib.spawn(parallel_rank, PAR_RANKS, backend="gloo", device="cuda", timeout=600)
    cfg = configs.CONFIG5_DATA_PARALLEL
    for r in ranks:
        tag = f"[parallel] gloo rank {r['rank']} of {PAR_RANKS} on one card"
        f32, bf = r["f32"], r["bf16"]
        check(f32["terms"] <= 1e-5, f"{tag}: float32 encoder, loss terms rel err {f32['terms']} vs one process")
        check(f32["global"] <= 1e-4, f"{tag}: float32 encoder, gradients' global error {f32}")
        for k in ("head", "encoder"):
            check(f32[k] <= FLOOR_MULTIPLE * f32["order"][k],
                  f"{tag}: float32 encoder, {k} gradients {f32[k]} > {FLOOR_MULTIPLE} x the reduction-order "
                  f"floor {f32['order'][k]}")
        check(f32["bn"] <= 1e-5, f"{tag}: BN running buffers err {f32['bn']}")
        check(r["update_bitwise"], f"{tag}: the update of the summed gradients is not the one-process update")
        check(max(bf["terms"], bf["global"], bf["bn"]) <= BF16_TOL, f"{tag}: bf16 step vs one process {bf}")
        pb = bf["per_block"]
        bf_limits = [FLOOR_MULTIPLE * max(f, sf) for f, sf in zip(bf["floor"], bf["stats_floor"])]
        for k, lim in zip(("head", "encoder"), bf_limits):
            check(pb[k] <= lim, f"{tag}: bf16 {k} gradients {pb[k]} vs one process with the mesh's "
                                f"partition, over {FLOOR_MULTIPLE} x the floor ({lim})")
        check(pb["global"] <= 1e-4, f"{tag}: bf16 whole gradient vs one process with the mesh's partition {pb}")
        for impl, q in r["int8"].items():
            check(q["shapes"] and q["kp2d"] <= INT8_KP2D_TOL,
                  f"{tag}: sharded {impl} vs one process: shapes {q['shapes']}, kp2d {q['kp2d']}")
            check(q["launches"] == PER_CALL_INT8, f"{tag}: sharded {impl}: launches {q['launches']} in one call")
        pl = r["plain"]
        check(pl["terms"] <= 1e-4 and pl["head"] <= 1e-3 and pl["encoder"] <= 1e-3,
              f"{tag}: kernels vs plain versions (culled plain raster) on the rank's path: {pl}")
        for name, per in PER_STEP.items():
            got = r["dp"]["launches"].get(name, 0)
            check(got == per * PAR_STEPS, f"{tag}: kernel {name} launched {got} times in {PAR_STEPS} DP steps")
        sr = r["sp_render"]
        check(sr["fwd"] <= 1e-5 and sr["grad"] <= 1e-5 and sr["loss"] <= 1e-6,
              f"{tag}: row-sharded render vs local {sr}")
        sp = r["sp"]
        sp_err = abs(sp["loss"] - sp["one_loss"]) / abs(sp["one_loss"])
        check(sp_err <= SP_LOSS_TOL, f"{tag}: SP step loss {sp['loss']} vs one process {sp['one_loss']}")
        check(sp["launches"] == {k: v * PAR_STEPS for k, v in PER_STEP_SP.items()},
              f"{tag}: SP launches {sp['launches']}, expected {PER_STEP_SP} per step")
        check(r["hard_equal"] and r["hard_fg"] > 0.01, f"{tag}: hard raster bands vs dense (fg {r['hard_fg']})")
        check(r["lbs_err"] <= TOL, f"{tag}: LBS kernel vs plain on the SP path {r['lbs_err']}")
        print(
            f"{tag}, config5_data_parallel B={cfg.batch_size} ({cfg.batch_size // PAR_RANKS} a rank): its batch "
            f"vs the global batch's rows max abs {r['batch_err']:.3e}; step 1 vs one process on the global "
            f"batch (gradients: global, then normalised per leaf, IEF / encoder; reduction-order floor = one "
            f"process on the batch with its halves swapped): float32 encoder terms {f32['terms']:.3e} (floor "
            f"{f32['order']['terms']:.3e}), gradients {f32['global']:.3e}, {f32['head']:.3e} / {f32['encoder']:.3e} "
            f"(floor {f32['order']['global']:.3e}, {f32['order']['head']:.3e} / {f32['order']['encoder']:.3e}), BN "
            f"buffers {f32['bn']:.3e}, update bitwise; bf16 terms {bf['terms']:.3e} (floor "
            f"{bf['order']['terms']:.3e}), gradients {bf['global']:.3e}, {bf['head']:.3e} / {bf['encoder']:.3e} "
            f"(floor {bf['order']['global']:.3e}, {bf['order']['head']:.3e} / {bf['order']['encoder']:.3e}; "
            f"jittered-vertices floor {bf['floor'][0]:.3e} / {bf['floor'][1]:.3e}), BN buffers {bf['bn']:.3e}; "
            f"kernels vs plain versions on its path: terms {pl['terms']:.3e}, gradients {pl['global']:.3e}, "
            f"{pl['head']:.3e} / {pl['encoder']:.3e}"
        )
        hm = bf["half_means"]
        print(
            f"{tag}: bf16 gap, the rank's step-1 gradients (global, then per leaf IEF / encoder) against one "
            f"process on the global batch with the mesh's BN statistics (the mean of the {PAR_RANKS} "
            f"half-batch means): {hm['global']:.3e}, {hm['head']:.3e} / {hm['encoder']:.3e}; that process vs "
            f"the plain one process (statistics floor) {bf['stats_floor'][0]:.3e} / {bf['stats_floor'][1]:.3e}; "
            f"against one process with each conv, the statistics and the normalisation per half: "
            f"{pb['global']:.3e} (limit 1e-4), {pb['head']:.3e} / {pb['encoder']:.3e} (limits {FLOOR_MULTIPLE} x "
            f"the larger floor: {bf_limits[0]:.3e} / {bf_limits[1]:.3e})"
        )
        for impl, q in r["int8"].items():
            print(
                f"{tag}: sharded {impl} serving, request {PAR_INT8_BATCH} ({PAR_INT8_BATCH // PAR_RANKS} a rank), "
                f"qparams calibrated on rank 0 and replicated: gathered outputs vs one process max abs kp2d "
                f"{q['kp2d']:.3e} px (limit {INT8_KP2D_TOL}), verts {q['verts']:.3e}, theta {q['theta']:.3e}; "
                f"launches in one call {q['launches']}; host {q['ms']:.3f} ms a call (median of {PAR_INT8_CALLS}; "
                f"gloo ranks share the card: no multi-GPU rate) [{smi}]"
            )
        print(
            f"{tag}: {PAR_STEPS} DP steps, host wall {r['dp']['ms']:.3f} ms/step (ranks share the card: no "
            f"multi-GPU rate), launches {r['dp']['launches']}; gradient all-reduce "
            f"{r['dp']['reduce_bytes'] / 1e6:.3f} MB in {r['dp']['reduce_ms']:.3f} ms a step (gloo through the "
            f"host; between synchronizes, {PAR_STEPS} more steps) [{smi}]"
        )
        print(
            f"{tag}: 1x{PAR_RANKS} render mesh: separable render rows vs local max abs {sr['fwd']:.3e}, loss "
            f"{sr['loss']:.3e}, vertex gradient {sr['grad']:.3e} normalised ({sr['grad_abs']:.3e} abs); SP step "
            f"loss {sp['loss']:.6f} vs one process {sp['one_loss']:.6f} (rel {sp_err:.3e}, limit {SP_LOSS_TOL}); "
            f"SP host wall {sp['ms']:.3f} ms/step (gradient all-reduce {sp['reduce_bytes'] / 1e6:.3f} MB in "
            f"{sp['reduce_ms']:.3f} ms), launches {sp['launches']}; hard raster at "
            f"{cfg.model.image_size}² in "
            f"{PAR_RANKS} tile bands equal to dense; LBS kernel vs plain {r['lbs_err']:.3e} [{smi}]"
        )
    t0 = time.perf_counter()
    logged = torchrun_cli()
    check([rec["step"] for rec in logged] == [0, 1] and all(np.isfinite(rec["total"]) for rec in logged),
          f"torchrun train: logged {logged}")
    print(f"[parallel] torchrun --nproc_per_node 1 -m ...train --preset config5_data_parallel --steps 2: "
          f"losses {[round(rec['total'], 6) for rec in logged]} in {time.perf_counter() - t0:.1f} s (NCCL group "
          f"from torchrun's environment; one rank trains with no mesh, as the reference on one device)")
    print(f"[parallel] phase in {time.perf_counter() - t_phase:.1f} s")
    r0 = ranks[0]
    int8_launches = {}
    for q in r0["int8"].values():
        for k, v in q["launches"].items():
            int8_launches[k] = int8_launches.get(k, 0) + v
    return {"nccl": nccl["launches"], "dp": r0["dp"]["launches"], "sp": r0["sp"]["launches"],
            "int8": int8_launches}


# --- The compiled paths: CUDA graphs of the step and of the buckets. -------

GRAPH_STEPS = 5  # config4_full: graphed steps (the first the eager warm-up) against eager ones
GRAPH_RECIPE_STEPS = 3  # config4_mixed, config4_robust
GRAPH_TIMED = 20  # host wall per step, each route, in turns after the checks
GRAPH_BUCKETS = (1, 4, 8, 32, 128)
GRAPH_REQ_TIMED = 20
GRAPH_RESUME = 4  # the resumed run's budget; it stops at 3 and resumes from the save at 2
GRAPH_DISK_EXAMPLES = 64  # the phase's own 320² dataset: 2 batches an epoch
GRAPH_DISK_STEPS = 5  # disk steps each route (the first graphed one the eager warm-up and capture)
GRAPH_DISK_TIMED = 16  # host wall per disk step, each route, in turns
GRAPH_PRE_STEPS = 3  # fit_preprocessed's steps each route
GRAPH_EVAL_BATCHES = 3  # plain-suite batches an evaluate call (hardapp: 1, its dense hard raster ~0.35 s)
GRAPH_EVAL_TIMED = 10  # replays timed alone and with the eager PA-MPJPE tail


def run_state(ts) -> dict:
    """What a step changes: the model's parameters and BN buffers, Adam's
    moments and counts by parameter name, the rates, the EMA and the step."""
    names = {id(p): k for k, p in ts.model.named_parameters()}
    return {
        "model": {k: v.detach().clone() for k, v in ts.model.state_dict().items()},
        "adam": {names[id(p)]: {k: v.clone() for k, v in st.items()} for p, st in ts.optimizer.state.items()},
        "lr": [float(g["lr"]) for g in ts.optimizer.param_groups],
        "ema": None if ts.ema is None else {k: v.clone() for k, v in ts.ema.items()},
        "step": ts.step,
    }


def wall_stats(times: list) -> str:
    return f"median {statistics.median(times):.3f} ms, p90 {float(np.percentile(times, 90)):.3f} ms"


def graphed_steps(name, cfg, asset, steps: int, smi, timed: int = 0, keep: bool = False) -> dict:
    """`steps` calls of `compile_fused_step` (the first one the eager
    warm-up step and the capture, the rest replays) against as many eager
    `fused_step` calls from the same state: every step's terms and the
    final state (parameters, BN buffers, Adam's moments and counts, rates,
    EMA) bitwise, and each call's launches exactly the eager step's, which
    are the preset's. With `timed`, host wall per step of both routes in
    turns. With `keep`, the result also holds the compiled step, both
    states and the consts (`fn`, `ts_g`, `ts_e`, `consts`)."""
    ts_g, consts = scaled_state(cfg, asset, "cuda")
    ts_e, _ = scaled_state(cfg, asset, "cuda")
    same_state(run_state(ts_g), run_state(ts_e), True, name, "initial state")
    per = PER_STEP_ROBUST if cfg.synthetic.targets == "hard" else PER_STEP
    fn = train.compile_fused_step(cfg, consts)
    launches = []
    for i in range(steps):
        _build.reset_counts()
        tg = fn(ts_g)
        torch.cuda.synchronize()
        launches.append(_build.counts())
        _build.reset_counts()
        te = train.fused_step(ts_e, consts, cfg)
        torch.cuda.synchronize()
        eager = _build.counts()
        same_state(te, tg, True, f"{name} step {i} terms", "graphed step")
        check(eager == per, f"{name}: eager step {i} launched {eager}, not {per}")
        check(launches[-1] == eager,
              f"{name}: graphed call {i} launched {launches[-1]}, the eager step {eager}")
    same_state(run_state(ts_e), run_state(ts_g), True, name, "graphed run's state")
    check(fn.captures == 1, f"{name}: {fn.captures} captures in {steps} calls")
    out = {"capture_s": fn.graph.seconds, "pool_bytes": fn.graph.pool_bytes, "per_replay": launches[-1]}
    if keep:
        out.update(fn=fn, ts_g=ts_g, ts_e=ts_e, consts=consts)
    msg = (
        f"[graphs] {name} B={cfg.batch_size}: {steps} graphed steps (1 eager warm-up + capture, "
        f"{steps - 1} replays) equal {steps} eager steps bitwise (terms each step; parameters, BN "
        f"buffers, Adam moments and counts, rates{', EMA' if ts_e.ema is not None else ''}); capture "
        f"{fn.graph.seconds:.3f} s, pool {fn.graph.pool_bytes / 2**20:.1f} MiB; launches per replay "
        f"{launches[-1]}"
    )
    if timed:
        runs = {"eager": [], "graph": []}
        for route in ("eager", "graph", "graph", "eager"):
            for _ in range(timed // 2):
                t0 = time.perf_counter()
                if route == "graph":
                    fn(ts_g)
                else:
                    train.fused_step(ts_e, consts, cfg)
                torch.cuda.synchronize()
                runs[route].append((time.perf_counter() - t0) * 1e3)
        out.update({f"{r}_ms": statistics.median(t) for r, t in runs.items()})
        out.update({f"{r}_p90_ms": float(np.percentile(t, 90)) for r, t in runs.items()})
        msg += (
            f"; host wall per step over {timed} steps each, in turns: eager {wall_stats(runs['eager'])}, "
            f"graph {wall_stats(runs['graph'])}"
        )
    print(f"{msg} [{smi}]")
    return out


def graphed_train_fns(asset, smi) -> None:
    """`compile_train_fns` at config4_full: `gen_fn`'s batches bitwise
    `make_batch`'s, and `step_fn` on them (the first call the eager warm-up
    step and the capture) bitwise `train_step`, terms and final state."""
    cfg = configs.CONFIG4_FULL
    ts_g, consts = scaled_state(cfg, asset, "cuda")
    ts_e, _ = scaled_state(cfg, asset, "cuda")
    gen_fn, step_fn = train.compile_train_fns(cfg, consts)
    for step in range(3):
        batch = gen_fn(cfg.seed, step)
        want = train.make_batch(cfg.seed, step, cfg.batch_size, consts, cfg)
        same_state(want, batch, True, f"batch {step}", "graphed gen_fn")
        same_state(train.train_step(ts_e, want, consts, cfg), step_fn(ts_g, batch), True,
                   f"step {step} terms", "graphed step_fn")
    same_state(run_state(ts_e), run_state(ts_g), True, "state", "graphed step_fn run")
    check(step_fn.captures == 1, f"compile_train_fns: {step_fn.captures} captures of step_fn")
    print(
        f"[graphs] compile_train_fns config4_full: 3 graphed batches equal make_batch's and 3 graphed "
        f"train steps on them equal train_step's, bitwise (terms, state) [{smi}]"
    )


class _Stop(Exception):
    """Stops a `fit` run after a checkpoint, as a crash would."""


def graphed_resume(asset, smi) -> None:
    """`fit` (the graph route on the card) checkpointed every 2 steps and
    stopped after step 3, then resumed from the save at 2 and captured
    anew, against a straight run to the same budget: the states and the
    last terms bitwise. config4_full with a cosine rate (warm-up 1) and an
    EMA, so the restored rate tensor and the schedule are on the path."""
    base = dataclasses.replace(
        configs.CONFIG4_FULL, lr_schedule="cosine", warmup_steps=1, num_steps=GRAPH_RESUME,
        ema_decay=0.999, log_every=1,
    )

    def stop_at(step):
        def log(rec):
            if rec["step"] == step:
                raise _Stop()
        return log

    with tempfile.TemporaryDirectory(prefix="ilps_graphs_") as work, scaled_init():
        cfg = dataclasses.replace(base, checkpoint_every=2, checkpoint_dir=os.path.join(work, "ck"))
        try:
            train.fit(cfg, asset=asset, log=stop_at(2))
        except _Stop:
            pass
        check(Checkpointer(cfg.checkpoint_dir).latest_step() == 2, "graphed fit: no checkpoint at step 2")
        resumed, terms_r = train.fit(cfg, asset=asset)
        straight, terms_s = train.fit(base, asset=asset)
    same_state(run_state(straight), run_state(resumed), True, "resume", "resumed graphed run")
    check(terms_r == terms_s, f"graphed fit: resumed terms {terms_r} != straight {terms_s}")
    print(
        f"[graphs] fit (graph route) config4_full cosine + EMA: checkpointed at 2, stopped after 3, "
        f"resumed and captured again to {GRAPH_RESUME}: state and last terms bitwise the straight "
        f"graphed run's (total {terms_s['total']:.6f}) [{smi}]"
    )


def graphed_nccl(asset, smi, ds=None) -> None:
    """NCCL at world size 1 in this process: `compile_fused_step` under the
    mesh (the graph records the collectives) against the graphed step with
    no mesh, 3 steps each, terms and state bitwise; with `ds`, the same for
    the augmented disk step (`compile_data_step`) on its batches."""
    cfg = configs.CONFIG4_FULL
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "store"), rank=0, world_size=1)
        try:
            mesh = mesh_lib.make_mesh(None, "cuda")
            ts_m, consts = scaled_state(cfg, asset, "cuda")
            ts_p, _ = scaled_state(cfg, asset, "cuda")
            fn_m = train.compile_fused_step(cfg, consts, mesh)
            fn_p = train.compile_fused_step(cfg, consts)
            for i in range(3):
                same_state(fn_p(ts_p), fn_m(ts_m), True, f"step {i} terms", "NCCL world 1 graphed step")
            same_state(run_state(ts_p), run_state(ts_m), True, "state", "NCCL world 1 graphed run")
            check(fn_m.captures == 1, f"NCCL world 1: {fn_m.captures} captures")
            print(
                f"[graphs] NCCL world 1: 3 graphed steps through the mesh (the all-reduces in the graph) "
                f"equal the graphed no-mesh steps bitwise; capture {fn_m.graph.seconds:.3f} s [{smi}]"
            )
            if ds is not None:
                dcfg = disk_cfg()
                ts_m, consts = scaled_state(dcfg, asset, "cuda")
                ts_p, _ = scaled_state(dcfg, asset, "cuda")
                fn_m = train.compile_data_step(dcfg, consts, mesh)
                fn_p = train.compile_data_step(dcfg, consts)
                batches = disk_batches(ds, dcfg, rows=mesh.batch_rows(dcfg.batch_size))
                for i in range(3):
                    raw = next(batches)
                    same_state(fn_p(ts_p, raw), fn_m(ts_m, raw), True, f"disk step {i} terms",
                               "NCCL world 1 graphed disk step")
                batches.close()
                same_state(run_state(ts_p), run_state(ts_m), True, "state", "NCCL world 1 graphed disk run")
                check(fn_m.captures == 1, f"NCCL world 1 disk: {fn_m.captures} captures")
                print(
                    f"[graphs] NCCL world 1: 3 graphed augmented disk steps through the mesh (draws cut to the "
                    f"rank's rows, the all-reduces in the graph) equal the graphed no-mesh disk steps bitwise; "
                    f"capture {fn_m.graph.seconds:.3f} s [{smi}]"
                )
        finally:
            dist.destroy_process_group()


def graphed_requests(label, make, cfg, rng, smi) -> dict:
    """A graphed and an eager `Predictor` (`make(graphs=...)`) on the same
    requests: bucket b's request of b images, and a request of 3 after one
    of 4 (the padding row zeroed), all outputs bitwise; an earlier
    request's outputs unchanged by later replays; 1 LBS and no raster
    launch a request; request median and p90 per bucket, both routes."""
    size = cfg.image_size
    p_g, p_e = make(graphs=True), make(graphs=False)
    p_g.warmup(GRAPH_BUCKETS)
    p_e.warmup(GRAPH_BUCKETS)
    reqs = {b: rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32) for b in GRAPH_BUCKETS}
    reqs[3] = rng.uniform(-1, 1, (3, size, size, 3)).astype(np.float32)
    _build.reset_counts()
    first = p_g(reqs[1])
    kept = {k: v.clone() for k, v in first.items()}
    outs = {n: p_g(x) for n, x in reqs.items()}  # 3 after 4: padding zeroed over the 4th image
    torch.cuda.synchronize()
    launches = _build.counts()
    check(launches == {lbs_cuda.KERNEL: len(reqs) + 1},
          f"{label}: {len(reqs) + 1} graphed requests launched {launches}")
    for n, x in reqs.items():
        same_state(p_e(x), outs[n], True, f"request {n}", f"{label} graphed request")
    same_state(kept, first, True, "request 1", f"{label} earlier request's outputs after later replays")
    times = {}
    for n in GRAPH_BUCKETS:
        x = reqs[n]
        for route, p in (("eager", p_e), ("graph", p_g), ("graph", p_g), ("eager", p_e)):
            got = times.setdefault((route, n), [])
            for _ in range(GRAPH_REQ_TIMED // 2):
                t0 = time.perf_counter()
                p(x)
                torch.cuda.synchronize()
                got.append((time.perf_counter() - t0) * 1e3)
    for n in GRAPH_BUCKETS:
        g = p_g.bucket_graph(n)
        print(
            f"[graphs] {label} request batch {n}: eager {wall_stats(times[('eager', n)])}, graph "
            f"{wall_stats(times[('graph', n)])} (host wall from numpy images, forward only); capture "
            f"{g.seconds:.3f} s, pool +{g.pool_bytes / 2**20:.1f} MiB [{smi}]"
        )
    print(
        f"[graphs] {label}: graphed requests at buckets {GRAPH_BUCKETS} and a padded 3 equal the eager "
        f"Predictor's bitwise (every output); an earlier request's outputs survive later replays; "
        f"launches in {len(reqs) + 1} requests {launches}"
    )
    return {n: {r: statistics.median(times[(r, n)]) for r in ("eager", "graph")} for n in GRAPH_BUCKETS}


def disk_cfg():
    """config4_full with augmentation, as `train --dataset D --augment`."""
    cfg = configs.CONFIG4_FULL
    return dataclasses.replace(cfg, log_every=1, augment=dataclasses.replace(cfg.augment, enabled=True))


def disk_batches(ds, cfg, rows=None):
    """`fit_dataset`'s prefetched raw batches of `ds` from step 0."""
    pulls = train.dataset_pulls(cfg, ds.keys)
    return dataset_lib.prefetch_to_device(
        ({k: b[src] for k, src in pulls.items()} for b in ds.batches()), device=torch.device("cuda"), rows=rows)


def graphed_disk(asset, ds, idd, smi) -> dict:
    """`train.compile_data_step` (the route of `fit_dataset` on the card) at
    config4_full b32, augmented, 256² crops of 320² images: GRAPH_DISK_STEPS
    graphed steps (the first the eager warm-up and the capture) against as
    many eager `data_train_step`s on the same prefetched batches from the
    same state, terms every step and the final state bitwise, 1 LBS, 1
    raster forward and 1 raster backward launch a call; the draws of the
    steps differ (so a replay equal to the eager step reads its own step's
    draws); host wall per step of both routes in turns. With `idd` (an
    image directory, where PIL imports) the same for `fit_preprocessed`'s
    step, `compile_data_step(raw=False)` against `train_step`."""
    cfg = disk_cfg()
    B, cuda = cfg.batch_size, torch.device("cuda")
    ts_g, consts = scaled_state(cfg, asset, "cuda")
    ts_e, _ = scaled_state(cfg, asset, "cuda")
    fn = train.compile_data_step(cfg, consts)
    batches = disk_batches(ds, cfg)
    launches = []
    for i in range(GRAPH_DISK_STEPS):
        raw = next(batches)
        _build.reset_counts()
        tg = fn(ts_g, raw)
        torch.cuda.synchronize()
        launches.append(_build.counts())
        same_state(train.data_train_step(ts_e, raw, consts, cfg), tg, True, f"disk step {i} terms", "graphed disk step")
        check(launches[-1] == PER_STEP_DISK, f"graphed disk call {i} launched {launches[-1]}, not {PER_STEP_DISK}")
    same_state(run_state(ts_e), run_state(ts_g), True, "disk", "graphed disk run's state")
    check(fn.captures == 1, f"compile_data_step: {fn.captures} captures in {GRAPH_DISK_STEPS} calls")
    draws = [train.augment_draws(ts_g.seed, i, B, cfg, cuda) for i in range(GRAPH_DISK_STEPS)]
    check(all(not torch.equal(a["scale"], b["scale"]) for a, b in zip(draws, draws[1:])),
          "the disk steps' augmentation draws repeat from step to step")
    flips = [int(d["flip"].sum()) for d in draws]
    runs = {"eager": [], "graph": []}
    for route in ("eager", "graph", "graph", "eager"):
        for _ in range(GRAPH_DISK_TIMED // 2):
            t0 = time.perf_counter()
            raw = next(batches)
            if route == "graph":
                fn(ts_g, raw)
            else:
                train.data_train_step(ts_e, raw, consts, cfg)
            torch.cuda.synchronize()
            runs[route].append((time.perf_counter() - t0) * 1e3)
    batches.close()
    print(
        f"[graphs] compile_data_step (fit_dataset's route) config4_full B={B} augmented, {DISK_SOURCE}^2 -> 256^2: "
        f"{GRAPH_DISK_STEPS} graphed steps (1 eager warm-up + capture, {GRAPH_DISK_STEPS - 1} replays) equal "
        f"{GRAPH_DISK_STEPS} eager data_train_steps bitwise (terms each step; parameters, BN buffers, Adam moments "
        f"and counts, rates); flips a step {flips} (the draws differ every step); capture {fn.graph.seconds:.3f} s, "
        f"pool {fn.graph.pool_bytes / 2**20:.1f} MiB; launches per replay {launches[-1]}; host wall per step "
        f"(the batch's prefetch wait included) over {GRAPH_DISK_TIMED} steps each, in turns: eager "
        f"{wall_stats(runs['eager'])}, graph {wall_stats(runs['graph'])} [{smi}]"
    )
    out = {"per_replay": launches[-1], "capture_s": fn.graph.seconds, "pool_bytes": fn.graph.pool_bytes}
    out.update({f"{r}_ms": statistics.median(t) for r, t in runs.items()})
    if idd is None:
        print("[graphs] fit_preprocessed: PIL does not import here, so its graph was not driven")
        return out
    ts_g, consts = scaled_state(cfg, asset, "cuda")
    ts_e, _ = scaled_state(cfg, asset, "cuda")
    fn = train.compile_data_step(cfg, consts, raw=False)
    batches = dataset_lib.prefetch_to_device(idd.batches(), device=cuda)
    for i in range(GRAPH_PRE_STEPS):
        b = next(batches)
        _build.reset_counts()
        tg = fn(ts_g, b)
        torch.cuda.synchronize()
        got = _build.counts()
        same_state(train.train_step(ts_e, b, consts, cfg), tg, True, f"step {i} terms", "graphed preprocessed step")
        check(got == PER_STEP_DISK, f"graphed preprocessed call {i} launched {got}")
    batches.close()
    same_state(run_state(ts_e), run_state(ts_g), True, "preprocessed", "graphed preprocessed run's state")
    check(fn.captures == 1, f"compile_data_step(raw=False): {fn.captures} captures")
    print(
        f"[graphs] compile_data_step(raw=False) (fit_preprocessed's route), image directory, host-augmented: "
        f"{GRAPH_PRE_STEPS} graphed steps equal {GRAPH_PRE_STEPS} eager train_steps bitwise (terms, state); "
        f"capture {fn.graph.seconds:.3f} s, pool {fn.graph.pool_bytes / 2**20:.1f} MiB; launches per replay {got}"
    )
    return out


def pa_tail(smi) -> dict:
    """What the eager PA-MPJPE tail costs a batch, on the most recently used
    evaluation graph (a stream batch): host wall of the replay alone and of
    the replay with the tail, and the tail between CUDA events."""
    entry = next(reversed(evaluate._graphs.values()))
    item = train.step_seed(123, 0)
    alone, tail = [], []
    for _ in range(GRAPH_EVAL_TIMED):
        t0 = time.perf_counter()
        entry.gen.manual_seed(item)
        entry.graph.replay()
        torch.cuda.synchronize()
        alone.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        entry(item)
        torch.cuda.synchronize()
        tail.append((time.perf_counter() - t0) * 1e3)
    metrics_out, moments = entry.graph.outputs
    tail_ms = events_ms(lambda: evaluate._finish(metrics_out, moments), 10)
    out = {"replay_ms": statistics.median(alone), "with_tail_ms": statistics.median(tail), "tail_events_ms": tail_ms}
    print(
        f"[graphs] PA-MPJPE split (the batched 3x3 SVD reads its status on the host, so it and the alignment's "
        f"tail run eagerly after each replay): plain bf16 batch, replay alone {out['replay_ms']:.3f} ms, replay + "
        f"eager tail {out['with_tail_ms']:.3f} ms (host wall, median of {GRAPH_EVAL_TIMED}); the tail alone "
        f"{tail_ms:.4f} ms between CUDA events (each call waits for its SVD's status) [{smi}]"
    )
    return out


@contextlib.contextmanager
def counting_captures(store: list):
    """Inside the block every `utils.graphs.capture` appends its graph to
    `store`."""
    from indirect_learning_pose_shape_tpu_torch.utils import graphs as graphs_lib

    plain = graphs_lib.capture

    def capture(*args, **kwargs):
        store.append(plain(*args, **kwargs))
        return store[-1]

    graphs_lib.capture = capture
    try:
        yield
    finally:
        graphs_lib.capture = plain


def graphed_eval(model, consts, qp, asset, ds, idd, smi) -> dict:
    """The evaluators' graphs against their eager routes (`graphs=False`),
    every metric bitwise, bf16 and int8c: `evaluate` on the plain and
    hardapp suites (the first call captures, the second replays only: one
    capture a case, its launches and the eager route's exactly per batch),
    `evaluate_dataset` and, where PIL imports, `evaluate_preprocessed`;
    an EMA model made anew after a step is captured anew and equals eager;
    host ms a batch both routes; the eager PA-MPJPE tail's cost."""
    B = configs.CONFIG4_FULL.batch_size
    captures: list = []
    out = {}
    timing: dict = {}
    with counting_captures(captures):
        for suite, batches, per in (("plain", GRAPH_EVAL_BATCHES, PER_EVAL_BATCH),
                                    ("hardapp", 1, PER_EVAL_BATCH_HARD)):
            cfg, _ = evaluate.eval_config(configs.CONFIG4_FULL, suite=suite)
            for label, kw in (("bf16", {}), ("int8c", dict(qparams=qp, int8_impl="int8c"))):
                n0 = len(captures)
                got, launches = [], []
                for graphs in (True, True, False):
                    _build.reset_counts()
                    got.append(evaluate.evaluate(model, consts, cfg, batches, graphs=graphs, **kw))
                    torch.cuda.synchronize()
                    launches.append(_build.counts())
                check(got[0] == got[2] and got[1] == got[2],
                      f"evaluate {suite} {label}: graphed {got[:2]} != eager {got[2]}")
                check(len(captures) == n0 + 1, f"evaluate {suite} {label}: {len(captures) - n0} captures")
                want = {k: v * batches for k, v in per.items()}
                check(all(x == want for x in launches), f"evaluate {suite} {label}: launches {launches}, not {want}")
                g = captures[-1]
                print(
                    f"[graphs] evaluate {suite} {label}, {batches} x {B}: graphed (capture, then replays only) "
                    f"equal eager bitwise ({', '.join(f'{k} {v:.5f}' for k, v in sorted(got[2].items()))}); "
                    f"capture {g.seconds:.3f} s, pool {g.pool_bytes / 2**20:.1f} MiB; launches per replay "
                    f"{g.launches} [{smi}]"
                )
                if suite == "plain":
                    out.setdefault("per_replay", g.launches)
                    runs = {"eager": [], "graph": []}
                    for route in ("eager", "graph", "graph", "eager"):
                        t0 = time.perf_counter()
                        evaluate.evaluate(model, consts, cfg, batches, graphs=route == "graph", **kw)
                        runs[route].append((time.perf_counter() - t0) * 1e3 / batches)
                    timing[label] = {r: statistics.median(t) for r, t in runs.items()}
                    print(f"[graphs] evaluate plain {label}: host ms a batch (a call of {batches}, its one host "
                          f"read included), eager {timing[label]['eager']:.3f}, graph {timing[label]['graph']:.3f}")
                if (suite, label) == ("plain", "bf16"):
                    out["pa_tail"] = pa_tail(smi)

        cfg = disk_cfg()
        sources = [("evaluate_dataset", lambda **kw: evaluate.evaluate_dataset(model, consts, cfg, ds, **kw),
                    PER_EVAL_BATCH_DISK, GRAPH_DISK_EXAMPLES // B)]
        if idd is not None:
            sources.append(("evaluate_preprocessed",
                            lambda **kw: evaluate.evaluate_preprocessed(model, consts, cfg, idd, **kw),
                            {lbs_cuda.KERNEL: 1, raster_cuda.KERNEL: 1}, idd.steps_per_epoch()))
        for name, run, per, batches in sources:
            for label, kw in (("bf16", {}), ("int8c", dict(qparams=qp, int8_impl="int8c"))):
                n0 = len(captures)
                _build.reset_counts()
                g = run(**kw)
                torch.cuda.synchronize()
                launches = _build.counts()
                e = run(graphs=False, **kw)
                check(g == e, f"{name} {label}: graphed {g} != eager {e}")
                check(len(captures) == n0 + 1, f"{name} {label}: {len(captures) - n0} captures")
                want = {k: v * batches for k, v in per.items()}
                check(launches == want, f"{name} {label}: launches {launches}, not {want}")
                print(
                    f"[graphs] {name} {label}, {batches} x {B}: graphed equal eager bitwise "
                    f"({', '.join(f'{k} {v:.5f}' for k, v in sorted(e.items()))}); capture "
                    f"{captures[-1].seconds:.3f} s, pool {captures[-1].pool_bytes / 2**20:.1f} MiB; launches per "
                    f"replay {captures[-1].launches}"
                )
        if idd is None:
            print("[graphs] evaluate_preprocessed: PIL does not import here, so its graph was not driven")

        # An EMA model is a new copy each call: captured anew, never a stale graph.
        ecfg = dataclasses.replace(configs.CONFIG4_FULL, ema_decay=0.999)
        ts, tconsts = scaled_state(ecfg, asset, "cuda")
        n0 = len(captures)
        first = evaluate.evaluate(train.ema_model(ts), tconsts, ecfg, 1)
        train.fused_step(ts, tconsts, ecfg)
        ema = train.ema_model(ts)
        second = evaluate.evaluate(ema, tconsts, ecfg, 1)
        check(second == evaluate.evaluate(ema, tconsts, ecfg, 1, graphs=False), "EMA evaluation: graphed != eager")
        check(len(captures) == n0 + 2 and first != second,
              f"EMA evaluation after a step: {len(captures) - n0} captures, metrics changed {first != second}")
        print("[graphs] evaluate of train.ema_model after a step (a new model): captured anew, equal to eager "
              "bitwise, metrics moved from the first EMA's")
    evaluate.clear_graphs()
    out["timing"] = timing
    return out


def graphs_phase(cfg, model, consts, asset, rng, smi) -> dict:
    """The compiled paths (`train.compile_fused_step`, `fit`'s graph route,
    `train.compile_data_step`, the evaluators' graphs, `serve.Predictor`'s
    bucket graphs) against the eager ones they record."""
    t0 = time.perf_counter()
    full = graphed_steps("config4_full", configs.CONFIG4_FULL, asset, GRAPH_STEPS, smi, timed=GRAPH_TIMED)
    for name, preset in (("config4_mixed", configs.CONFIG4_MIXED), ("config4_robust", configs.CONFIG4_ROBUST)):
        graphed_steps(name, dataclasses.replace(preset, ema_decay=0.999), asset, GRAPH_RECIPE_STEPS, smi)
    graphed_train_fns(asset, smi)
    graphed_resume(asset, smi)
    from indirect_learning_pose_shape_tpu_torch.models import quantize as quant

    calib = predict.synthetic_images(consts, cfg, 16, seed=999)
    qp = quant.ptq_quantize(model.encoder, calib)
    with tempfile.TemporaryDirectory(prefix="ilps_graphs_disk_") as work:
        path = os.path.join(work, "d.npz")
        t1 = time.perf_counter()
        dataset_lib.make_synthetic_dataset(path, GRAPH_DISK_EXAMPLES, source_size=DISK_SOURCE, asset=asset)
        B = configs.CONFIG4_FULL.batch_size
        ds = dataset_lib.NpzDataset(path, B, seed=configs.CONFIG4_FULL.seed)
        idd = idd_eval = None
        try:
            import PIL  # noqa: F401
        except ImportError:
            pass
        else:
            from indirect_learning_pose_shape_tpu_torch.data import image_dir

            root = os.path.join(work, "imgs")
            with np.load(path) as z:
                image_dir.export_image_dir({k: z[k] for k in ("images", "masks", "kp2d", "kp_vis")}, root)
            size = configs.CONFIG4_FULL.model.image_size
            idd = image_dir.ImageDirDataset(root, B, size, seed=0, augment=disk_cfg().augment)
            idd_eval = image_dir.ImageDirDataset(root, B, size)
        print(f"[graphs] the phase's dataset: {GRAPH_DISK_EXAMPLES} examples at {DISK_SOURCE}^2"
              f"{' and its image directory' if idd is not None else ''} in {time.perf_counter() - t1:.2f} s")
        disk = graphed_disk(asset, ds, idd, smi)
        graphed_nccl(asset, smi, ds)
        ev = graphed_eval(model, consts, qp, asset, ds, idd_eval, smi)
    graphed_requests("bf16", lambda graphs: serve.Predictor(cfg, model, consts, graphs=graphs), cfg, rng, smi)
    graphed_requests(
        "int8c", lambda graphs: serve.Predictor(cfg, model, consts, qparams=qp, graphs=graphs), cfg, rng, smi,
    )
    print(f"[graphs] phase in {time.perf_counter() - t0:.1f} s")
    return dict(full, disk_per_replay=disk["per_replay"], eval_per_replay=ev["per_replay"])


# --- The presets that no other phase trains, on fit's graph route. ---------

PRESET_RUNS = (
    "config1_single", "config2_smpl_batch", "config3_render", "config4_r34",
    "config4_large", "config4_parts31", "config4_b128",
)
PRESET_STEPS = 3  # fit's budget; graphed steps (1 eager warm-up + capture, 2 replays) against eager ones
PRESET_TIMED = 10  # graph replays timed: host wall of each, then back to back between CUDA events
PRESET_KERNELS = ("config3_render", "config4_parts31", "config4_b128")  # raster kernels vs plain versions
PRESET_SERVE = "config4_large"  # its model served through a Predictor's bucket graphs
PRESET_BUCKETS = (1, 32)


def preset_raster(name, cfg, ts, consts, smi) -> dict:
    """Both raster kernels on a preset's own step inputs (the model of `ts`,
    whose BN buffers move, on the batch of its next step; the cotangent of
    the preset's own loss) against the culled plain versions, with exact
    zeros in the score planes of classes with no slot and in the gradient
    of every padding slot; each kernel timed and bounded on these inputs."""
    B, size = cfg.batch_size, cfg.model.image_size
    layout, rcfg = consts.part_layout, cfg.model.raster
    C, S, real = layout.num_parts, layout.seg_size, layout.real
    batch = train.make_batch(cfg.seed, ts.step, B, consts, cfg)
    out = net.forward_train(ts.model, consts, batch["image"], cfg.model, probs=False)
    targets = {k: batch[k] for k in ("silhouette", "part_labels", "kp2d", "kp_vis")}
    total, _ = losses.total_loss(out, targets, cfg.loss_weight_dict, size)
    (g,) = torch.autograd.grad(total, out["score_cp"])
    g = g.reshape(B, C, size, size).contiguous()
    vx = raster.gather_class_sorted(out["verts2d"].detach(), layout)
    vt = vx.transpose(1, 2).contiguous()
    del out, total
    with torch.no_grad():
        fk = raster_cuda.raster_fwd_cuda(vt, real, C, S, rcfg)
        fc = raster_cuda.raster_scores_culled_torch(vx, real, C, S, rcfg)
        bk = raster_cuda.raster_bwd_cuda(vt, g, real, C, S, rcfg)
        bc = raster_cuda.raster_scores_bwd_culled_torch(vx, g, real, C, S, rcfg)
    torch.cuda.synchronize()
    f_err, b_err = norm_err(fk, fc), norm_err(bk, bc)
    check(f_err <= GRAD_TOL, f"{name}: raster forward kernel vs culled plain version at B={B}: {f_err}")
    check(b_err <= GRAD_TOL, f"{name}: raster backward kernel vs culled plain version at B={B}: {b_err}")
    check(float(fk.amax()) > 0 and float(bk.abs().max()) > 0, f"{name}: a raster kernel's output is all zero")
    empty = real == 0
    check(bool((fk[:, empty] == 0).all()) and bool((fc[:, empty] == 0).all()),
          f"{name}: the score planes of the {int(empty.sum())} classes with no slot are not 0")
    pad = (torch.arange(S, device=real.device)[None, :] >= real[:, None]).reshape(C * S)
    check(bool((bk[:, :, pad] == 0).all()) and bool((bc[:, :, pad] == 0).all()),
          f"{name}: the gradient of the padding slots is not 0")
    work = raster_work(vx, layout, rcfg)
    fb = raster_bound(vx, layout, rcfg, work, backward=False)
    bb = raster_bound(vx, layout, rcfg, work, backward=True)
    with torch.no_grad():
        f_ms = device_ms(lambda: raster_cuda.raster_fwd_cuda(vt, real, C, S, rcfg), 20)
        b_ms = device_ms(lambda: raster_cuda.raster_bwd_cuda(vt, g, real, C, S, rcfg), 20)
    print(
        f"[presets] {name} raster kernels on the step's prediction, B={B}, C={C} ({int(empty.sum())} with no "
        f"slot), S={S}, cotangent of {'+'.join(k for k, w in cfg.loss_weights if w)}: normalised err forward "
        f"{f_err:.3e}, backward {b_err:.3e} against the culled plain versions; the empty classes' planes and "
        f"{int(pad.sum()) * B * 2} padding gradient entries exactly 0; forward {f_ms:.4f} ms (bound "
        f"{fb['bound_ms']:.4f} ms, {fb['bound_by']}), backward {b_ms:.4f} ms (bound {bb['bound_ms']:.4f} ms, "
        f"{bb['bound_by']}); pairs {work['pairs']} needed, {work['pairs_in_kernel_boxes']} computed [{smi}]"
    )
    return {"fwd_err": f_err, "bwd_err": b_err, "fwd_ms": f_ms, "bwd_ms": b_ms,
            "fwd_bound_ms": fb["bound_ms"], "bwd_bound_ms": bb["bound_ms"]}


def preset_serving(asset, smi) -> dict:
    """`PRESET_SERVE`'s model (seed 0, IEF output x 0.01) through a
    `Predictor` with bucket graphs at PRESET_BUCKETS: requests of 1, 3 (padded
    into 32) and 32, every output finite and of its shape, bitwise the eager
    Predictor's, one LBS launch a request; the padded rows against each
    image alone in the same bucket at TOL. Across buckets (32 against 1) the
    bf16 encoder's convolutions round differently (cuDNN picks other
    algorithms per batch), so the same model with a float32 encoder is held
    there at TOL and the bf16 gap printed beside it. Request median per
    bucket."""
    cfg = configs.PRESETS[PRESET_SERVE].model
    f32 = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, compute_dtype=torch.float32))
    model, consts = predict.load_model(cfg, asset=asset, seed=0, device="cuda")
    with torch.no_grad():
        model.ief.layers[-1].weight.mul_(0.01)
    p = serve.Predictor(cfg, model, consts, buckets=PRESET_BUCKETS)
    p_e = serve.Predictor(cfg, model, consts, buckets=PRESET_BUCKETS, graphs=False)
    t0 = time.perf_counter()
    p.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    rng = np.random.RandomState(7)
    size, J, V = cfg.image_size, consts.smpl.num_joints, consts.smpl.num_verts
    reqs = {n: rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32) for n in (1, 3, 32)}
    _build.reset_counts()
    outs = {n: {k: v.clone() for k, v in p(x).items()} for n, x in reqs.items()}
    torch.cuda.synchronize()
    launches = _build.counts()
    check(launches == {lbs_cuda.KERNEL: len(reqs)}, f"{PRESET_SERVE} Predictor: {len(reqs)} requests launched {launches}")
    for n, out in outs.items():
        shapes = {
            "theta": (n, cfg.ief.theta_dim), "rotmats": (n, J, 3, 3), "betas": (n, 10), "cam": (n, 3),
            "verts": (n, V, 3), "joints": (n, J, 3), "kp3d": (n, 19, 3), "kp2d": (n, 19, 2),
        }
        for k, shape in shapes.items():
            check(tuple(out[k].shape) == shape, f"{PRESET_SERVE} {k} shape {tuple(out[k].shape)} != {shape}")
        for k, v in out.items():
            check(v.shape[0] == n and bool(torch.isfinite(v).all()), f"{PRESET_SERVE} {k} (batch {n})")
        same_state(p_e(reqs[n]), out, True, f"request {n}", f"{PRESET_SERVE} graphed request")
    half = 0.5 * (size - 1)

    def row_err(rows: dict, fn) -> float:
        """Max error of the 3 rows of `rows` against each image run alone by
        `fn`, every output; kp2d in units of half the image."""
        err = 0.0
        for i in range(3):
            alone = fn(reqs[3][i : i + 1])
            for k, v in rows.items():
                err = max(err, max_err(v[i : i + 1], alone[k]) / (half if k == "kp2d" else 1.0))
        return err

    same_bucket = serve.Predictor(cfg, model, consts, buckets=(PRESET_BUCKETS[-1],))
    pad_err, bf16_gap = row_err(outs[3], same_bucket), row_err(outs[3], p)
    check(pad_err <= TOL, f"{PRESET_SERVE}: padded rows differ from the images alone in their bucket: {pad_err}")
    del same_bucket
    model32, _ = predict.load_model(f32, asset=asset, seed=0, device="cuda")
    with torch.no_grad():
        model32.ief.layers[-1].weight.mul_(0.01)
    same_state(model.state_dict(), model32.state_dict(), True, PRESET_SERVE, "float32-encoder model's weights")
    p32 = serve.Predictor(f32, model32, consts, buckets=PRESET_BUCKETS)
    f32_gap = row_err({k: v.clone() for k, v in p32(reqs[3]).items()}, p32)
    check(f32_gap <= TOL, f"{PRESET_SERVE} float32 encoder: bucket 32 rows differ from bucket 1's: {f32_gap}")
    del p32, model32
    ms = {n: request_ms(lambda: p(reqs[n]), 20) for n in PRESET_BUCKETS}
    print(
        f"[presets] {PRESET_SERVE} served (ResNet-{cfg.encoder.depth}, {cfg.ief.rotation_format}, bf16): "
        f"bucket graphs {PRESET_BUCKETS} captured in {warm_s:.2f} s; requests of 1, 3 and 32 bitwise the "
        f"eager Predictor's, launches {launches}; padded rows {pad_err:.3e} from the images alone in "
        f"their bucket; bucket 32 against bucket 1: {f32_gap:.3e} with a float32 encoder, {bf16_gap:.3e} in "
        f"bf16 (the convolutions' rounding); forward median "
        + ", ".join(f"{ms[n]:.3f} ms at {n}" for n in PRESET_BUCKETS) + f" [{smi}]"
    )
    return {"launches": launches, "ms": ms}


def presets_phase(asset, smi) -> dict:
    """Each preset of PRESET_RUNS at its full width and batch: `train.fit`
    for PRESET_STEPS steps on its graph route (the route line checked, the
    state bitwise the eager run's), `compile_fused_step` against eager
    `fused_step`s bitwise with the launches of each replay, the graphed
    step's host wall, device time, capture and pool, and fit's peak memory
    above what earlier phases hold;
    the raster kernels on the step's inputs for PRESET_KERNELS; then the
    PRESET_SERVE model's serving graphs. Each preset's graphs are freed
    before the next."""
    t0 = time.perf_counter()
    per_replay, rasters = {}, {}
    for name in PRESET_RUNS:
        t1 = time.perf_counter()
        cfg = dataclasses.replace(configs.PRESETS[name], num_steps=PRESET_STEPS)
        B = cfg.batch_size
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()  # by earlier phases
        with scaled_init():
            fitted, terms = routed(lambda: train.fit(cfg, asset=asset), "graph: compile_fused_step")
        peak = torch.cuda.max_memory_allocated() - held[0], torch.cuda.max_memory_reserved() - held[1]
        check(all(np.isfinite(v) for v in terms.values()), f"{name}: fit's terms {terms}")
        run = graphed_steps(name, cfg, asset, PRESET_STEPS, smi, keep=True)
        same_state(run_state(run["ts_e"]), run_state(fitted), True, name, "fit's graph-route state")
        del fitted
        fn, ts_g = run["fn"], run["ts_g"]
        walls = []
        for _ in range(PRESET_TIMED):
            t2 = time.perf_counter()
            fn(ts_g)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t2) * 1e3)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(PRESET_TIMED):
            fn(ts_g)
        e1.record()
        e1.synchronize()
        dev_ms = e0.elapsed_time(e1) / PRESET_TIMED
        med = statistics.median(walls)
        per_replay[name] = run["per_replay"]
        m = cfg.model
        print(
            f"[presets] {name} (ResNet-{m.encoder.depth}, {m.ief.rotation_format}, {m.raster.num_parts} parts, "
            f"B={B}, {m.image_size}^2, losses {'+'.join(k for k, w in cfg.loss_weights if w)}): fit on "
            f"'graph: compile_fused_step' for {PRESET_STEPS} steps, state bitwise the eager run's, total "
            f"{terms['total']:.6f}; graphed step {wall_stats(walls)} host wall ({B / med * 1e3:.1f} img/s), "
            f"{dev_ms:.3f} ms device (CUDA events over {PRESET_TIMED} back-to-back replays); capture "
            f"{run['capture_s']:.3f} s, pool {run['pool_bytes'] / 2**20:.1f} MiB; fit's peak allocated "
            f"{peak[0] / 2**30:.2f} GiB, reserved {peak[1] / 2**30:.2f} GiB (above what earlier phases "
            f"hold); launches per replay "
            f"{run['per_replay']} [{smi}]"
        )
        if name in PRESET_KERNELS:
            rasters[name] = preset_raster(name, cfg, run["ts_e"], run["consts"], smi)
        del run, fn, ts_g
        torch.cuda.empty_cache()
        print(f"[presets] {name} in {time.perf_counter() - t1:.1f} s")
    serving = preset_serving(asset, smi)
    torch.cuda.empty_cache()
    print(f"[presets] phase in {time.perf_counter() - t0:.1f} s")
    return {"per_replay": per_replay, "raster": rasters, "serve_launches": serving["launches"]}


RECIPE = "r34_indirect_5k"
RECIPE_STEPS = 200
RECIPE_EVAL_BATCHES = 2


def recipes_phase(asset, smi) -> dict:
    """`recipe_parity.run` of RECIPE cut to RECIPE_STEPS steps on the kernel
    route, scored on one protocol seed x RECIPE_EVAL_BATCHES plain batches:
    the graph route (the tool raises on another), the run's launches
    exactly its eager steps' and its evaluation batches', finite metrics,
    the logged total falling. Makes no quality claim."""
    t0 = time.perf_counter()
    _build.reset_counts()
    line = recipe_parity.run(
        recipe_parity.RECIPES[RECIPE], 0, "auto", RECIPE_STEPS, "cuda", asset=asset,
        eval_seeds=QUALITY_SEEDS[:1], batches=RECIPE_EVAL_BATCHES,
    )
    torch.cuda.synchronize()
    launches = _build.counts()
    want = {k: RECIPE_STEPS * PER_STEP.get(k, 0) + RECIPE_EVAL_BATCHES * PER_EVAL_BATCH.get(k, 0)
            for k in PER_STEP}
    check(line["route"].startswith("fit: graph: compile_fused_step"), f"recipe route {line['route']!r}")
    check(launches == want, f"recipe run launched {launches}, not {RECIPE_STEPS} steps at {PER_STEP} "
          f"and {RECIPE_EVAL_BATCHES} eval batches at {PER_EVAL_BATCH}: {want}")
    metrics_ = line["suites"]["plain"]["metrics"]
    check(all(np.isfinite(m["mean"]) for m in metrics_.values()), f"recipe metrics {metrics_}")
    check(line["last_step"] == RECIPE_STEPS - 1 and line["last_total"] < line["first_total"],
          f"recipe total {line['first_total']} at step 0, {line['last_total']} at step {line['last_step']}")
    print(
        f"[recipes] {RECIPE} for {RECIPE_STEPS} steps on {line['route']!r}: total "
        f"{line['first_total']:.6f} at step 0 -> {line['last_total']:.6f} at step {line['last_step']}; "
        f"graphed step {line['step_ms']:.3f} ms host wall; train {line['train_s']:.1f} s, run "
        f"{line['run_s']:.1f} s; launches {launches} ({RECIPE_STEPS} x {PER_STEP} + "
        f"{RECIPE_EVAL_BATCHES} x {PER_EVAL_BATCH}); plain PVE {metrics_['pve']['mean']:.5f}, sil IoU "
        f"{metrics_['sil_iou']['mean']:.5f} on seed {QUALITY_SEEDS[0]} x {RECIPE_EVAL_BATCHES} batches "
        f"(no quality claim at this horizon) [{smi}]"
    )
    print(json.dumps(line))
    print(f"[recipes] phase in {time.perf_counter() - t0:.1f} s")
    return {"launches": launches}


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
    oracle_launches = oracle_phase(consts, asset, cfg, smi)
    bwd4 = raster_bwd_phase(consts, cfg, verts2d, far, rng)
    serve_launches = serving_phase(cfg, model, consts, rng, smi)
    tr = training_phase(asset, smi)
    graphed = graphs_phase(cfg, model, consts, asset, rng, smi)
    presets = presets_phase(asset, smi)
    recipes = recipes_phase(asset, smi)
    mixed = mixed_phase(asset, smi)
    robust = robust_phase(asset, smi)
    addln = add_ln_phase(asset, smi)
    disk = disk_phase(asset, smi)
    int8 = int8_phase(cfg, model, consts, asset, smi)
    par = parallel_phase(asset, smi)

    def entry(name, source, replaces, **numbers):
        return dict(
            name=name, route="cuda",
            source=f"indirect_learning_pose_shape_tpu_torch/csrc/{source}",
            replaces=f"indirect_learning_pose_shape_tpu/ops/kernels/{replaces}",
            launches=tr["launches"].get(name, 0),
            launches_graph_replay=graphed["per_replay"].get(name, 0),
            launches_disk_graph_replay=graphed["disk_per_replay"].get(name, 0),
            launches_eval_graph_replay=graphed["eval_per_replay"].get(name, 0),
            launches_presets={p: d.get(name, 0) for p, d in presets["per_replay"].items()},
            launches_presets_serve=presets["serve_launches"].get(name, 0),
            launches_recipes=recipes["launches"].get(name, 0),
            launches_serve=serve_launches.get(name, 0),
            launches_mixed=mixed["launches"].get(name, 0),
            launches_eval=mixed["eval_launches"].get(name, 0),
            launches_robust=robust["launches"].get(name, 0),
            launches_disk=disk["launches"].get(name, 0),
            launches_dataset=disk["dataset_launches"].get(name, 0),
            launches_int8=int8["launches"].get(name, 0),
            launches_fit=int8["fit_launches"].get(name, 0),
            launches_parallel_nccl=par["nccl"].get(name, 0),
            launches_parallel_dp=par["dp"].get(name, 0),
            launches_parallel_sp=par["sp"].get(name, 0),
            launches_parallel_int8=par["int8"].get(name, 0),
            launches_oracle=oracle_launches.get(name, 0),
            **{"library_ms": None, **numbers},
        )

    fwd, bwd = tr["raster_fwd"], tr["raster_bwd"]
    fwd["max_abs_err"] = max(fwd["max_abs_err"], ras4["max_abs_err"])
    bwd["max_abs_err"] = max(bwd["max_abs_err"], bwd4["max_abs_err"])
    for rec, key in ((fwd, "fwd"), (bwd, "bwd")):  # at the presets' shapes: C=31, B=128, config3's cotangent
        rec["ms_presets"] = {n: r[f"{key}_ms"] for n, r in presets["raster"].items()}
        rec["bound_ms_presets"] = {n: r[f"{key}_bound_ms"] for n, r in presets["raster"].items()}
        rec["norm_err_presets"] = {n: r[f"{key}_err"] for n, r in presets["raster"].items()}
    kernels = [
        entry(lbs_cuda.KERNEL, "lbs.cu", "lbs_pallas.py:37", **lbs),
        entry(raster_cuda.KERNEL, "raster_fwd.cu", "raster_pallas.py:73", **fwd),
        entry(raster_cuda.KERNEL_BWD, "raster_bwd.cu", "raster_pallas.py:103", **bwd),
        # No Pallas kernel: the reference's dense hard raster is a lax.scan.
        dict(entry(raster_hard_cuda.KERNEL, "raster_hard.cu", "", **robust["hard"]),
             replaces="indirect_learning_pose_shape_tpu/ops/raster_hard.py hard_raster (lax.scan, no Pallas)"),
    ]
    # No TPU kernel: the JAX package has no ViT. At the drop-path variant,
    # the one of 63 of a training step's 64 sites; `by_variant` holds all three.
    dp = addln["by_variant"]["drop_path"]
    for name, key, eager in (("vit_add_ln_fwd", "fwd", dp["eager_fwd_ms"]),
                             ("vit_add_ln_bwd", "bwd", dp["eager_ms"] - dp["eager_fwd_ms"])):
        kernels.append(dict(
            entry(name, "vit_add_ln.cu", "", ms=dp[f"{key}_ms"], bound_ms=dp[f"{key}_bound_ms"], bound_by="bytes",
                  eager_ms=eager, by_variant={v: {k: r[k] for k in (f"{key}_ms", f"{key}_bound_ms")}
                                              for v, r in addln["by_variant"].items()}),
            replaces="none: the JAX package has no ViT (the eager chain of models/vit.py's LayerNorm sites)",
            launches_hmr2_graph_replay=addln["hmr2_replay"].get(name, 0),
            **({"launches_hmr2_graph_replay_reduce": addln["hmr2_replay"].get("vit_add_ln_bwd_reduce", 0)}
               if key == "bwd" else {}),
        ))
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
