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

The last three lines of standard output are the kernel record
({"kernels": [...]}, with each kernel's launches on the config4_full
training main path, on the config4_mixed steps and in its evaluation, its
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
import json
import statistics
import sys
import time

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch import configs, evaluate, losses, predict, serve, train
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import smpl
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build, lbs_cuda, raster_cuda
from indirect_learning_pose_shape_tpu_torch.tools.profile_serve import smi_line
from indirect_learning_pose_shape_tpu_torch.tools.timing import ColdTimer, device_ms
from indirect_learning_pose_shape_tpu_torch.utils import assets
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


def events_ms(fn, iters: int, reps: int = 3) -> float:
    """Device ms per call of `fn` between CUDA events, median over `reps`
    runs of `iters` calls, for work that cannot be captured in a graph (an
    autograd backward). The calls are queued back to back, so the host's
    launches hide behind device work of a millisecond or more."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


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

    def entry(name, source, replaces, **numbers):
        return dict(
            name=name, route="cuda",
            source=f"indirect_learning_pose_shape_tpu_torch/csrc/{source}",
            replaces=f"indirect_learning_pose_shape_tpu/ops/kernels/{replaces}",
            launches=tr["launches"].get(name, 0),
            launches_serve=serve_launches.get(name, 0),
            launches_mixed=mixed["launches"].get(name, 0),
            launches_eval=mixed["eval_launches"].get(name, 0),
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
