"""Where a training step's time goes on the card.

    python -m indirect_learning_pose_shape_tpu_torch.tools.profile_train \\
        [--preset config4_full] [--batch-size 32] [--dataset D.npz [--augment]] \\
        [--eager] [--out profile_train.json]

Builds the training state of the preset (any of `configs.PRESETS`, e.g.
config4_mixed: ResNet-34, rot6d, clipping, the 3D targets; config4_robust:
the same on hard targets with appearance randomisation) at full width
with seed-0 weights
(the IEF output layer scaled by 0.01, as in `chip_smoke.py`, so the
predicted bodies stay in frame and the raster kernels see real work), runs
`--warmup` fused steps (batch generation + update) on the route `train.fit`
takes on the card, `train.compile_fused_step`: one CUDA graph of the step,
captured at the first call after an eager warm-up step and replayed once a
step (`--eager`: the eager `train.fused_step`, for comparison), then:

- `route` ("graph" or "eager"); on the graph route `capture_s`, the host
  seconds of the capture alone (`utils/graphs.Graph.seconds`: the eager
  warm-up step before it is not in it), and `pool_bytes`, the bytes the
  capture reserved for the graph's memory pool (`torch.cuda.memory_reserved`
  after the capture minus before it, the cache emptied first);
- `step_ms_median` / `step_ms_p90` and `images_per_s` (batch / median):
  host wall of `--timed` steps, each ended by a synchronize;
- from `torch.profiler` over `--profiled` more steps, per step: `device_ms`
  (the sum of every device kernel's and copy's time), `profiled_wall_ms`
  (host wall of the profiled steps; the profiler lengthens it),
  `device_busy_share` = device_ms / profiled_wall_ms (a lower bound of the
  busy share without the profiler), `kernels_per_step`, `by_category_ms`
  (`profile_serve.category`: the three kernels, "conv/gemm" for cuDNN
  convolutions and cuBLAS GEMMs, "other" for the rest), the eight
  largest device items as [ms, name, launches], and `idle_by_span`: the
  device's idle ms over the profiled steps by the innermost of the port's
  spans over it (`utils/tracing.idle_by_span`);
- `kernel_launches_per_step` from the port's launch counters, and
  `peak_memory_gb` (`torch.cuda.max_memory_allocated`);
- with hard targets, `hard_raster_ms`: the device time of one call of the
  hard raster as the batch makes it (its mode, shade and light) on one
  batch's bodies, between CUDA events (`tools/timing.events_ms`); it is part
  of "other" in `by_category_ms`.

With `--dataset` (an .npz file or a directory of shards) the step is the
disk step instead, on batches that `prefetch_to_device` stages from the
dataset, as `train.fit_dataset` does, on its route on the card:
`train.compile_data_step`, one CUDA graph of the step (the batch copied into
its static inputs) captured after an eager warm-up step and replayed once a
step (`--eager`: the eager `train.data_train_step`); `--augment` turns on
the preset's mirror and crop jitter. The result
adds `h2d_ms_per_batch` (the side stream's copies, between CUDA events),
`prefetch_wait_ms` (the host's median wait for a batch) and
`preprocess_ms` (`train.preprocess_raw_batch` on one batch, between CUDA
events).

Needs one CUDA device; writes the JSON to `--out` and prints it.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import statistics
import sys
import time

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.tools.profile_serve import (
    device_summary,
    smi_line,
    wall_ms,
)
from indirect_learning_pose_shape_tpu_torch.tools.timing import events_ms


def hard_raster_ms(cfg, consts, iters: int = 3) -> float:
    """Device ms of one hard-raster call as `synthetic.render_batch` makes it,
    on the bodies of the stream's batch 0."""
    from indirect_learning_pose_shape_tpu_torch import train
    from indirect_learning_pose_shape_tpu_torch.data import synthetic
    from indirect_learning_pose_shape_tpu_torch.models import smpl
    from indirect_learning_pose_shape_tpu_torch.ops import camera, raster_hard

    size, scfg = cfg.model.image_size, cfg.synthetic
    gen = torch.Generator(device="cuda").manual_seed(train.step_seed(cfg.seed, 0))
    draws = synthetic.sample_draws(gen, cfg.batch_size, consts, scfg, size)
    verts = smpl.smpl_forward(consts.smpl, draws["pose"], draws["betas"])["verts"]
    verts2d = camera.project_pixel(verts, draws["cam"], size)
    light = draws["light"] if scfg.shading else (0.35, -0.5, 0.79)
    return events_ms(lambda: raster_hard.hard_raster(
        verts2d, verts[..., 2], consts.hard, size, k_faces=scfg.hard_k_faces or None,
        with_shade=scfg.shading > 0, light=light), iters)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="config4_full")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--timed", type=int, default=20)
    ap.add_argument("--profiled", type=int, default=5)
    ap.add_argument("--dataset", default=None, help="time the disk step on this dataset (.npz or shards)")
    ap.add_argument("--augment", action="store_true", help="with --dataset: mirror and crop jitter")
    ap.add_argument("--eager", action="store_true",
                    help="time the eager step (fused_step, or data_train_step with --dataset) "
                    "instead of the fit loops' CUDA graph route")
    ap.add_argument("--out", default="profile_train.json")
    args = ap.parse_args(argv)
    if args.augment and not args.dataset:
        ap.error("--augment applies to --dataset")
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device found", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from indirect_learning_pose_shape_tpu_torch import configs, train
    from indirect_learning_pose_shape_tpu_torch.data import dataset as dataset_lib
    from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build
    from indirect_learning_pose_shape_tpu_torch.utils import tracing

    cfg = configs.PRESETS[args.preset]
    if args.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
    if args.augment:
        cfg = dataclasses.replace(cfg, augment=dataclasses.replace(cfg.augment, enabled=True))
    ts, consts = train.init_state(cfg, device="cuda")
    with torch.no_grad():
        ts.model.ief.layers[-1].weight.mul_(0.01)

    if args.dataset:
        ds = dataset_lib.open_dataset(args.dataset, cfg.batch_size, seed=cfg.seed)
        pulls = train.dataset_pulls(cfg, ds.keys)
        stats = dataset_lib.PrefetchStats()
        batches = dataset_lib.prefetch_to_device(
            ({k: b[src] for k, src in pulls.items() if src in b} for b in ds.batches()),
            device="cuda", stats=stats,
        )

        compiled = None if args.eager else train.compile_data_step(cfg, consts)

        def step():
            raw = next(batches)
            return train.data_train_step(ts, raw, consts, cfg) if compiled is None else compiled(ts, raw)
    elif args.eager:
        compiled = None

        def step():
            return train.fused_step(ts, consts, cfg)
    else:
        compiled = train.compile_fused_step(cfg, consts)
        step = functools.partial(compiled, ts)

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    times = wall_ms(step, args.timed)
    launches = {k: v / args.timed for k, v in _build.counts().items()}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.profiled):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.profiled
    dev = device_summary(prof, args.profiled)

    median = statistics.median(times)
    result = {
        "device": smi_line(),
        "preset": args.preset,
        "batch_size": cfg.batch_size,
        "route": "eager" if compiled is None else "graph",
        "step_ms_median": median,
        "step_ms_p90": float(np.percentile(times, 90)),
        "images_per_s": cfg.batch_size / median * 1e3,
        "profiled_wall_ms": wall,
        "device_ms": dev["device_ms"],
        "device_busy_share": dev["device_ms"] / wall,
        "kernels_per_step": dev["kernels"],
        "by_category_ms": dev["by_category_ms"],
        "top": dev["top"],
        "idle_by_span": tracing.idle_by_span(prof),
        "kernel_launches_per_step": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if compiled is not None:
        result.update(capture_s=compiled.graph.seconds, pool_bytes=compiled.graph.pool_bytes)
    if args.dataset:
        torch.cuda.synchronize()
        result["dataset"] = args.dataset
        result["augment"] = args.augment
        result["h2d_ms_per_batch"] = statistics.median(a.elapsed_time(b) for a, b in stats.h2d_events)
        result["prefetch_wait_ms"] = statistics.median(stats.wait_s) * 1e3
        raw = next(batches)
        draws = train.augment_draws(cfg.seed, 0, cfg.batch_size, cfg, raw["images"].device) if args.augment else None
        result["preprocess_ms"] = events_ms(lambda: train.preprocess_raw_batch(raw, cfg, draws), 10)
        batches.close()
    elif cfg.synthetic.targets == "hard":
        result["hard_raster_ms"] = hard_raster_ms(cfg, consts)
    text = json.dumps(result, indent=1)
    with open(args.out, "w") as f:
        f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
