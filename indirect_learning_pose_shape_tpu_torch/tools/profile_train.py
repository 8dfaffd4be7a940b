"""Where a training step's time goes on the card.

    python -m indirect_learning_pose_shape_tpu_torch.tools.profile_train \\
        [--preset config4_full] [--batch-size 32] [--out profile_train.json]

Builds the training state of the preset (any of `configs.PRESETS`, e.g.
config4_mixed: ResNet-34, rot6d, clipping, the 3D targets) at full width
with seed-0 weights
(the IEF output layer scaled by 0.01, as in `chip_smoke.py`, so the
predicted bodies stay in frame and the raster kernels see real work), runs
`--warmup` fused steps (`train.fused_step`: batch generation + update), then:

- `step_ms_median` / `step_ms_p90` and `images_per_s` (batch / median):
  host wall of `--timed` steps, each ended by a synchronize;
- from `torch.profiler` over `--profiled` more steps, per step: `device_ms`
  (the sum of every device kernel's and copy's time), `profiled_wall_ms`
  (host wall of the profiled steps; the profiler lengthens it),
  `device_busy_share` = device_ms / profiled_wall_ms (a lower bound of the
  busy share without the profiler), `kernels_per_step`, `by_category_ms`
  (`profile_serve.category`: the three kernels, "conv/gemm" for cuDNN
  convolutions and cuBLAS GEMMs, "other" for the rest) and the eight
  largest device items as [ms, name, launches];
- `kernel_launches_per_step` from the port's launch counters, and
  `peak_memory_gb` (`torch.cuda.max_memory_allocated`).

Needs one CUDA device; writes the JSON to `--out` and prints it.
"""

from __future__ import annotations

import argparse
import dataclasses
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="config4_full")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--timed", type=int, default=20)
    ap.add_argument("--profiled", type=int, default=5)
    ap.add_argument("--out", default="profile_train.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device found", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from indirect_learning_pose_shape_tpu_torch import configs, train
    from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build

    cfg = configs.PRESETS[args.preset]
    if args.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
    ts, consts = train.init_state(cfg, device="cuda")
    with torch.no_grad():
        ts.model.ief.layers[-1].weight.mul_(0.01)

    def step():
        return train.fused_step(ts, consts, cfg)

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
        "step_ms_median": median,
        "step_ms_p90": float(np.percentile(times, 90)),
        "images_per_s": cfg.batch_size / median * 1e3,
        "profiled_wall_ms": wall,
        "device_ms": dev["device_ms"],
        "device_busy_share": dev["device_ms"] / wall,
        "kernels_per_step": dev["kernels"],
        "by_category_ms": dev["by_category_ms"],
        "top": dev["top"],
        "kernel_launches_per_step": launches,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    text = json.dumps(result, indent=1)
    with open(args.out, "w") as f:
        f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
