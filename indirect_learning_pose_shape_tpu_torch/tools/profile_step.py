"""Trace a few training steps with torch.profiler and print the top device ops.

    python -m indirect_learning_pose_shape_tpu_torch.tools.profile_step \\
        [--preset config4_full] [--batch-size 32] [--steps 5] [--out ilps_trace]

Builds the preset's training state on the card, runs 3 warm-up fused steps
(`train.fused_step`: batch generation + update), then traces `--steps` more
and writes the Chrome trace to `--out`/trace.json (viewable in Perfetto or
chrome://tracing). Prints, per step, the device time by category
(`profile_serve.category`: the three kernels, conv/gemm, H2D, other) and
the `--top` largest device items as ms, launches and name.
`tools/profile_train.py` adds host wall, busy share and memory to the same
categories. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import torch

from indirect_learning_pose_shape_tpu_torch.tools.profile_serve import device_summary, smi_line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="config4_full")
    ap.add_argument("--batch-size", type=int, default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=8, help="largest device items to print (at most 8)")
    ap.add_argument("--out", default="ilps_trace", help="directory for trace.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA device found", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from indirect_learning_pose_shape_tpu_torch import configs, train

    cfg = configs.PRESETS[args.preset]
    if args.batch_size:
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
    ts, consts = train.init_state(cfg, device="cuda")
    for _ in range(3):
        train.fused_step(ts, consts, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            train.fused_step(ts, consts, cfg)
        torch.cuda.synchronize()
    os.makedirs(args.out, exist_ok=True)
    trace = os.path.join(args.out, "trace.json")
    prof.export_chrome_trace(trace)

    dev = device_summary(prof, args.steps)
    print(f"{args.preset} b{cfg.batch_size}, {args.steps} steps [{smi_line()}]; trace: {trace}")
    print(f"device ms/step {dev['device_ms']:.3f}, device items/step {dev['kernels']:.1f}")
    for cat, ms in sorted(dev["by_category_ms"].items(), key=lambda kv: -kv[1]):
        print(f"  {cat:<18} {ms:9.3f} ms")
    print("top device items (ms/step, launches/step, name):")
    for ms, name, n in dev["top"][: args.top]:
        print(f"  {ms:9.3f} {n:7.1f}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
