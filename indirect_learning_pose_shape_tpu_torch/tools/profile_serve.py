"""Where a serving request's time goes on the card, per bucket.

    python -m indirect_learning_pose_shape_tpu_torch.tools.profile_serve \\
        [--preset config4_full] [--buckets 1 4 8 32 128] [--int8-impl int8c] \\
        [--eager] [--out profile_serve.json]

Builds a `serve.Predictor` on the preset at full width with seed-0 weights
(the IEF output layer scaled by 0.01, as in `chip_smoke.py`, so the bodies
stay in frame and the raster kernel renders real silhouettes), with
`--int8-impl` its int8 encoder (models/quantize.py, calibrated on 16
images of the preset's synthetic stream at seed 999), warms every bucket up
(on the card the Predictor's route: each bucket captured as a CUDA graph;
`--eager`: `Predictor(graphs=False)`, the eager forward, for comparison),
and for each bucket sends requests of exactly that batch from
host numpy images, one at a time (closed loop, one client). A request is
`Predictor.__call__` + `predict.render_silhouette`, ended by a synchronize.

Per bucket it reports:

- on the graph route, `capture_s`, the host seconds of the bucket's
  capture alone (`utils/graphs.Graph.seconds`; the eager warm-up call before
  it is not in it), and `pool_bytes`, the bytes it added to the buckets'
  shared memory pool (`torch.cuda.memory_reserved` after the capture minus
  before it, the cache emptied first);
- `request_ms_median` / `request_ms_p90`, `forward_ms_median`: host wall
  over `--timed` requests (forward only = without the silhouette);
- from `torch.profiler` over `--profiled` more requests, per request:
  `device_ms` (the sum of every device kernel's and copy's time),
  `profiled_wall_ms` (host wall of the profiled requests; the profiler
  lengthens it), `device_busy_share` = device_ms / profiled_wall_ms (a lower
  bound of the busy share without the profiler), `kernels_per_request`
  (device kernel and copy launches), `by_category_ms` (see `category`), and
  the eight largest device items as [ms, name, launches].

Needs one CUDA device; writes the JSON to `--out` and prints it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

CATEGORIES = (
    ("raster kernel", ("raster_fwd_kernel",)),
    ("raster bwd kernel", ("raster_bwd_kernel",)),
    ("lbs kernel", ("lbs_forward_kernel",)),
    ("H2D copy", ("Memcpy HtoD",)),
    ("conv/gemm", ("conv", "gemm", "xmma", "cudnn", "cutlass")),
)


def category(name: str) -> str:
    """The `by_category_ms` bucket of a device item, by its name."""
    lower = name.lower()
    for cat, keys in CATEGORIES:
        if any(k.lower() in lower for k in keys):
            return cat
    return "other"


def _request(p, cfg, consts, images):
    from indirect_learning_pose_shape_tpu_torch import predict

    return predict.render_silhouette(p(images), consts, cfg)


def wall_ms(fn, reps: int) -> list[float]:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def device_summary(prof, per: int) -> dict:
    """Device items of a `torch.profiler` run over `per` units (requests or
    steps), per unit: `device_ms`, `by_category_ms`, `kernels` (device
    kernel and copy launches) and the eight largest items [ms, name, launches]."""
    totals: dict[str, list] = {}  # name -> [device us, launches]
    for e in prof.events():
        # Device items only; a range annotated on the host (for example
        # `Optimizer.step#Adam.step`) is mirrored on the device timeline as a
        # user annotation that spans other kernels, and is not counted.
        if e.device_type != torch.autograd.DeviceType.CUDA or e.is_user_annotation:
            continue
        if e.self_device_time_total <= 0:
            continue
        t = totals.setdefault(e.name, [0.0, 0])
        t[0] += e.self_device_time_total
        t[1] += 1
    items = [(us / 1e3 / per, name, n / per) for name, (us, n) in totals.items()]
    by_cat: dict[str, float] = {}
    for ms, name, _ in items:
        by_cat[category(name)] = by_cat.get(category(name), 0.0) + ms
    items.sort(reverse=True)
    return {
        "device_ms": sum(ms for ms, _, _ in items),
        "by_category_ms": by_cat,
        "kernels": sum(n for _, _, n in items),
        "top": [[ms, name[:80], n] for ms, name, n in items[:8]],
    }


def profile_bucket(p, cfg, consts, images, timed: int, profiled: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    def req():
        return _request(p, cfg, consts, images)

    req()
    torch.cuda.synchronize()
    full = wall_ms(req, timed)
    fwd = wall_ms(lambda: p(images), timed)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(profiled):
            req()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / profiled

    dev = device_summary(prof, profiled)
    return {
        "request_ms_median": statistics.median(full),
        "request_ms_p90": float(np.percentile(full, 90)),
        "forward_ms_median": statistics.median(fwd),
        "profiled_wall_ms": wall,
        "device_ms": dev["device_ms"],
        "device_busy_share": dev["device_ms"] / wall,
        "by_category_ms": dev["by_category_ms"],
        "kernels_per_request": dev["kernels"],
        "top": dev["top"],
    }


def smi_line() -> str:
    """The card's name and power limit, as `nvidia-smi` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="config4_full")
    ap.add_argument("--buckets", type=int, nargs="+", default=[1, 4, 8, 32, 128])
    ap.add_argument("--timed", type=int, default=30)
    ap.add_argument("--profiled", type=int, default=10)
    ap.add_argument("--int8-impl", default=None, choices=["int8", "int8c", "sim", "simc"],
                    help="serve the int8 encoder under this impl (default: the bf16 encoder)")
    ap.add_argument("--eager", action="store_true",
                    help="serve the eager forward instead of the buckets' CUDA graphs")
    ap.add_argument("--out", default="profile_serve.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device found", file=sys.stderr)
        return 1

    from indirect_learning_pose_shape_tpu_torch import configs, predict, serve
    from indirect_learning_pose_shape_tpu_torch.utils import assets

    smi = smi_line()
    tcfg = configs.PRESETS[args.preset]
    cfg = tcfg.model
    model, consts = predict.load_model(cfg, asset=assets.load_asset(), seed=0, device="cuda")
    with torch.no_grad():
        model.ief.layers[-1].weight.mul_(0.01)
    qparams = None
    if args.int8_impl:
        from indirect_learning_pose_shape_tpu_torch import evaluate

        qparams = evaluate.int8_qparams(model, consts, tcfg)
    p = serve.Predictor(
        cfg, model, consts, qparams=qparams, int8_impl=args.int8_impl or "int8c", graphs=not args.eager
    )
    p.warmup(args.buckets)
    rng = np.random.RandomState(0)
    size = cfg.image_size
    result = {
        "device": smi, "preset": args.preset, "int8_impl": args.int8_impl,
        "route": "graph" if p.graphs else "eager", "buckets": {},
    }
    for b in args.buckets:
        images = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
        row = result["buckets"][str(b)] = profile_bucket(
            p, cfg, consts, images, args.timed, args.profiled
        )
        graph = p.bucket_graph(p.bucket_for(b))
        if graph is not None:
            row.update(capture_s=graph.seconds, pool_bytes=graph.pool_bytes)
    text = json.dumps(result, indent=1)
    with open(args.out, "w") as f:
        f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
