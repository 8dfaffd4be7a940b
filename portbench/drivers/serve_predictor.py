"""Serving cells: `serve.Predictor` in a closed loop with one client.

Set-up builds the configuration's model from the benchmark's weights, a
Predictor over the traffic's buckets (each captured as a CUDA graph by
`warmup`), the crop pool in host memory, and sends two requests of every
size of the mix. A request is `Predictor.__call__` on float32 crops in
host numpy, then, with `silhouette`, `predict.render_silhouette`, then every
output (and the silhouette) copied to host memory; its latency runs from
the call to the last copy. The window sends requests one after another for
`--seconds`: `request_p50_ms` and `request_p95_ms` are over every request
it sent, `serve_img_per_s` every crop returned over the time to the last;
`BENCHMARK.json` says which of them a cell reports.

With `--trace 1`, after the window: `trace_requests` requests with the
benchmark's own spans (the forward and the silhouette, each ended by a
synchronize), then as many under `torch.profiler`. Then the Predictor is
freed and the reference answers the sampled requests: from their crops
(the whole forward), and from the program's own Θ (SMPL, the projection
and the silhouette apart from the encoder).
"""

from __future__ import annotations

import dataclasses
import gc
import statistics
import time

import numpy as np
import torch

from portbench import compare, inputs, trace, traffic as traffic_lib
from portbench.context import sub_seed
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train
from portbench.reference.precision import Precision


def model_config(config: dict):
    from indirect_learning_pose_shape_tpu_torch import configs

    model = configs.PRESETS[config["preset"]].model
    if (model.encoder.depth, model.ief.rotation_format) != (config["encoder"]["depth"], config["ief"]["rotation"]):
        raise ValueError(f"preset {config['preset']} differs from its file")
    size = config["image_size"]
    if size != model.image_size:
        model = dataclasses.replace(model, image_size=size,
                                    raster=dataclasses.replace(model.raster, image_size=size))
    return model


def reference_config(config: dict, traffic: dict) -> dict:
    return {"depth": config["encoder"]["depth"], "rotation": config["ief"]["rotation"],
            "iterations": config["ief"]["iterations"], "image_size": config["image_size"],
            "sigma": config["raster"]["sigma"], "bg_gamma": config["raster"]["bg_gamma"]}


def percentile(values: list, q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    return float(np.percentile(np.asarray(values), q))


def run(ctx) -> dict:
    from indirect_learning_pose_shape_tpu_torch import predict, serve
    from indirect_learning_pose_shape_tpu_torch.models import network as net
    from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build

    config, tr, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    ctx.phase("import")
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
        ctx.phase("cuda_init")
        _build.library()
        ctx.phase("library")
    asset = inputs.stand_in(**config["asset"])
    ctx.phase("asset")
    mcfg = model_config(config)
    model, consts = net.init(inputs.port_asset(asset), mcfg, seed=ctx.seed, device=dev)
    ctx.phase("init_model")
    weights = inputs.make_weights(config["encoder"]["depth"], config["ief"]["rotation"],
                                  sub_seed(ctx.seed, 1), dev)
    model.load_state_dict(weights, strict=True)
    weights = {k: v.cpu() for k, v in weights.items()}
    size = mcfg.image_size
    pool = inputs.crop_pool(tr["pool"], size, sub_seed(ctx.seed, 2), dev)
    p = serve.Predictor(mcfg, model, consts, buckets=tr["buckets"])
    ctx.phase("init")
    p.warmup()
    ctx.phase("capture")
    with_sil = tr["silhouette"]

    def request(crops: np.ndarray) -> dict:
        out = p(crops)
        sil = predict.render_silhouette(out, consts, mcfg)["silhouette"] if with_sil else None
        host = {k: v.cpu() for k, v in out.items()}
        if sil is not None:
            host["silhouette"] = sil.cpu()
        return host

    for n, _ in tr["mix"]:
        for _ in range(2):
            request(pool[:n])
    sync()
    ctx.phase("warm_requests")

    # The window.
    gen = traffic_lib.requests(tr["mix"], tr["pool"], tr["check_every"], ctx.seed)
    latencies, kept, crops_done = [], [], 0
    _build.reset_counts()
    setup_s = ctx.since_start()
    t0 = last = time.perf_counter()
    while last - t0 < ctx.seconds:
        r = next(gen)
        begin = time.perf_counter()
        out = request(pool[r.offset : r.offset + r.crops])
        last = time.perf_counter()
        latencies.append((last - begin) * 1e3)
        crops_done += r.crops
        if r.keep:
            kept.append((r, out))
    window_s = last - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    attempted = len(latencies)
    metrics = {"setup_s": setup_s, "request_p50_ms": percentile(latencies, 50),
               "request_p95_ms": percentile(latencies, 95), "serve_img_per_s": crops_done / window_s}
    result = {
        "metrics": metrics, "attempted": attempted, "failed": 0, "memory_peak_bytes": peak,
        "window": {"images_per_s": crops_done / window_s, "requests": attempted, "seconds": window_s},
        "info": {"requests": attempted, "crops": crops_done, "window_s": window_s,
                 "launches_per_request": {k: v / attempted for k, v in _build.counts().items()},
                 "capture_s": {b: p.bucket_graph(b).seconds for b in p.buckets if p.bucket_graph(b)},
                 "pool_bytes": {b: p.bucket_graph(b).pool_bytes for b in p.buckets if p.bucket_graph(b)},
                 "kept": len(kept), "setup": dict(ctx.setup)},
    }
    if ctx.trace:
        result["trace"] = _trace(ctx, p, request, pool, gen, consts, mcfg, with_sil, sync)

    del p, model, consts
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    rcfg = reference_config(config, tr)
    inp = ref_train.Inputs(asset, config["raster"]["num_parts"], dev)
    crops = torch.from_numpy(np.concatenate([pool[r.offset : r.offset + r.crops] for r, _ in kept])).to(dev)
    ref = ref_serve.answer({k: v.to(dev) for k, v in weights.items()}, inp, rcfg, crops, with_sil, Precision())
    prog = {k: torch.cat([out[k] for _, out in kept]) for k in ref}
    geo = ref_serve.geometry(inp, rcfg, prog["theta"].to(dev), with_sil, Precision())
    result["numbers"] = compare.serve_numbers(prog, ref, weights["ief.mean_theta"], geo)
    result["notes"] = {"kept_requests": len(kept), "kept_crops": int(crops.shape[0])}
    return result


def _trace(ctx, p, request, pool, gen, consts, mcfg, with_sil, sync) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    from indirect_learning_pose_shape_tpu_torch import predict

    k = ctx.traffic["trace_requests"]
    fwd, sil = [], []
    for _ in range(k):
        r = next(gen)
        crops = pool[r.offset : r.offset + r.crops]
        t0 = time.perf_counter()
        out = p(crops)
        sync()
        t1 = time.perf_counter()
        if with_sil:
            predict.render_silhouette(out, consts, mcfg)
            sync()
        fwd.append((t1 - t0) * 1e3)
        sil.append((time.perf_counter() - t1) * 1e3)
    cuda = ctx.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts):  # the profiler's own first-use cost, outside the stretch
        request(pool[:1])
    with profile(activities=acts) as prof:
        with record_function(trace.STRETCH):
            for _ in range(k):
                r = next(gen)
                request(pool[r.offset : r.offset + r.crops])
            sync()
    extras = {"forward_ms_p50": statistics.median(fwd),
              "silhouette_ms_p50": statistics.median(sil) if with_sil else None}
    return {"summary": trace.summarize(prof, k), "extras": extras}
