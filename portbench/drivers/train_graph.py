"""Training cells: the port's synthetic-stream step on `train.fit`'s route.

Set-up builds one training state of the configuration's preset, with the
traffic's stream and batch, loads the benchmark's weights into it, and
drives it with `train.compile_fused_step`'s callable the way `train._run`
calls it: one call (one CUDA graph replay) a step, the terms logged every
`log_every` steps through a `MetricsWriter` that writes no file, nothing
checkpointed. Its first call is the eager warm-up step and the capture;
its first `check_steps` steps are the output check's (the terms of each,
the first step's BatchNorm batch statistics, from the running ones, and
Adam's first moment after it, the parameters after the last), then
`warm_steps` more. The window runs the same loop for `--seconds`:
`train_img_per_s` is every image trained in it over its length, closed by
a synchronize.

After the window, the state is copied to the host (parameters, BatchNorm
running statistics, Adam's moments) and one more step is run: a replay of
the window's graph, whose terms, BatchNorm batch statistics, gradient (from
Adam's first moment before and after it) and parameters after it are the
check's replay numbers. With `--trace 1`, then: `trace_steps` more steps
under `torch.profiler`, the raster kernels' work on those steps' bodies,
and, with hard targets, one hard-raster call timed between CUDA events.
Then the state is freed; the reference trains the first `check_steps`
steps from the same weights, and the replayed step from the copied state,
on the batch of the step the benchmark counted it as.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch

from portbench import compare, inputs, trace
from portbench.context import sub_seed
from portbench.reference import model as ref_model
from portbench.reference import stream as ref_stream
from portbench.reference import train as ref_train
from portbench.reference.precision import Precision, full_float32
from portbench.work import raster as raster_work


def reference_config(config: dict, traffic: dict) -> dict:
    """The run's settings as the reference reads them: the configuration's
    file and the traffic's stream and batch."""
    return {
        "depth": config["encoder"]["depth"], "rotation": config["ief"]["rotation"],
        "iterations": config["ief"]["iterations"], "image_size": config["image_size"],
        "num_parts": config["raster"]["num_parts"], "sigma": config["raster"]["sigma"],
        "bg_gamma": config["raster"]["bg_gamma"], "batch_size": traffic["batch_size"],
        "stream": ref_stream.Stream(**traffic["synthetic"]),
        "loss_weights": config["loss_weights"], "learning_rate": config["learning_rate"],
        "lr_schedule": config["lr_schedule"], "warmup_steps": config["warmup_steps"],
        "num_steps": config["num_steps"], "grad_clip_norm": config["grad_clip_norm"],
    }


def program_config(config: dict, traffic: dict, seed: int):
    """The port's TrainConfig: the preset, refused where it differs from
    the configuration's file, with the traffic's stream and batch."""
    from indirect_learning_pose_shape_tpu_torch import configs

    preset = configs.PRESETS[config["preset"]]
    model = preset.model
    stated = {
        "depth": (model.encoder.depth, config["encoder"]["depth"]),
        "rotation": (model.ief.rotation_format, config["ief"]["rotation"]),
        "iterations": (model.ief.num_iterations, config["ief"]["iterations"]),
        "num_parts": (model.raster.num_parts, config["raster"]["num_parts"]),
        "sigma": (model.raster.sigma, config["raster"]["sigma"]),
        "bg_gamma": (model.raster.bg_gamma, config["raster"]["bg_gamma"]),
        "learning_rate": (preset.learning_rate, config["learning_rate"]),
        "lr_schedule": (preset.lr_schedule, config["lr_schedule"]),
        "warmup_steps": (preset.warmup_steps, config["warmup_steps"]),
        "num_steps": (preset.num_steps, config["num_steps"]),
        "grad_clip_norm": (preset.grad_clip_norm, config["grad_clip_norm"]),
        "loss_weights": ({k: v for k, v in preset.loss_weights if v}, {k: v for k, v in config["loss_weights"].items() if v}),
        "encoder_dtype": (str(model.encoder.compute_dtype), "torch." + config["precision"]["encoder"]),
        "bn_momentum": (model.encoder.bn_momentum, config["encoder"]["bn_momentum"]),
        "bn_eps": (model.encoder.bn_eps, config["encoder"]["bn_eps"]),
    }
    wrong = {k: v for k, v in stated.items() if v[0] != v[1]}
    if wrong:
        raise ValueError(f"preset {config['preset']} differs from its file: {wrong}")
    size = config["image_size"]
    if size != model.image_size:
        model = dataclasses.replace(model, image_size=size,
                                    raster=dataclasses.replace(model.raster, image_size=size))
    return dataclasses.replace(
        preset, model=model, synthetic=dataclasses.replace(preset.synthetic, **traffic["synthetic"]),
        batch_size=traffic["batch_size"], log_every=traffic["log_every"], checkpoint_every=0,
        metrics_path=None, tensorboard_dir=None, seed=seed, steps_per_call=1,
    )


def _host(d: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in d.items()}


def _state(ts, names: dict) -> dict:
    """The state a step reads, on the host: parameters, buffers and Adam's
    two moments, by leaf name."""
    opt = ts.optimizer.state
    return {"params": _host(dict(ts.model.named_parameters())), "buffers": _host(dict(ts.model.named_buffers())),
            "exp_avg": _host({names[p]: st["exp_avg"] for p, st in opt.items()}),
            "exp_avg_sq": _host({names[p]: st["exp_avg_sq"] for p, st in opt.items()})}


def _batch_stats(after: dict, before: dict, momentum: float) -> dict:
    """Each BatchNorm's first batch (mean, variance), worked out from its
    running statistics before and after the first step:
    new = momentum · old + (1 − momentum) · batch."""
    out = {}
    for k in after:
        if k.endswith(".mean"):
            name = k[: -len(".mean")]
            out[name] = tuple(
                (after[f"{name}.{s}"].double() - momentum * before[f"{name}.{s}"].double()) / (1 - momentum)
                for s in ("mean", "var"))
    return out


def run(ctx) -> dict:
    from indirect_learning_pose_shape_tpu_torch import train
    from indirect_learning_pose_shape_tpu_torch.ops import raster_hard
    from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build
    from indirect_learning_pose_shape_tpu_torch.utils import metrics as metrics_lib

    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    ctx.phase("import")
    if cuda:
        torch.cuda.init()
        torch.zeros(1, device=dev)
        ctx.phase("cuda_init")
        _build.library()
        ctx.phase("library")
    asset = inputs.stand_in(**config["asset"])
    ctx.phase("asset")
    cfg = program_config(config, traffic, ctx.seed)
    ts, consts = train.init_state(cfg, asset=inputs.port_asset(asset), device=dev)
    ctx.phase("init_state")
    weights = inputs.make_weights(config["encoder"]["depth"], config["ief"]["rotation"],
                                  sub_seed(ctx.seed, 1), dev)
    ts.model.load_state_dict(weights, strict=True)
    start = _host({k: v for k, v in weights.items() if not k.endswith((".mean", ".var"))})
    weights = _host(weights)
    names = {p: k for k, p in ts.model.named_parameters()}
    step_fn = train.compile_fused_step(cfg, consts)
    writer = metrics_lib.MetricsWriter(print_every=0)
    le = max(1, cfg.log_every)
    logged = []
    ctx.phase("init")

    done = 0  # steps run, as the benchmark counts them

    def step():
        nonlocal done
        first = ts.step
        terms = step_fn(ts, 1)
        done += 1
        if any(s % le == 0 for s in range(first, ts.step)):
            logged.append(writer.write(ts.step - 1, terms)["total"])
        return terms

    terms = [step()]
    beta1 = ref_train.ADAM[0]
    first_grad = {names[p]: st["exp_avg"] / (1 - beta1) for p, st in ts.optimizer.state.items()}
    first_grad = _host(first_grad)
    bn1 = _batch_stats(_host(dict(ts.model.named_buffers())), weights, config["encoder"]["bn_momentum"])
    ctx.phase("first_step")
    for _ in range(traffic["check_steps"] - 1):
        terms.append(step())
    terms = [{k: float(v) for k, v in t.items()} for t in terms]
    prog = {"loss": [t["total"] for t in terms], "terms": terms, "first_grad": first_grad, "bn1": bn1,
            "params": _host(dict(ts.model.named_parameters()))}
    for _ in range(traffic["warm_steps"]):
        step()
    if cuda:
        torch.cuda.synchronize()
    ctx.phase("warm_steps")

    # The window.
    _build.reset_counts()
    setup_s = ctx.since_start()
    t0 = time.perf_counter()
    steps = 0
    while time.perf_counter() - t0 < ctx.seconds:
        step()
        steps += 1
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = {k: v / steps for k, v in _build.counts().items()}
    B = cfg.batch_size
    result = {
        "metrics": {"train_img_per_s": steps * B / window_s, "setup_s": setup_s},
        "attempted": steps, "failed": sum(1 for x in logged if not math.isfinite(x)),
        "memory_peak_bytes": peak,
        "info": {"steps": steps, "window_s": window_s, "launches_per_step": launches,
                 "capture_s": getattr(getattr(step_fn, "graph", None), "seconds", None),
                 "pool_bytes": getattr(getattr(step_fn, "graph", None), "pool_bytes", None),
                 "captures": getattr(step_fn, "captures", None), "setup": dict(ctx.setup)},
        "window": {"images_per_s": steps * B / window_s, "steps": steps, "seconds": window_s},
    }

    # One replay from a state copied to the host, for the check.
    k = done
    before = _state(ts, names)
    replay_terms = {n: float(v) for n, v in step().items()}
    after = _state(ts, names)
    momentum = config["encoder"]["bn_momentum"]
    replay = {"loss": [replay_terms["total"]], "terms": [replay_terms],
              "first_grad": {n: (m - beta1 * before["exp_avg"][n]) / (1 - beta1) for n, m in after["exp_avg"].items()},
              "bn1": _batch_stats(after["buffers"], before["buffers"], momentum), "params": after["params"]}
    result["info"].update(replay_step=k, program_step=ts.step - 1)
    result["replay_state"] = {"step": k, **before}
    del after

    rcfg = reference_config(config, traffic)
    inp = ref_train.Inputs(asset, rcfg["num_parts"], dev)
    if ctx.trace:
        result["trace"] = _trace(ctx, step, ts, inp, rcfg, consts, raster_hard)

    del step_fn, ts, consts, names
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    on_dev = {k: v.to(dev) for k, v in weights.items()}
    ref = ref_train.run_steps(on_dev, inp, rcfg, ctx.seed, traffic["check_steps"], Precision())
    ref = {"loss": [t["total"] for t in ref["terms"]], "terms": ref["terms"], "first_grad": _host(ref["first_grad"]),
           "bn1": {k: tuple(v.cpu() for v in mv) for k, mv in ref["bn1"].items()},
           "params": _host(ref["params"])}
    numbers, notes = compare.train_numbers(prog, ref, start)
    ref = replay_reference(before, inp, rcfg, ctx.seed, k, Precision(), dev)
    more, more_notes = compare.train_numbers(replay, ref, before["params"])
    numbers.update(compare.replay_names(more))
    notes["replay"] = more_notes
    result["numbers"], result["notes"] = numbers, notes
    return result


def replay_reference(state: dict, inp, rcfg: dict, seed: int, k: int, prec: Precision, dev,
                     rows: int | None = None) -> dict:
    """The reference's step `k` from a state copied by `_state`, as
    `compare.train_numbers` reads it."""
    weights = {n: v.to(dev) for n, v in {**state["params"], **state["buffers"]}.items()}
    r = ref_train.run_steps(weights, inp, rcfg, seed, 1, prec, rows, first=k,
                            adam=(state["exp_avg"], state["exp_avg_sq"]))
    return {"loss": [t["total"] for t in r["terms"]], "terms": r["terms"], "first_grad": _host(r["first_grad"]),
            "bn1": {n: tuple(v.cpu() for v in mv) for n, mv in r["bn1"].items()}, "params": _host(r["params"])}


def _trace(ctx, step, ts, inp, rcfg, consts, raster_hard) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = ctx.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts):  # the profiler's own first-use cost, outside the stretch
        step()
    k = ctx.traffic["trace_steps"]
    first = ts.step
    with profile(activities=acts) as prof:
        with record_function(trace.STRETCH):
            for _ in range(k):
                step()
            if cuda:
                torch.cuda.synchronize()
    summary = trace.summarize(prof, k)

    # The raster kernels' work on the stretch's bodies: the targets' from the
    # stream, the prediction's from the state's weights after the stretch.
    weights = {n: t.detach() for n, t in {**dict(ts.model.named_parameters()),
                                           **dict(ts.model.named_buffers())}.items()}
    labels = torch.as_tensor(inp.body.labels, device=ctx.device)
    size, C, sigma = rcfg["image_size"], rcfg["num_parts"], rcfg["sigma"]
    bound = {"raster_fwd_kernel": 0.0, "raster_bwd_kernel": 0.0}
    fmas = 0.0
    hard_ms = None
    prec = Precision()
    for s in range(first, first + k):
        batch = ref_train.make_batch(inp, rcfg, ctx.seed, s, prec)
        with torch.no_grad(), full_float32():
            pred = ref_model.forward(weights, inp.body, batch["image"], rcfg, True, prec)["verts2d"]
        if rcfg["stream"].targets == "soft":
            w = raster_work.raster_work(batch["verts2d"], labels, C, size, sigma)
            bound["raster_fwd_kernel"] += raster_work.bound_ms(w, False)
            fmas += w["pairs"]
        w = raster_work.raster_work(pred, labels, C, size, sigma)
        bound["raster_fwd_kernel"] += raster_work.bound_ms(w, False)
        bound["raster_bwd_kernel"] += raster_work.bound_ms(w, True)
        fmas += 3 * w["pairs"]
        if s == first and rcfg["stream"].targets == "hard" and cuda:
            hard_ms = _hard_raster_ms(inp, rcfg, ctx.seed, s, consts, raster_hard)
    extras = {"bound_ms": bound, "raster_fmas_per_image": fmas / (k * rcfg["batch_size"]),
              "hard_raster_ms": hard_ms}
    return {"summary": summary, "extras": extras}


def _hard_raster_ms(inp, rcfg, seed, step, consts, raster_hard, iters: int = 3) -> float:
    """Device ms of one call of the port's hard raster as the stream makes
    it (dense, shaded, the batch's lights) on step `step`'s bodies, between
    CUDA events (a frozen copy of `tools/profile_train.hard_raster_ms`)."""
    from portbench.reference import body as body_lib

    b = inp.body
    gen = torch.Generator(device=b.v_template.device).manual_seed(ref_stream.step_seed(seed, step))
    d = ref_stream.draws(gen, rcfg["batch_size"], b.num_joints, b.shapedirs.shape[1],
                         b.coco_regressor.shape[0], rcfg["num_parts"], rcfg["stream"], rcfg["image_size"])
    B = d["pose"].shape[0]
    with full_float32():
        out = body_lib.smpl(b, body_lib.rodrigues(d["pose"].reshape(B, -1, 3)), d["betas"], Precision())
    verts2d = body_lib.project_pixel(out["verts"], d["cam"], rcfg["image_size"])
    s = rcfg["stream"]

    def call():
        raster_hard.hard_raster(verts2d, out["verts"][..., 2], consts.hard, rcfg["image_size"],
                                k_faces=s.hard_k_faces or None, with_shade=s.shading > 0,
                                light=d.get("light") if s.shading else (0.35, -0.5, 0.79))

    call()
    begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    begin.record()
    for _ in range(iters):
        call()
    end.record()
    torch.cuda.synchronize()
    return begin.elapsed_time(end) / iters
