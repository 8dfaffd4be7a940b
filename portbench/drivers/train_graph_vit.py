"""Training cells of HMR 2.0 (`hmr2_vith`): the port's ViT-H/16 and
transformer head on the synthetic stream, driven as `train_graph.py`
drives the ResNet cells, on `train.fit`'s route.

Set-up builds the program only from the port's preset
(`configs.PRESETS[config["preset"]]`, refused where it differs from the
configuration file: `program_config`), before anything touches the card,
so a program without the preset fails at once. It loads the benchmark's
weights (`portbench/inputs_vit.py`), then drives
`train.compile_fused_step`'s callable one call (one graph replay) a step:
the first call is the eager warm-up and the capture, whose
`attn.calls.<backend>` counts it keeps, and whose warm-up step (step 0,
drop path on) gives the backbone's tokens and the head's final LayerNorm
output through forward hooks; the first `check_steps` steps are the
check's (terms, Adam's first moment after step 1, the parameters after the
last); `warm_steps` more; the
window for `--seconds`, closed by a synchronize; one replay from a state
copied to the host, for the check; with `--trace 1`, `trace_steps`
profiled steps. Then the state is freed and the plain reference
(`portbench/reference/vit.py`, float32, micro-batches of 16) takes the same
steps from the same weights on its own recomputed batches.

Compared numbers (`train_numbers`; limits in
`portbench/limits/<workload>.json`): `loss1_rel`, `loss_rel`, `grad_leaf`,
`change_leaf` and their `replay_*` twins as `compare.py` defines them;
`tokens_rel`, ‖t − t_ref‖ / ‖t_ref − mean‖ of the backbone's output tokens
in step 0's training forward (the mean per channel), and `head_rel`, the
same of the head's final LayerNorm output, which the decoders read. There
is no BatchNorm.

    python3 -m portbench.drivers.train_graph_vit --workload <cell> --seeds 11 12 ... [--seconds 3]

prints, a seed, the run's numbers beside the control's: the reference
with its backbone and head at float8 e4m3 (`reference/vit.py`), against
the float32 reference on the same inputs (one JSON line a seed, also
appended to `build/control_vit.jsonl`); the benchmark's own runs never run
it.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

from portbench import compare, inputs, inputs_vit, trace
from portbench.context import sub_seed
from portbench.drivers.train_graph import _host, _state
from portbench.reference import stream as ref_stream
from portbench.reference import train as ref_train
from portbench.reference import vit as ref_vit
from portbench.reference.precision import Precision
from portbench.work import vit as vit_work


def program_config(config: dict, traffic: dict, seed: int):
    """The port's TrainConfig: the preset, refused where it differs from
    the configuration's file, with the traffic's stream and batch."""
    from indirect_learning_pose_shape_tpu_torch import configs

    preset = configs.PRESETS[config["preset"]]
    model = preset.model
    v, h, cv, ch = model.encoder, model.head, config["vit"], config["head"]
    size = config["image_size"]
    stated = {
        "vit": ((tuple(v.crop_cols), v.patch_size, v.patch_padding, v.width, v.depth, v.num_heads, v.head_dim,
                 v.mlp_dim, v.qkv_bias, v.ln_eps, v.num_tokens(model.image_size)),
                (tuple(cv["crop_cols"]), cv["patch_size"], cv["patch_padding"], cv["width"], cv["depth"],
                 cv["num_heads"], cv["head_dim"], cv["mlp_dim"], cv["qkv_bias"], cv["ln_eps"], cv["tokens"])),
        "head": ((h.width, h.depth, h.num_heads, h.head_dim, h.mlp_dim, h.context_dim, h.token_dim, h.ln_eps,
                  model.ief.num_iterations),
                 tuple(ch[k] for k in ("width", "depth", "num_heads", "head_dim", "mlp_dim", "context_dim",
                                       "token_dim", "ln_eps", "iterations"))),
        "drop_path": (v.drop_path, config["drop_path_rate"]),
        "image_size": (model.image_size, size),
        "rotation": (model.ief.rotation_format, config["rotation"]),
        "num_parts": (model.raster.num_parts, config["raster"]["num_parts"]),
        "sigma": (model.raster.sigma, config["raster"]["sigma"]),
        "bg_gamma": (model.raster.bg_gamma, config["raster"]["bg_gamma"]),
        "learning_rate": (preset.learning_rate, config["learning_rate"]),
        "weight_decay": (preset.weight_decay, config["weight_decay"]),
        "lr_schedule": (preset.lr_schedule, config["lr_schedule"]),
        "warmup_steps": (preset.warmup_steps, config["warmup_steps"]),
        "num_steps": (preset.num_steps, config["num_steps"]),
        "grad_clip_norm": (preset.grad_clip_norm, config["grad_clip_norm"]),
        "loss_weights": ({k: w for k, w in preset.loss_weights if w},
                         {k: w for k, w in config["loss_weights"].items() if w}),
        "precision": ((str(v.compute_dtype), str(h.compute_dtype)),
                      ("torch." + config["precision"]["encoder"], "torch." + config["precision"]["head"])),
    }
    wrong = {k: s for k, s in stated.items() if s[0] != s[1]}
    if wrong:
        raise ValueError(f"preset {config['preset']} differs from its file: {wrong}")
    return dataclasses.replace(
        preset, synthetic=dataclasses.replace(preset.synthetic, **traffic["synthetic"]),
        batch_size=traffic["batch_size"], log_every=traffic["log_every"], checkpoint_every=0,
        metrics_path=None, tensorboard_dir=None, seed=seed, steps_per_call=1,
    )


def reference_config(config: dict, traffic: dict) -> dict:
    """The run's settings as `reference/vit.py` and `reference/train.py`
    read them."""
    return {
        "vit": config["vit"], "head": config["head"], "drop_path_rate": config["drop_path_rate"],
        "rotation": config["rotation"],
        "image_size": config["image_size"], "num_parts": config["raster"]["num_parts"],
        "sigma": config["raster"]["sigma"], "bg_gamma": config["raster"]["bg_gamma"],
        "batch_size": traffic["batch_size"], "stream": ref_stream.Stream(**traffic["synthetic"]),
        "loss_weights": config["loss_weights"], "learning_rate": config["learning_rate"],
        "weight_decay": config["weight_decay"], "lr_schedule": config["lr_schedule"],
        "warmup_steps": config["warmup_steps"], "num_steps": config["num_steps"],
        "grad_clip_norm": config["grad_clip_norm"],
    }


def train_numbers(prog: dict, ref: dict, start: dict) -> tuple[dict, dict]:
    """`compare.train_numbers` without BatchNorm: the loss, the worst and
    median leaf of the first gradient and of the change over the steps."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    terms = [{k: abs(tp[k] - tr[k]) / abs(tr[k]) if tr[k] else abs(tp[k]) for k in tr if k in tp}
             for tp, tr in zip(prog["terms"], ref["terms"])]
    gp, gr = compare._norms(prog["first_grad"]), compare._norms(ref["first_grad"])
    grad = compare._gaps(gp, gr, gr)
    med = statistics.median(gr.values())
    moved = [k for k in gr if gr[k] >= 1e-3 * med]
    cp = compare._norms({k: prog["params"][k].double() - start[k].double() for k in moved})
    cr = compare._norms({k: ref["params"][k].double() - start[k].double() for k in moved})
    change = compare._gaps(cp, cr, moved)
    numbers = {"loss_rel": max(losses), "loss1_rel": losses[0], "kp1_rel": terms[0].get("kp", 0.0),
               "grad_leaf": max(grad.values()), "grad_median": statistics.median(grad.values()),
               "change_leaf": max(change.values()), "change_median": statistics.median(change.values())}
    notes = {"grad_worst": max(grad, key=grad.get), "change_worst": max(change, key=change.get),
             "left_out": sorted(set(gr) - set(moved)), "loss": prog["loss"], "loss_ref": ref["loss"],
             "term_gaps": terms}
    return numbers, notes


REPLAYED = ("loss_rel", "kp1_rel", "grad_leaf", "grad_median", "change_leaf", "change_median")


def spread_rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    """‖x − ref‖ over ‖ref − its mean per channel‖ (the last dimension)."""
    r = ref.double()
    spread = torch.linalg.vector_norm(r - r.mean(dim=tuple(range(r.dim() - 1))))
    return float(torch.linalg.vector_norm(x.double() - r) / spread)


SEEN = ("tokens", "head_norm")  # step 0's backbone tokens and head LayerNorm output


def _reading(r: dict) -> dict:
    return {"loss": [t["total"] for t in r["terms"]], "terms": r["terms"], "first_grad": _host(r["first_grad"]),
            "params": _host(r["params"]), **{k: r[k] for k in SEEN}}


def reference_numbers(config: dict, traffic: dict, seed: int, device, prog: dict, start: dict,
                      replay: dict, state: dict, prec: Precision) -> tuple[dict, dict]:
    """The compared numbers of `prog` (the first steps, `tokens`,
    `head_norm`) and `replay` (the step replayed from `state`) against the
    reference at `prec` on the same weights (`start` and the fixed leaves in
    `state`) and stream."""
    rcfg = reference_config(config, traffic)
    inp = ref_train.Inputs(inputs.stand_in(**config["asset"]), rcfg["num_parts"], device)
    weights = {k: v.to(device) for k, v in {**start, **{k: state["buffers"][k] for k in ref_vit.FIXED}}.items()}
    ref = _reading(ref_vit.run_steps(weights, inp, rcfg, seed, traffic["check_steps"], prec))
    del weights
    numbers, notes = train_numbers(prog, ref, start)
    numbers["tokens_rel"] = spread_rel(prog["tokens"], ref["tokens"])
    numbers["head_rel"] = spread_rel(prog["head_norm"], ref["head_norm"])
    del ref
    gc.collect()
    weights = {k: v.to(device) for k, v in {**state["params"], **state["buffers"]}.items()}
    ref = _reading(ref_vit.run_steps(weights, inp, rcfg, seed, 1, prec, first=state["step"],
                                     adam=(state["exp_avg"], state["exp_avg_sq"])))
    del weights
    more, notes["replay"] = train_numbers(replay, ref, state["params"])
    numbers.update({f"replay_{k}": more[k] for k in REPLAYED})
    return numbers, notes


def run(ctx) -> dict:
    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    cfg = program_config(config, traffic, ctx.seed)  # a program without the preset stops here

    from indirect_learning_pose_shape_tpu_torch import train
    from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build
    from indirect_learning_pose_shape_tpu_torch.utils import metrics as metrics_lib
    from indirect_learning_pose_shape_tpu_torch.utils import tracing

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
    ts, consts = train.init_state(cfg, asset=inputs.port_asset(asset), device=dev)
    ctx.phase("init_state")
    ts.model.load_state_dict(inputs_vit.make_weights(config, sub_seed(ctx.seed, 1), dev), strict=True)
    names = {p: k for k, p in ts.model.named_parameters()}
    start = _host(dict(ts.model.named_parameters()))
    seen = {}

    def keep(name):
        def hook(module, args, out):
            if name not in seen:  # the warm-up's call; the capture's records nothing
                seen[name] = out.detach().clone()
        return hook

    hooks = [ts.model.encoder.last_norm.register_forward_hook(keep("tokens")),
             ts.model.head.norm.register_forward_hook(keep("head_norm"))]
    step_fn = train.compile_fused_step(cfg, consts)
    writer = metrics_lib.MetricsWriter(print_every=0)
    le = max(1, cfg.log_every)
    logged = []
    ctx.phase("init")

    done = 0

    def step():
        nonlocal done
        first = ts.step
        terms = step_fn(ts, 1)
        done += 1
        if any(s % le == 0 for s in range(first, ts.step)):
            logged.append(writer.write(ts.step - 1, terms)["total"])
        return terms

    counts = tracing.counters()
    terms = [step()]  # the eager warm-up step, then the capture
    for h in hooks:
        h.remove()
    if cuda:
        torch.cuda.synchronize()
    seen = {k: v.cpu() for k, v in seen.items()}
    captured = {k: n - counts.get(k, 0) for k, n in tracing.counters().items()
                if k.startswith(("attn.calls.", "vit.tokens")) and n != counts.get(k, 0)}
    beta1 = ref_train.ADAM[0]
    first_grad = _host({names[p]: st["exp_avg"] / (1 - beta1) for p, st in ts.optimizer.state.items()})
    ctx.phase("first_step")
    for _ in range(traffic["check_steps"] - 1):
        terms.append(step())
    terms = [{k: float(v) for k, v in t.items()} for t in terms]
    prog = {"loss": [t["total"] for t in terms], "terms": terms, "first_grad": first_grad,
            "params": _host(dict(ts.model.named_parameters())), **seen}
    for _ in range(traffic["warm_steps"]):
        step()
    if cuda:
        torch.cuda.synchronize()
    ctx.phase("warm_steps")

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
    B = cfg.batch_size
    graph = getattr(step_fn, "graph", None)
    result = {
        "metrics": {"train_img_per_s": steps * B / window_s, "setup_s": setup_s},
        "attempted": steps, "failed": sum(1 for x in logged if not math.isfinite(x)),
        "memory_peak_bytes": peak,
        "info": {"steps": steps, "window_s": window_s,
                 "launches_per_step": {k: v / steps for k, v in _build.counts().items()},
                 "counts_first_call": captured, "capture_s": getattr(graph, "seconds", None),
                 "pool_bytes": getattr(graph, "pool_bytes", None), "captures": getattr(step_fn, "captures", None),
                 "setup": dict(ctx.setup)},
        "window": {"images_per_s": steps * B / window_s, "steps": steps, "seconds": window_s},
    }

    k = done
    before = _state(ts, names)
    replay_terms = {n: float(v) for n, v in step().items()}
    after = _state(ts, names)
    replay = {"loss": [replay_terms["total"]], "terms": [replay_terms], "params": after["params"],
              "first_grad": {n: (m - beta1 * before["exp_avg"][n]) / (1 - beta1) for n, m in after["exp_avg"].items()}}
    result["info"].update(replay_step=k, program_step=ts.step - 1)
    result["replay_state"] = {"step": k, **before}
    del after

    if ctx.trace:
        result["trace"] = _trace(ctx, step, captured)

    del step_fn, ts, consts, names
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    result["numbers"], result["notes"] = reference_numbers(config, traffic, ctx.seed, dev, prog, start, replay,
                                                           result["replay_state"], Precision())
    return result


def _trace(ctx, step, captured: dict) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = ctx.device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts):  # the profiler's own first-use cost, outside the stretch
        step()
    k = ctx.traffic["trace_steps"]
    with profile(activities=acts) as prof:
        with record_function(trace.STRETCH):
            for _ in range(k):
                step()
            if cuda:
                torch.cuda.synchronize()
    summary = trace.summarize(prof, k)
    attn = vit_work.attention_flops_per_image(ctx.config) * ctx.traffic["batch_size"]
    return {"summary": summary, "extras": {"attn_calls": captured, "attn_flops_per_step": attn}}


def control(workload: str, seed: int, seconds: float, device, root=None) -> dict:
    """One run of the cell (the program's numbers), then the control: the
    float8 reference against the float32 one on the same inputs."""
    from portbench import run as run_lib
    from portbench.spec import ROOT, Spec

    root = ROOT if root is None else root
    spec = Spec(workload, root)
    line = run_lib.run_cell(workload, seed, seconds, False, device, root=root, started=time.perf_counter())
    rec = {"workload": workload, "seed": seed, "correct": line["correct"], "checks": line["checks"],
           "program": line["_info"]["numbers"], "program_notes": line["_info"]["notes"]}
    state = line["_info"]["replay_state"]
    del line
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    config, traffic = spec.config, spec.traffic
    low, high = Precision(encoder="fp8"), Precision()
    rcfg = reference_config(config, traffic)
    inp = ref_train.Inputs(inputs.stand_in(**config["asset"]), rcfg["num_parts"], device)
    # The program's place taken by the float8 reference: its first steps from
    # the seed's weights, and the replayed step from the run's state.
    weights = inputs_vit.make_weights(config, sub_seed(seed, 1), device)
    start = _host({k: v for k, v in weights.items() if k not in ref_vit.FIXED})
    prog = _reading(ref_vit.run_steps(weights, inp, rcfg, seed, traffic["check_steps"], low))
    del weights
    weights = {k: v.to(device) for k, v in {**state["params"], **state["buffers"]}.items()}
    replay = _reading(ref_vit.run_steps(weights, inp, rcfg, seed, 1, low, first=state["step"],
                                        adam=(state["exp_avg"], state["exp_avg_sq"])))
    del weights
    numbers, _ = reference_numbers(config, traffic, seed, device, prog, start, replay, state, high)
    rec["control"] = numbers
    return rec


def main(argv=None) -> int:
    from portbench import run as run_lib
    from portbench.spec import ROOT

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "control_vit.jsonl"))
    args = ap.parse_args(argv)
    run_lib.set_caches()
    if not torch.cuda.is_available():
        print("control: no CUDA device found", file=sys.stderr)
        return 2
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for seed in args.seeds:
            t0 = time.perf_counter()
            rec = control(args.workload, seed, args.seconds, torch.device("cuda:0"))
            rec["seconds"] = time.perf_counter() - t0
            f.write(json.dumps(rec, default=str) + "\n")
            f.flush()
            print(json.dumps(rec, default=str), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
