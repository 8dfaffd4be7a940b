"""Readings for the output check's limits, on the card, in one process:

    python3 -m portbench.control --workload <name> --seeds 11 12 ... [--seconds 3] \\
        [--modes fp8 tf32 both] [--out build/control.jsonl]

For each seed: one run of the cell (`run.run_cell`, a short window), whose
compared numbers are the program's reading; then the reference itself, in
each control precision (`reference/precision.py`: 'fp8' encoder, 'tf32'
geometry, 'both'), put in the program's place and compared with the
reference by the same numbers, on the same inputs: the first three training
steps and the step the run replayed after its window (from the state the
run copied before it), or the requests a run of the cell keeps for its
check. One JSON line
a seed and mode; the benchmark's own runs never run this. The mode 'half'
(training) is a fault, not a control: the reference on the first half of
each batch, the mean taken over it.
"""

from __future__ import annotations

import argparse
import gc
import itertools
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from portbench import compare, inputs, run, traffic as traffic_lib
from portbench.context import sub_seed
from portbench.reference import serve as ref_serve
from portbench.reference import train as ref_train
from portbench.reference.precision import Precision
from portbench.spec import ROOT, Spec

MODES = {"fp8": Precision(encoder="fp8"), "tf32": Precision(geometry="tf32"),
         "both": Precision(encoder="fp8", geometry="tf32"),
         # Not controls: the reference with half a bfloat16 unit of noise on
         # each convolution's input, the size of rounding alone.
         "jitter": Precision(jitter=2.0**-9)}


def _host(d: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in d.items()}


def train_control(spec: Spec, seed: int, device, modes, replay_state: dict | None = None) -> dict:
    """The control's readings of the first steps from the seed's weights,
    and, given the state a run copied before its replayed step
    (`replay_state`), of that step (the `replay_*` numbers)."""
    config, traffic = spec.config, spec.traffic
    driver = spec.driver()
    rcfg = driver.reference_config(config, traffic)
    asset = inputs.stand_in(**config["asset"])
    inp = ref_train.Inputs(asset, rcfg["num_parts"], device)
    weights = inputs.make_weights(config["encoder"]["depth"], config["ief"]["rotation"], sub_seed(seed, 1), device)
    start = _host({k: v for k, v in weights.items() if not k.endswith((".mean", ".var"))})
    steps = traffic["check_steps"]

    def reading(prec, rows=None):
        r = ref_train.run_steps(weights, inp, rcfg, seed, steps, prec, rows)
        return {"loss": [t["total"] for t in r["terms"]], "terms": r["terms"], "first_grad": _host(r["first_grad"]),
                "bn1": {k: tuple(v.cpu() for v in mv) for k, mv in r["bn1"].items()},
                "params": _host(r["params"])}

    def replay(prec, rows=None):
        k = replay_state["step"]
        return driver.replay_reference(replay_state, inp, rcfg, seed, k, prec, device, rows)

    ref = reading(Precision())
    ref_replay = replay(Precision()) if replay_state else None
    out = {}
    for m in modes:
        torch.manual_seed(seed)
        prec, rows = (Precision(), rcfg["batch_size"] // 2) if m == "half" else (MODES[m], None)
        # 'half' is a fault: half of the batch left out, the mean over the rest.
        numbers, notes = compare.train_numbers(reading(prec, rows), ref, start)
        if replay_state:
            torch.manual_seed(seed)
            more, _ = compare.train_numbers(replay(prec, rows), ref_replay, replay_state["params"])
            numbers.update(compare.replay_names(more))
        out[m] = {"numbers": numbers, **notes}
    return out


def serve_control(spec: Spec, seed: int, device, modes, kept_requests: int) -> dict:
    config, tr = spec.config, spec.traffic
    rcfg = spec.driver().reference_config(config, tr)
    asset = inputs.stand_in(**config["asset"])
    inp = ref_train.Inputs(asset, config["raster"]["num_parts"], device)
    weights = inputs.make_weights(config["encoder"]["depth"], config["ief"]["rotation"], sub_seed(seed, 1), device)
    pool = inputs.crop_pool(tr["pool"], config["image_size"], sub_seed(seed, 2), device)
    gen = traffic_lib.requests(tr["mix"], tr["pool"], tr["check_every"], seed)
    kept = list(itertools.islice((r for r in gen if r.keep), kept_requests))
    crops = torch.from_numpy(np.concatenate([pool[r.offset : r.offset + r.crops] for r in kept])).to(device)
    ref = ref_serve.answer(weights, inp, rcfg, crops, tr["silhouette"], Precision())
    out = {}
    for m in modes:
        torch.manual_seed(seed)
        low = ref_serve.answer(weights, inp, rcfg, crops, tr["silhouette"], MODES[m])
        geo = ref_serve.geometry(inp, rcfg, low["theta"].to(device), tr["silhouette"], Precision())
        out[m] = {"numbers": compare.serve_numbers(low, ref, weights["ief.mean_theta"].cpu(), geo)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--modes", nargs="*", default=["fp8", "tf32", "both"])
    ap.add_argument("--program", type=int, default=1, help="0: control readings only")
    ap.add_argument("--out", default=str(ROOT / "build" / "control.jsonl"))
    args = ap.parse_args(argv)
    run.set_caches()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    if not torch.cuda.is_available():
        print("control: no CUDA device found", file=sys.stderr)
        return 2
    spec = Spec(args.workload)
    dev = torch.device("cuda:0")
    with open(args.out, "a") as f:
        for seed in args.seeds:
            t0 = time.perf_counter()
            rec = {"workload": args.workload, "seed": seed}
            kept = state = None
            if args.program:
                line = run.run_cell(args.workload, seed, args.seconds, False, dev, started=time.perf_counter())
                rec["program"] = line["_info"]["numbers"]
                rec["program_notes"] = line["_info"]["notes"]
                rec["correct"], rec["checks"] = line["correct"], line["checks"]
                kept = (line["_info"]["notes"] or {}).get("kept_requests")
                state = line["_info"]["replay_state"]
                del line
                gc.collect()
                torch.cuda.empty_cache()
            if args.modes:
                if spec.traffic["driver"] == "train_graph":
                    rec["control"] = train_control(spec, seed, dev, args.modes, state)
                else:
                    rec["control"] = serve_control(spec, seed, dev, args.modes, kept or 100)
            rec["seconds"] = time.perf_counter() - t0
            f.write(json.dumps(rec, default=str) + "\n")
            f.flush()
            print(json.dumps(rec, default=str), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
