"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It finds the cell's configuration, traffic,
driver, limits and metric readers by the names in `BENCHMARK.json`
(`portbench/spec.py`), loads and warms up (set-up), measures for
`--seconds`, checks the outputs against the plain reference
(`portbench/reference/`), and prints, last on standard output, one JSON
line: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics with `--trace 0`, its per-layer metrics with `--trace 1`),
`device`, with `--trace 1` `breakdown`, and last `checks`, each compared
number beside its limit (also the last lines of standard error). Earlier
lines, prefixed `#`, give the set-up's phases and the program's counters.

It exits non-zero and prints no result without as many CUDA devices as the
cell asks for, and when `jax`, `jaxlib`, `flax` or the reference package
(`indirect_learning_pose_shape_tpu`, matched by whole top-level name) is
loaded once the window has closed. Build and kernel caches live under
`build/` in the checkout.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

from portbench.context import process_age_s  # noqa: E402

_STARTED -= process_age_s()
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "indirect_learning_pose_shape_tpu")
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda"}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared whole."""
    tops = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "portbench_cache" / sub)


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device, root: Path = ROOT,
             started: float | None = None) -> dict:
    """Run the cell on `device` and return the result line as a dict."""
    import torch

    from portbench import compare
    from portbench.context import Context
    from portbench.spec import Spec

    spec = Spec(workload, root)
    ctx = Context(spec, seed, seconds, trace, torch.device(device),
                  _STARTED if started is None else started)
    res = spec.driver().run(ctx)
    correct, checks = compare.judge(res["numbers"], spec.limits)
    units = {m["name"]: m["unit"] for m in spec.bench["end_to_end"] + spec.bench["per_layer"]}
    metrics = {}
    if trace:
        data = {"summary": res["trace"]["summary"], "extras": res["trace"]["extras"],
                "window": res["window"], "config": spec.config, "traffic": spec.traffic}
        for m in spec.per_layer():
            value = spec.reader(m["name"]).read(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec.end_to_end():
            # `train_img_per_s.robust`: the driver's `train_img_per_s`, under
            # a name and bound of its own.
            metrics[m["name"]] = {"value": res["metrics"][m["name"].split(".")[0]], "unit": units[m["name"]]}
    dev = torch.device(device)
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": spec.workload["chips"], "memory_peak_bytes": res["memory_peak_bytes"],
    }
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": device_info}
    if trace:
        s = res["trace"]["summary"]
        device_info.update(busy_s=s["busy_s"], window_s=s["window_s"])
        line["breakdown"] = {"device_ops": s["device_ops"], "idle_gaps": s["idle_gaps"]}
    line["checks"] = checks
    line["_info"] = {"run": res["info"], "numbers": res["numbers"], "notes": res.get("notes"),
                     "end_to_end": res["metrics"], "replay_state": res.get("replay_state")}
    return line


def _smi() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches()
    import torch

    from portbench.spec import Spec

    chips = Spec(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s), found {have}", file=sys.stderr)
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    info = line.pop("_info")
    print("# setup " + json.dumps(info["run"]["setup"]))
    print("# program " + json.dumps({**{k: v for k, v in info["run"].items() if k != "setup"},
                                     "memory_peak_bytes": line["device"]["memory_peak_bytes"]}))
    print("# card " + _smi())
    print("# numbers " + json.dumps({"numbers": info["numbers"], "notes": info["notes"],
                                     "end_to_end": info["end_to_end"]}))
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
