"""A benchmark root at a size the CPU holds: the cells of `BENCHMARK.json`
with 64² crops, the 864-vertex stand-in and batches of 2, built from new
files in a temporary directory beside links to the drivers and readers."""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

from portbench.spec import ROOT

SIZES = {"soft_b32": {"batch_size": 2, "trace_steps": 2, "warm_steps": 1},
         "hard_b32": {"batch_size": 2, "trace_steps": 1, "warm_steps": 1},
         "interactive": {"pool": 16, "check_every": 3, "trace_requests": 4},
         "bulk128": {"mix": [[4, 1]], "buckets": [4], "pool": 8, "check_every": 2, "trace_requests": 2}}


def tiny_root(tmp: Path) -> Path:
    """`tmp` laid out as a checkout root holding the tiny cells."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    pb = tmp / "portbench"
    for sub in ("configs", "traffic", "limits"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("drivers", "metrics"):
        os.symlink(ROOT / "portbench" / sub, pb / sub)
    for c in bench["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg.update(image_size=64, asset={"num_verts": 864, "seed": 1})
        (tmp / c["file"]).write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        traffic = json.loads((ROOT / "portbench" / "traffic" / f"{w['traffic']}.json").read_text())
        traffic.update(SIZES.get(w["traffic"], {}))
        (pb / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(traffic))
        shutil.copy(ROOT / "portbench" / "limits" / f"{w['name']}.json", pb / "limits")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
