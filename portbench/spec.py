"""Where the benchmark finds each part of a cell, by the names in
`BENCHMARK.json`: nothing here names a cell, a configuration, a traffic
mix, a driver or a metric.

    <root>/BENCHMARK.json                     the cells and the metrics
    <configs[].file>                          a configuration (its `preset` in the port)
    <root>/portbench/traffic/<traffic>.json   a mix; its `driver` names the driver
    <root>/portbench/drivers/<driver>.py      `run(ctx) -> dict`
    <root>/portbench/limits/<workload>.json   the output check's limits
    <root>/portbench/metrics/<metric>.py      `read(data) -> float | None`
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """One cell of the benchmark under `root`."""

    def __init__(self, workload: str, root: Path = ROOT):
        self.root = Path(root)
        self.bench = _json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
        self.workload = cells[workload]
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.workload["config"]]
        self.config = _json(self.root / self.config_entry["file"])
        self.traffic = _json(self.root / "portbench" / "traffic" / f"{self.workload['traffic']}.json")
        self.limits = _json(self.root / "portbench" / "limits" / f"{workload}.json")

    @property
    def name(self) -> str:
        return self.workload["name"]

    def driver(self):
        return _module(self.root / "portbench" / "drivers" / f"{self.traffic['driver']}.py")

    def end_to_end(self) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list[dict]:
        """The per-layer metrics read in this cell: those that list it, and
        those without a list whose `moves` metric the cell reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m else m["moves"] in mine)]

    def reader(self, metric: str):
        return _module(self.root / "portbench" / "metrics" / f"{metric}.py")


def _module(path: Path):
    name = f"portbench_{path.parent.name}_{path.stem.replace('.', '_').replace('-', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
