"""`BENCHMARK.json` keeps to the contract's characters and shapes, and a cell
defined only by new files loads and runs without an edit."""

import json
import re
import shutil

import pytest

from portbench import run
from portbench.spec import ROOT, Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_names_and_units_use_the_allowed_characters():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["traffic"] for w in b["workloads"]] + [k for c in b["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in [c["why"] for c in b["configs"]] + [w["why"] for w in b["workloads"]] + \
            [m["layer"] for m in b["per_layer"]] + [c["source"] for c in b["configs"]] + b["command"]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    for p in b["paths"] + [c["file"] for c in b["configs"]]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p, p
    for path in (ROOT / "portbench").rglob("*"):
        if "__pycache__" not in path.parts:
            assert PATH.match(str(path.relative_to(ROOT))), path


def test_every_cell_reports_what_the_contract_asks():
    b = _bench()
    assert 1 <= b["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for w in b["workloads"]:
        spec = Spec(w["name"])
        e2e = {m["name"] for m in spec.end_to_end()}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert spec.per_layer(), w["name"]
        for m in spec.per_layer():
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
        assert (ROOT / "portbench" / "drivers" / f"{spec.traffic['driver']}.py").exists()
        assert spec.limits and all(v > 0 for v in spec.limits.values()), w["name"]
    for m in b["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%", m["name"]


_DRIVER = '''
def reference_config(config, traffic):
    return {}


def run(ctx):
    ctx.phase("init")
    n = ctx.traffic["requests"]
    return {"metrics": {"echo_per_s": n / ctx.seconds, "setup_s": ctx.since_start()},
            "attempted": n, "failed": 0, "memory_peak_bytes": 0,
            "window": {"requests": n}, "info": {"setup": dict(ctx.setup)},
            "numbers": {"gap": ctx.config["gap"]},
            "trace": {"summary": {"device_ops": [], "idle_gaps": [], "busy_s": 0.0, "window_s": 1.0},
                      "extras": {"echo": ctx.config["width"]}}}
'''
_READER = '''
def read(data):
    return data["extras"]["echo"] * data["window"]["requests"]
'''


def test_a_cell_of_new_files_loads_without_edits(tmp_path):
    """A configuration, a traffic mix, a driver and a metric added as files
    and entries, in a copy of the layout, run with the harness unchanged."""
    root = tmp_path
    shutil.copytree(ROOT / "portbench", root / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file()}
    b = _bench()
    b["configs"].append({"name": "echo_model", "source": "https://example.org/echo",
                         "file": "portbench/configs/echo_model.json", "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "echo.cell", "config": "echo_model", "traffic": "echo_mix", "chips": 1,
                           "why": "a test"})
    b["end_to_end"].append({"name": "echo_per_s.echo", "unit": "1/s", "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": ["echo.cell"]})
    b["per_layer"].append({"name": "echo_width", "unit": "count", "better": "higher", "source": "program_counter",
                           "layer": "echo", "moves": "echo_per_s.echo", "workloads": ["echo.cell"]})
    # Without `workloads`: read in every cell that reports what it moves.
    b["per_layer"].append({"name": "echo_depth", "unit": "count", "better": "higher", "source": "program_counter",
                           "layer": "echo", "moves": "echo_per_s.echo"})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    (root / "portbench/configs/echo_model.json").write_text(json.dumps({"width": 3, "gap": 0.5}))
    (root / "portbench/traffic/echo_mix.json").write_text(json.dumps({"driver": "echo", "requests": 8}))
    (root / "portbench/drivers/echo.py").write_text(_DRIVER)
    (root / "portbench/metrics/echo_width.py").write_text(_READER)
    (root / "portbench/metrics/echo_depth.py").write_text(_READER)
    (root / "portbench/limits/echo.cell.json").write_text(json.dumps({"gap": 1.0}))
    after = {p: p.read_bytes() for p in (root / "portbench").rglob("*") if p.is_file() and p in before}
    assert after == before
    line = run.run_cell("echo.cell", 1, 2.0, False, "cpu", root=root, started=0.0)
    assert line["correct"] and line["metrics"]["echo_per_s.echo"] == {"value": 4.0, "unit": "1/s"}
    assert set(line["metrics"]) == {"echo_per_s.echo", "setup_s"}
    traced = run.run_cell("echo.cell", 1, 2.0, True, "cpu", root=root, started=0.0)
    assert traced["metrics"] == {"echo_width": {"value": 24, "unit": "count"},
                                 "echo_depth": {"value": 24, "unit": "count"}}
    for w in b["workloads"][:-1]:
        assert "echo_depth" not in {m["name"] for m in Spec(w["name"], root).per_layer()}
    assert list(traced)[-2:] == ["checks", "_info"]
    with pytest.raises(KeyError):
        Spec("no.such.cell", root)
