"""Nothing the benchmark runs imports JAX or the reference package, compared
by whole top-level name; the plain reference imports nothing of the port."""

import ast
import subprocess
import sys

from portbench import run
from portbench.spec import ROOT


def test_forbidden_names_are_matched_whole():
    assert run.forbidden_modules(["indirect_learning_pose_shape_tpu_torch.train", "numpy"]) == []
    assert run.forbidden_modules(["jax.numpy", "torch"]) == ["jax"]
    assert run.forbidden_modules(["indirect_learning_pose_shape_tpu.ops", "flax.linen", "jaxlib"]) == [
        "flax", "indirect_learning_pose_shape_tpu", "jaxlib"]
    assert run.forbidden_modules(["jaxtyping", "flaxen"]) == []


def test_a_run_loads_no_forbidden_module():
    """Import every module a run of any cell imports (the harness, each
    driver and reader, the port's modules the drivers call) in a fresh
    process, then look."""
    code = """
import json, sys
from portbench import run, control
from portbench.spec import Spec
bench = json.load(open('BENCHMARK.json'))
for w in bench['workloads']:
    spec = Spec(w['name'])
    spec.driver()
    for m in spec.per_layer():
        spec.reader(m['name'])
from indirect_learning_pose_shape_tpu_torch import train, serve, predict, configs
from indirect_learning_pose_shape_tpu_torch.utils import metrics, assets
from indirect_learning_pose_shape_tpu_torch.ops import raster_hard
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build
import torch.profiler
print(json.dumps(run.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_imports_nothing_of_the_port():
    allowed = {"torch", "numpy", "math", "dataclasses", "contextlib", "__future__", "portbench"}
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top in allowed, (path.name, name)
                if top == "portbench":
                    assert name.startswith("portbench.reference"), (path.name, name)
