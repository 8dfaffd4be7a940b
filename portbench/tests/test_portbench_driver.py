"""The training driver runs the steps its traffic file names, and the hard
raster's readers read its kernel from a profiled stretch."""

import pytest

from portbench import run
from portbench.spec import Spec
from portbench.tests.tiny import tiny_root

from indirect_learning_pose_shape_tpu_torch import train

TRAIN = ["train.config4_full.soft_b32", "train.config4_mixed.hard_b32"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", TRAIN)
def test_the_loop_runs_the_traffics_steps(root, workload, monkeypatch):
    """Check steps, then warm-up steps, the window, one replay for the
    check, and with `--trace 1` one step for the profiler's first use and
    `trace_steps` traced: nothing else steps the state."""
    calls = []
    compile_fused_step = train.compile_fused_step

    def counted(*a, **k):
        fn = compile_fused_step(*a, **k)

        def step(ts, n=None):
            calls.append(n)
            return fn(ts, n)

        return step

    monkeypatch.setattr(train, "compile_fused_step", counted)
    line = run.run_cell(workload, 2**31 + 5, 0.3, True, "cpu", root=root, started=0.0)
    t = Spec(workload, root).traffic
    assert line["correct"], line["checks"]
    assert calls == [1] * (t["check_steps"] + t["warm_steps"] + line["attempted"] + 1 + 1 + t["trace_steps"])
    assert line["_info"]["run"]["replay_step"] == t["check_steps"] + t["warm_steps"] + line["attempted"]


def _summary(kernels: dict, units: int = 2) -> dict:
    return {"units": units, "by_kernel_ms": {n: ms for n, (ms, _) in kernels.items()},
            "launches": {n: c for n, (_, c) in kernels.items()}}


@pytest.mark.parametrize("metric", ["hard_raster_ms.robust", "hard_raster_roofline.robust"])
def test_the_hard_raster_readers(metric):
    reader = Spec("train.config4_mixed.hard_b32").reader(metric)
    extras = {"bound_ms": {"raster_hard_kernel": 0.02, "raster_fwd_kernel": 0.1}}
    found = _summary({"raster_hard_kernel(float const*, unsigned char const*, int const*, int*)": (0.8, 2),
                      "raster_fwd_kernel<4>": (0.4, 4), "vectorized_elementwise_kernel": (5.0, 90)})
    value = reader.read({"summary": found, "extras": extras})
    assert value == pytest.approx(0.4 if metric.startswith("hard_raster_ms") else 2.5)
    absent = _summary({"raster_fwd_kernel<4>": (0.4, 4)})
    assert reader.read({"summary": absent, "extras": extras}) is None
    assert reader.read({"summary": absent, "extras": {}}) is None
