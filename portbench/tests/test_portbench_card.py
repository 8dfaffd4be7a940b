"""The output check's control at each cell's own size, on the card:

    python -m pytest portbench/tests/test_portbench_card.py -q -p no:cacheprovider

The reference computed one step of precision below the configuration's
(float8 encoder, TF32 geometry: `portbench/control.py`) must fail at least
one of the cell's limits, and a sound run of the program none. Skipped
without a card."""

import json

import pytest
import torch

from portbench import compare, control, run
from portbench.spec import ROOT, Spec

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_the_program_passes(card, workload):
    run.set_caches()
    spec = Spec(workload)
    seed = 2**31 + 977
    line = run.run_cell(workload, seed, 2.0, False, card, started=0.0)
    assert line["correct"], line["checks"]
    torch.cuda.empty_cache()
    if spec.traffic["driver"] == "train_graph":
        state = line["_info"]["replay_state"]
        low = control.train_control(spec, seed, card, ["both"], state)["both"]["numbers"]
    else:
        kept = line["_info"]["notes"]["kept_requests"]
        low = control.serve_control(spec, seed, card, ["both"], kept)["both"]["numbers"]
    ok, checks = compare.judge(low, spec.limits)
    assert not ok, checks
