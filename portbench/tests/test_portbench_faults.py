"""A run with the timed path broken underneath reads `correct` false: the
harness's look for a card skipped, everything else of a run driven at the
tiny size (`tiny.py`), each fault planted in the port where it acts.

- a step that leaves the state unchanged (the update skipped);
- half of the batch left out, the mean taken over the rest;
- a stale batch from the window on (every step from there generating the
  window's first batch), which only the replayed step can see;
- an answer altered where it is produced (the served vertices moved 1 cm).

One card only: no cell has an exchange between chips to leave out."""

import pytest
import torch

from portbench import run
from portbench.spec import Spec
from portbench.tests.tiny import tiny_root

from indirect_learning_pose_shape_tpu_torch import serve, train

TRAIN = ["train.config4_full.soft_b32", "train.config4_mixed.hard_b32"]
SERVE = ["serve.config4_full.interactive", "serve.config4_full.bulk128"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, workload):
    return run.run_cell(workload, 2**31 + 21, 0.3, False, "cpu", root=root, started=0.0)


@pytest.mark.parametrize("workload", TRAIN + SERVE)
def test_sound_run_is_correct(root, workload):
    """The contrast the faults below are read against."""
    line = _run(root, workload)
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_state_left_unchanged(root, workload, monkeypatch):
    monkeypatch.setattr(train, "_update_on_device", lambda ts, cfg: None)
    line = _run(root, workload)
    assert line["correct"] is False
    assert line["checks"]["change_leaf"]["value"] == pytest.approx(1.0)
    assert line["checks"]["replay_change_leaf"]["value"] == pytest.approx(1.0)
    assert line["checks"]["replay_grad_leaf"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("workload", TRAIN)
def test_half_the_batch_left_out(root, workload, monkeypatch):
    whole = train.loss_and_metrics

    def half(model, consts, batch, cfg, mesh=None):
        n = batch["image"].shape[0] // 2
        return whole(model, consts, {k: v[:n] if v.ndim else v for k, v in batch.items()}, cfg, mesh)

    monkeypatch.setattr(train, "loss_and_metrics", half)
    line = _run(root, workload)
    assert line["correct"] is False
    assert line["checks"]["loss1_rel"]["value"] > line["checks"]["loss1_rel"]["limit"]


@pytest.mark.parametrize("workload", TRAIN)
def test_stale_batch_in_the_window(root, workload, monkeypatch):
    seed_of = train.step_seed
    traffic = Spec(workload, root).traffic
    window = traffic["check_steps"] + traffic["warm_steps"]
    monkeypatch.setattr(train, "step_seed", lambda seed, step, *s: seed_of(seed, min(step, window), *s))
    line = _run(root, workload)
    assert line["correct"] is False
    checks = line["checks"]
    assert all(checks[k]["value"] <= checks[k]["limit"] for k in checks if not k.startswith("replay_")), checks
    assert checks["replay_bn_rel"]["value"] > checks["replay_bn_rel"]["limit"]


@pytest.mark.parametrize("workload", SERVE)
def test_answer_altered_where_produced(root, workload, monkeypatch):
    call = serve.Predictor.__call__

    def altered(self, images):
        out = call(self, images)
        out["verts"] = out["verts"] + torch.tensor([0.01, 0.0, 0.0])
        return out

    monkeypatch.setattr(serve.Predictor, "__call__", altered)
    line = _run(root, workload)
    assert line["correct"] is False
    assert line["_info"]["numbers"]["verts_geo_m"] == pytest.approx(0.01, rel=1e-3)
