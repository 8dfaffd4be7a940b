"""Host ms a training step spends around its graph's launch (the reseed,
the stale check, `_advance`, the clones): the mean over the profiled
stretch's steps of the port's span `train.step` less its `graph.replay`
(`utils/tracing.py`). None for a program without the spans."""


def read(data):
    try:
        from indirect_learning_pose_shape_tpu_torch.utils import tracing
    except ImportError:
        return None
    steps = tracing.units(tracing.last_units("train.step", data["summary"]["units"]), "train.step")
    if not steps:
        return None
    return sum(u["ms"]["train.step"] - u["ms"].get("graph.replay", 0.0) for u in steps) / len(steps)
