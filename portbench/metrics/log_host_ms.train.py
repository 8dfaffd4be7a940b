"""Host ms a step of the loop's logging spends on its own work (the JSONL
line, the TensorBoard event, the console line): the port's spans
`train.log` less their `train.log.readback` over the profiled stretch,
summed, over its steps (`utils/tracing.py`). The read-back is left out: it
waits for the steps still queued on the card, and so reads the device's
lead, not the host's cost. None for a program without the spans."""


def read(data):
    try:
        from indirect_learning_pose_shape_tpu_torch.utils import tracing
    except ImportError:
        return None
    stretch = tracing.last_units("train.step", data["summary"]["units"])
    steps = tracing.units(stretch, "train.step")
    if not steps:
        return None
    logs = tracing.units(stretch, "train.log")
    return sum(u["ms"]["train.log"] - u["ms"].get("train.log.readback", 0.0) for u in logs) / len(steps)
