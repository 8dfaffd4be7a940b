"""Median host ms of a request outside its upload and graph launch (the
bucket choice, the staging into the bucket's buffer, the clones): the
port's span `serve.request` less its `serve.upload` and `graph.replay`,
over the profiled stretch's requests (`utils/tracing.py`). None for a
program without the spans."""

import statistics


def read(data):
    try:
        from indirect_learning_pose_shape_tpu_torch.utils import tracing
    except ImportError:
        return None
    reqs = tracing.units(tracing.last_units("serve.request", data["summary"]["units"]), "serve.request")
    if not reqs:
        return None
    return statistics.median(u["ms"]["serve.request"] - u["ms"].get("serve.upload", 0.0)
                             - u["ms"].get("graph.replay", 0.0) for u in reqs)
