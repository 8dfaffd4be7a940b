"""Median host ms of `predict.render_silhouette` (its launches, no
synchronize): the port's span `serve.silhouette` over the profiled
stretch's requests (`utils/tracing.py`). None for a program without the
spans."""

import statistics


def read(data):
    try:
        from indirect_learning_pose_shape_tpu_torch.utils import tracing
    except ImportError:
        return None
    stretch = tracing.last_units("serve.request", data["summary"]["units"])
    sils = tracing.units(stretch, "serve.silhouette")
    return statistics.median(u["ms"]["serve.silhouette"] for u in sils) if sils else None
