"""Mean host ms of a request's upload (`Predictor.__call__`'s pageable
`from_numpy(...).to(device)` of 128 crops): the port's span `serve.upload`
over the profiled stretch's requests (`utils/tracing.py`). None for a
program without the spans."""


def read(data):
    try:
        from indirect_learning_pose_shape_tpu_torch.utils import tracing
    except ImportError:
        return None
    reqs = tracing.units(tracing.last_units("serve.request", data["summary"]["units"]), "serve.request")
    return sum(u["ms"].get("serve.upload", 0.0) for u in reqs) / len(reqs) if reqs else None
