"""The share (%) of the bucket rows the profiled stretch's requests ran that
were padding: the port's counts `serve.padded_rows` over `serve.rows` plus
`serve.padded_rows`, made inside its spans `serve.request`
(`utils/tracing.py`). None for a program without them."""


def read(data):
    try:
        from indirect_learning_pose_shape_tpu_torch.utils import tracing
    except ImportError:
        return None
    reqs = tracing.units(tracing.last_units("serve.request", data["summary"]["units"]), "serve.request")
    rows = sum(u["counts"].get("serve.rows", 0) for u in reqs)
    padded = sum(u["counts"].get("serve.padded_rows", 0) for u in reqs)
    return 100.0 * padded / (rows + padded) if rows + padded else None
