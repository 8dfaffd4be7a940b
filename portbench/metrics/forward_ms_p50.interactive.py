"""Median ms of `Predictor.__call__` (upload, bucket graph replay, clones),
the benchmark's span around the call ended by a synchronize."""


def read(data):
    return data["extras"].get("forward_ms_p50")
