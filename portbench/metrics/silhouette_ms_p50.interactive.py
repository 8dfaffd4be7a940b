"""Median ms of `predict.render_silhouette` (eager projection and raster
forward), the benchmark's span around the call ended by a synchronize."""


def read(data):
    return data["extras"].get("silhouette_ms_p50")
