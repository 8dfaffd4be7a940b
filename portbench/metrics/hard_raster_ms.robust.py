"""Device ms of one call of the port's hard raster as the robust stream makes
it, on a step's bodies, between CUDA events."""


def read(data):
    return data["extras"].get("hard_raster_ms")
