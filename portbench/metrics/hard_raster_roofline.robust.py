"""The hard raster kernel's share of its roofline (%): the least time of the
stretch's hard rasters, from their bytes (`portbench/work/hard.py`), over
the kernel's device time there."""

from portbench import trace


def read(data):
    ms, n = trace.kernel_ms(data["summary"], "raster_hard_kernel")
    bound = data["extras"].get("bound_ms", {}).get("raster_hard_kernel")
    return 100.0 * bound / ms if n and bound else None
