"""The raster forward kernel's share of its roofline (%): the least time of
its launches in the profiled stretch, from the work their bodies need
(`portbench/work/raster.py`), over the kernel's device time there."""

from portbench import trace


def read(data):
    ms, n = trace.kernel_ms(data["summary"], "raster_fwd_kernel")
    bound = data["extras"].get("bound_ms", {}).get("raster_fwd_kernel")
    return 100.0 * bound / ms if n and bound else None
