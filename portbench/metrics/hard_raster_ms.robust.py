"""Device ms a step of the hard raster's kernel (`raster_hard_kernel`) inside
the robust step's graph, over the profiled stretch. The torch prologue that
prepares its face coefficients (`_face_coeffs`) runs generic kernels that
no name ties to the layer inside a graph, and is not counted."""

from portbench import trace


def read(data):
    ms, n = trace.kernel_ms(data["summary"], "raster_hard_kernel")
    return ms / data["summary"]["units"] if n else None
