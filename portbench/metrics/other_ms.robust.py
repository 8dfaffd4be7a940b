"""Device ms a step of every item outside conv/gemm, the raster and LBS
kernels and host-to-device copies (train-mode BatchNorm, elementwise work,
the losses, the batch, the update), from the profiled stretch."""


def read(data):
    return data["summary"]["by_category_ms"].get("other")
