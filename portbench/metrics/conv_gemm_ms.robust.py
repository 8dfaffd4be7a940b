"""Device ms a step of cuDNN convolutions and cuBLAS GEMMs (the encoder
and IEF), from the profiled stretch."""


def read(data):
    return data["summary"]["by_category_ms"].get("conv/gemm")
