"""Device ms a step of the ViT blocks' fused add + LayerNorm kernels
(`csrc/vit_add_ln.cu`: the names holding `vit_add_ln_`, forward, backward
and the γ/β reduction) over the profiled stretch. Their names hold none of
the GEMM or attention keys, so `other_ms.hmr2` counts them too. None when
the stretch holds none."""

NAME = "vit_add_ln_"


def read(data):
    s = data["summary"]
    ms = [v for n, v in s["by_kernel_ms"].items() if NAME in n]
    return sum(ms) / s["units"] if ms else None
