"""Device ms a step of the GEMMs and convolutions (`portbench/work/vit.py`'s
`kind` 'gemm'): the "conv/gemm" category of `portbench/trace.py` (names
holding conv, gemm, xmma, cudnn or cutlass) and cuBLAS's Hopper GEMMs
(`nvjet_*`, which hold none of those keys and which the category leaves in
"other"), less the attention kernels, whose cuDNN and cutlass names the
category would take (`attn_ms.hmr2` reads those). The ViT's and the head's
bfloat16 GEMMs, the patch convolution, the float32 decoders."""

from portbench.work import vit


def read(data):
    return vit.kind_ms(data["summary"], "gemm")
