"""Device ms a step of the "other" category (`portbench/trace.py`) less
cuBLAS's `nvjet_*` GEMMs and the attention kernels (`portbench/work/vit.py`'s
`kind` 'other'; `gemm_ms.hmr2` and `attn_ms.hmr2` read those): the
LayerNorms, GELUs, residual adds, weight casts, AdamW, clipping, the batch
and the losses, the SMPL and raster tail outside the LBS and raster kernels."""

from portbench.work import vit


def read(data):
    return vit.kind_ms(data["summary"], "other")
