"""Device ms a step of the attention kernels of `scaled_dot_product_attention`,
forward and backward, from the profiled stretch, found by name
(`portbench/work/vit.py`'s `ATTENTION_NAMES`: flash, fmha, sdpa, attention;
on the H100 the ViT's heads of 80 run cuDNN's SDPA, the head's FlashAttention
or cuDNN). None when the stretch holds none."""

from portbench.work import vit


def read(data):
    return vit.kind_ms(data["summary"], "attention")
