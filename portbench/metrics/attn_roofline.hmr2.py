"""Attention's share of its roofline (%): the FLOPs the step's attention
needs (`portbench/work/vit.py`: 4·Nq·Nk·d a head forward, twice that
backward, over the ViT's and the head's attentions at the cell's batch) at
989 TFLOP/s bfloat16, over the device time of the attention kernels a step
(`attn_ms.hmr2`'s). Bound by operations: at 192 tokens a head's q, k, v and
output are read and written once in far less time."""

from portbench import work
from portbench.work import vit


def read(data):
    ms = vit.kind_ms(data["summary"], "attention")
    flops = data["extras"].get("attn_flops_per_step")
    return 100.0 * flops / work.BF16_FLOP_PER_S * 1e3 / ms if ms and flops else None
