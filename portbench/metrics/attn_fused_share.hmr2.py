"""The share (%) of `scaled_dot_product_attention` calls that took a fused
backend (flash, memory-efficient or cuDNN), from the port's counters
`attn.calls.<backend>` (`models/vit.py`) counted by the step's first call,
the eager warm-up and the CUDA graph's capture; the driver keeps them in
`extras["attn_calls"]`. None for a program that counts none."""

FUSED = ("attn.calls.flash_attention", "attn.calls.efficient_attention", "attn.calls.cudnn_attention")


def read(data):
    calls = {k: n for k, n in data["extras"].get("attn_calls", {}).items() if k.startswith("attn.calls.")}
    total = sum(calls.values())
    return 100.0 * sum(calls.get(k, 0) for k in FUSED) / total if total else None
