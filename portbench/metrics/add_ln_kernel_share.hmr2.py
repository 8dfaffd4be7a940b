"""The share (%) of the rows that the ViT blocks' fused add + LayerNorm op
normalised on its CUDA kernels, from the port's counters
`vit.tokens.add_ln.kernel` and `vit.tokens.add_ln.eager`
(`ops/kernels/vit_add_ln_cuda.py`) counted by the step's first call, the
eager warm-up and the CUDA graph's capture; `drivers/train_graph_vit.py` keeps them in
`extras["attn_calls"]` with the other `vit.tokens` counters. None for a
program that counts neither."""

KEYS = ("vit.tokens.add_ln.kernel", "vit.tokens.add_ln.eager")


def read(data):
    calls = data["extras"].get("attn_calls", {})
    kernel, eager = (calls.get(k, 0) for k in KEYS)
    return 100.0 * kernel / (kernel + eager) if kernel + eager else None
