"""Where the port's entry points run.

Entry points (`predict.load_model`, `network.init`, `train.init_state`,
`train.fit`, the `train` CLI) run on the card unless the caller asks for the
CPU: their `device` defaults to "cuda", and without a CUDA device they raise
instead of carrying on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device: torch.device | str = "cuda") -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and none exists."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
