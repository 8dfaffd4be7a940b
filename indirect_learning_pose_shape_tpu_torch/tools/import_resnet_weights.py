"""Convert a torchvision ResNet checkpoint to a `--pretrained` npz.

Thin CLI over `models/pretrained.py` (the mapping and the file format; the
file is the reference's, so either package reads it). No network access is
needed: fetch the .pth elsewhere, convert once, ship the npz.

    python -m indirect_learning_pose_shape_tpu_torch.tools.import_resnet_weights \\
        resnet18.pth enc18.npz --depth 18
    python -m indirect_learning_pose_shape_tpu_torch.train --pretrained enc18.npz
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.models.pretrained import (
    map_state_dict,
    save_encoder_npz,
    verify_against_init,
)


def load_torch_state_dict(path: str) -> dict:
    """A .pth state dict (or a module, or {'state_dict': ...}) as numpy,
    read with `weights_only=True`."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if "state_dict" in obj and isinstance(obj["state_dict"], dict):
        obj = obj["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="torchvision ResNet checkpoint (.pth) or .npz state dict")
    ap.add_argument("out", help="output .npz for --pretrained")
    ap.add_argument("--depth", type=int, default=18, choices=(18, 34, 50))
    args = ap.parse_args(argv)

    if args.src.endswith(".npz"):
        with np.load(args.src) as z:
            sd = {k: z[k] for k in z.files}
    else:
        sd = load_torch_state_dict(args.src)
    params, state = map_state_dict(sd, args.depth)
    verify_against_init(params, state, args.depth)
    save_encoder_npz(args.out, params, state, args.depth)
    n = sum(int(np.prod(v.shape)) for v in sd.values())
    print(f"wrote {args.out}: depth {args.depth}, {n:,} source params mapped")
    return 0


if __name__ == "__main__":
    sys.exit(main())
