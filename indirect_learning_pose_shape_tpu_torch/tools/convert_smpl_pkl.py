"""One-time SMPL asset conversion: a chumpy-era .pkl -> the .npz the port loads.

    python -m indirect_learning_pose_shape_tpu_torch.tools.convert_smpl_pkl in.pkl smpl_neutral.npz

`utils/assets.load_pkl` unpickles the original model file without chumpy
installed; `utils/assets.save_npz` writes the plain-numpy file (the
reference's format).
"""

from __future__ import annotations

import argparse
import os
import sys

from indirect_learning_pose_shape_tpu_torch.utils import assets


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("pkl_path")
    ap.add_argument("npz_path")
    args = ap.parse_args(argv)
    asset = assets.load_pkl(args.pkl_path)
    asset.validate()
    os.makedirs(os.path.dirname(os.path.abspath(args.npz_path)), exist_ok=True)
    assets.save_npz(asset, args.npz_path)
    print(
        f"converted {args.pkl_path} -> {args.npz_path}: "
        f"V={asset.num_verts} J={asset.num_joints} betas={asset.num_betas}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
