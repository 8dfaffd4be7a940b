"""Render a dataset with the port's own generator and write it as `.npz`.

    python -m indirect_learning_pose_shape_tpu_torch.tools.make_synthetic_dataset out.npz \\
        --num 2048 [--size 320] [--seed 0] [--include-3d] [--include-verts3d] \\
        [--synthetic targets=hard ...] [--shards N] [--device cuda]

The file is the training and evaluation format of `--dataset`
(`data/dataset.py`: images, masks, kp2d, kp_vis, gt_pose, gt_betas);
`--include-3d` adds joints3d and rotmats for direct supervision,
`--include-verts3d` the vertices (verts3d, about 83 KB an example).
`--shards N` writes N shard files under OUT (a directory) for
`ShardedNpzDataset`. On the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="output .npz path, or a directory with --shards")
    ap.add_argument("--num", type=int, default=512, help="number of examples")
    ap.add_argument("--size", type=int, default=320, help="source resolution (training crops on the device)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--include-3d", action="store_true", help="store joints3d and rotmats")
    ap.add_argument("--include-verts3d", action="store_true", help="store the vertices (verts3d)")
    ap.add_argument("--synthetic", action="append", default=[], metavar="FIELD=VALUE",
                    help="override one generator field (repeatable), e.g. targets=hard")
    ap.add_argument("--shards", type=int, default=0,
                    help="split into this many shards under OUT (a directory); 0 writes one file")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    from indirect_learning_pose_shape_tpu_torch.data import dataset as ds
    from indirect_learning_pose_shape_tpu_torch.data import synthetic

    try:
        synth = synthetic.apply_overrides(synthetic.SyntheticConfig(), args.synthetic) if args.synthetic else None
    except (ValueError, NotImplementedError) as e:
        ap.error(str(e))
    kw = dict(source_size=args.size, seed=args.seed, include_3d=args.include_3d,
              include_verts3d=args.include_verts3d, synth=synth, device=args.device)
    if args.shards:
        os.makedirs(args.out, exist_ok=True)
        with tempfile.TemporaryDirectory() as tmp:
            src = os.path.join(tmp, "all.npz")
            ds.make_synthetic_dataset(src, args.num, **kw)
            paths = ds.shard_npz(src, args.out, -(-args.num // args.shards))
        print(f"wrote {args.num} examples in {len(paths)} shards under {args.out}")
    else:
        arrays = ds.make_synthetic_dataset(args.out, args.num, **kw)
        mb = sum(a.nbytes for a in arrays.values()) / 1e6
        print(f"wrote {args.num} examples ({mb:.1f} MB uncompressed, keys {sorted(arrays)}) to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
