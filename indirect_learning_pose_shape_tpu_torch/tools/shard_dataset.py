"""Split a dataset `.npz` into `ShardedNpzDataset` shards.

    python -m indirect_learning_pose_shape_tpu_torch.tools.shard_dataset big.npz shards/ --shard-size 4096
    python -m indirect_learning_pose_shape_tpu_torch.train --dataset shards/

Every key of the source is sliced into `shard_NNNNN.npz` files of
`--shard-size` examples, one shard's slice in memory at a time.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", help="source .npz dataset")
    ap.add_argument("out_dir", help="directory for the shard files")
    ap.add_argument("--shard-size", type=int, default=4096, help="examples per shard")
    args = ap.parse_args(argv)

    from indirect_learning_pose_shape_tpu_torch.data.dataset import shard_npz

    paths = shard_npz(args.src, args.out_dir, args.shard_size)
    print(f"wrote {len(paths)} shards to {args.out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
