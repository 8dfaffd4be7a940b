"""Export the preset's forward as a `torch.export` artifact (`.pt2` bytes).

Thin CLI over `export.py` (its docstring states what the artifact holds):

    python -m indirect_learning_pose_shape_tpu_torch.tools.export_model out.pt2 \\
        [--preset config4_full] [--checkpoint D [--ema]] [--pretrained enc.npz] \\
        [--batch 1] [--int8 [--int8-impl int8c|int8]] [--device cuda|cpu]

    # serving side:
    #   fn = export.load_exported(open("out.pt2", "rb").read())
    #   theta, verts, kp2d = fn(images)   # images [batch, S, S, 3] in [-1, 1]

`--int8` quantizes the encoder on 16 images of the preset's synthetic
stream (seed 17, as the reference's tool). The artifact is exported on
`--device` (the card by default) and runs there.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    from indirect_learning_pose_shape_tpu_torch import configs, export, predict
    from indirect_learning_pose_shape_tpu_torch.utils import assets
    from indirect_learning_pose_shape_tpu_torch.utils.precision import disable_tf32

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", help="output artifact path")
    ap.add_argument("--preset", default="config4_full", choices=sorted(configs.PRESETS))
    ap.add_argument("--checkpoint", default=None, help="a training run's checkpoint_dir")
    ap.add_argument("--ema", action="store_true", help="export the checkpoint's EMA parameters")
    ap.add_argument("--pretrained", default=None, help="backbone npz (tools/import_resnet_weights.py)")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--int8", action="store_true", help="export the int8-encoder forward")
    ap.add_argument("--int8-impl", default="int8c", choices=["int8", "int8c"],
                    help="'int8c' carried int8 activations (default) or 'int8' per site")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    disable_tf32()
    cfg = configs.PRESETS[args.preset]
    model, consts = predict.load_model(
        cfg.model, asset=assets.load_asset(), seed=cfg.seed, device=args.device, ema=args.ema,
        checkpoint_dir=args.checkpoint, pretrained=args.pretrained,
    )
    t0 = time.perf_counter()
    if args.int8:
        calib = predict.synthetic_images(consts, cfg.model, 16, seed=17, synthetic_cfg=cfg.synthetic)
        blob = export.export_forward_int8(
            cfg.model, model, consts, args.batch, calib, device=args.device, impl=args.int8_impl
        )
    else:
        blob = export.export_forward(cfg.model, model, consts, args.batch, device=args.device)
    with open(args.out, "wb") as f:
        f.write(blob)
    kind = f"int8 ({args.int8_impl})" if args.int8 else "float"
    print(f"wrote {args.out}: {len(blob) / 1e6:.1f} MB, {kind}, batch {args.batch}, "
          f"device {args.device}, {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
