"""Inference and demo entry point (port of predict.py).

`load_model` builds the network from a seed, from a converted-weights
`.npz` (keys and layouts of `Model.state_dict()`, as
`utils.convert.jax_to_state_dict` writes them) or from a training
checkpoint (the model, or its EMA), over an imported backbone when asked;
`predict` runs the eval forward, or the int8 encoder's with `qparams`
(models/quantize.py); `render_silhouette` renders the soft part raster of a
prediction. The writers are the reference's: `save_obj` (Wavefront mesh),
`shade_mesh` (a flat-shaded z-buffered numpy render) and `save_overlay`
(input with keypoints, soft silhouette, part map and shaded mesh as a PNG;
matplotlib is imported when it is called).

    python -m indirect_learning_pose_shape_tpu_torch.predict --demo --num 4 \\
        --int8 --qparams q.npz --out D [--device cpu]

runs the preset's model (`--checkpoint`, `--ema`, `--pretrained`) on
synthetic demo images (`--demo`), image files (`--image`, optional
`--mask`) or a dataset's first batch (`--dataset`), and writes
`overlay_<i>.png` and `mesh_<i>.obj` into `--out`. With `--int8` the encoder
is quantized on a calibration batch of the preset's synthetic stream (16
images, seed 999) and served as 'int8c'; `--qparams` reads that file, or
writes it after calibrating when it does not exist.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib
from indirect_learning_pose_shape_tpu_torch.utils import convert, tracing
from indirect_learning_pose_shape_tpu_torch.utils.checkpoint import Checkpointer


def load_model(
    cfg: net.ModelConfig,
    params_npz: Optional[str] = None,
    asset=None,
    seed: int = 0,
    device: torch.device | str = "cuda",
    ema: bool = False,
    checkpoint_dir: Optional[str] = None,
    step: Optional[int] = None,
    pretrained: Optional[str] = None,
) -> tuple[net.Model, net.ModelConsts]:
    """(model, consts) on `device` (the card unless the caller asks for the
    CPU; raises without one): a fresh init from `seed`, its encoder replaced
    by the backbone file `pretrained` when given
    (`models/pretrained.load_encoder`), then overwritten by the weights in
    `params_npz` when given (strict key and shape check), or by the model of
    checkpoint `step` (default: the latest) in `checkpoint_dir`. Only the
    model and the EMA are read, so the load does not depend on how the run's
    optimizer was built.

    ema=True serves the checkpoint's EMA parameters with its live BN
    statistics, and refuses a checkpoint written without an EMA."""
    asset = asset if asset is not None else assets_lib.load_asset()
    model, consts = net.init(asset, cfg, seed=seed, device=device)
    if pretrained:
        from indirect_learning_pose_shape_tpu_torch.models.pretrained import load_encoder

        load_encoder(model.encoder, pretrained)
    if params_npz:
        with np.load(params_npz) as z:
            convert.load_state_arrays(model, {k: z[k] for k in z.files})
    if checkpoint_dir:
        saved = Checkpointer(checkpoint_dir).restore_partial(
            ("model", "ema"), step, map_location=consts.smpl.v_template.device
        )
        model.load_state_dict(saved["model"])
        if ema:
            if saved["ema"] is None:
                raise ValueError(
                    f"checkpoint {checkpoint_dir!r} holds no EMA parameters (the run trained "
                    "with ema_decay=0): train with ema_decay > 0, or load without ema"
                )
            with torch.no_grad():
                for k, p in model.named_parameters():
                    p.copy_(saved["ema"][k])
    elif ema:
        raise ValueError("ema=True needs a checkpoint_dir (a live run's EMA model is train.ema_model)")
    return model, consts


def predict(
    model, consts, images, cfg: net.ModelConfig, qparams=None, int8_impl: str = "int8c"
) -> dict:
    """images [B, S, S, 3] in [-1, 1] -> outputs (verts, kp2d, theta, ...);
    with `qparams` through the int8 encoder run by `int8_impl` (the carried
    scheme by default, the reference's serving choice)."""
    with torch.inference_mode():
        if qparams is None:
            return net.forward(model, consts, images, cfg)
        from indirect_learning_pose_shape_tpu_torch.models import quantize as quant

        return quant.quantized_forward(qparams, model.ief, consts, images, cfg, int8_impl)


def render_silhouette(outputs: dict, consts, cfg: net.ModelConfig) -> dict:
    """Soft part probabilities and silhouette from predicted verts + camera
    (the span `serve.silhouette`, its parts `silhouette.project` and
    `silhouette.raster`: `utils/tracing.py`)."""
    with tracing.span("serve.silhouette", root=True):
        with tracing.span("silhouette.project"):
            verts2d = camera.project_pixel(outputs["verts"], outputs["cam"], cfg.image_size)
        with tracing.span("silhouette.raster"), torch.inference_mode():
            return raster.soft_rasterize(
                verts2d, consts.part_layout, cfg.raster, impl=cfg.raster_impl
            )


def synthetic_images(
    consts, cfg: net.ModelConfig, num: int, seed: int, synthetic_cfg=None
) -> torch.Tensor:
    """[num, S, S, 3] images of the port's synthetic stream (`synthetic_cfg`,
    the default stream when None) from a generator seeded `seed`, on the
    consts' device: the demo images (seed 0) and the int8 calibration batch
    (16 images, seed 999, the preset's stream), as the reference draws them."""
    from indirect_learning_pose_shape_tpu_torch.data import synthetic

    scfg = synthetic_cfg or synthetic.SyntheticConfig()
    gen = torch.Generator(device=consts.smpl.v_template.device).manual_seed(seed)
    draws = synthetic.sample_draws(gen, num, consts, scfg, cfg.image_size)
    with torch.no_grad():
        return synthetic.render_batch(draws, consts, cfg, scfg)["image"]


def load_image_files(image_paths: list, mask_paths: Optional[list], size: int) -> np.ndarray:
    """Image files -> [B, size, size, 3] float32 in [-1, 1].

    With masks, the person crop box comes from the mask's nonzero extent
    (exactly the training-data crop); without, a full-frame centre square.
    """
    from indirect_learning_pose_shape_tpu_torch.data import native_preprocess as npp
    from indirect_learning_pose_shape_tpu_torch.data.image_dir import _imread_mask, _imread_rgb

    imgs = [_imread_rgb(p) for p in image_paths]
    if mask_paths:
        if len(mask_paths) != len(image_paths):
            raise ValueError("--mask count must match --image count")
        bboxes = np.stack([npp.bbox_from_mask(_imread_mask(p)) for p in mask_paths])
    else:
        bboxes = np.stack(
            [
                np.array([im.shape[0] / 2.0, im.shape[1] / 2.0, max(im.shape[:2])], np.float32)
                for im in imgs
            ]
        )
    return npp.crop_resize_normalize(imgs, bboxes, size)


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Minimal Wavefront OBJ export of the predicted mesh."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def shade_mesh(
    verts2d: np.ndarray,
    verts_z: np.ndarray,
    faces: np.ndarray,
    size: int,
    light=(0.35, -0.5, 0.79),
) -> np.ndarray:
    """Flat-shaded, z-buffered numpy render of the projected mesh (Lambertian
    per triangle, the nearest face wins). Visualisation only. Returns
    [size, size] in [0, 1] (0 = background)."""
    v = np.concatenate(
        [np.asarray(verts2d, np.float32), np.asarray(verts_z, np.float32)[:, None]], axis=1
    )
    tri = v[np.asarray(faces, np.int64)]  # [F, 3, 3] (x_px, y_px, z)
    # Face normals from screen-space x/y and true z, turned toward the viewer.
    e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    n = np.cross(e1, e2)
    flip = n[:, 2] < 0
    n[flip] = -n[flip]
    norm = np.linalg.norm(n, axis=1)
    ok = norm > 1e-9
    n[ok] /= norm[ok, None]
    l = np.asarray(light, np.float32)
    l = l / np.linalg.norm(l)
    shade = 0.25 + 0.75 * np.clip(n @ l, 0.0, 1.0)

    img = np.zeros((size, size), np.float32)
    zbuf = np.full((size, size), -np.inf, np.float32)
    order = np.argsort(tri[:, :, 2].mean(axis=1))
    for f in order:
        if not ok[f]:
            continue
        t = tri[f]
        x0, x1 = int(np.floor(t[:, 0].min())), int(np.ceil(t[:, 0].max()))
        y0, y1 = int(np.floor(t[:, 1].min())), int(np.ceil(t[:, 1].max()))
        x0, y0 = max(x0, 0), max(y0, 0)
        x1, y1 = min(x1, size - 1), min(y1, size - 1)
        if x1 < x0 or y1 < y0:
            continue
        xs, ys = np.meshgrid(
            np.arange(x0, x1 + 1, dtype=np.float32),
            np.arange(y0, y1 + 1, dtype=np.float32),
        )
        d = (t[1, 0] - t[0, 0]) * (t[2, 1] - t[0, 1]) - (t[2, 0] - t[0, 0]) * (t[1, 1] - t[0, 1])
        if abs(d) < 1e-9:
            continue
        w1 = ((xs - t[0, 0]) * (t[2, 1] - t[0, 1]) - (t[2, 0] - t[0, 0]) * (ys - t[0, 1])) / d
        w2 = ((t[1, 0] - t[0, 0]) * (ys - t[0, 1]) - (xs - t[0, 0]) * (t[1, 1] - t[0, 1])) / d
        w0 = 1.0 - w1 - w2
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        z = w0 * t[0, 2] + w1 * t[1, 2] + w2 * t[2, 2]
        sub_z = zbuf[y0 : y1 + 1, x0 : x1 + 1]
        upd = inside & (z > sub_z)
        sub_z[upd] = z[upd]
        img[y0 : y1 + 1, x0 : x1 + 1][upd] = shade[f]
    return img


def save_overlay(path: str, image, silhouette, kp2d, part_map=None, shaded=None) -> None:
    """Input + keypoints, soft silhouette, and (optionally) part map and
    shaded mesh -> PNG."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img = np.asarray(image)
    img = (img + 1.0) / 2.0 if img.min() < 0 else img
    ncols = 2 + (part_map is not None) + (shaded is not None)
    fig, axes = plt.subplots(1, ncols, figsize=(4 * ncols, 4))
    axes[0].imshow(np.clip(img, 0, 1))
    axes[0].scatter(kp2d[:, 0], kp2d[:, 1], c="lime", s=12, marker="+")
    axes[0].set_title("input + predicted 2D keypoints")
    axes[1].imshow(np.clip(img, 0, 1))
    axes[1].imshow(np.asarray(silhouette), alpha=0.5, cmap="viridis")
    axes[1].set_title("predicted soft silhouette")
    col = 2
    if part_map is not None:
        axes[col].imshow(np.asarray(part_map), cmap="tab20", interpolation="nearest")
        axes[col].set_title("predicted body-part segmentation")
        col += 1
    if shaded is not None:
        axes[col].imshow(np.asarray(shaded), cmap="gray", vmin=0.0, vmax=1.0)
        axes[col].set_title("shaded predicted mesh")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _input_images(args, cfg, consts, device) -> torch.Tensor:
    size = cfg.model.image_size
    if args.image:
        images = load_image_files(args.image, args.mask, size)
    elif args.dataset:
        from indirect_learning_pose_shape_tpu_torch.data import native_preprocess as npp
        from indirect_learning_pose_shape_tpu_torch.data.dataset import NpzDataset

        raw = next(NpzDataset(args.dataset, batch_size=args.num).batches())
        bboxes = np.stack([npp.bbox_from_mask(m) for m in raw["masks"]])
        images = npp.crop_resize_normalize(list(raw["images"]), bboxes, size)
    else:  # the synthetic demo stream: no data needed
        return synthetic_images(consts, cfg.model, args.num, seed=0)
    return torch.from_numpy(images).to(device)


def main(argv=None) -> int:
    from indirect_learning_pose_shape_tpu_torch import configs
    from indirect_learning_pose_shape_tpu_torch.models import quantize as quant
    from indirect_learning_pose_shape_tpu_torch.utils.precision import disable_tf32

    ap = argparse.ArgumentParser(description="Predict meshes, keypoints and silhouettes; write overlays.")
    ap.add_argument("--preset", default="config4_full", choices=sorted(configs.PRESETS))
    ap.add_argument("--checkpoint", default=None, help="a training run's checkpoint_dir")
    ap.add_argument("--dataset", default=None, help=".npz dataset to read the first batch from")
    ap.add_argument("--image", nargs="+", default=None,
                    help="image file(s); cropped from --mask when given, else a full-frame centre square")
    ap.add_argument("--mask", nargs="+", default=None,
                    help="silhouette or part mask PNG(s), one per --image, for the person crop box")
    ap.add_argument("--demo", action="store_true", help="use synthetic demo images (the default source)")
    ap.add_argument("--num", type=int, default=2, help="images to process")
    ap.add_argument("--out", default="ilps_vis", help="output directory")
    ap.add_argument("--pretrained", default=None,
                    help="backbone npz from tools/import_resnet_weights.py (under --checkpoint's weights)")
    ap.add_argument("--int8", action="store_true",
                    help="predict through the int8 encoder, calibrated on a synthetic batch")
    ap.add_argument("--qparams", default=None,
                    help="quantized encoder .npz (implies --int8): read when it exists, else written "
                    "after calibration")
    ap.add_argument("--ema", action="store_true", help="serve the checkpoint's EMA parameters")
    ap.add_argument("--no-overlays", action="store_true", help="write the meshes only (no matplotlib)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.image and args.dataset:
        ap.error("--image and --dataset are two image sources: give one")

    disable_tf32()
    cfg = configs.PRESETS[args.preset]
    asset = assets_lib.load_asset()
    model, consts = load_model(
        cfg.model, asset=asset, seed=cfg.seed, device=args.device, ema=args.ema,
        checkpoint_dir=args.checkpoint, pretrained=args.pretrained,
    )
    size = cfg.model.image_size
    images = _input_images(args, cfg, consts, consts.smpl.v_template.device)

    qparams = None
    if args.int8 or args.qparams:
        if args.qparams and os.path.exists(args.qparams):
            qparams = quant.load_qparams(args.qparams)
        else:
            from indirect_learning_pose_shape_tpu_torch.evaluate import int8_qparams

            qparams = int8_qparams(model, consts, cfg)
            if args.qparams:
                quant.save_qparams(args.qparams, qparams)
                print(f"wrote quantized encoder to {args.qparams}")
    outputs = predict(model, consts, images, cfg.model, qparams=qparams)
    rendered = render_silhouette(outputs, consts, cfg.model)

    os.makedirs(args.out, exist_ok=True)
    verts = outputs["verts"].cpu().numpy()
    kp2d = outputs["kp2d"].cpu().numpy()
    sil = rendered["silhouette"].cpu().numpy()
    parts = torch.argmax(rendered["probs"], dim=-1).cpu().numpy()
    verts2d = camera.project_pixel(outputs["verts"], outputs["cam"], size).cpu().numpy()
    host_images = images.cpu().numpy()
    for i in range(len(host_images)):
        save_obj(os.path.join(args.out, f"mesh_{i}.obj"), verts[i], asset.faces)
        if not args.no_overlays:
            save_overlay(
                os.path.join(args.out, f"overlay_{i}.png"), host_images[i], sil[i], kp2d[i], parts[i],
                shaded=shade_mesh(verts2d[i], verts[i][:, 2], asset.faces, size),
            )
    what = "meshes" if args.no_overlays else "overlays + meshes"
    print(f"wrote {len(host_images)} {what} to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
