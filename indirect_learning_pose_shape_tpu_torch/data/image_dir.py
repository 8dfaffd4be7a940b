"""Image-directory dataset (port of data/image_dir.py).

Layout (file per sample, as UP-3D-style datasets ship):

    root/
      images/<name>.(png|jpg)     RGB, any size per image
      masks/<name>.png            uint8 label mask (0 = background, > 0 = part id)
      keypoints.npz               kp2d [N, K, 2] float32 (source pixels),
                                  kp_vis [N, K], names [N] (the image stems)

Source images differ in size, so the step to fixed-size batches runs on the
host: the native preprocessor (`data/native_preprocess.py`) crops the square
box of each mask out of image and mask and resizes them to the model's
resolution, and `data/preprocess.transform_keypoints` moves the keypoints
by the same affine. Batches arrive ready for
`train.train_step`. PIL is imported where an image is read or written.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.data import augment as aug_lib
from indirect_learning_pose_shape_tpu_torch.data import native_preprocess as npp
from indirect_learning_pose_shape_tpu_torch.data import preprocess as pp


def _imread_rgb(path: str) -> np.ndarray:
    """[H, W, 3] uint8 (a grayscale image is broadcast)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _imread_mask(path: str) -> np.ndarray:
    """[H, W] uint8 with the ids kept: a paletted PNG (mode 'P') is read as
    its palette indices, which are the part ids, never converted."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.uint8)


class ImageDirDataset:
    """A file-per-sample dataset, preprocessed on the host in batches of
    {image, silhouette, part_labels, kp2d, kp_vis} at `image_size`.

    Epoch e's order is `RandomState((seed * 99991 + e) % 2**31)`'s
    permutation, the ragged tail dropped. With `augment` (an AugmentConfig
    with enabled=True) each sample is mirrored with probability flip_prob
    at source resolution before its box is derived, and the boxes are
    jittered, all drawn from `RandomState((seed * 7919 + step * 31 + 7) %
    2**31)`, so a resumed run replays them; the flip tables refuse label
    spaces they do not know, as on the device."""

    def __init__(
        self,
        root: str,
        batch_size: int,
        image_size: int,
        num_parts: int = 24,
        seed: int = 0,
        augment=None,
    ):
        self.root = root
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_parts = num_parts
        self.seed = seed
        self.augment = augment if (augment is not None and augment.enabled) else None

        img_dir = os.path.join(root, "images")
        files = os.listdir(img_dir)
        self.names = sorted(
            os.path.splitext(f)[0] for f in files if f.lower().endswith((".png", ".jpg", ".jpeg"))
        )
        self.image_paths = {os.path.splitext(f)[0]: os.path.join(img_dir, f) for f in files}
        with np.load(os.path.join(root, "keypoints.npz"), allow_pickle=True) as kp:
            kp_names = [str(n) for n in kp["names"]]
            kp2d, kp_vis = kp["kp2d"], kp["kp_vis"]  # each read once from the archive
        self.kp2d = dict(zip(kp_names, kp2d))
        self.kp_vis = dict(zip(kp_names, kp_vis))
        self.num_examples = len(self.names)
        if self.num_examples < batch_size:
            raise ValueError("dataset smaller than one batch")

    def steps_per_epoch(self) -> int:
        return self.num_examples // self.batch_size

    def _load_sample(self, name: str):
        image = _imread_rgb(self.image_paths[name])
        mask = _imread_mask(os.path.join(self.root, "masks", name + ".png"))
        return image, mask

    def _make_batch(self, names: list, rng=None) -> dict:
        aug = self.augment if rng is not None else None
        if aug is not None:
            label_perm = aug_lib.part_label_flip_perm(
                self.num_parts, aug.part_convention, aug.part_lr_pairs
            )
        images, masks, kps, viss = [], [], [], []
        for n in names:
            im, mk = self._load_sample(n)
            kp, vis = self.kp2d[n], self.kp_vis[n]
            if aug is not None and rng.rand() < aug.flip_prob:
                W = im.shape[1]
                kperm = aug_lib.kp_flip_perm(kp.shape[0])
                im = im[:, ::-1]
                mk = label_perm[mk[:, ::-1].astype(np.int32)].astype(mk.dtype)
                kp = kp[kperm].copy()
                kp[..., 0] = W - 1.0 - kp[..., 0]
                vis = vis[kperm]
            images.append(im)
            masks.append(mk)
            kps.append(kp)
            viss.append(vis)
        bboxes = np.stack([npp.bbox_from_mask(m) for m in masks])
        if aug is not None:  # augment.jitter_bboxes's law, on the host
            scale = rng.uniform(1.0 - aug.scale_jitter, 1.0 + aug.scale_jitter, (len(names), 1))
            shift = rng.uniform(-aug.trans_jitter, aug.trans_jitter, (len(names), 2))
            size = bboxes[:, 2:3] * scale
            centre = bboxes[:, :2] + shift * bboxes[:, 2:3]
            bboxes = np.concatenate([centre, size], axis=1).astype(bboxes.dtype)
        out_imgs = npp.crop_resize_normalize(images, bboxes, self.image_size)
        out_masks = npp.crop_resize_mask(masks, bboxes, self.image_size)
        return {
            "image": out_imgs,
            "silhouette": (out_masks > 0).astype(np.float32),
            "part_labels": np.minimum(out_masks.astype(np.int32), self.num_parts),
            "kp2d": pp.transform_keypoints(
                torch.from_numpy(np.stack(kps).astype(np.float32)), torch.from_numpy(bboxes), self.image_size
            ).numpy(),
            "kp_vis": np.stack(viss).astype(np.float32),
        }

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        """The endless preprocessed stream from global step `start_step`."""
        spe = self.steps_per_epoch()
        step = start_step
        epoch_idx, offset = divmod(start_step, spe)
        while True:
            rng = np.random.RandomState((self.seed * 99991 + epoch_idx) % (2**31))
            order = rng.permutation(self.num_examples)
            for i in range(offset, spe):
                idx = order[i * self.batch_size : (i + 1) * self.batch_size]
                aug_rng = None
                if self.augment is not None:
                    aug_rng = np.random.RandomState((self.seed * 7919 + step * 31 + 7) % (2**31))
                yield self._make_batch([self.names[j] for j in idx], rng=aug_rng)
                step += 1
            epoch_idx, offset = epoch_idx + 1, 0


def export_image_dir(arrays: dict, root: str) -> None:
    """Write an npz-style dict (images, masks, kp2d, kp_vis) as an image
    directory: sample_NNNNN.png images and masks and keypoints.npz."""
    from PIL import Image

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    os.makedirs(os.path.join(root, "masks"), exist_ok=True)
    names = []
    for i in range(len(arrays["images"])):
        name = f"sample_{i:05d}"
        names.append(name)
        Image.fromarray(arrays["images"][i]).save(os.path.join(root, "images", name + ".png"))
        Image.fromarray(arrays["masks"][i]).save(os.path.join(root, "masks", name + ".png"))
    np.savez(
        os.path.join(root, "keypoints.npz"),
        kp2d=arrays["kp2d"], kp_vis=arrays["kp_vis"], names=np.array(names),
    )
