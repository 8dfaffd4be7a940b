"""Training-data augmentation on the device (port of data/augment.py).

Mirror and crop jitter act on a raw disk batch before the on-device
crop/resize (`data/preprocess.py`):

- Horizontal mirror: flips the image and the label mask, maps each 2D
  keypoint's x to W - 1 - x, and swaps left/right identities in both label
  spaces: the keypoints (cocoplus-19, COCO-17 or LSP-14) and the body-part
  ids of the mask. A mirrored left hand is a right hand.
- Crop jitter: the mask-derived square box gets a random scale and a
  random shift of its centre.

The draws are split from their use: `sample_draws` takes every random
number of a batch from an explicit `torch.Generator` (flip ~ Bernoulli
(flip_prob), scale ~ U(1 - s, 1 + s), shift ~ U(-t, t)), and
`mirror_raw_batch` / `jitter_bboxes` are deterministic functions of those
draws. jax.random and torch give different numbers from the same seed, so
the tests hand the reference's own draws in. Flips are per sample; one
batch mixes flipped and unflipped items with no branch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# cocoplus-19 keypoint order: 0 R ankle, 1 R knee, 2 R hip, 3 L hip, 4 L knee,
# 5 L ankle, 6 R wrist, 7 R elbow, 8 R shoulder, 9 L shoulder, 10 L elbow,
# 11 L wrist, 12 neck, 13 head top, 14 nose, 15 L eye, 16 R eye, 17 L ear,
# 18 R ear.
_KP_SWAP = (5, 4, 3, 2, 1, 0, 11, 10, 9, 8, 7, 6, 12, 13, 14, 16, 15, 18, 17)

# COCO-17 order: 0 nose, 1 L eye, 2 R eye, 3 L ear, 4 R ear, 5 L shoulder,
# 6 R shoulder, 7 L elbow, 8 R elbow, 9 L wrist, 10 R wrist, 11 L hip,
# 12 R hip, 13 L knee, 14 R knee, 15 L ankle, 16 R ankle.
_KP_SWAP_COCO17 = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)

# Keypoint conventions by count. LSP-14 is the first 14 cocoplus entries, and
# the cocoplus swap table is closed under that prefix.
_KP_SWAPS = {
    19: _KP_SWAP,
    17: _KP_SWAP_COCO17,
    14: _KP_SWAP[:14],
}

# Left/right pairs of the 24 SMPL joints: hips, knees, ankles, feet, collars,
# shoulders, elbows, wrists, hands (0, 3, 6, 9, 12 and 15 are midline).
_SMPL_LR = ((1, 2), (4, 5), (7, 8), (10, 11), (13, 14), (16, 17), (18, 19), (20, 21), (22, 23))

# Part-mask conventions the mirror knows how to flip: their left/right pairs
# in mask-id space (id k+1 = SMPL joint k, 0 = background).
# - 'smpl24': the rendered label space, for any num_parts <= 24 (a pair with
#   a side out of range is dropped whole).
# - 's31-smpl-prefix': the 31-part synthetic layout (configs.CONFIG4_PARTS31):
#   ids 1-24 are the SMPL parts, 25-31 unoccupied and midline. Not a verified
#   UP-S31 palette: a real UP-S31 dataset declares its pairs ('custom').
# - 'custom': the pairs in AugmentConfig.part_lr_pairs.
# - 'none': no left/right structure; masks flip with ids unchanged.
_SMPL24_MASK_PAIRS = tuple((l + 1, r + 1) for l, r in _SMPL_LR)
_PART_CONVENTIONS = {
    "smpl24": _SMPL24_MASK_PAIRS,
    "s31-smpl-prefix": _SMPL24_MASK_PAIRS,
    "custom": None,
    "none": (),
}


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    enabled: bool = False
    flip_prob: float = 0.5
    # Crop-box jitter: size *= U(1-s, 1+s), centre += U(-t, t) * size.
    scale_jitter: float = 0.1
    trans_jitter: float = 0.05
    # The part mask's left/right convention (a key of _PART_CONVENTIONS);
    # unknown conventions and convention/num_parts mismatches are refused.
    part_convention: str = "smpl24"
    # The mask-id pairs of part_convention='custom'.
    part_lr_pairs: tuple = ()


def part_label_flip_perm(
    num_parts: int, convention: str = "smpl24", custom_pairs: tuple = ()
) -> np.ndarray:
    """The 256-entry label permutation that swaps left/right part ids (0,
    the background, fixed). Refuses unknown conventions and a convention
    that does not describe `num_parts`: a mirrored mask with its ids
    unswapped points every left label at the right side."""
    if convention not in _PART_CONVENTIONS:
        raise ValueError(
            f"unknown part-mask convention {convention!r}; known: "
            f"{sorted(_PART_CONVENTIONS)}. Declare the dataset's left/right "
            "id pairing (part_convention='custom' + part_lr_pairs) or "
            "disable flips (flip_prob=0)."
        )
    if convention == "smpl24" and num_parts > 24:
        raise ValueError(
            f"part_convention='smpl24' covers mask ids 1-24 but the run is "
            f"configured for {num_parts} parts: ids 25-{num_parts} have no "
            "declared left/right pairing and would flip sides with their "
            "labels unswapped. Use 's31-smpl-prefix' for the repo's 31-part "
            "synthetic layout, or 'custom' with explicit part_lr_pairs."
        )
    if convention == "s31-smpl-prefix" and num_parts != 31:
        raise ValueError(
            f"part_convention='s31-smpl-prefix' describes a 31-part label "
            f"space; the run is configured for {num_parts} parts."
        )
    pairs = custom_pairs if convention == "custom" else _PART_CONVENTIONS[convention]
    perm = np.arange(256, dtype=np.int32)
    for l, r in pairs:
        if convention == "custom" and not (0 < l <= num_parts and 0 < r <= num_parts):
            raise ValueError(
                f"part_lr_pairs entry ({l}, {r}) outside mask-id range "
                f"1..{num_parts} (0 is background and cannot be paired)"
            )
        if l <= num_parts and r <= num_parts:
            perm[l], perm[r] = r, l
    return perm


def kp_flip_perm(num_kp: int) -> np.ndarray:
    """The left/right keypoint permutation of cocoplus-19, COCO-17 or
    LSP-14; any other count is refused rather than guessed."""
    if num_kp not in _KP_SWAPS:
        raise ValueError(
            f"mirror augmentation knows the left/right pairings for "
            f"{sorted(_KP_SWAPS)} keypoints (cocoplus-19 / COCO-17 / "
            f"LSP-14); got {num_kp}. Extend _KP_SWAPS for this keypoint "
            "set or disable flips (flip_prob=0)."
        )
    return np.asarray(_KP_SWAPS[num_kp], dtype=np.int32)


def sample_draws(gen: torch.Generator, batch: int, cfg: AugmentConfig) -> dict[str, torch.Tensor]:
    """The augmentation draws of one batch, from `gen`, on its device:
    flip [B] bool (Bernoulli(flip_prob)), scale [B, 1] ~ U(1 - scale_jitter,
    1 + scale_jitter) and shift [B, 2] ~ U(-trans_jitter, trans_jitter)."""
    dev = gen.device
    flip = torch.rand(batch, generator=gen, device=dev) < cfg.flip_prob
    s, t = cfg.scale_jitter, cfg.trans_jitter
    scale = (1.0 - s) + 2.0 * s * torch.rand(batch, 1, generator=gen, device=dev)
    shift = -t + 2.0 * t * torch.rand(batch, 2, generator=gen, device=dev)
    return {"flip": flip, "scale": scale, "shift": shift}


# The mirror's tables on the device, built once per (num_parts, convention,
# pairs, keypoint count, device): a CUDA graph of a disk step cannot record
# the host copy that building them makes.
_TABLES: dict = {}


def _flip_tables(num_parts: int, cfg: AugmentConfig, num_kp: int, device: torch.device):
    """(part label permutation int32 [256], keypoint permutation int64 [K])
    on `device`."""
    key = (num_parts, cfg.part_convention, cfg.part_lr_pairs, num_kp, device)
    if key not in _TABLES:
        labels = part_label_flip_perm(num_parts, cfg.part_convention, cfg.part_lr_pairs)
        _TABLES[key] = (
            torch.as_tensor(labels, device=device),
            torch.as_tensor(kp_flip_perm(num_kp), device=device).long(),
        )
    return _TABLES[key]


def mirror_raw_batch(
    raw: dict, flip: torch.Tensor, cfg: AugmentConfig, num_parts: int = 24
) -> dict:
    """Mirror the samples of a raw batch where `flip` [B] is set.

    raw: images [B, H, W, 3] (any numeric dtype), masks [B, H, W] int,
    kp2d [B, K, 2] source pixels, kp_vis [B, K]. `num_parts` is the run's
    part-label space, which cfg.part_convention must describe. With
    flip_prob 0 the batch is returned as it is (no table is needed). Masks
    come back as int32, their ids < 256 (`dataset._check_mask_labels`)."""
    if cfg.flip_prob == 0.0:
        return raw
    dev = raw["images"].device
    W = raw["images"].shape[2]
    f3 = flip[:, None, None]
    images = torch.where(flip[:, None, None, None], raw["images"].flip(2), raw["images"])

    label_perm, kperm = _flip_tables(num_parts, cfg, raw["kp2d"].shape[1], dev)
    masks = raw["masks"].to(torch.int32)
    masks = torch.where(f3, label_perm[masks.flip(2).long()], masks)

    kp_m = raw["kp2d"][:, kperm]
    kp_m = torch.stack([W - 1.0 - kp_m[..., 0], kp_m[..., 1]], dim=-1)
    kp2d = torch.where(f3, kp_m, raw["kp2d"])
    kp_vis = torch.where(flip[:, None], raw["kp_vis"][:, kperm], raw["kp_vis"])
    return dict(raw, images=images, masks=masks, kp2d=kp2d, kp_vis=kp_vis)


def jitter_bboxes(bboxes: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """(cy, cx, size) boxes [B, 3] scaled by `scale` [B, 1] and their centres
    moved by `shift` [B, 2] times the original size."""
    size = bboxes[:, 2:3] * scale
    centre = bboxes[:, :2] + shift * bboxes[:, 2:3]
    return torch.cat([centre, size], dim=1)
