"""On-device synthetic training data (port of data/synthetic.py).

Ground-truth Θ = (pose, betas, camera) is sampled, posed by SMPL (the LBS
kernel on the card) and projected. The targets come from one of two
renderers, as in the reference: `targets='soft'` derives the part labels,
the silhouette and the input image from the soft raster's class scores (the
raster forward kernel on the card); `targets='hard'` renders them with the
z-buffered triangle raster of the asset's faces (`ops/raster_hard.py`, plain
PyTorch) and paints the image from the hard labels. Appearance
randomisation (textured or noise backgrounds, per-sample palette jitter,
flat shading under a random light, occluder rectangles over the image only)
changes the image, never the targets.

Sampling and rendering are split: `sample_draws` takes every random number
from an explicit `torch.Generator`, and `render_batch` is a deterministic
function of those draws. jax.random and torch give different numbers from
the same seed, so the tests hand the reference's own draws to
`render_batch` and compare the batches. The appearance draws come after the
others and only when their knob is on, so the stream with every knob off
is the one earlier versions drew.

Under a mesh (`parallel/`), `train.make_batch` draws the global batch,
keeps this rank's rows (`shard_draws`) and renders them; under a render axis
`render_batch(rows=...)` renders the targets and the image for its band of
image rows only, keeps the targets as that band (the losses read them so),
and gathers the image's rows over the render group for the encoder.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import smpl as smpl_mod
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster, raster_hard

TARGETS = ("soft", "hard")
BG_MODES = ("none", "noise", "texture")
_LIGHT = (0.35, -0.5, 0.79)  # the mean light direction of the shading
_TEXTURE_CELLS = 8  # the texture background's low-resolution field, per side


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    pose_std: float = 0.25  # axis-angle std for body joints
    global_std: float = 0.15  # std for global orientation
    shape_std: float = 1.0
    cam_scale_range: tuple = (0.7, 1.1)
    cam_trans_std: float = 0.08
    image_noise: float = 0.05
    kp_visibility: float = 0.9  # fraction of keypoints marked visible
    targets: str = "soft"  # 'soft' (soft-raster scores) | 'hard' (z-buffered faces)
    bg_mode: str = "none"  # 'none' (palette colour) | 'noise' | 'texture'
    color_jitter: float = 0.0  # per-sample, per-part palette noise std
    shading: float = 0.0  # flat-shading strength in [0, 1]; needs targets='hard'
    occluders: int = 0  # random rectangles painted over the image only
    occluder_size: float = 0.25  # largest half-size, a fraction of the image
    # Faces per tile of the hard raster (its culled mode); 0 = every face in
    # every tile (exact). Faces past the budget are dropped and counted in the
    # batch's `hard_overflow`.
    hard_k_faces: int = 0

    def __post_init__(self):
        if self.targets not in TARGETS:
            raise ValueError(f"targets must be one of {TARGETS}, got {self.targets!r}")
        if self.bg_mode not in BG_MODES:
            raise ValueError(f"bg_mode must be one of {BG_MODES}, got {self.bg_mode!r}")


# The reference's fixed part palette is `jax.random.uniform(PRNGKey(1234),
# (n, 3), 0.15, 1.0)` with row 0 (background) set to (0.05, 0.05, 0.08).
# torch cannot reproduce jax.random, so `part_palette` computes the same
# numbers in numpy: JAX's partitionable threefry2x32 (element i of the draw
# is threefry2x32(key, (0, i)), its two words xor-ed), the top 23 bits made
# a float in [1, 2) less 1, then f · 0.85 + 0.15 rounded once, as XLA's fused
# multiply-add on the CPU rounds it. Every row is thus a prefix of one
# sequence, for any channel count. A test pins it to the reference's
# `_part_palette`.
_PALETTE_KEY = (0, 1234)  # PRNGKey(1234): (seed >> 32, seed & 0xFFFFFFFF)
_PALETTE_RANGE = (0.15, 1.0)
_PALETTE_BACKGROUND = (0.05, 0.05, 0.08)
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key: tuple, x0: np.ndarray, x1: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as `jax.random`
    computes it, on uint32 arrays."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in _THREEFRY_ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


# Named eval distributions (the reference's `EVAL_SUITES`): 'plain' is the
# default stream, 'hard' its z-buffered targets, 'hardapp' those with every
# appearance knob on.
EVAL_SUITES = {
    "plain": (),
    "hard": ("targets=hard",),
    "hardapp": (
        "targets=hard",
        "bg_mode=texture",
        "color_jitter=0.08",
        "shading=0.6",
        "occluders=2",
    ),
}


def apply_overrides(cfg: SyntheticConfig, specs) -> SyntheticConfig:
    """`cfg` with CLI ``FIELD=VALUE`` overrides applied (the reference's
    `apply_overrides`): unknown fields and unparsable values raise
    ValueError, and `cam_scale_range` parses as ``lo,hi``."""
    valid = {f.name for f in dataclasses.fields(SyntheticConfig)}
    choices = {"targets": TARGETS, "bg_mode": BG_MODES}
    updates = {}
    for spec in specs:
        name, sep, value = spec.partition("=")
        if not sep or name not in valid:
            raise ValueError(
                f"synthetic override {spec!r}: expected FIELD=VALUE with FIELD among {sorted(valid)}"
            )
        try:
            if name == "cam_scale_range":
                parts = value.split(",")
                if len(parts) != 2:
                    raise ValueError("takes LO,HI (e.g. cam_scale_range=0.5,1.3)")
                updates[name] = (float(parts[0]), float(parts[1]))
            elif name in choices:
                if value not in choices[name]:
                    raise ValueError(f"takes one of {choices[name]}")
                updates[name] = value
            elif name in ("occluders", "hard_k_faces"):
                updates[name] = int(value)
            else:
                updates[name] = float(value)
        except ValueError as e:
            raise ValueError(f"synthetic override {spec!r}: {e}") from None
    return dataclasses.replace(cfg, **updates)


def part_palette(num_channels: int) -> np.ndarray:
    """[num_channels, 3] float32 RGB per channel (0 = background, dark): the
    reference's `_part_palette(num_channels)`, bitwise."""
    if num_channels < 2:
        raise ValueError(
            f"a part palette has the background and at least one part, not {num_channels} channels"
        )
    i = np.arange(num_channels * 3, dtype=np.uint32)
    hi, lo = _threefry2x32(_PALETTE_KEY, np.zeros_like(i), i)
    unit = (((hi ^ lo) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    a, b = (np.float32(v) for v in _PALETTE_RANGE)
    # f · (b - a) + a is exact in float64 (at most 47 significant bits), so
    # one rounding to float32 is the fused multiply-add's.
    colors = (unit.astype(np.float64) * np.float64(b - a) + np.float64(a)).astype(np.float32)
    colors = np.maximum(a, colors).reshape(num_channels, 3)
    colors[0] = _PALETTE_BACKGROUND
    return colors


# The stream's constants on a device, made once per device and never
# written: a batch made on the card then copies nothing from the host, which
# is what lets a CUDA graph record it.
@functools.cache
def _device_palette(device: torch.device, num_channels: int) -> torch.Tensor:
    return torch.as_tensor(part_palette(num_channels), device=device)


@functools.cache
def _device_light(device: torch.device) -> torch.Tensor:
    return torch.tensor(_LIGHT, device=device)


def sample_draws(
    gen: torch.Generator,
    batch: int,
    consts: net.ModelConsts,
    cfg: SyntheticConfig,
    image_size: int,
) -> dict[str, torch.Tensor]:
    """Every random number of one batch, from `gen`, on `gen`'s device:
    pose [B, J*3] (global orientation in the first 3), betas [B, num_betas],
    cam [B, 3] (scale, tx, ty), noise [B, S, S, 3] standard normal, and
    vis_u [B, K] uniform, the keypoint dropout draws; then, each only when
    its knob is on:

      pal_noise   [B, C+1, 3]  color_jitter · N(0, 1), added to the palette
      bg_low      [B, 8, 8, 3] and bg_grain [B, S, S, 3] uniform (texture)
      bg_noise    [B, S, S, 3] uniform (noise background)
      light       [B, 3]       the shading's light, (0.35, -0.5, 0.79) + 0.6 · N(0, 1)
      occ_centre  [n, B, 2]    each occluder's centre (x, y), uniform on [0, S)
      occ_half    [n, B, 2]    its half-size, uniform on [0.04 S, occluder_size · S)
      occ_color   [n, B, 3]    its colour, uniform
    """
    dev = gen.device
    J = consts.smpl.num_joints
    K = consts.smpl.cocoplus_regressor.shape[0]

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    pose = cfg.pose_std * normal(batch, J * 3)
    pose[:, :3] = cfg.global_std * normal(batch, 3)
    betas = cfg.shape_std * normal(batch, consts.smpl.num_betas)
    lo, hi = cfg.cam_scale_range
    scale = lo + (hi - lo) * uniform(batch, 1)
    trans = cfg.cam_trans_std * normal(batch, 2)
    draws = {
        "pose": pose,
        "betas": betas,
        "cam": torch.cat([scale, trans], dim=1),
        "noise": normal(batch, image_size, image_size, 3),
        "vis_u": uniform(batch, K),
    }
    S = image_size
    if cfg.color_jitter:
        draws["pal_noise"] = cfg.color_jitter * normal(batch, consts.part_layout.num_parts + 1, 3)
    if cfg.bg_mode == "texture":
        draws["bg_low"] = uniform(batch, _TEXTURE_CELLS, _TEXTURE_CELLS, 3)
        draws["bg_grain"] = uniform(batch, S, S, 3)
    elif cfg.bg_mode == "noise":
        draws["bg_noise"] = uniform(batch, S, S, 3)
    if cfg.shading:
        draws["light"] = _device_light(dev) + 0.6 * normal(batch, 3)
    if cfg.occluders:
        occ = [
            (S * uniform(batch, 2),
             0.04 * S + (cfg.occluder_size - 0.04) * S * uniform(batch, 2),
             uniform(batch, 3))
            for _ in range(cfg.occluders)
        ]
        for i, key in enumerate(("occ_centre", "occ_half", "occ_color")):
            draws[key] = torch.stack([o[i] for o in occ])
    return draws


def shard_draws(draws: dict[str, torch.Tensor], rows: slice) -> dict[str, torch.Tensor]:
    """The draws of the batch rows `rows` (the occluders' draws carry the
    batch in their second dimension)."""
    return {k: v[:, rows] if k.startswith("occ_") else v[rows] for k, v in draws.items()}


def _background(draws: dict, mode: str, size: int) -> torch.Tensor | None:
    """The background image [B, S, S, 3] in [0, 1], or None for 'none':
    'noise' is i.i.d. per-pixel colour; 'texture' the 8x8 field upsampled
    bilinearly (half-pixel centres, edges clamped: `jax.image.resize`'s
    'bilinear' when enlarging) under 0.8, plus 0.2 of per-pixel grain."""
    if mode == "none":
        return None
    if mode == "noise":
        return draws["bg_noise"]
    low = F.interpolate(
        draws["bg_low"].permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
        align_corners=False, antialias=False,
    ).permute(0, 2, 3, 1)
    return torch.clamp(0.8 * low + 0.2 * draws["bg_grain"], 0.0, 1.0)


def _paint_occluders(draws: dict, image: torch.Tensor, cfg: SyntheticConfig, y0: int = 0) -> torch.Tensor:
    """Paint the occluder rectangles over the image (only: the targets keep
    labelling the whole body, as a dataset's annotations do). `image` holds
    the rows from `y0` on."""
    h, size = image.shape[1], image.shape[2]
    coords = torch.arange(size, dtype=torch.float32, device=image.device)
    ys = torch.arange(y0, y0 + h, dtype=torch.float32, device=image.device)
    for i in range(cfg.occluders):
        centre, half = draws["occ_centre"][i], draws["occ_half"][i]
        in_x = torch.abs(coords[None, :] - centre[:, 0:1]) < half[:, 0:1]  # [B, S]
        in_y = torch.abs(ys[None, :] - centre[:, 1:2]) < half[:, 1:2]  # [B, h]
        mask = (in_y[:, :, None] & in_x[:, None, :])[..., None]  # [B, h, S, 1]
        image = torch.where(mask, draws["occ_color"][i][:, None, None, :], image)
    return image


@torch.no_grad()
def render_batch(
    draws: dict[str, torch.Tensor],
    consts: net.ModelConsts,
    model_cfg: net.ModelConfig,
    cfg: SyntheticConfig,
    include_3d: bool = False,
    rows=None,
) -> dict[str, torch.Tensor]:
    """One batch from `draws` (see `sample_draws`), on their device:

      image       [B, S, S, 3] float32 in [-1, 1]
      silhouette  [B, S, S]    float32 target silhouette (0/1)
      part_labels [B, S, S]    int32 target class map (0 = background)
      kp2d        [B, K, 2]    pixel keypoints
      kp_vis      [B, K]       visibility mask
      gt_pose / gt_betas / gt_cam (recovery diagnostics)
      gt_joints3d [B, J, 3], gt_verts [B, V, 3], gt_rotmats [B, J, 3, 3]
                  (the direct-supervision targets, with include_3d)
      hard_overflow []         int32, faces the hard raster's culling
                  dropped (targets='hard' with hard_k_faces)

    Soft targets: the target render is stored as bf16, as the reference's
    target path (on the separable impl at matmul_precision 'default');
    labels are argmaxes and thresholds of those scores, and the image is the
    bf16 palette mix summed in float32 over the background colour. Hard
    targets: the hard raster's labels and silhouette, and the image is the
    palette colour of each label (times the shade) over the background.

    With `rows` (parallel/render_sp.Rows) silhouette and part_labels are
    this rank's band of rows [B, S/n, S], and the image, composed band by
    band, is gathered whole over the render group.
    """
    if cfg.shading and cfg.targets != "hard":
        raise ValueError(
            "synthetic shading needs face normals, which only the hard z-buffer "
            "renderer computes: set targets=hard with shading"
        )
    size = model_cfg.image_size
    pose, betas, cam = draws["pose"], draws["betas"], draws["cam"]
    B = pose.shape[0]
    smpl_out = smpl_mod.smpl_forward(consts.smpl, pose, betas, impl=model_cfg.smpl_impl)
    verts2d = camera.project_pixel(smpl_out["verts"], cam, size)
    kp2d = camera.project_pixel(smpl_out["kp3d"], cam, size)

    palette = _device_palette(pose.device, model_cfg.raster.num_parts + 1)
    if cfg.color_jitter:
        palette = torch.clamp(palette + draws["pal_noise"], 0.0, 1.0)  # [B, C+1, 3]
    else:
        palette = palette.expand(B, *palette.shape)
    bg_px = _background(draws, cfg.bg_mode, size)
    band = slice(0, size) if rows is None else rows.band(size)
    h = band.stop - band.start
    if bg_px is not None:
        bg_px = bg_px[:, band]
    extra = {}

    if cfg.targets == "hard":
        hr = raster_hard.hard_raster(
            verts2d, smpl_out["verts"][..., 2], consts.hard, size,
            k_faces=cfg.hard_k_faces or None, with_shade=cfg.shading > 0,
            light=draws["light"] if cfg.shading else None, rows=rows,
        )
        part_labels, silhouette = hr["part_labels"], hr["silhouette"]
        if cfg.hard_k_faces:
            extra["hard_overflow"] = hr["overflow"]
        idx = part_labels.reshape(B, -1, 1).long().expand(-1, -1, 3)
        rgb = torch.gather(palette, 1, idx).reshape(B, h, size, 3)
        fg = silhouette[..., None] > 0
        if cfg.shading:
            lit = 1.0 - cfg.shading + cfg.shading * hr["shade"][..., None]
            rgb = torch.where(fg, rgb * lit, rgb)
        if bg_px is not None:
            rgb = torch.where(fg, rgb, bg_px)
        image = rgb
    else:
        target_raster = dataclasses.replace(model_cfg.raster, matmul_precision="default")
        score = raster.raster_scores_cf(
            verts2d, consts.part_layout, target_raster, impl=model_cfg.raster_impl,
            out_dtype=torch.bfloat16, rows=rows,
        )  # [B, C, h, S]
        bg = float(model_cfg.raster.bg_gamma)
        s_total = torch.sum(score, dim=1, dtype=torch.float32)
        best = torch.argmax(score, dim=1).to(torch.int32)
        mx = torch.amax(score, dim=1).float()
        part_labels = torch.where(mx > bg, best + 1, 0).to(torch.int32)
        silhouette = (s_total > bg).float()

        pal = palette[:, 1:].to(score.dtype)  # [B, C, 3]
        mix = torch.sum(
            score[:, :, :, :, None] * pal[:, :, None, None, :], dim=1, dtype=torch.float32
        )  # [B, S, S, 3]
        bg_rgb = bg_px if bg_px is not None else palette[:, 0][:, None, None, :]
        image = (bg * bg_rgb + mix) / (bg + s_total)[..., None]

    image = _paint_occluders(draws, image, cfg, band.start)
    image = image + cfg.image_noise * draws["noise"][:, band]
    image = torch.clamp(image, 0.0, 1.0) * 2.0 - 1.0
    if rows is not None:
        image = rows.gather(image, dim=1)

    # Keypoints projected outside the crop are invisible, on top of the
    # random dropout.
    in_crop = torch.all((kp2d >= 0.0) & (kp2d <= size - 1.0), dim=-1)
    kp_vis = (in_crop & (draws["vis_u"] < cfg.kp_visibility)).float()
    out = {
        "image": image,
        "silhouette": silhouette,
        "part_labels": part_labels,
        "kp2d": kp2d,
        "kp_vis": kp_vis,
        "gt_pose": pose,
        "gt_betas": betas,
        "gt_cam": cam,
        **extra,
    }
    if include_3d:
        J = consts.smpl.num_joints
        out["gt_joints3d"] = smpl_out["joints"]
        out["gt_verts"] = smpl_out["verts"]
        # The stream samples axis-angle; rotation matrices are the target a
        # rot6d head can be supervised with.
        out["gt_rotmats"] = smpl_mod.batch_rodrigues(pose.reshape(B, J, 3))
    return out
