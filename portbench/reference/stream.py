"""The synthetic training stream, recomputed from the seed in plain PyTorch.

A step's batch is drawn from a generator on the card seeded by a hash of
(seed, step), in the order and shapes of the port's stream, so the same
seed gives the same draws on both sides; everything after the draws (SMPL,
projection, the target render, the appearance) is recomputed here:

- soft targets: the exact soft raster's float32 scores rounded to
  bfloat16; labels are the argmax where the largest score beats the
  background strength γ, the silhouette is Σ score > γ, and the image the
  palette mixed by the bfloat16 scores (products in bfloat16, sums in
  float32) over the background colour, divided by γ + Σ score;
- hard targets: the z-buffered raster's labels and silhouette, the image the
  palette colour of each label times the flat shade, over a bilinear 8x8
  texture plus grain, with the occluder rectangles painted over it;
- then Gaussian pixel noise, clipped to [0, 1] and mapped to [-1, 1], and
  keypoint visibility (inside the crop and a uniform draw under 0.9).

The part palette is the reference package's: `jax.random.uniform(PRNGKey(1234))`
computed in numpy (threefry-2x32).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import body as body_lib
from portbench.reference import hard as hard_lib
from portbench.reference import raster as raster_lib
from portbench.reference.precision import Precision

_LIGHT = (0.35, -0.5, 0.79)
_TEXTURE_CELLS = 8


@dataclasses.dataclass(frozen=True)
class Stream:
    """The stream's knobs (the port's `SyntheticConfig` fields)."""

    pose_std: float = 0.25
    global_std: float = 0.15
    shape_std: float = 1.0
    cam_scale_range: tuple = (0.7, 1.1)
    cam_trans_std: float = 0.08
    image_noise: float = 0.05
    kp_visibility: float = 0.9
    targets: str = "soft"
    bg_mode: str = "none"
    color_jitter: float = 0.0
    shading: float = 0.0
    occluders: int = 0
    occluder_size: float = 0.25
    hard_k_faces: int = 0


def step_seed(seed: int, step: int) -> int:
    return int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0] >> 1)


def _threefry2x32(key, x0, x1):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        x0, x1 = x0 + ks[0], x1 + ks[1]
        for i in range(5):
            for r in rot[i % 2]:
                x0 = x0 + x1
                x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def palette(num_channels: int) -> np.ndarray:
    """[num_channels, 3]: uniform(0.15, 1.0) from PRNGKey(1234), row 0 the
    background (0.05, 0.05, 0.08)."""
    i = np.arange(num_channels * 3, dtype=np.uint32)
    hi, lo = _threefry2x32((0, 1234), np.zeros_like(i), i)
    unit = (((hi ^ lo) >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    a, b = np.float32(0.15), np.float32(1.0)
    colors = (unit.astype(np.float64) * np.float64(b - a) + np.float64(a)).astype(np.float32)
    colors = np.maximum(a, colors).reshape(num_channels, 3)
    colors[0] = (0.05, 0.05, 0.08)
    return colors


def draws(gen: torch.Generator, batch: int, num_joints: int, num_betas: int, num_kp: int,
          num_parts: int, s: Stream, size: int) -> dict:
    dev = gen.device

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    pose = s.pose_std * normal(batch, num_joints * 3)
    pose[:, :3] = s.global_std * normal(batch, 3)
    betas = s.shape_std * normal(batch, num_betas)
    lo, hi = s.cam_scale_range
    scale = lo + (hi - lo) * uniform(batch, 1)
    trans = s.cam_trans_std * normal(batch, 2)
    out = {"pose": pose, "betas": betas, "cam": torch.cat([scale, trans], dim=1),
           "noise": normal(batch, size, size, 3), "vis_u": uniform(batch, num_kp)}
    if s.color_jitter:
        out["pal_noise"] = s.color_jitter * normal(batch, num_parts + 1, 3)
    if s.bg_mode == "texture":
        out["bg_low"] = uniform(batch, _TEXTURE_CELLS, _TEXTURE_CELLS, 3)
        out["bg_grain"] = uniform(batch, size, size, 3)
    elif s.bg_mode == "noise":
        out["bg_noise"] = uniform(batch, size, size, 3)
    if s.shading:
        out["light"] = torch.tensor(_LIGHT, device=dev) + 0.6 * normal(batch, 3)
    occ = []
    for _ in range(s.occluders):
        centre = size * uniform(batch, 2)
        half = 0.04 * size + (s.occluder_size - 0.04) * size * uniform(batch, 2)
        occ.append((centre, half, uniform(batch, 3)))
    for i, key in enumerate(("occ_centre", "occ_half", "occ_color")):
        if occ:
            out[key] = torch.stack([o[i] for o in occ])
    return out


@torch.no_grad()
def batch(d: dict, body: body_lib.Body, p: raster_lib.Parts, fclass: torch.Tensor, s: Stream,
          size: int, sigma: float, bg_gamma: float, prec: Precision, include_3d: bool) -> dict:
    """The training batch of draws `d` (see the module docstring)."""
    pose, betas, cam = d["pose"], d["betas"], d["cam"]
    B, J = pose.shape[0], body.num_joints
    rot = body_lib.rodrigues(pose.reshape(B, J, 3))
    out3 = body_lib.smpl(body, rot, betas, prec)
    verts2d = body_lib.project_pixel(out3["verts"], cam, size)
    kp2d = body_lib.project_pixel(out3["kp3d"], cam, size)
    pal = torch.as_tensor(palette(p.num_parts + 1), device=pose.device)
    pal = torch.clamp(pal + d["pal_noise"], 0.0, 1.0) if s.color_jitter else pal.expand(B, *pal.shape)
    bg_px = None
    if s.bg_mode == "noise":
        bg_px = d["bg_noise"]
    elif s.bg_mode == "texture":
        low = F.interpolate(d["bg_low"].permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                            align_corners=False).permute(0, 2, 3, 1)
        bg_px = torch.clamp(0.8 * low + 0.2 * d["bg_grain"], 0.0, 1.0)

    if s.targets == "hard":
        hr = hard_lib.hard_raster(verts2d, out3["verts"][..., 2], body.faces, fclass, size,
                                  with_shade=s.shading > 0, light=d.get("light"))
        labels, sil = hr["part_labels"], hr["silhouette"]
        rgb = torch.gather(pal, 1, labels.reshape(B, -1, 1).long().expand(-1, -1, 3)).reshape(B, size, size, 3)
        fg = sil[..., None] > 0
        if s.shading:
            rgb = torch.where(fg, rgb * (1.0 - s.shading + s.shading * hr["shade"][..., None]), rgb)
        image = rgb if bg_px is None else torch.where(fg, rgb, bg_px)
    else:
        score = raster_lib.scores(verts2d, p, size, sigma, prec).to(torch.bfloat16)
        s_total = torch.sum(score, dim=1, dtype=torch.float32)
        mx = torch.amax(score, dim=1).float()
        labels = torch.where(mx > bg_gamma, torch.argmax(score, dim=1) + 1, 0).to(torch.int32)
        sil = (s_total > bg_gamma).float()
        colours = pal[:, 1:].to(torch.bfloat16)
        mix = torch.sum(score[..., None] * colours[:, :, None, None, :], dim=1, dtype=torch.float32)
        bg_rgb = bg_px if bg_px is not None else pal[:, 0][:, None, None, :]
        image = (bg_gamma * bg_rgb + mix) / (bg_gamma + s_total)[..., None]

    if s.occluders:
        coords = torch.arange(size, dtype=torch.float32, device=image.device)
        for i in range(s.occluders):
            centre, half = d["occ_centre"][i], d["occ_half"][i]
            in_x = torch.abs(coords[None, :] - centre[:, 0:1]) < half[:, 0:1]
            in_y = torch.abs(coords[None, :] - centre[:, 1:2]) < half[:, 1:2]
            image = torch.where((in_y[:, :, None] & in_x[:, None, :])[..., None],
                                d["occ_color"][i][:, None, None, :], image)
    image = torch.clamp(image + s.image_noise * d["noise"], 0.0, 1.0) * 2.0 - 1.0
    in_crop = torch.all((kp2d >= 0.0) & (kp2d <= size - 1.0), dim=-1)
    out = {"image": image, "silhouette": sil, "part_labels": labels, "kp2d": kp2d,
           "kp_vis": (in_crop & (d["vis_u"] < s.kp_visibility)).float(), "verts2d": verts2d}
    if include_3d:
        out.update(joints3d=out3["joints"], rotmats=rot, betas=betas)
    return out
