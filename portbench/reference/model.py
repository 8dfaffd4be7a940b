"""The regressor in plain PyTorch: a ResNet (He et al. 2016, basic blocks)
whose convolutions run in bfloat16, then HMR's iterative error feedback
(Kanazawa et al. 2018), then SMPL and the camera.

Parameters are a flat dict of tensors under the port's names
(`encoder.stem`, `encoder.s{stage}b{block}.conv1`, `encoder.bn1.scale`, ...,
`ief.layers.{i}.weight`, `ief.mean_theta`), which is also the form the
benchmark makes them in (`portbench/inputs.py`).

BatchNorm in training normalises with the batch's statistics, taken in
float32 as the mean and mean of squares (variance max(E[x²] − E[x]², 0)),
and applies the per-channel affine in the compute dtype, as the reference
package's `_batch_norm` states; in evaluation it applies the running
statistics the same way (unfolded).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import body as body_lib
from portbench.reference.precision import Precision

STAGE_BLOCKS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}
BN_EPS = 1e-5


def blocks(depth: int, width: int = 64):
    """(name, cin, cout, stride) of every basic block, in order."""
    out, cin = [], width
    for stage, n in enumerate(STAGE_BLOCKS[depth]):
        cout = width * 2**stage
        for b in range(n):
            out.append((f"s{stage}b{b}", cin, cout, 2 if (b == 0 and stage > 0) else 1))
            cin = cout
    return out


def _bn(y: torch.Tensor, w: dict, name: str, train: bool, stats: dict | None = None) -> torch.Tensor:
    if train:
        y32 = y.float()
        mean = y32.mean(dim=(0, 2, 3))
        var = torch.clamp_min(torch.square(y32).mean(dim=(0, 2, 3)) - torch.square(mean), 0.0)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = w[name + ".mean"], w[name + ".var"]
    inv = torch.rsqrt(var + BN_EPS) * w[name + ".scale"]
    shift = w[name + ".bias"] - mean * inv
    return y * inv.to(y.dtype)[:, None, None] + shift.to(y.dtype)[:, None, None]


def encoder(w: dict, images: torch.Tensor, depth: int, train: bool, prec: Precision,
            stats: dict | None = None) -> torch.Tensor:
    """images [B, H, W, 3] float32 in [-1, 1] -> features [B, 512] float32.
    In training, `stats` (when given) receives each BatchNorm's batch
    (mean, variance) by its name."""
    def conv_bn(x, conv, bn, stride):
        k = w[conv].shape[-1]
        return _bn(prec.conv(x, w[conv], stride, (k - 1) // 2), w, bn, train, stats)

    x = images.permute(0, 3, 1, 2).to(torch.bfloat16)
    x = F.relu(conv_bn(x, "encoder.stem", "encoder.bn_stem", 2))
    x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
    for name, cin, cout, stride in blocks(depth):
        p = "encoder." + name
        short = conv_bn(x, p + ".proj", p + ".bn_proj", stride) if stride != 1 or cin != cout else x
        y = F.relu(conv_bn(x, p + ".conv1", p + ".bn1", stride))
        y = conv_bn(y, p + ".conv2", p + ".bn2", 1)
        x = F.relu(y + short)
    return torch.mean(x, dim=(2, 3), dtype=torch.float32)


def ief(w: dict, feat: torch.Tensor, iterations: int, prec: Precision) -> torch.Tensor:
    """Θ_{t+1} = Θ_t + MLP([features, Θ_t]) from Θ_0 = mean_theta."""
    theta = w["ief.mean_theta"][None, :].expand(feat.shape[0], -1)
    n = sum(1 for k in w if k.startswith("ief.layers.") and k.endswith(".weight"))
    for _ in range(iterations):
        x = torch.cat([feat, theta], dim=1)
        for i in range(n):
            x = prec.mm(x, w[f"ief.layers.{i}.weight"].T) + w[f"ief.layers.{i}.bias"]
            if i < n - 1:
                x = F.relu(x)
        theta = theta + x
    return theta


def forward(w: dict, body: body_lib.Body, images: torch.Tensor, cfg: dict, train: bool,
            prec: Precision, stats: dict | None = None) -> dict:
    """The regressor's outputs: theta, pose, betas, cam, rotmats, pose_prior,
    verts, joints, kp3d, kp2d, verts2d. `cfg`: depth, rotation ('axis_angle'
    or 'rot6d'), iterations, image_size."""
    feat = encoder(w, images, cfg["depth"], train, prec, stats)
    return head(ief(w, feat, cfg["iterations"], prec), body, cfg, prec)


def head(theta: torch.Tensor, body: body_lib.Body, cfg: dict, prec: Precision) -> dict:
    """Θ -> the outputs after the regressor: rotations, SMPL, the camera."""
    B, J = theta.shape[0], body.num_joints
    per = 6 if cfg["rotation"] == "rot6d" else 3
    pose, betas, cam = theta[:, : J * per], theta[:, J * per : J * per + 10], theta[:, J * per + 10 :]
    if per == 6:
        rotmats = body_lib.rot6d_to_rotmat(pose.reshape(B, J, 6))
        identity6 = torch.tensor([1.0, 0, 0, 0, 1, 0], device=pose.device).repeat(J)
        prior = (pose - identity6)[:, 6:]
    else:
        rotmats = body_lib.rodrigues(pose.reshape(B, J, 3))
        prior = pose[:, 3:]
    out = body_lib.smpl(body, rotmats, betas, prec)
    size = cfg["image_size"]
    return {"theta": theta, "pose": pose, "betas": betas, "cam": cam, "rotmats": rotmats,
            "pose_prior": prior, **out,
            "kp2d": body_lib.project_pixel(out["kp3d"], cam, size),
            "verts2d": body_lib.project_pixel(out["verts"], cam, size)}
