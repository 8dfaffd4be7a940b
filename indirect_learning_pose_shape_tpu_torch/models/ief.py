"""Iterative-error-feedback SMPL parameter regressor (port of models/ief.py).

Θ₀ = mean parameters; for T iterations a shared MLP maps
concat(features, Θ_t) → ΔΘ and Θ_{t+1} = Θ_t + ΔΘ. Layout of Θ:
[pose | betas | cam].
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init


@dataclasses.dataclass(frozen=True)
class IEFConfig:
    num_iterations: int = 3
    hidden_dims: tuple = (1024, 1024)
    num_joints: int = 24
    num_betas: int = 10
    num_cam: int = 3
    rotation_format: str = "axis_angle"  # or 'rot6d'

    @property
    def num_pose(self) -> int:
        return self.num_joints * (6 if self.rotation_format == "rot6d" else 3)

    @property
    def theta_dim(self) -> int:
        return self.num_pose + self.num_betas + self.num_cam


class IEF(nn.Module):
    """The regressor's parameters: `layers` (nn.Linear) and `mean_theta`.

    `mean_theta` is a parameter, as in the reference, where it sits in the
    params tree and the optimizer trains it. The layers are created
    uninitialised: `ief_init` draws them, or converted weights are loaded.
    """

    def __init__(self, cfg: IEFConfig, feature_dim: int, mean_theta):
        super().__init__()
        self.cfg = cfg
        dims = [feature_dim + cfg.theta_dim, *cfg.hidden_dims, cfg.theta_dim]
        self.layers = nn.ModuleList(
            skip_init(nn.Linear, a, b) for a, b in zip(dims, dims[1:])
        )
        self.mean_theta = nn.Parameter(torch.as_tensor(np.asarray(mean_theta, np.float32)))


def ief_init(
    cfg: IEFConfig, feature_dim: int, mean_theta, gen: torch.Generator
) -> IEF:
    """He-normal weights from `gen`, zero biases; the last layer has std 1e-3
    so the first iteration starts at the mean parameters."""
    ief = IEF(cfg, feature_dim, mean_theta)
    with torch.no_grad():
        for i, layer in enumerate(ief.layers):
            fan_in = layer.in_features
            std = 1e-3 if i == len(ief.layers) - 1 else math.sqrt(2.0 / fan_in)
            layer.weight.copy_(torch.randn(layer.weight.shape, generator=gen) * std)
            layer.bias.zero_()
    return ief


def load_mean_theta(path: str, cfg: IEFConfig) -> torch.Tensor:
    """Θ₀ from an .npz ('mean_theta' key) or bare .npy, shape-checked against
    the configured layout [pose | betas | cam]."""
    arr = np.load(path)
    if hasattr(arr, "files"):
        if "mean_theta" not in arr.files:
            raise ValueError(
                f"mean-params npz {path!r} has keys {arr.files}; expected 'mean_theta'"
            )
        arr = arr["mean_theta"]
    arr = np.asarray(arr, np.float32).reshape(-1)
    if arr.shape[0] != cfg.theta_dim:
        raise ValueError(
            f"mean-params file {path!r} holds {arr.shape[0]} values; the "
            f"configured layout needs theta_dim={cfg.theta_dim} "
            f"(pose {cfg.num_pose} [{cfg.rotation_format}] + betas "
            f"{cfg.num_betas} + cam {cfg.num_cam})"
        )
    return torch.from_numpy(arr)


def ief_apply(ief: IEF, features: torch.Tensor) -> torch.Tensor:
    """features [B, D] -> Θ [B, theta_dim] after T feedback iterations."""
    B = features.shape[0]
    theta = ief.mean_theta[None, :].expand(B, -1)
    last = len(ief.layers) - 1
    for _ in range(ief.cfg.num_iterations):
        x = torch.cat([features, theta], dim=1)
        for i, layer in enumerate(ief.layers):
            x = layer(x)
            if i < last:
                x = F.relu(x)
        theta = theta + x
    return theta


def split_theta(theta: torch.Tensor, cfg: IEFConfig):
    """Θ -> (pose [B, num_pose], betas [B, num_betas], cam [B, num_cam])."""
    p = cfg.num_pose
    b = cfg.num_betas
    return theta[:, :p], theta[:, p : p + b], theta[:, p + b :]
