"""Weak-perspective camera (port of the reference's ops/camera.py).

cam = (s, tx, ty): orthographic scale plus 2D translation in NDC; NDC
[-1, 1] maps onto pixel [0, size-1].
"""

from __future__ import annotations

import torch


def project_ndc(x3d: torch.Tensor, cam: torch.Tensor) -> torch.Tensor:
    """x3d [..., N, 3], cam [..., 3] -> NDC 2D points [..., N, 2]."""
    s = cam[..., 0:1, None]
    t = cam[..., None, 1:3]
    return s * x3d[..., :2] + t


def ndc_to_pixel(ndc: torch.Tensor, image_size: int) -> torch.Tensor:
    return (ndc + 1.0) * (0.5 * (image_size - 1))


def project_pixel(x3d: torch.Tensor, cam: torch.Tensor, image_size: int) -> torch.Tensor:
    """Weak-perspective projection straight to pixel coordinates."""
    return ndc_to_pixel(project_ndc(x3d, cam), image_size)


def perspective_project_pixel(
    x3d: torch.Tensor, cam_t: torch.Tensor, focal: float, image_size: int
) -> torch.Tensor:
    """Full perspective projection, principal point at the image centre.

    The z-guard keeps gradients finite for points behind the camera.
    """
    p = x3d + cam_t[..., None, :]
    z = torch.clamp(p[..., 2:3], min=1e-3)
    centre = (image_size - 1) / 2.0
    return focal * p[..., :2] / z + centre
