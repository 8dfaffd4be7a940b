"""SMPL, written from its published equations (Loper et al. 2015), and the
weak-perspective camera, in plain PyTorch.

    v_shaped = T + S·β,  J = R_J·v_shaped,  v_posed = v_shaped + P·(R[1:] − I)
    G_k = G_parent(k) · [R_k | J_k − J_parent(k)],  A_k = G_k − [0 | G_k·J_k]
    v = Σ_j w_vj · A_j · [v_posed; 1],  kp3d = R_coco · v

Every product goes through `Precision.mm`: float32 with TF32 off, or the
control's TF32 operands.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.reference.precision import Precision


@dataclasses.dataclass(frozen=True)
class Body:
    """The asset's arrays on one device, in their published layout."""

    v_template: torch.Tensor  # [V, 3]
    shapedirs: torch.Tensor  # [V*3, Kb]
    posedirs: torch.Tensor  # [V*3, Kp]
    j_regressor: torch.Tensor  # [J, V]
    coco_regressor: torch.Tensor  # [K, V]
    weights: torch.Tensor  # [V, J]
    parents: tuple
    faces: torch.Tensor  # [F, 3] int64
    labels: np.ndarray  # [V] part class of each vertex (argmax weight, clipped)

    @property
    def num_joints(self) -> int:
        return self.j_regressor.shape[0]


def body_from_asset(asset, num_parts: int, device) -> Body:
    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)

    V = asset.v_template.shape[0]
    return Body(
        v_template=t(asset.v_template),
        shapedirs=t(asset.shapedirs.reshape(V * 3, -1)),
        posedirs=t(asset.posedirs.reshape(V * 3, -1)),
        j_regressor=t(asset.J_regressor),
        coco_regressor=t(asset.cocoplus_regressor),
        weights=t(asset.weights),
        parents=tuple(int(p) for p in asset.parents),
        faces=torch.as_tensor(np.asarray(asset.faces, np.int64), device=device),
        labels=np.minimum(np.argmax(asset.weights, axis=1), num_parts - 1).astype(np.int64),
    )


def rodrigues(aa: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> [..., 3, 3]: cos·I + sin·[k]x + (1 − cos)·k kᵀ,
    the angle taken as sqrt(|a|² + 1e-12) so that zero is the identity with
    finite gradients."""
    angle = torch.sqrt(torch.sum(aa * aa, dim=-1, keepdim=True) + 1e-12)
    k = aa / angle
    s, c = torch.sin(angle)[..., None], torch.cos(angle)[..., None]
    x, y, z = k.unbind(-1)
    zero = torch.zeros_like(x)
    cross = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(aa.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=aa.dtype, device=aa.device)
    return c * eye + s * cross + (1.0 - c) * (k[..., :, None] * k[..., None, :])


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """Zhou et al. 2019: two columns, Gram-Schmidt, the cross product."""
    a1, a2 = x[..., 0:3], x[..., 3:6]
    b1 = a1 / (torch.linalg.vector_norm(a1, dim=-1, keepdim=True) + 1e-8)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / (torch.linalg.vector_norm(a2p, dim=-1, keepdim=True) + 1e-8)
    return torch.stack([b1, b2, torch.linalg.cross(b1, b2, dim=-1)], dim=-1)


def smpl(body: Body, rotmats: torch.Tensor, betas: torch.Tensor, prec: Precision) -> dict:
    """rotmats [B, J, 3, 3], betas [B, Kb] -> verts [B, V, 3], joints
    [B, J, 3] (posed), kp3d [B, K, 3]."""
    B, J = rotmats.shape[0], body.num_joints
    V = body.v_template.shape[0]
    v_shaped = body.v_template + prec.mm(betas, body.shapedirs.T).reshape(B, V, 3)
    j_rest = prec.mm(body.j_regressor, v_shaped)  # [B, J, 3]
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feat = (rotmats[:, 1:] - eye).reshape(B, -1)
    v_posed = v_shaped + prec.mm(pose_feat, body.posedirs.T).reshape(B, V, 3)

    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], device=rotmats.device).expand(B, 1, 4)
    glob = []
    for k in range(J):
        p = body.parents[k]
        offset = j_rest[:, k] if p < 0 else j_rest[:, k] - j_rest[:, p]
        local = torch.cat([torch.cat([rotmats[:, k], offset[..., None]], dim=-1), bottom], dim=1)
        glob.append(local if p < 0 else prec.mm(glob[p], local))
    G = torch.stack(glob, dim=1)  # [B, J, 4, 4]
    joints = G[:, :, :3, 3]
    moved = prec.mm(G[:, :, :3, :3], j_rest[..., None])[..., 0]
    A = torch.cat([G[:, :, :3, :3], (joints - moved)[..., None]], dim=-1)  # [B, J, 3, 4]
    T = prec.mm(body.weights, A.reshape(B, J, 12)).reshape(B, V, 3, 4)
    verts = prec.mm(T[..., :3], v_posed[..., None])[..., 0] + T[..., 3]
    return {"verts": verts, "joints": joints, "kp3d": prec.mm(body.coco_regressor, verts)}


def project_pixel(x3d: torch.Tensor, cam: torch.Tensor, size: int) -> torch.Tensor:
    """Weak perspective: (s·xy + t) in NDC, NDC [-1, 1] onto pixels [0, size − 1]."""
    ndc = cam[:, None, 0:1] * x3d[..., :2] + cam[:, None, 1:3]
    return (ndc + 1.0) * (0.5 * (size - 1))
