"""Batched SMPL body model in PyTorch (port of the reference's models/smpl.py).

- Rodrigues, the 24-joint kinematic chain (unrolled over the static parent
  tuple), shape and pose blendshapes, linear blend skinning and the
  cocoplus keypoint regressor, all in float32.
- Geometry runs in IEEE float32, never TF32 (`utils.precision.full_f32`),
  the counterpart of the reference's `Precision.HIGHEST`.
- `impl` selects the blendshape + LBS hot path: 'kernel' is the fused CUDA
  kernel (ops/kernels/lbs_cuda.py, port of the Pallas `lbs_pallas._kernel`),
  'torch' is the plain twin `_lbs_torch` (the kernel's plain version,
  `lbs_cuda.lbs_planar_torch`, at this module's interface), 'auto' is the
  kernel for CUDA tensors and the twin for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.ops.kernels import lbs_cuda
from indirect_learning_pose_shape_tpu_torch.utils.assets import SMPLAsset
from indirect_learning_pose_shape_tpu_torch.utils.precision import full_f32


@dataclasses.dataclass(frozen=True)
class SMPLConsts:
    """SMPL asset tensors on one device, pre-laid-out for the hot path.

    The `_p` fields are planar (channel-major, vertex-minor) copies padded to
    a 128-multiple vertex count, each blendshape component group padded to
    an 8-multiple of rows: the layout the LBS kernel reads, each basis row's
    32-vertex tile one contiguous 128-byte copy. The plain twin
    reads the same layouts; the flat fields serve the rest-pose joints and
    the keypoint regressor.
    """

    v_template: torch.Tensor  # [V, 3]
    shapedirs_flat: torch.Tensor  # [num_betas, V*3]
    J_regressor: torch.Tensor  # [J, V]
    cocoplus_regressor: torch.Tensor  # [19, V]
    v_template_p: torch.Tensor  # [3, Vp]
    shapedirs_p: torch.Tensor  # [3*Kb_pad, Vp]  rows c*Kb_pad+k
    posedirs_p: torch.Tensor  # [3*Kp_pad, Vp]  rows c*Kp_pad+k
    weights_p: torch.Tensor  # [J, Vp]
    parents: tuple  # python ints, parents[0] == -1

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    @property
    def num_verts_padded(self) -> int:
        return self.v_template_p.shape[1]

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def num_betas(self) -> int:
        return self.shapedirs_flat.shape[0]


def smpl_consts(asset: SMPLAsset, device: torch.device | str = "cpu") -> SMPLConsts:
    v = asset.num_verts
    vp = -(-v // 128) * 128

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32, device=device)

    def planar(x_vc):  # [V, C] -> [C, Vp]
        x = np.asarray(x_vc).T
        out = np.zeros((x.shape[0], vp), x.dtype)
        out[:, :v] = x
        return t(out)

    def planar_dirs(x_v3k):  # [V, 3, K] -> [3*K_pad, Vp], rows c*K_pad+k
        x = np.asarray(x_v3k)
        k = x.shape[2]
        k_pad = -(-k // 8) * 8
        out = np.zeros((3 * k_pad, vp), x.dtype)
        for c in range(3):
            out[c * k_pad : c * k_pad + k, :v] = x[:, c, :].T
        return t(out)

    return SMPLConsts(
        v_template=t(asset.v_template),
        shapedirs_flat=t(asset.shapedirs.reshape(v * 3, -1).T),
        J_regressor=t(asset.J_regressor),
        cocoplus_regressor=t(asset.cocoplus_regressor),
        v_template_p=planar(asset.v_template),
        shapedirs_p=planar_dirs(asset.shapedirs),
        posedirs_p=planar_dirs(asset.posedirs),
        weights_p=planar(asset.weights),
        parents=tuple(int(p) for p in asset.parents),
    )


def batch_rodrigues(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3].

    R = cos·I + sin·K + (1−cos)·aaᵀ, elementwise. The 1e-12 inside the sqrt
    makes zero pose give exactly the identity with finite gradients.
    """
    eps = 1e-12
    angle = torch.sqrt(torch.sum(axis_angle * axis_angle, dim=-1, keepdim=True) + eps)
    axis = axis_angle / angle
    s = torch.sin(angle)[..., None]
    c = torch.cos(angle)[..., None]
    x, y, z = axis.unbind(-1)
    zero = torch.zeros_like(x)
    K = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1).reshape(
        axis_angle.shape[:-1] + (3, 3)
    )
    outer = axis[..., :, None] * axis[..., None, :]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    return c * eye + s * K + (1.0 - c) * outer


def rot6d_to_rotmat(x: torch.Tensor) -> torch.Tensor:
    """Continuous 6D rotation [..., 6] -> [..., 3, 3] (Gram-Schmidt, columns)."""
    a1 = x[..., 0:3]
    a2 = x[..., 3:6]
    b1 = a1 / (torch.linalg.vector_norm(a1, dim=-1, keepdim=True) + 1e-8)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / (torch.linalg.vector_norm(a2p, dim=-1, keepdim=True) + 1e-8)
    b3 = torch.linalg.cross(b1, b2, dim=-1)
    return torch.stack([b1, b2, b3], dim=-1)


def _mat3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] x [..., 3, k] as elementwise products: exact float32."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def rigid_transform_chain(
    rotmats: torch.Tensor, joints_rest: torch.Tensor, parents: tuple
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics over the static kinematic tree.

    rotmats [B, J, 3, 3], joints_rest [B, J, 3] ->
      joints_posed [B, J, 3],
      rel [B, J, 12]: rotation (9, row-major) + translation (3) of
      A_k = G_k − [0 | R_k·J_k], the rows the LBS contraction consumes.
    """
    num_joints = len(parents)
    rot_g = [None] * num_joints
    pos_g = [None] * num_joints
    rot_g[0] = rotmats[:, 0]
    pos_g[0] = joints_rest[:, 0]
    for k in range(1, num_joints):
        p = parents[k]
        bone = joints_rest[:, k] - joints_rest[:, p]
        rot_g[k] = _mat3(rot_g[p], rotmats[:, k])
        pos_g[k] = pos_g[p] + _mat3(rot_g[p], bone[..., None])[..., 0]
    rot_g = torch.stack(rot_g, dim=1)  # [B, J, 3, 3]
    pos_g = torch.stack(pos_g, dim=1)  # [B, J, 3]
    trans = pos_g - _mat3(rot_g, joints_rest[..., None])[..., 0]
    rel = torch.cat([rot_g.reshape(rot_g.shape[0], num_joints, 9), trans], dim=-1)
    return pos_g, rel


def _lbs_torch(
    consts: SMPLConsts, betas: torch.Tensor, pose_feat: torch.Tensor, rel: torch.Tensor
) -> torch.Tensor:
    """Plain twin of the LBS kernel: blendshapes + skinning. verts [B, V, 3]."""
    verts, _, _ = lbs_cuda.lbs_planar_torch(consts, betas, pose_feat, rel)
    return verts[:, :, : consts.num_verts].transpose(1, 2)


def smpl_forward(
    consts: SMPLConsts, pose: torch.Tensor, betas: torch.Tensor, impl: str = "auto"
) -> dict[str, torch.Tensor]:
    """pose [B, J*3] axis-angle, betas [B, num_betas] -> verts, joints, kp3d."""
    B = pose.shape[0]
    rotmats = batch_rodrigues(pose.reshape(B, consts.num_joints, 3))
    return smpl_forward_rotmats(consts, rotmats, betas, impl=impl)


def smpl_forward_rotmats(
    consts: SMPLConsts, rotmats: torch.Tensor, betas: torch.Tensor, impl: str = "auto"
) -> dict[str, torch.Tensor]:
    """SMPL forward from rotation matrices [B, J, 3, 3].

    Returns verts [B, V, 3], joints [B, J, 3], kp3d [B, 19, 3].
    """
    if impl == "auto":
        impl = "kernel" if rotmats.is_cuda else "torch"
    if impl not in ("kernel", "torch"):
        raise ValueError(f"smpl impl must be 'kernel' | 'torch' | 'auto', got {impl!r}")
    B = rotmats.shape[0]
    J = consts.num_joints
    eye = torch.eye(3, dtype=rotmats.dtype, device=rotmats.device)
    pose_feat = (rotmats[:, 1:] - eye).reshape(B, (J - 1) * 9)

    with full_f32():
        shape_off = (betas @ consts.shapedirs_flat).reshape(B, consts.num_verts, 3)
        v_shaped = consts.v_template[None] + shape_off
        joints_rest = torch.einsum("jv,bvi->bji", consts.J_regressor, v_shaped)

    joints_posed, rel = rigid_transform_chain(rotmats, joints_rest, consts.parents)

    if impl == "kernel":
        verts = lbs_cuda.fused_blend_lbs(consts, betas, pose_feat, rel)
    else:
        verts = _lbs_torch(consts, betas, pose_feat, rel)

    with full_f32():
        kp3d = torch.einsum("kv,bvi->bki", consts.cocoplus_regressor, verts)
    return {"verts": verts, "joints": joints_posed, "kp3d": kp3d}


def mean_params(
    consts: SMPLConsts, num_cam: int = 3, rotation_format: str = "axis_angle"
) -> np.ndarray:
    """IEF's Θ₀: neutral pose and shape, camera scale 0.9. [pose | betas | cam]."""
    J = consts.num_joints
    if rotation_format == "rot6d":
        pose0 = np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32), J)
    else:
        pose0 = np.zeros(J * 3, np.float32)
    theta = np.concatenate(
        [pose0, np.zeros(consts.num_betas, np.float32), np.zeros(num_cam, np.float32)]
    )
    theta[-num_cam] = 0.9
    return theta
