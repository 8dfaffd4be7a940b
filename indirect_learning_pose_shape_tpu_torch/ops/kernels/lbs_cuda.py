"""Fused SMPL blendshape + LBS: wrapper of the CUDA kernel `csrc/lbs.cu`.

Port of the reference's Pallas kernel (ops/kernels/lbs_pallas.py `_kernel`,
driven by `_fwd_planar` and the `_lbs` custom VJP). Per (batch item, vertex):

    v_posed = v_template + Σ_k β_k·shapedirs_k + Σ_k pf_k·posedirs_k
    T       = Σ_j rel[j]·w_j                 ([12] skinning rows)
    verts   = R(T)·v_posed + t(T)

in float32, over the planar `_p` layouts of `SMPLConsts`. With `residuals`
the kernel also writes `v_posed` and `T`, the residuals of the backward;
`fused_blend_lbs` asks for them only where autograd will run the backward
(`wants_residuals`), so serving and the synthetic batch write verts alone.

`fused_blend_lbs` launches the kernel for CUDA tensors and runs its plain
version, `lbs_planar_torch`, for CPU tensors; that plain version is also the
body of `models.smpl._lbs_torch`, the twin `impl='torch'` runs. Gradients
go through `lbs_backward_torch`, the reference's `_lbs_bwd` einsums in torch
(the reference's backward was plain XLA, not a kernel).
"""

from __future__ import annotations

import ctypes

import torch

from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build
from indirect_learning_pose_shape_tpu_torch.utils.precision import full_f32

KERNEL = "lbs"
_P, _I = ctypes.c_void_p, ctypes.c_int
# The kernel's tiles, which must match csrc/lbs.cu: a block owns VT (kVT)
# vertices and ITEM_ROWS (kTY) rows of threads, each row `ipt` batch items,
# one of IPTS (the instantiations in `ilps_lbs_forward`'s switch). The
# plan is made here and checked there.
VT = 32
ITEM_ROWS = 16
IPTS = (1, 2, 4, 8)


def _padded_rows(consts) -> tuple[int, int]:
    return consts.shapedirs_p.shape[0] // 3, consts.posedirs_p.shape[0] // 3


def launch_plan(B: int, Vp: int) -> tuple[int, int, int]:
    """(ipt, b_tiles, v_tiles): the kernel's grid for B items and Vp
    vertices. The batch tile, ITEM_ROWS * ipt items, is the smallest that
    holds B up to 128 items (more rows per thread only where there are items
    to fill them); the vertex tiles are Vp / VT, 216 for SMPL, so the grid
    covers every SM at B=1."""
    if B < 1 or Vp % VT:
        raise ValueError(f"lbs kernel: no plan for B={B}, Vp={Vp} (Vp must be a multiple of {VT})")
    ipt = next((i for i in IPTS if B <= ITEM_ROWS * i), IPTS[-1])
    return ipt, -(-B // (ITEM_ROWS * ipt)), Vp // VT


def lbs_planar_torch(consts, betas, pose_feat, rel):
    """Plain version of the kernel at its own interface.

    betas [B, Kb], pose_feat [B, Kp], rel [B, J, 12] ->
    (verts [B, 3, Vp], v_posed [B, 3, Vp], T [B, 12, Vp]).
    """
    B = betas.shape[0]
    Vp = consts.num_verts_padded
    kbp, kpp = _padded_rows(consts)
    Kb, Kp = betas.shape[1], pose_feat.shape[1]
    sd = consts.shapedirs_p.reshape(3, kbp, Vp)[:, :Kb]
    pd = consts.posedirs_p.reshape(3, kpp, Vp)[:, :Kp]
    with full_f32():
        v_posed = (
            consts.v_template_p[None]
            + torch.einsum("bk,ckv->bcv", betas, sd)
            + torch.einsum("bk,ckv->bcv", pose_feat, pd)
        )
        T = torch.einsum("bjr,jv->brv", rel, consts.weights_p)
    R = T[:, :9].reshape(B, 3, 3, Vp)
    verts = (R * v_posed[:, None]).sum(dim=2) + T[:, 9:]
    return verts, v_posed, T


def _launch(consts, betas, pose_feat, rel, residuals: bool):
    B, Kb = betas.shape
    Kp = pose_feat.shape[1]
    J = consts.num_joints
    Vp = consts.num_verts_padded
    kbp, kpp = _padded_rows(consts)
    dev = betas.device
    for name, x, shape in (
        ("betas", betas, (B, Kb)),
        ("pose_feat", pose_feat, (B, Kp)),
        ("rel", rel, (B, J, 12)),
        ("v_template_p", consts.v_template_p, (3, Vp)),
        ("shapedirs_p", consts.shapedirs_p, (3 * kbp, Vp)),
        ("posedirs_p", consts.posedirs_p, (3 * kpp, Vp)),
        ("weights_p", consts.weights_p, (J, Vp)),
    ):
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(
                f"lbs kernel: {name} must be float32 {shape} on {dev}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if not x.is_contiguous():
            raise ValueError(f"lbs kernel: {name} must be contiguous")
        if name not in ("betas", "pose_feat") and x.data_ptr() % 16:
            raise ValueError(f"lbs kernel: {name} must be 16-byte aligned (copied in 16-byte pieces)")
    if Kb > kbp or Kp > kpp:
        raise ValueError(f"lbs kernel: {Kb} betas / {Kp} pose features exceed the layout")
    ipt, b_tiles, v_tiles = launch_plan(B, Vp)
    verts = torch.empty((B, 3, Vp), dtype=torch.float32, device=dev)
    v_posed = torch.empty_like(verts) if residuals else None
    T = torch.empty((B, 12, Vp), dtype=torch.float32, device=dev) if residuals else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _build.launch(
            "ilps_lbs_forward",
            (_P, betas.data_ptr()), (_P, pose_feat.data_ptr()), (_P, rel.data_ptr()),
            (_P, consts.v_template_p.data_ptr()), (_P, consts.shapedirs_p.data_ptr()),
            (_P, consts.posedirs_p.data_ptr()), (_P, consts.weights_p.data_ptr()),
            (_P, verts.data_ptr()),
            (_P, v_posed.data_ptr() if residuals else None),
            (_P, T.data_ptr() if residuals else None),
            (_I, B), (_I, Vp), (_I, Kb), (_I, kbp), (_I, Kp), (_I, kpp), (_I, J),
            (_I, ipt), (_I, b_tiles), (_I, v_tiles), (_I, int(residuals)),
            (_P, stream),
        )
    _build.count(KERNEL)
    return verts, v_posed, T


def lbs_planar(consts, betas, pose_feat, rel, residuals: bool = True):
    """The kernel for CUDA tensors, its plain version for CPU tensors:
    (verts, v_posed, T), or (verts, None, None) without `residuals`."""
    if betas.is_cuda:
        return _launch(
            consts, betas.contiguous(), pose_feat.contiguous(), rel.contiguous(), residuals
        )
    if betas.device.type != "cpu":
        raise ValueError(f"lbs kernel: unsupported device {betas.device}")
    verts, v_posed, T = lbs_planar_torch(consts, betas, pose_feat, rel)
    return (verts, v_posed, T) if residuals else (verts, None, None)


def lbs_backward_torch(consts, v_posed, T, g):
    """VJP of the kernel from its residuals (reference `_lbs_bwd`).

    v_posed [B, 3, Vp], T [B, 12, Vp], g = d verts [B, 3, Vp] ->
    (d_betas [B, Kb], d_pose_feat [B, Kp], d_rel [B, J, 12]).
    """
    B, _, Vp = v_posed.shape
    Kb = consts.num_betas
    Kp = (consts.num_joints - 1) * 9
    kbp, kpp = _padded_rows(consts)
    sd = consts.shapedirs_p.reshape(3, kbp, Vp)[:, :Kb]  # [3, Kb, Vp]
    pd = consts.posedirs_p.reshape(3, kpp, Vp)[:, :Kp]
    rot = T[:, :9].reshape(B, 3, 3, Vp)
    d_rot = (g[:, :, None, :] * v_posed[:, None, :, :]).reshape(B, 9, Vp)
    d_t = torch.cat([d_rot, g], dim=1)  # [B, 12, Vp]
    with full_f32():
        d_rel = torch.einsum("brv,jv->bjr", d_t, consts.weights_p)
        d_vposed = (rot * g[:, :, None, :]).sum(dim=1)  # [B, 3, Vp]
        d_betas = torch.einsum("bcv,ckv->bk", d_vposed, sd)
        d_pf = torch.einsum("bcv,ckv->bk", d_vposed, pd)
    return d_betas, d_pf, d_rel


class _FusedLBS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, betas, pose_feat, rel, consts):
        verts, v_posed, T = lbs_planar(consts, betas, pose_feat, rel)
        ctx.consts = consts
        ctx.save_for_backward(v_posed, T)
        return verts

    @staticmethod
    def backward(ctx, g):
        v_posed, T = ctx.saved_tensors
        d_betas, d_pf, d_rel = lbs_backward_torch(ctx.consts, v_posed, T, g)
        return d_betas, d_pf, d_rel, None


def wants_residuals(*inputs: torch.Tensor) -> bool:
    """Whether autograd will run the backward, which needs v_posed and T:
    grad mode is on and some input requires grad."""
    return torch.is_grad_enabled() and any(x.requires_grad for x in inputs)


def fused_blend_lbs(consts, betas, pose_feat, rel) -> torch.Tensor:
    """Fused shape/pose blendshapes + skinning. verts [B, V, 3].

    Same interface and semantics as models.smpl._lbs_torch; `rel` is
    [B, J, 12] from rigid_transform_chain. Without autograd the kernel
    writes verts alone.
    """
    if wants_residuals(betas, pose_feat, rel):
        planar = _FusedLBS.apply(betas, pose_feat, rel, consts)  # [B, 3, Vp]
    else:
        planar = lbs_planar(consts, betas, pose_feat, rel, residuals=False)[0]
    return planar[:, :, : consts.num_verts].transpose(1, 2)
