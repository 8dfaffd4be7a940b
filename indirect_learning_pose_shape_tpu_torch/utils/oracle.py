"""Pure-numpy float64 oracle for SMPL forward, projection and the soft
rasterizer (numpy copy of the reference's utils/oracle.py, the same math and
signatures; it takes this package's `utils.assets.SMPLAsset`).

Deliberately naive, loop-heavy and dependency-free so it is easy to audit:
the port's float32 model (`models/smpl.py`, `ops/camera.py`,
`ops/raster.py`) and its CUDA kernels (`csrc/`) are held to it, on the CPU
by the tests and on the card by `chip_smoke.py`.

Math spec (shared by every implementation tier):

SMPL forward (SURVEY.md §3.3):
    v_shaped = v_template + shapedirs · β
    J        = J_regressor · v_shaped
    R_k      = rodrigues(θ_k)                       k = 0..23
    pose_feat= vec(R_1..23 − I)                     [207]
    v_posed  = v_shaped + posedirs · pose_feat
    G_0      = [R_0 | J_0];  G_k = G_parent · [R_k | J_k − J_parent]
    A_k      = G_k − [0 | G_k[:3,:3] · J_k]          (remove rest-pose offset)
    T_v      = Σ_k weights[v,k] A_k
    verts    = (T_v · [v_posed, 1])[:3]
    joints   = G[:, :3, 3]                           posed 24 joints
    kp3d     = cocoplus_regressor · verts            19 keypoints

Weak-perspective camera (SURVEY.md §2.2), cam = (s, tx, ty):
    x2d_ndc  = s · x3d[:, :2] + (tx, ty)             in [-1, 1] NDC
    x2d_pix  = (x2d_ndc + 1) / 2 · (size − 1)

Soft rasterizer (TPU-native gather/matmul formulation; lineage: SoftRas
per PAPERS.md, re-derived as sum-of-Gaussians so both forward and backward
are matmul-shaped — see ops/raster.py for the design rationale):
    d2[p,v]      = ||pixel_p − vert2d_v||²           (pixel units)
    E[p,v]       = exp(−d2 / (2σ²))
    score[p,c]   = Σ_v E[p,v] · 1[part(v) = c]       c = 0..C_fg−1
    S[p]         = Σ_c score[p,c]
    probs[p,0]   = γ / (γ + S[p])                    background
    probs[p,c+1] = score[p,c] / (γ + S[p])           foreground parts
    silhouette[p]= S[p] / (γ + S[p]) = 1 − probs[p,0]
"""

from __future__ import annotations

import numpy as np

from indirect_learning_pose_shape_tpu_torch.utils.assets import SMPLAsset


def rodrigues(axis_angle: np.ndarray) -> np.ndarray:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3] (float64 internally)."""
    aa = np.asarray(axis_angle, dtype=np.float64)
    flat = aa.reshape(-1, 3)
    out = np.zeros((flat.shape[0], 3, 3))
    for i, v in enumerate(flat):
        angle = np.linalg.norm(v)
        if angle < 1e-12:
            out[i] = np.eye(3)
            continue
        axis = v / angle
        K = np.array(
            [
                [0.0, -axis[2], axis[1]],
                [axis[2], 0.0, -axis[0]],
                [-axis[1], axis[0], 0.0],
            ]
        )
        out[i] = np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)
    return out.reshape(aa.shape[:-1] + (3, 3))


def smpl_forward(
    asset: SMPLAsset, pose: np.ndarray, betas: np.ndarray
) -> dict[str, np.ndarray]:
    """Single-example SMPL forward. pose [J*3], betas [B_betas]."""
    J = asset.num_joints
    pose = np.asarray(pose, dtype=np.float64).reshape(J, 3)
    betas = np.asarray(betas, dtype=np.float64)

    v_template = asset.v_template.astype(np.float64)
    shapedirs = asset.shapedirs.astype(np.float64)
    posedirs = asset.posedirs.astype(np.float64)

    v_shaped = v_template + shapedirs @ betas
    joints_rest = asset.J_regressor.astype(np.float64) @ v_shaped  # [J, 3]

    R = rodrigues(pose)  # [J, 3, 3]
    pose_feat = (R[1:] - np.eye(3)).reshape(-1)  # [207]
    v_posed = v_shaped + posedirs @ pose_feat

    # Global rigid transform chain.
    G = np.zeros((J, 4, 4))
    G[0] = np.eye(4)
    G[0, :3, :3] = R[0]
    G[0, :3, 3] = joints_rest[0]
    for k in range(1, J):
        local = np.eye(4)
        local[:3, :3] = R[k]
        local[:3, 3] = joints_rest[k] - joints_rest[asset.parents[k]]
        G[k] = G[asset.parents[k]] @ local

    joints_posed = G[:, :3, 3].copy()

    # Remove rest-pose joint offset: A_k = G_k - [0 | G_k[:3,:3] @ J_k].
    A = G.copy()
    for k in range(J):
        A[k, :3, 3] -= G[k, :3, :3] @ joints_rest[k]

    weights = asset.weights.astype(np.float64)  # [V, J]
    T = np.einsum("vk,kij->vij", weights, A)  # [V, 4, 4]
    verts_h = np.concatenate([v_posed, np.ones((v_posed.shape[0], 1))], axis=1)
    verts = np.einsum("vij,vj->vi", T, verts_h)[:, :3]

    kp3d = asset.cocoplus_regressor.astype(np.float64) @ verts

    return {
        "v_shaped": v_shaped,
        "v_posed": v_posed,
        "joints_rest": joints_rest,
        "rotmats": R,
        "pose_feat": pose_feat,
        "rel_transforms": A,
        "verts": verts,
        "joints": joints_posed,
        "kp3d": kp3d,
    }


def project_weak_perspective(
    x3d: np.ndarray, cam: np.ndarray, image_size: int
) -> np.ndarray:
    """Weak-perspective projection to pixel coords. x3d [N,3], cam [3]=(s,tx,ty)."""
    x3d = np.asarray(x3d, dtype=np.float64)
    s, tx, ty = [float(c) for c in np.asarray(cam, dtype=np.float64)]
    ndc = s * x3d[:, :2] + np.array([tx, ty])
    return (ndc + 1.0) / 2.0 * (image_size - 1)


def soft_rasterize(
    verts2d: np.ndarray,
    part_labels: np.ndarray,
    image_size: int,
    num_parts: int,
    sigma: float,
    bg_gamma: float,
) -> dict[str, np.ndarray]:
    """Naive O(H·W·V) soft rasterization. verts2d [V,2] in pixel coords.

    Returns probs [H, W, num_parts+1] (channel 0 = background) and
    silhouette [H, W].
    """
    V = verts2d.shape[0]
    ys, xs = np.meshgrid(
        np.arange(image_size, dtype=np.float64),
        np.arange(image_size, dtype=np.float64),
        indexing="ij",
    )
    pix = np.stack([xs, ys], axis=-1).reshape(-1, 2)  # [P, 2], (x, y)
    d2 = ((pix[:, None, :] - verts2d[None, :, :].astype(np.float64)) ** 2).sum(-1)
    E = np.exp(-d2 / (2.0 * sigma * sigma))  # [P, V]
    onehot = np.zeros((V, num_parts))
    onehot[np.arange(V), part_labels] = 1.0
    score = E @ onehot  # [P, C]
    S = score.sum(axis=1, keepdims=True)
    denom = bg_gamma + S
    probs = np.concatenate([bg_gamma / denom, score / denom], axis=1)
    sil = (S / denom).reshape(image_size, image_size)
    return {
        "probs": probs.reshape(image_size, image_size, num_parts + 1),
        "silhouette": sil,
        "score": score.reshape(image_size, image_size, num_parts),
    }
