"""What the benchmark makes and hands to both sides: the SMPL stand-in, the
weights and the crops.

- The stand-in has SMPL's exact shapes (V=6890, 24 joints, 10 betas, 207
  pose correctives, the cocoplus regressor's 19 keypoints) and is a frozen
  copy of the port's `utils/assets.synthetic_asset`, which is bitwise the
  reference package's: the licensed model is a download.
- The weights are drawn on the card from the seed in a few large calls:
  He-normal convolutions and IEF layers (zero biases), BatchNorm scale
  1 + 0.1·z, bias, running mean 0.1·z and running variance exp(0.2·z), and
  IEF's output layer at std 1e-3 · 0.01 (the port's 1e-3, scaled by 0.01 as
  `chip_smoke.py` does so that the bodies stay in frame), from Θ₀ = the
  neutral pose and shape with camera scale 0.9. Named as the port's
  `state_dict`.
- The crops are uniform in [-1, 1], drawn on the card from the seed and
  held in host memory, where a client holds its images.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from portbench.reference import model as model_lib

SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21], dtype=np.int32
)
ASSET_FIELDS = ("v_template", "shapedirs", "posedirs", "J_regressor", "cocoplus_regressor",
                "weights", "parents", "faces")


def _faces(v_template: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-part convex hulls of the vertex cloud, [F, 3] int32."""
    from scipy.spatial import ConvexHull, QhullError

    v = np.asarray(v_template, np.float64)
    tris = []
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        if len(idx) < 4:
            continue
        try:
            hull = ConvexHull(v[idx])
        except QhullError:
            rng = np.random.RandomState(int(c) + 1)
            try:
                hull = ConvexHull(v[idx] + rng.randn(len(idx), 3) * 1e-6)
            except QhullError:
                continue
        tris.append(idx[hull.simplices])
    return np.ascontiguousarray(np.concatenate(tris).astype(np.int32))


def stand_in(num_verts: int = 6890, seed: int = 0, num_joints: int = 24, num_betas: int = 10):
    """The SMPL-shaped stand-in: a namespace of float32 arrays (int32
    parents and faces) under the asset's field names."""
    rng = np.random.RandomState(seed)
    parents = SMPL_PARENTS.copy()
    joint_pos = np.zeros((num_joints, 3), dtype=np.float64)
    for k in range(1, num_joints):
        joint_pos[k] = joint_pos[parents[k]] + rng.randn(3) * np.array([0.35, 0.5, 0.12]) * 0.25
    owner = rng.randint(0, num_joints, size=num_verts)
    v_template = joint_pos[owner] + rng.randn(num_verts, 3) * 0.07
    d = np.linalg.norm(v_template[:, None, :] - joint_pos[None, :, :], axis=-1)
    logits = -d / 0.08
    logits -= logits.max(axis=1, keepdims=True)
    weights = np.exp(logits)
    weights /= weights.sum(axis=1, keepdims=True)
    jr = weights.T.copy()
    jr /= jr.sum(axis=1, keepdims=True) + 1e-12
    shapedirs = rng.randn(num_verts, 3, num_betas) * 0.01
    posedirs = rng.randn(num_verts, 3, (num_joints - 1) * 9) * 0.002
    coco = np.zeros((19, num_verts), dtype=np.float64)
    picks = rng.randint(0, num_joints, size=19)
    picks[: min(19, num_joints)] = np.arange(min(19, num_joints))
    for i, k in enumerate(picks):
        coco[i] = jr[k]
    faces = _faces(v_template.astype(np.float32), np.argmax(weights, axis=1).astype(np.int32))
    return types.SimpleNamespace(
        v_template=v_template.astype(np.float32), shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32), J_regressor=jr.astype(np.float32),
        cocoplus_regressor=coco.astype(np.float32), weights=weights.astype(np.float32),
        parents=parents, faces=faces,
    )


def port_asset(asset):
    """The stand-in as the port's `SMPLAsset`, for the program's side."""
    from indirect_learning_pose_shape_tpu_torch.utils import assets

    return assets.SMPLAsset(**{k: getattr(asset, k) for k in ASSET_FIELDS})


def weight_shapes(depth: int, rotation: str, hidden=(1024, 1024), num_joints: int = 24):
    """[(name, shape, kind)] of every tensor of the model, kind in 'conv',
    'bn', 'ief', 'ief_out', 'ief_bias', 'mean_theta'."""
    out = [("encoder.stem", (64, 3, 7, 7), "conv"), ("encoder.bn_stem", (64,), "bn")]
    for name, cin, cout, stride in model_lib.blocks(depth):
        p = "encoder." + name
        out += [(p + ".conv1", (cout, cin, 3, 3), "conv"), (p + ".bn1", (cout,), "bn"),
                (p + ".conv2", (cout, cout, 3, 3), "conv"), (p + ".bn2", (cout,), "bn")]
        if stride != 1 or cin != cout:
            out += [(p + ".proj", (cout, cin, 1, 1), "conv"), (p + ".bn_proj", (cout,), "bn")]
    theta = num_joints * (6 if rotation == "rot6d" else 3) + 10 + 3
    dims = [512 + theta, *hidden, theta]
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        out.append((f"ief.layers.{i}.weight", (b, a), "ief_out" if i == len(dims) - 2 else "ief"))
        out.append((f"ief.layers.{i}.bias", (b,), "ief_bias"))
    out.append(("ief.mean_theta", (theta,), "mean_theta"))
    return out


def make_weights(depth: int, rotation: str, seed: int, device, num_joints: int = 24) -> dict:
    """The model's tensors from `seed`, drawn on `device` in two calls."""
    shapes = weight_shapes(depth, rotation, num_joints=num_joints)
    drawn = [s for _, s, kind in shapes if kind in ("conv", "ief", "ief_out")]
    bn = [s for _, s, kind in shapes if kind == "bn"]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(math.prod(s) for s in drawn) + 4 * sum(s[0] for s in bn),
                    generator=gen, device=device)
    w, at = {}, 0

    def take(n):
        nonlocal at
        at += n
        return z[at - n : at]

    for name, shape, kind in shapes:
        if kind == "conv":
            std = math.sqrt(2.0 / (shape[1] * shape[2] * shape[3]))
            w[name] = take(math.prod(shape)).reshape(shape) * std
        elif kind in ("ief", "ief_out"):
            std = 1e-3 * 0.01 if kind == "ief_out" else math.sqrt(2.0 / shape[1])
            w[name] = take(math.prod(shape)).reshape(shape) * std
        elif kind == "ief_bias":
            w[name] = torch.zeros(shape, device=device)
        elif kind == "bn":
            c = shape[0]
            w[name + ".scale"] = 1.0 + 0.1 * take(c)
            w[name + ".bias"] = 0.1 * take(c)
            w[name + ".mean"] = 0.1 * take(c)
            w[name + ".var"] = torch.exp(0.2 * take(c))
        else:
            pose0 = [1.0, 0, 0, 0, 1, 0] if rotation == "rot6d" else [0.0, 0, 0]
            theta = torch.tensor(pose0 * num_joints + [0.0] * 10 + [0.9, 0.0, 0.0], device=device)
            w[name] = theta
    return {k: v.contiguous() for k, v in w.items()}


def crop_pool(n: int, size: int, seed: int, device) -> np.ndarray:
    """[n, size, size, 3] float32 crops uniform in [-1, 1], in host memory."""
    gen = torch.Generator(device=device).manual_seed(seed)
    crops = torch.rand((n, size, size, 3), generator=gen, device=device) * 2.0 - 1.0
    return crops.cpu().numpy()
