"""SMPL model asset (numpy copy of the reference's utils/assets.py).

The asset is a plain dataclass of float32 numpy arrays. `load_asset` reads a
real SMPL model when one is present (an ``.npz`` in the layout of
`save_npz`, or the chumpy-era ``.pkl``) and otherwise builds
`synthetic_asset`: a deterministic stand-in with SMPL's exact shapes, whose
arrays are bit-identical to the reference's for the same arguments.

Tensor shapes:
    v_template   [V, 3]      rest-pose vertices        (V = 6890)
    shapedirs    [V, 3, 10]  shape blendshape basis
    posedirs     [V, 3, 207] pose-corrective basis      (207 = 23 * 9)
    J_regressor  [24, V]     rest-joint regressor
    cocoplus_regressor [19, V]  keypoint regressor
    weights      [V, 24]     LBS skinning weights (rows sum to 1)
    parents      [24]        kinematic-tree parent index (parents[0] = -1)
    faces        [F, 3]      triangle indices (visualisation only)
"""

from __future__ import annotations

import dataclasses
import io
import os
import pickle
from typing import Optional

import numpy as np

NUM_VERTS = 6890
NUM_JOINTS = 24
NUM_BETAS = 10
NUM_COCO_JOINTS = 19

# Standard SMPL kinematic tree (public model topology; joint k's parent).
SMPL_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)


@dataclasses.dataclass(frozen=True)
class SMPLAsset:
    """Container for the SMPL model tensors (all float32 numpy)."""

    v_template: np.ndarray
    shapedirs: np.ndarray
    posedirs: np.ndarray
    J_regressor: np.ndarray
    cocoplus_regressor: np.ndarray
    weights: np.ndarray
    parents: np.ndarray
    faces: np.ndarray

    @property
    def num_verts(self) -> int:
        return int(self.v_template.shape[0])

    @property
    def num_joints(self) -> int:
        return int(self.J_regressor.shape[0])

    @property
    def num_betas(self) -> int:
        return int(self.shapedirs.shape[2])

    def part_labels(self) -> np.ndarray:
        """Per-vertex body-part label in [0, num_joints): argmax skin weight."""
        return np.argmax(self.weights, axis=1).astype(np.int32)

    def validate(self) -> None:
        v, j, b = self.num_verts, self.num_joints, self.num_betas
        assert self.v_template.shape == (v, 3)
        assert self.shapedirs.shape == (v, 3, b)
        assert self.posedirs.shape == (v, 3, (j - 1) * 9)
        assert self.J_regressor.shape == (j, v)
        assert self.weights.shape == (v, j)
        assert self.parents.shape == (j,)
        assert self.parents[0] == -1
        assert np.all(self.parents[1:] < np.arange(1, j)), "parents must precede children"
        np.testing.assert_allclose(self.weights.sum(axis=1), 1.0, atol=1e-4)


def structured_faces(v_template: np.ndarray, part_labels: np.ndarray) -> np.ndarray:
    """Per-part convex hulls (qhull) over an unordered vertex cloud.

    The synthetic asset's vertices are Gaussian blobs around bones with no
    connectivity of their own; the union of each part's hull triangles gives
    it a surface. Returns [F, 3] int32 global vertex indices.
    """
    from scipy.spatial import ConvexHull, QhullError

    v = np.asarray(v_template, np.float64)
    labels = np.asarray(part_labels)
    tris: list[np.ndarray] = []
    for c in np.unique(labels):
        idx = np.nonzero(labels == c)[0]
        if len(idx) < 4:
            continue
        try:
            hull = ConvexHull(v[idx])
        except QhullError:
            # Degenerate (coplanar) part: jitter deterministically and retry.
            rng = np.random.RandomState(int(c) + 1)
            try:
                hull = ConvexHull(v[idx] + rng.randn(len(idx), 3) * 1e-6)
            except QhullError:
                continue
        tris.append(idx[hull.simplices])
    if not tris:
        return np.zeros((0, 3), dtype=np.int32)
    return np.ascontiguousarray(np.concatenate(tris).astype(np.int32))


def synthetic_asset(
    num_verts: int = NUM_VERTS,
    num_joints: int = NUM_JOINTS,
    num_betas: int = NUM_BETAS,
    seed: int = 0,
) -> SMPLAsset:
    """Deterministic synthetic SMPL-shaped asset.

    A roughly body-sized vertex cloud (unit scale, zero-centred), joints at
    skinning-weight centroids, smooth skinning weights and small blendshape
    bases. Reduced sizes (e.g. V=864) serve the CPU tests.
    """
    rng = np.random.RandomState(seed)
    if num_joints == NUM_JOINTS:
        parents = SMPL_PARENTS.copy()
    else:
        parents = np.concatenate(
            [[-1], rng.randint(0, np.maximum(1, np.arange(1, num_joints)))]
        ).astype(np.int32)
        # Parent index < child index (topological order), as in SMPL.
        parents[1:] = np.minimum(parents[1:], np.arange(num_joints - 1))

    # Joint rest positions: a rough stick-figure along y, branching in x.
    joint_pos = np.zeros((num_joints, 3), dtype=np.float64)
    for k in range(1, num_joints):
        direction = rng.randn(3) * np.array([0.35, 0.5, 0.12])
        joint_pos[k] = joint_pos[parents[k]] + direction * 0.25

    # Vertices: Gaussian blobs around the bones.
    owner = rng.randint(0, num_joints, size=num_verts)
    v_template = joint_pos[owner] + rng.randn(num_verts, 3) * 0.07

    # Skinning weights: softmax of negative distance to each joint.
    d = np.linalg.norm(v_template[:, None, :] - joint_pos[None, :, :], axis=-1)
    logits = -d / 0.08
    logits -= logits.max(axis=1, keepdims=True)
    weights = np.exp(logits)
    weights /= weights.sum(axis=1, keepdims=True)

    # Joint regressor: normalised proximity weights (rows sum to 1), so that
    # J_regressor @ v_template ≈ joint_pos.
    jr = weights.T.copy()  # [J, V]
    jr /= jr.sum(axis=1, keepdims=True) + 1e-12

    shapedirs = rng.randn(num_verts, 3, num_betas) * 0.01
    posedirs = rng.randn(num_verts, 3, (num_joints - 1) * 9) * 0.002

    ncoco = min(NUM_COCO_JOINTS, num_joints)
    coco = np.zeros((NUM_COCO_JOINTS, num_verts), dtype=np.float64)
    picks = rng.randint(0, num_joints, size=NUM_COCO_JOINTS)
    picks[:ncoco] = np.arange(ncoco)
    for i, k in enumerate(picks):
        coco[i] = jr[k]

    faces = structured_faces(
        v_template.astype(np.float32), np.argmax(weights, axis=1).astype(np.int32)
    )

    asset = SMPLAsset(
        v_template=v_template.astype(np.float32),
        shapedirs=shapedirs.astype(np.float32),
        posedirs=posedirs.astype(np.float32),
        J_regressor=jr.astype(np.float32),
        cocoplus_regressor=coco.astype(np.float32),
        weights=weights.astype(np.float32),
        parents=parents,
        faces=faces,
    )
    asset.validate()
    return asset


class _ChumpyShimUnpickler(pickle.Unpickler):
    """Unpickles chumpy/scipy-bearing SMPL pkls without chumpy installed:
    each `chumpy.Ch` becomes a minimal object exposing its ndarray."""

    class _Ch:
        def __setstate__(self, state):
            self.__dict__.update(state)

        @property
        def r(self):
            return np.asarray(self.__dict__.get("x"))

    def find_class(self, module, name):
        if module.startswith("chumpy"):
            return _ChumpyShimUnpickler._Ch
        return super().find_class(module, name)


def _to_dense(x) -> np.ndarray:
    if hasattr(x, "r"):  # chumpy shim
        x = x.r
    if hasattr(x, "todense"):  # scipy sparse
        x = np.asarray(x.todense())
    return np.asarray(x, dtype=np.float64)


def load_pkl(path: str) -> SMPLAsset:
    """Load a real SMPL pkl (chumpy-era pickle) into an SMPLAsset."""
    with open(path, "rb") as f:
        data = _ChumpyShimUnpickler(io.BytesIO(f.read()), encoding="latin1").load()
    parents = np.asarray(data["kintree_table"], dtype=np.int64)[0].astype(np.int32)
    parents[0] = -1
    coco_key = "cocoplus_regressor" if "cocoplus_regressor" in data else "J_regressor"
    return SMPLAsset(
        v_template=_to_dense(data["v_template"]).astype(np.float32),
        shapedirs=_to_dense(data["shapedirs"]).astype(np.float32),
        posedirs=_to_dense(data["posedirs"]).astype(np.float32),
        J_regressor=_to_dense(data["J_regressor"]).astype(np.float32),
        cocoplus_regressor=_to_dense(data[coco_key]).astype(np.float32),
        weights=_to_dense(data["weights"]).astype(np.float32),
        parents=parents,
        faces=np.asarray(data["f"], dtype=np.int32),
    )


_FIELDS = [f.name for f in dataclasses.fields(SMPLAsset)]


def save_npz(asset: SMPLAsset, path: str) -> None:
    np.savez_compressed(path, **{k: getattr(asset, k) for k in _FIELDS})


def load_npz(path: str) -> SMPLAsset:
    with np.load(path) as z:
        asset = SMPLAsset(**{k: z[k] for k in _FIELDS})
    asset.validate()
    return asset


def load_asset(path: Optional[str] = None, **synthetic_kwargs) -> SMPLAsset:
    """Load the SMPL asset: a real file if available, else the synthetic one.

    Search order: explicit `path` (npz or pkl), `$SMPL_ASSET_PATH`, the
    repository root's `assets/smpl_neutral.npz` and
    `assets/neutral_smpl_with_cocoplus_reg.pkl`, then `synthetic_asset()`.
    """
    candidates = []
    if path:
        candidates.append(path)
    env = os.environ.get("SMPL_ASSET_PATH")
    if env:
        candidates.append(env)
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates += [
        os.path.join(root, "assets", "smpl_neutral.npz"),
        os.path.join(root, "assets", "neutral_smpl_with_cocoplus_reg.pkl"),
    ]
    for cand in candidates:
        if os.path.exists(cand):
            return load_npz(cand) if cand.endswith(".npz") else load_pkl(cand)
    return synthetic_asset(**synthetic_kwargs)
