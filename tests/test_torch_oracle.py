"""PyTorch port, the float64 numpy oracle (utils/oracle.py): the port's copy
against the reference's, bitwise, on the tiny asset and seeded inputs; the
port's soft raster (its plain pairwise version and the kernel wrapper, which
runs that version on CPU tensors) against the port's oracle, and its
gradient against central differences through the oracle, as the
reference's tests/test_raster.py holds its own raster.
"""

import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.utils import oracle as joracle
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.utils import assets, oracle


def _raster_case(rng, num_verts=40, size=32, num_parts=5):
    verts2d = (rng.rand(num_verts, 2) * size).astype(np.float32)
    labels = rng.randint(0, num_parts, size=num_verts)
    return verts2d, labels, size, num_parts, 2.0, 1.0


CASES = {
    "rodrigues": lambda m, asset, rng: {"R": m.rodrigues(rng.randn(2, 9, 3).astype(np.float32))},
    "smpl_forward": lambda m, asset, rng: m.smpl_forward(
        asset, (rng.randn(asset.num_joints * 3) * 0.4).astype(np.float32),
        rng.randn(asset.num_betas).astype(np.float32),
    ),
    "project_weak_perspective": lambda m, asset, rng: {
        "x2d": m.project_weak_perspective(rng.randn(11, 3).astype(np.float32), np.array([0.8, 0.1, -0.2], np.float32), 64)
    },
    "soft_rasterize": lambda m, asset, rng: m.soft_rasterize(*_raster_case(rng)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_copy_equals_reference_bitwise(tiny_asset, case):
    """Every array each function returns, from the same seeded inputs: the
    port's copy (on the port's asset) equals the reference's (on its own)."""
    port_asset = assets.synthetic_asset(num_verts=tiny_asset.num_verts, seed=1)
    got = CASES[case](oracle, port_asset, np.random.RandomState(7))
    want = CASES[case](joracle, tiny_asset, np.random.RandomState(7))
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == np.float64, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _port_raster(verts2d, labels, size, num_parts, sigma, gamma):
    layout = raster.build_part_layout(labels, num_parts)
    cfg = raster.RasterConfig(image_size=size, num_parts=num_parts, sigma=sigma, bg_gamma=gamma)
    return layout, cfg


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_soft_rasterize_matches_oracle(rng, impl):
    """Two images: probs and silhouette within the reference's 2e-3 absolute
    (tests/test_raster.py: float32 d² feeding exp amplifies rounding)."""
    verts2d, labels, size, num_parts, sigma, gamma = _raster_case(rng)
    v = np.stack([verts2d, (rng.rand(*verts2d.shape) * size).astype(np.float32)])
    layout, cfg = _port_raster(verts2d, labels, size, num_parts, sigma, gamma)
    out = raster.soft_rasterize(torch.from_numpy(v), layout, cfg, impl=impl)
    for i in range(len(v)):
        want = oracle.soft_rasterize(v[i], labels, size, num_parts, sigma, gamma)
        for k in ("probs", "silhouette"):
            np.testing.assert_allclose(out[k][i].numpy(), want[k], atol=2e-3, err_msg=k)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_raster_gradient_finite_difference(rng, impl):
    """d(loss)/d(verts2d) of a silhouette MSE through the port's raster
    against central differences of the same loss through the float64
    oracle, at the reference's tolerance (rtol 5e-2, atol 1e-7)."""
    verts2d, labels, size, num_parts, sigma, gamma = _raster_case(rng, num_verts=12, size=16)
    layout, cfg = _port_raster(verts2d, labels, size, num_parts, sigma, gamma)
    target = (rng.rand(size, size) > 0.5).astype(np.float64)
    v = torch.from_numpy(verts2d[None]).requires_grad_(True)
    sil = raster.soft_rasterize(v, layout, cfg, impl=impl)["silhouette"][0]
    (g,) = torch.autograd.grad(torch.mean((sil - torch.from_numpy(target).float()) ** 2), v)
    g = g[0].numpy()
    assert np.all(np.isfinite(g))

    def loss(x):
        s = oracle.soft_rasterize(x, labels, size, num_parts, sigma, gamma)["silhouette"]
        return float(np.mean((s - target) ** 2))

    v64, eps = verts2d.astype(np.float64), 1e-5
    for vi, ci in [(0, 0), (5, 1), (11, 0)]:
        dv = np.zeros_like(v64)
        dv[vi, ci] = eps
        fd = (loss(v64 + dv) - loss(v64 - dv)) / (2 * eps)
        np.testing.assert_allclose(g[vi, ci], fd, rtol=5e-2, atol=1e-7)
