"""PyTorch port, preprocessing: the on-device crop/resize, mask crop,
keypoint affine, normalisation and mask boxes against the reference's
`data/preprocess.py`, and the host path (`data/native_preprocess.py`, the
g++-built library and its numpy versions) against the reference's host path,
at the image border, at exact half-pixel ties, downscaling, upscaling and on
non-square sources.

Tolerance of `crop_resize`: its weights are bitwise JAX's
(`compute_weight_mat` of `jax.image.scale_and_translate`), its values within
1e-4 (0-255 scale) of the float64 contraction of JAX's own weight matrices.
JAX's CPU contraction itself strays up to 1.2e-3 from that float64 value
(measured on these cases), so against JAX's output the limit is 2e-3.
Everything else is held exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.image import scale as jscale

from indirect_learning_pose_shape_tpu.data import native_preprocess as jnpp
from indirect_learning_pose_shape_tpu.data import preprocess as jpp
from indirect_learning_pose_shape_tpu_torch.data import native_preprocess as npp
from indirect_learning_pose_shape_tpu_torch.data import preprocess as pp

S = 32
# (source H, W, box (cy, cx, size)) on the output S: inside; past the
# top-left and the bottom-right corners (the reference's disagreeing boxes);
# straddling each edge alone; the first sample at s = -0.5 and the last at
# h - 0.5 exactly; integer sample positions (nearest ties); a downscale
# past every border and an upscale; a non-square source both ways.
CASES = {
    "inside": (48, 40, (24.0, 20.0, 30.0)),
    "top_left": (48, 40, (10.0, 5.0, 60.0)),
    "bottom_right": (48, 40, (40.0, 38.0, 20.0)),
    "top": (48, 40, (3.0, 20.0, 16.0)),
    "bottom": (48, 40, (45.0, 20.0, 16.0)),
    "left": (48, 40, (24.0, 3.0, 16.0)),
    "right": (48, 40, (24.0, 37.0, 16.0)),
    "band_ends": (31, 31, (15.5, 15.5, 32.0)),
    "ties": (48, 40, (16.5, 16.5, 32.0)),
    "ties_step2": (64, 64, (31.0, 33.0, 64.0)),
    "downscale": (40, 40, (20.0, 20.0, 100.0)),
    "upscale": (64, 48, (30.0, 22.0, 12.0)),
    "tall": (64, 24, (30.0, 12.0, 40.0)),
}


def _images(H, W, B=2, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (B, H, W, 3)).astype(np.uint8)


def _boxes(box, B=2):
    return np.tile(np.asarray(box, np.float32), (B, 1))


def _jax_weights(n, box_c, box_size):
    scale, trans = jpp._affine_params(jnp.asarray([box_c, box_c, box_size], jnp.float32), S)
    return np.asarray(jscale.compute_weight_mat(
        n, S, scale[0], trans[0], jscale._kernels[jax.image.ResizeMethod.LINEAR], False
    ))


@pytest.mark.parametrize("case", sorted(CASES))
def test_crop_resize_matches_jax(case):
    H, W, box = CASES[case]
    img, boxes = _images(H, W), _boxes(box)
    # The taps and weights, scattered to JAX's dense [n, S] matrix: bitwise.
    dense = {}
    for axis, n, c in (("y", H, box[0]), ("x", W, box[1])):
        idx, w = pp._linear_taps(torch.tensor([c]), torch.tensor([box[2]]), S, n)
        mat = np.zeros((n, S), np.float32)
        for o in range(S):
            for k in range(2):
                mat[idx[0, o, k], o] += w[0, o, k].item()
        np.testing.assert_array_equal(mat, _jax_weights(n, c, box[2]), err_msg=axis)
        dense[axis] = mat
    got = pp.crop_resize(torch.from_numpy(img), torch.from_numpy(boxes), S).numpy()
    exact = np.einsum("bhwc,ho,wp->bopc", img.astype(np.float64), dense["y"], dense["x"])
    np.testing.assert_allclose(got, exact, atol=1e-4, rtol=0)
    want = np.asarray(jpp.crop_resize(jnp.asarray(img), jnp.asarray(boxes), S))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_crop_resize_band_edges():
    """A sample in [-0.5, h - 0.5] takes the clamped edge value and one
    outside it is 0, as `scale_and_translate` computes (the host path zeroes
    everything outside [0, h - 1])."""
    img = _images(31, 31)
    got = pp.crop_resize(torch.from_numpy(img), torch.from_numpy(_boxes((15.5, 15.5, 32.0))), S).numpy()
    np.testing.assert_allclose(got[:, 0, 0], img[:, 0, 0], atol=1e-4)  # s = (-0.5, -0.5)
    np.testing.assert_allclose(got[:, -1, -1], img[:, -1, -1], atol=1e-4)  # s = (h - 0.5, w - 0.5)
    far = pp.crop_resize(torch.from_numpy(img), torch.from_numpy(_boxes((15.5, -1.0, 32.0))), S).numpy()
    assert (far[:, :, :17] == 0).all()  # x = o - 17 <= -1: outside the band
    assert (far[:, :, 17:] > 0).any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_crop_resize_mask_matches_jax(case):
    H, W, box = CASES[case]
    masks = np.random.RandomState(1).randint(0, 25, (2, H, W)).astype(np.uint8)
    boxes = _boxes(box)
    got = pp.crop_resize_mask(torch.from_numpy(masks), torch.from_numpy(boxes), S).numpy()
    want = np.asarray(jpp.crop_resize_mask(jnp.asarray(masks), jnp.asarray(boxes), S))
    np.testing.assert_array_equal(got, want)


def test_transform_keypoints_and_normalize_match_jax():
    rng = np.random.RandomState(2)
    kp = (rng.rand(3, 19, 2) * 60 - 5).astype(np.float32)
    boxes = np.array([[24, 20, 30], [10, 5, 60], [40.25, 38.5, 20]], np.float32)
    got = pp.transform_keypoints(torch.from_numpy(kp), torch.from_numpy(boxes), S).numpy()
    want = np.asarray(jpp.transform_keypoints(jnp.asarray(kp), jnp.asarray(boxes), S))
    np.testing.assert_array_equal(got, want)
    img = _images(8, 8)
    np.testing.assert_array_equal(pp.normalize(torch.from_numpy(img)).numpy(),
                                  np.asarray(jpp.normalize(jnp.asarray(img))))


def test_bbox_from_mask_matches_jax():
    """A blob, an empty mask, a one-pixel mask (size floor 8), a blob on the
    corner, on a non-square source, batched as the reference vmaps it."""
    m = np.zeros((4, 48, 40), np.uint8)
    m[0, 10:31, 5:17] = 3
    m[2, 47, 39] = 1
    m[3, 0:20, 0:37] = 7
    m[3, 5, 39] = 2
    got = pp.bbox_from_mask(torch.from_numpy(m)).numpy()
    want = np.asarray(jax.vmap(jpp.bbox_from_mask)(jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], [24.0, 20.0, 48.0])
    assert got[2, 2] == 8.0


def _ragged(n, seed=0):
    rng = np.random.RandomState(seed)
    imgs = [rng.randint(0, 256, (40 + 13 * (i % 5), 30 + 7 * i, 3)).astype(np.uint8) for i in range(n)]
    masks = [(rng.rand(*im.shape[:2]) > 0.7).astype(np.uint8) * (i + 1) for i, im in enumerate(imgs)]
    masks[1][:] = 0  # an empty mask: the full-frame box
    return imgs, masks


def test_host_numpy_matches_reference_host_path():
    """The port's numpy versions against the reference's host path: boxes
    bitwise equal to the reference's float32 box (its library's and its
    device path's arithmetic; its numpy fallback rounds a float64 size once
    and may differ by one ulp), masks bitwise, images within 1e-6 on
    [-1, 1] (the port interpolates as the library does, a + (b - a)·t, the
    reference's numpy as a·(1 - t) + b·t)."""
    imgs, masks = _ragged(6)
    boxes = np.stack([npp._np_bbox_from_mask(m, 1.15) for m in masks])
    for m, b in zip(masks, boxes):
        want = np.asarray(jpp.bbox_from_mask(jnp.asarray(m)))
        np.testing.assert_array_equal(b, want)
    boxes[3] = (5.0, 2.0, 70.0)  # past the border
    for im, m, b in zip(imgs, masks, boxes):
        got = npp._np_crop_resize(im, b, S) / np.float32(127.5) - 1
        np.testing.assert_allclose(got, jnpp._np_crop_resize(im, b, S) / 127.5 - 1, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(npp._np_crop_resize(m, b, S, nearest=True),
                                      jnpp._np_crop_resize(m, b, S, nearest=True))


def test_native_library_matches_numpy_bitwise():
    """The library built from native/preprocess.cc (g++ here) against the
    numpy versions on 32 ragged images, boxes inside and past the border:
    bitwise in all three functions. Without g++ the numpy versions run and
    the check is vacuous."""
    imgs, masks = _ragged(32, seed=3)
    boxes = np.stack([npp.bbox_from_mask(m) for m in masks])
    np.testing.assert_array_equal(boxes, np.stack([npp._np_bbox_from_mask(m, 1.15) for m in masks]))
    boxes[4], boxes[5] = (0.0, 0.0, 40.0), (60.0, 3.0, 90.0)
    out = npp.crop_resize_normalize(imgs, boxes, S)
    want = np.stack([npp._np_crop_resize(im, b, S) for im, b in zip(imgs, boxes)])
    np.testing.assert_array_equal(out, want * (np.float32(1.0) / np.float32(127.5)) - np.float32(1.0))
    np.testing.assert_array_equal(
        npp.crop_resize_mask(masks, boxes, S),
        np.stack([npp._np_crop_resize(m, b, S, nearest=True) for m, b in zip(masks, boxes)]),
    )
    assert out.dtype == np.float32 and out.min() >= -1.0 and out.max() <= 1.0
    if npp.SOURCE.is_file() and npp.shutil.which("g++"):
        assert npp.USE_NATIVE and npp.library_path().is_file()


@pytest.mark.parametrize("case", ["inside", "top_left", "bottom_right"])
def test_device_and_host_paths_disagree_as_the_reference_does(case):
    """Inside the image the two paths agree to float32 rounding; past the
    border the on-device band differs from the host's [0, h - 1] on the
    same samples in the port as in the reference."""
    H, W, box = CASES[case]
    img, boxes = _images(H, W, B=1), _boxes(box, B=1)
    dev = pp.crop_resize(torch.from_numpy(img), torch.from_numpy(boxes), S).numpy()[0]
    host = npp._np_crop_resize(img[0], boxes[0], S)
    jdev = np.asarray(jpp.crop_resize(jnp.asarray(img), jnp.asarray(boxes), S))[0]
    jhost = jnpp._np_crop_resize(img[0], boxes[0], S)
    np.testing.assert_array_equal(np.abs(dev - host) > 1.0, np.abs(jdev - jhost) > 1.0)
    if case == "inside":
        np.testing.assert_allclose(dev, host, atol=2e-3)
    else:
        assert np.abs(dev - host).max() > 100.0
