"""PyTorch port, the dense hard raster's CUDA kernel (`csrc/raster_hard.cu`,
`ops/kernels/raster_hard_cuda.py`) against the eager dense path.

On the CPU: the route `hard_raster` takes (CPU tensors and `k_faces` keep the
eager code and launch nothing; `impl='kernel'` refuses a CPU tensor), the
wrapper's argument checks, and the kernel's culling test, which must keep
every face the per-pixel evaluation finds inside, slivers whose rounded edge
functions reach far past their corners included.

On the card (`card` tests, which skip without CUDA), the kernel against
`impl='torch'` bitwise on every output: the robust stream's own b32 bodies at
256², adversarial scenes, every band of a row split, a CUDA graph replayed on
new vertices, and one launch a call. This file imports no JAX; run it on the
card with

    python -m pytest tests/test_torch_raster_hard_kernel.py -q -p no:cacheprovider --noconftest
"""

import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu_torch import configs, train
from indirect_learning_pose_shape_tpu_torch.data import synthetic
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models import smpl
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster_hard
from indirect_learning_pose_shape_tpu_torch.ops.kernels import _build, raster_hard_cuda
from indirect_learning_pose_shape_tpu_torch.parallel.render_sp import Rows
from indirect_learning_pose_shape_tpu_torch.utils import assets

SIZE = 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def small_asset():
    return assets.synthetic_asset(num_verts=864, seed=1)


def _bodies(asset, batch: int, size: int, seed: int = 42):
    """Jittered rest bodies filling a size² canvas, a light per image, and
    the asset's hard consts (on the CPU)."""
    rng = np.random.RandomState(seed)
    v = asset.v_template[None] + 0.02 * rng.randn(batch, *asset.v_template.shape).astype(np.float32)
    v2d = ((v[..., :2] / (np.abs(v[..., :2]).max() + 0.3)) + 1.0) * 0.5 * (size - 1)
    light = np.array([0.35, -0.5, 0.79], np.float32) + 0.6 * rng.randn(batch, 3).astype(np.float32)
    hc = raster_hard.build_hard_consts(asset.faces, np.minimum(asset.part_labels(), 23))
    return (torch.from_numpy(v2d.astype(np.float32)), torch.from_numpy(v[..., 2].astype(np.float32)),
            torch.from_numpy(light), hc)


def _slivers(n: int, size: int, seed: int = 1):
    """n nearly collinear triangles, each on a line through a pixel P0 (with
    a 1e-5 px jitter): their rounded edge functions can all be >= 0 at P0
    though it lies tens of pixels past their corners. -> (verts2d [1, 3n, 2],
    z [1, 3n], faces [n, 3], P0 [n, 2])."""
    g = torch.Generator().manual_seed(seed)
    p0 = torch.randint(0, size, (n, 2), generator=g).float()
    ang = torch.rand(n, generator=g) * np.pi
    d = torch.stack([torch.cos(ang), torch.sin(ang)], -1)
    t = torch.rand(n, 3, generator=g) * 40 + torch.rand(n, 1, generator=g) * 100 - 50
    pts = p0[:, None] + t[..., None] * d[:, None] + (torch.rand(n, 3, 2, generator=g) - 0.5) * 1e-5
    return pts.reshape(1, 3 * n, 2), torch.rand(1, 3 * n, generator=g), torch.arange(3 * n).reshape(n, 3), p0


def _equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), f"{k}: {int((got[k] != want[k]).sum())} elements differ"


def _coeffs_scene(size: int = 256):
    """Bodies at size², slivers and degenerate faces over one face set:
    (verts2d [2, V, 2], z [2, V], lights [2, 3], HardConsts)."""
    asset = assets.synthetic_asset()
    v2d, vz, light, hc = _bodies(asset, 2, size)
    sv, sz, sf, _ = _slivers(512, size)
    flat = torch.tensor([[[10.0, 10.0], [20.0, 20.0], [30.0, 30.0], [5.0, 7.0]]]).expand(2, 4, 2)
    V = v2d.shape[1]
    faces = torch.cat([hc.faces, sf + V, torch.tensor([[0, 1, 2], [3, 3, 0]]) + V + sv.shape[1]])
    return (torch.cat([v2d, sv.expand(2, -1, -1), flat], 1), torch.cat([vz, sz.expand(2, -1), flat[..., 0]], 1),
            light, raster_hard.HardConsts(faces, torch.zeros(faces.shape[0], dtype=torch.int32)))


def _frozen_coeffs_equal(v2d, vz, light, hc) -> None:
    """`_face_coeffs` (all edges at once) against the benchmark's frozen copy
    of the one-edge-at-a-time prologue, bitwise, with and without the shade
    and for one light or one an image."""
    from portbench.reference import hard as frozen

    for shade in (True, False):
        for lt in (light, light[0]):
            got, _, ok = raster_hard._face_coeffs(v2d, vz, hc, shade, lt)
            want, want_ok = frozen._coeffs(v2d, vz, hc.faces, shade, lt.expand(v2d.shape[0], 3))
            assert torch.equal(got, want) and torch.equal(ok, want_ok)
            assert not bool(ok.all()) and bool(ok.any())


def test_face_coeffs_match_the_frozen_prologue():
    _frozen_coeffs_equal(*_coeffs_scene())


# --- CPU: the route and the wrapper ------------------------------------------


def test_cpu_tensors_take_the_eager_code(small_asset):
    """The default route on CPU tensors is the eager code, bitwise, and
    launches nothing."""
    v2d, vz, light, hc = _bodies(small_asset, 2, SIZE)
    _build.reset_counts()
    got = raster_hard.hard_raster(v2d, vz, hc, SIZE, with_shade=True, light=light)
    assert raster_hard_cuda.KERNEL not in _build.counts()
    _equal(got, raster_hard.hard_raster(v2d, vz, hc, SIZE, with_shade=True, light=light, impl="torch"))
    assert 0.05 < float(got["silhouette"].mean()) < 0.9


def test_kernel_impl_refuses_cpu_tensors(small_asset):
    v2d, vz, _, hc = _bodies(small_asset, 1, SIZE)
    with pytest.raises(ValueError, match="CUDA tensor"):
        raster_hard.hard_raster(v2d, vz, hc, SIZE, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        raster_hard.hard_raster(v2d, vz, hc, SIZE, impl="pallas")


def test_k_faces_keeps_the_eager_culled_result(small_asset):
    """With `k_faces` the default route is the eager culled code, overflow
    included, on any device; the kernel refuses it."""
    v2d, vz, _, hc = _bodies(small_asset, 2, SIZE)
    got = raster_hard.hard_raster(v2d, vz, hc, SIZE, k_faces=8)
    assert int(got["overflow"]) > 0
    _equal(got, raster_hard.hard_raster(v2d, vz, hc, SIZE, k_faces=8, impl="torch"))
    assert not raster_hard._use_kernel("auto", torch.device("cuda", 0), 8)
    with pytest.raises(ValueError, match="k_faces"):
        raster_hard.hard_raster(v2d, vz, hc, SIZE, k_faces=8, impl="kernel")


@pytest.mark.parametrize("impl, device, k_faces, want", [
    ("auto", "cuda", None, True),
    ("auto", "cuda", 512, False),
    ("auto", "cpu", None, False),
    ("torch", "cuda", None, False),
    ("kernel", "cuda", None, True),
    ("kernel", "cpu", None, True),  # and the wrapper refuses the CPU tensor
])
def test_route_is_chosen_from_the_input(impl, device, k_faces, want):
    assert raster_hard._use_kernel(impl, torch.device(device), k_faces) is want


def _args(B=2, F=5):
    return (torch.zeros(B, F, 13), torch.ones(B, F, dtype=torch.bool), torch.zeros(F, dtype=torch.int32))


@pytest.mark.parametrize("case, match", [
    ("coeffs_float64", "coeffs must be contiguous float32"),
    ("coeffs_12", "coeffs must be contiguous float32"),
    ("coeffs_2d", r"coeffs must be \[B, F, 13\]"),
    ("coeffs_strided", "coeffs must be contiguous float32"),
    ("ok_uint8", "ok must be contiguous bool"),
    ("ok_shape", "ok must be contiguous bool"),
    ("class_int64", "face_class must be contiguous int32"),
    ("class_shape", "face_class must be contiguous int32"),
    ("negative_band", "bad band"),
    ("cpu", "must be a CUDA tensor"),
])
def test_wrapper_checks_its_arguments(case, match):
    coeffs, ok, fclass = _args()
    band = (8, 8, 0)
    if case == "coeffs_float64":
        coeffs = coeffs.double()
    elif case == "coeffs_12":
        coeffs = coeffs[..., :12].contiguous()
    elif case == "coeffs_2d":
        coeffs = coeffs[0]
    elif case == "coeffs_strided":
        coeffs = torch.zeros(5, 2, 13).transpose(0, 1)
    elif case == "ok_uint8":
        ok = ok.to(torch.uint8)
    elif case == "ok_shape":
        ok = ok[:, :4]
    elif case == "class_int64":
        fclass = fclass.long()
    elif case == "class_shape":
        fclass = fclass[:4]
    elif case == "negative_band":
        band = (8, 8, -1)
    _build.reset_counts()
    with pytest.raises(ValueError, match=match):
        raster_hard_cuda.raster_hard_cuda(coeffs, ok, fclass, *band)
    assert _build.counts() == {}


def _inside(coeffs: torch.Tensor, size: int) -> torch.Tensor:
    """[F, 13] -> [F, size, size]: the eager path's per-pixel inside test."""
    p = torch.arange(size, dtype=torch.float32)

    def plane(i):
        return (coeffs[:, i, None, None] * p[None, None, :] + coeffs[:, i + 1, None, None] * p[None, :, None]) \
            + coeffs[:, i + 2, None, None]

    return torch.minimum(torch.minimum(plane(0), plane(3)), plane(6)) >= 0.0


@pytest.mark.parametrize("rect", [(32, 32), (16, 8), (1, 1)])
def test_culling_test_keeps_every_inside_face_of_bodies(small_asset, rect):
    """On two bodies at 64², every (face, rectangle) pair the dense
    evaluation finds inside somewhere passes the kernel's culling test, for
    its block tiles (32x32), warp patches (16x8) and single pixels; and the
    test does drop faces."""
    v2d, vz, light, hc = _bodies(small_asset, 2, SIZE)
    coeffs, _, ok = raster_hard._face_coeffs(v2d, vz, hc, True, light)
    w, h = rect
    dropped = 0
    for b in range(2):
        inside = _inside(coeffs[b], SIZE) & ok[b, :, None, None]
        for y0 in range(0, SIZE, h):
            for x0 in range(0, SIZE, w):
                keep = raster_hard_cuda.may_cover(coeffs[b], x0, x0 + w - 1, y0, y0 + h - 1)
                needed = inside[:, y0 : y0 + h, x0 : x0 + w].flatten(1).any(1)
                assert not (needed & ~keep).any(), f"image {b}, rect at ({x0}, {y0}) dropped an inside face"
                dropped += int((~keep).sum())
    assert dropped > 0


def test_culling_test_keeps_slivers_past_their_box():
    """Nearly collinear faces evaluate inside at pixels tens of pixels past
    their vertices' box (so a box test with a 1 px margin would drop them);
    the culling test keeps each such face for the pixel, its patch and its
    tile."""
    v2d, vz, faces, p0 = _slivers(20000, 256)
    hc = raster_hard.HardConsts(faces, torch.zeros(faces.shape[0], dtype=torch.int32))
    coeffs, (xmin, xmax, ymin, ymax), ok = raster_hard._face_coeffs(v2d, vz, hc, False, None)
    coeffs, ok, px, py = coeffs[0], ok[0], p0[:, 0], p0[:, 1]

    def plane(i):
        return (coeffs[:, i] * px + coeffs[:, i + 1] * py) + coeffs[:, i + 2]

    inside = (torch.minimum(torch.minimum(plane(0), plane(3)), plane(6)) >= 0.0) & ok
    past = inside & ((px < xmin[0] - 1) | (px > xmax[0] + 1) | (py < ymin[0] - 1) | (py > ymax[0] + 1))
    assert int(past.sum()) > 100
    idx = torch.nonzero(inside).flatten()
    x, y = px[idx].long(), py[idx].long()
    for w, h in ((1, 1), (16, 8), (32, 32)):
        x0, y0 = x - x % w, y - y % h
        keep = torch.stack([raster_hard_cuda.may_cover(coeffs[i], int(a), int(a) + w - 1, int(c), int(c) + h - 1)
                            for i, a, c in zip(idx.tolist(), x0, y0)])
        assert keep.all(), f"{int((~keep).sum())} inside slivers dropped at {w}x{h}"


# --- The card: the kernel against the eager dense path ----------------------


def _render(v2d, vz, hc, size, impl, **kw):
    return raster_hard.hard_raster(v2d, vz, hc, size, impl=impl, **kw)


def _on(device, *xs):
    return [x.to(device) for x in xs]


@pytest.mark.card
def test_face_coeffs_match_the_frozen_prologue_on_the_card(card):
    v2d, vz, light, hc = _coeffs_scene()
    _frozen_coeffs_equal(*_on(card, v2d, vz, light), raster_hard.HardConsts(*_on(card, hc.faces, hc.face_class)))


@pytest.mark.card
def test_kernel_equals_eager_on_the_robust_stream(card):
    """config4_robust's own batch 0 at b32, 256², with the shade and the
    batch's lights: all five outputs bitwise."""
    cfg = configs.CONFIG4_ROBUST
    B, S = cfg.batch_size, cfg.model.image_size
    consts = net.build_consts(assets.synthetic_asset(), cfg.model, device=card)
    gen = torch.Generator(device=card).manual_seed(train.step_seed(cfg.seed, 0))
    draws = synthetic.sample_draws(gen, B, consts, cfg.synthetic, S)
    verts = smpl.smpl_forward(consts.smpl, draws["pose"], draws["betas"], impl=cfg.model.smpl_impl)["verts"]
    v2d, vz = camera.project_pixel(verts, draws["cam"], S), verts[..., 2]
    kw = dict(with_shade=True, light=draws["light"])
    got, want = _render(v2d, vz, consts.hard, S, "kernel", **kw), _render(v2d, vz, consts.hard, S, "torch", **kw)
    _equal(got, want)
    assert 0.01 < float(got["silhouette"].mean()) < 0.9 and int(got["overflow"]) == 0


def _adversarial(size: int):
    """Four images over one face set: (0) a body, two identical coplanar
    faces of classes 3 and 7, faces straddling the tile borders and the
    canvas edges, degenerate faces and slivers; (1) the same moved 1000 px
    off the canvas (only a sliver's rounding can still reach it); (2) every
    vertex at one point (empty); (3) image 0 mirrored."""
    asset = assets.synthetic_asset(num_verts=864, seed=1)
    v2d, vz, _, hc = _bodies(asset, 1, size)
    faces, fclass = [hc.faces], [hc.face_class]
    pts, zs = [v2d[0]], [vz[0]]

    def add(p, z, f, c):
        n = sum(x.shape[0] for x in pts)
        pts.append(torch.tensor(p, dtype=torch.float32))
        zs.append(torch.tensor(z, dtype=torch.float32))
        faces.append(torch.tensor(f, dtype=torch.int64) + n)
        fclass.append(torch.tensor(c, dtype=torch.int32))

    # Coplanar duplicates of classes 3 and 7 in front of the body: the tie
    # goes to the larger class.
    add([[5.5, 5.5], [size * 0.6, 8.25], [9.75, size * 0.55]], [9.0, 9.0, 9.0], [[0, 1, 2], [0, 1, 2]], [3, 7])
    # Straddling the tile borders (x, y = 31.5) and the canvas edges.
    e = size - 1
    add([[25.0, 28.0], [38.0, 30.5], [31.5, 40.0], [-7.0, -3.0], [6.0, -9.0], [-5.0, 12.0],
         [e + 6.0, e - 4.0], [e - 8.0, e + 7.0], [e + 3.0, e + 9.0]],
        [8.0, 8.5, 8.2, 8.0, 8.0, 8.0, 8.0, 8.0, 8.0], [[0, 1, 2], [3, 4, 5], [6, 7, 8]], [11, 12, 13])
    # Degenerate: a repeated vertex and three exactly collinear ones.
    add([[20.0, 20.0], [30.0, 10.0], [10.0, 10.0], [12.0, 12.0], [16.0, 16.0]], [9.5] * 5,
        [[0, 0, 1], [2, 3, 4]], [5, 6])
    # Slivers: nearly collinear, |area| from 0 past 1e-9 up; in front of the
    # body, behind the faces above.
    sv, sz, sf, _ = _slivers(64, size, seed=3)
    add(sv[0].tolist(), (2.0 + sz[0]).tolist(), sf.tolist(), list(range(64)))
    v = torch.cat(pts)
    hc = raster_hard.HardConsts(torch.cat(faces), torch.cat(fclass) % 24)
    z = torch.cat(zs)
    v2d = torch.stack([v, v + 1000.0, torch.full_like(v, size / 2.0), torch.stack([e - v[:, 0], v[:, 1]], -1)])
    vz = torch.stack([z, z, z, z])
    light = torch.tensor([[0.35, -0.5, 0.79], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [-0.2, 0.4, 0.9]])
    return v2d, vz, light, hc


@pytest.mark.card
@pytest.mark.parametrize("size, tile", [(64, 32), (256, 32), (48, 16)])
def test_kernel_equals_eager_on_adversarial_scenes(card, size, tile):
    """Ties, tile and canvas borders, degenerate faces, slivers, an
    off-canvas body and an empty image (48²: a canvas the kernel's 32x32
    tiles do not divide): bitwise, with and without the shade."""
    v2d, vz, light, hc = _adversarial(size)
    v2d, vz, light = _on(card, v2d, vz, light)
    hc = raster_hard.HardConsts(*_on(card, hc.faces, hc.face_class))
    for kw in (dict(with_shade=True, light=light), {}):
        got = _render(v2d, vz, hc, size, "kernel", tile=tile, **kw)
        _equal(got, _render(v2d, vz, hc, size, "torch", tile=tile, **kw))
    assert float(got["silhouette"][0].mean()) > 0.05
    assert not got["silhouette"][2].any()
    assert got["part_labels"][0, 8, 8] == 8  # the coplanar tie: class 7 over class 3
    assert (got["zbuf"][2] == raster_hard._NEG).all()


@pytest.mark.card
@pytest.mark.parametrize("count", [2, 4])
def test_kernel_bands_equal_the_whole_render(card, count):
    """Every band of a `count`-way row split equals the eager band, and the
    bands concatenated equal the whole render."""
    v2d, vz, light, hc = _adversarial(256)
    v2d, vz, light = _on(card, v2d, vz, light)
    hc = raster_hard.HardConsts(*_on(card, hc.faces, hc.face_class))
    kw = dict(with_shade=True, light=light)
    whole = _render(v2d, vz, hc, 256, "kernel", **kw)
    bands = []
    for i in range(count):
        rows = Rows(index=i, count=count, group=None)
        band = _render(v2d, vz, hc, 256, "kernel", rows=rows, **kw)
        _equal(band, _render(v2d, vz, hc, 256, "torch", rows=rows, **kw))
        bands.append(band)
    for k in ("part_labels", "silhouette", "zbuf", "shade"):
        assert torch.equal(torch.cat([b[k] for b in bands], dim=1), whole[k]), k


@pytest.mark.card
def test_kernel_in_a_cuda_graph_on_new_vertices(card):
    """One call captured in a CUDA graph, replayed after new vertices are
    copied into its inputs, equals the eager path on those vertices; each
    call launches the kernel once."""
    asset = assets.synthetic_asset()
    v2d, vz, light, hc = _bodies(asset, 4, 256, seed=5)
    v2d, vz, light = _on(card, v2d, vz, light)
    hc = raster_hard.HardConsts(*_on(card, hc.faces, hc.face_class))
    kw = dict(with_shade=True, light=light)
    _build.reset_counts()
    _render(v2d, vz, hc, 256, "auto", **kw)  # warm: builds and loads the library
    assert _build.counts() == {raster_hard_cuda.KERNEL: 1}
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        out = _render(v2d, vz, hc, 256, "auto", **kw)
    torch.cuda.current_stream().wait_stream(stream)
    assert _build.counts() == {raster_hard_cuda.KERNEL: 2}
    v2d2, vz2, _, _ = _bodies(asset, 4, 256, seed=6)
    v2d.copy_(v2d2.to(card) + 3.25)
    vz.copy_(vz2.to(card))
    graph.replay()
    torch.cuda.synchronize()
    _equal(out, _render(v2d, vz, hc, 256, "torch", **kw))
    assert _build.counts() == {raster_hard_cuda.KERNEL: 2}  # the eager render launches nothing
