"""PyTorch port, disk datasets: the files the port's `make_synthetic_dataset`
writes against the reference's format (keys, dtypes, shapes), each file read
by both frameworks' `NpzDataset` with the same batch stream (bitwise, in
order: epochs, the endless stream, a resume mid-epoch), `shard_npz` and
`ShardedNpzDataset` against the reference's (resume mid-shard and past whole
shards, which are never read), `open_dataset`'s dispatch, the label
refusal, and `prefetch_to_device` on the CPU: order, values, dtypes, the
bound on batches in flight, a loader's error and closing.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu.data import dataset as jds
from indirect_learning_pose_shape_tpu_torch.data import dataset as ds
from indirect_learning_pose_shape_tpu_torch.data import synthetic

N, SRC = 12, 48


@pytest.fixture(scope="module")
def files(tmp_path_factory, tiny_asset):
    """One dataset file written by each framework's writer (12 examples at
    48², tiny asset) and the port's arrays."""
    d = tmp_path_factory.mktemp("data")
    port, ref = str(d / "port.npz"), str(d / "ref.npz")
    arrays = ds.make_synthetic_dataset(port, N, source_size=SRC, asset=tiny_asset, device="cpu")
    jds.make_synthetic_dataset(ref, N, source_size=SRC, asset=tiny_asset)
    return {"port": port, "reference": ref, "arrays": arrays, "dir": d}


def _same_stream(a, b, n):
    """The first n batches of streams a and b (each pulled n times at most)
    bitwise equal."""
    got, want = [x for _, x in zip(range(n), a)], [y for _, y in zip(range(n), b)]
    assert len(got) == len(want) == n
    for i, (x, y) in enumerate(zip(got, want)):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=f"batch {i} {k}")


def test_writer_matches_reference_format(files):
    """Keys, dtypes and shapes as the reference writes them; labels in the
    24-part space, bodies in frame, a stream of distinct examples."""
    with np.load(files["port"]) as p, np.load(files["reference"]) as r:
        assert sorted(p.files) == sorted(r.files)
        for k in r.files:
            assert (p[k].dtype, p[k].shape) == (r[k].dtype, r[k].shape), k
        masks = p["masks"]
        assert masks.max() <= 24 and (masks > 0).mean() > 0.02
        assert len({p["images"][i].tobytes() for i in range(N)}) == N
        np.testing.assert_array_equal(p["images"], files["arrays"]["images"])


def test_writer_3d_keys_seed_and_targets(tiny_asset):
    """include_3d / include_verts3d as the reference's; the same seed writes
    the same arrays, another seed others; targets='hard' writes the hard
    raster's masks."""
    a = ds.make_synthetic_dataset(None, 3, source_size=SRC, asset=tiny_asset, include_3d=True,
                                  include_verts3d=True, seed=4, device="cpu")
    assert a["joints3d"].shape == (3, 24, 3) and a["rotmats"].shape == (3, 24, 3, 3)
    assert a["verts3d"].shape == (3, tiny_asset.v_template.shape[0], 3) and "betas" not in a
    b = ds.make_synthetic_dataset(None, 3, source_size=SRC, asset=tiny_asset, seed=4, device="cpu")
    np.testing.assert_array_equal(a["images"], b["images"])
    c = ds.make_synthetic_dataset(None, 3, source_size=SRC, asset=tiny_asset, seed=5, device="cpu")
    assert not np.array_equal(a["images"], c["images"])
    soft, hard = (
        ds.make_synthetic_dataset(None, 2, source_size=64, asset=tiny_asset, seed=4, device="cpu",
                                  synth=synthetic.SyntheticConfig(targets=t))
        for t in ("soft", "hard")  # the hard raster's tiles are 32 pixels
    )
    assert not np.array_equal(hard["masks"], soft["masks"]) and hard["masks"].max() > 0


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_npz_stream_matches_reference(files, writer):
    """Each file read by both NpzDatasets: the same batches, bitwise, in
    order: epochs 0 and 1, the endless stream across epochs, and resumes
    mid-epoch and at an epoch boundary."""
    mine, ref = ds.NpzDataset(files[writer], 4, seed=3), jds.NpzDataset(files[writer], 4, seed=3)
    assert (mine.keys, mine.steps_per_epoch()) == (ref.keys, ref.steps_per_epoch())
    for e in (0, 1):
        _same_stream(mine.epoch(e), ref.epoch(e), 3)
    _same_stream(mine.batches(), ref.batches(), 7)
    for start in (2, 3, 5):
        _same_stream(mine.batches(start_step=start), ref.batches(start_step=start), 5)
    straight = list(zip(range(8), mine.batches()))
    _same_stream(mine.batches(start_step=5), (b for _, b in straight[5:]), 3)


@pytest.fixture(scope="module")
def shards(files):
    """The port's file split by both frameworks' shard_npz: 5 + 5 + 2."""
    out = {}
    for name, fn in (("port", ds.shard_npz), ("reference", jds.shard_npz)):
        out[name] = fn(files["port"], str(files["dir"] / f"shards_{name}"), shard_size=5)
    return out


def test_shard_npz_matches_reference(shards):
    assert [os.path.basename(p) for p in shards["port"]] == [os.path.basename(p) for p in shards["reference"]]
    for a, b in zip(shards["port"], shards["reference"]):
        with np.load(a) as x, np.load(b) as y:
            assert x.files == y.files
            for k in x.files:
                np.testing.assert_array_equal(x[k], y[k])
    with pytest.raises(ValueError, match="positive"):
        ds.shard_npz(shards["port"][0], "unused", 0)


def test_sharded_stream_matches_reference(shards):
    """Two-level shuffle, ragged shard tails dropped: the endless stream,
    epoch 1, and resumes mid-shard and past whole shards, which are never
    loaded."""
    d = os.path.dirname(shards["port"][0])
    mine, ref = ds.ShardedNpzDataset(d, 2, seed=3), jds.ShardedNpzDataset(d, 2, seed=3)
    assert mine.steps_per_epoch() == ref.steps_per_epoch() == 5 and mine.keys == ref.keys
    _same_stream(mine.batches(), ref.batches(), 12)
    _same_stream(mine.epoch(1), ref.epoch(1), 5)
    for start in range(0, 11):
        _same_stream(mine.batches(start_step=start), ref.batches(start_step=start), 3)
    loaded = []
    load = mine._load
    mine._load = lambda i: loaded.append(i) or load(i)
    order = mine._shard_order(0)  # epoch 0's shards: 2, 2 and 1 steps in turn
    spe = [mine._spe[i] for i in order]
    start = spe[0] + spe[1]  # the first batch of epoch 0's third shard
    next(mine.batches(start_step=start))
    assert loaded == [order[2]]


def test_open_dataset_dispatch(files, shards):
    d = os.path.dirname(shards["port"][0])
    assert isinstance(ds.open_dataset(files["port"], 2), ds.NpzDataset)
    assert isinstance(ds.open_dataset(d, 2), ds.ShardedNpzDataset)
    assert isinstance(ds.open_dataset(os.path.join(d, "*.npz"), 2), ds.ShardedNpzDataset)
    with pytest.raises(FileNotFoundError):
        ds.ShardedNpzDataset(os.path.join(d, "none_*.npz"), 2)


def test_mask_labels_past_255_are_refused(tmp_path):
    arrays = {"images": np.zeros((2, 4, 4, 3), np.uint8), "masks": np.full((2, 4, 4), 300, np.uint16),
              "kp2d": np.zeros((2, 19, 2), np.float32), "kp_vis": np.zeros((2, 19), np.float32)}
    with pytest.raises(ValueError, match="< 256"):
        ds.NpzDataset(arrays, 2)
    np.savez(tmp_path / "s.npz", **arrays)
    with pytest.raises(ValueError, match="< 256"):
        next(ds.ShardedNpzDataset(str(tmp_path), 2).batches())


def _workers():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


def _wait_gone(timeout=5.0):
    end = time.time() + timeout
    while _workers() and time.time() < end:
        time.sleep(0.05)
    return not _workers()


def test_prefetch_order_values_and_dtypes(files):
    """On the CPU the batches come as tensors of the arrays' dtypes (uint8
    images and masks), in order, equal to the arrays."""
    assert _wait_gone()
    data = ds.NpzDataset(files["port"], 4, seed=1)
    got = list(ds.prefetch_to_device(data.epoch(0), size=2, device="cpu"))
    want = list(data.epoch(0))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g["images"].dtype == torch.uint8 and g["masks"].dtype == torch.uint8
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])
    assert _wait_gone()


def test_prefetch_bounds_in_flight_and_closes():
    """At most `size` staged batches beyond the one being loaded; closing
    the generator ends the worker."""
    assert _wait_gone()
    pulled = []

    def source():
        for i in range(100):
            pulled.append(i)
            yield {"x": np.full(3, i)}

    stats = ds.PrefetchStats()
    gen = ds.prefetch_to_device(source(), size=2, device="cpu", stats=stats)
    assert int(next(gen)["x"][0]) == 0
    time.sleep(0.3)
    assert len(pulled) <= 1 + 2 + 1
    assert [int(next(gen)["x"][0]) for _ in range(3)] == [1, 2, 3]
    assert len(stats.wait_s) == 4 and stats.h2d_events == []
    gen.close()
    assert _wait_gone()
    assert len(pulled) <= 4 + 2 + 1


def test_prefetch_raises_the_loader_error():
    assert _wait_gone()

    def source():
        yield {"x": np.zeros(2)}
        raise OSError("disk gone")

    gen = ds.prefetch_to_device(source(), device="cpu")
    next(gen)
    with pytest.raises(OSError, match="disk gone"):
        next(gen)
    assert _wait_gone()


def test_cuda_entry_points_raise_without_a_card(tiny_asset):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(ds.prefetch_to_device(iter([{"x": np.zeros(1)}])))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.make_synthetic_dataset(None, 1, source_size=SRC, asset=tiny_asset)
