"""Disk datasets and device prefetch (port of data/dataset.py).

On-disk format: one `.npz` with

    images  [N, H, W, 3] uint8
    masks   [N, H, W]    uint8/int  (0 = background; > 0 = body-part id)
    kp2d    [N, K, 2]    float32    (x, y) in source pixels
    kp_vis  [N, K]       float32

and optionally gt_pose / gt_betas (the 3D metrics of `evaluate_dataset`)
and the direct-supervision targets joints3d / rotmats / verts3d.
`make_synthetic_dataset` writes such a file from the port's own generator.
Datasets larger than host RAM are the same format split over shard files
(`shard_npz`, `ShardedNpzDataset`), one shard resident at a time.

The batch streams are the reference's, bitwise and in order, for the same
file, batch size and seed: the shuffles are numpy `RandomState`s seeded by
the reference's formulas, so resuming at any step is index arithmetic.

`prefetch_to_device` stages batches on the card from a background thread:
pinned host copies, `non_blocking` copies on a side stream, an event the
consumer's stream waits on. Images and masks travel as uint8 and are
widened on the device (`data/preprocess.py`).
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import os
import queue
import threading
import time
from typing import Iterator, Optional

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.utils import device as device_lib


def _check_mask_labels(arrays: dict, origin: str) -> None:
    """Refuse part-label ids >= 256: the flip table (data/augment.py) has 256
    entries, and on the device an index past it raises or, worse, reads
    another label."""
    if "masks" in arrays and arrays["masks"].size:
        max_label = int(arrays["masks"].max())
        if max_label >= 256:
            raise ValueError(
                f"{origin}: mask labels reach {max_label}; part-label ids "
                "must be < 256 (uint8 label space). Remap the dataset's masks."
            )


class NpzDataset:
    """An npz dataset held in host memory, in shuffled batches: epoch e's
    order is `RandomState((seed * 100003 + e) % 2**31).permutation(N)`,
    the ragged tail dropped."""

    def __init__(self, path_or_arrays, batch_size: int, seed: int = 0):
        if isinstance(path_or_arrays, (str, bytes, os.PathLike)):
            with np.load(path_or_arrays) as z:
                self.arrays = {k: z[k] for k in z.files}
        else:
            self.arrays = dict(path_or_arrays)
        self.batch_size = batch_size
        self.seed = seed
        self.num_examples = len(self.arrays["images"])
        self.keys = frozenset(self.arrays)
        if self.num_examples < batch_size:
            raise ValueError("dataset smaller than one batch")
        _check_mask_labels(self.arrays, "dataset")

    def _epoch_order(self, epoch_idx: int) -> np.ndarray:
        rng = np.random.RandomState((self.seed * 100003 + epoch_idx) % (2**31))
        return rng.permutation(self.num_examples)

    def steps_per_epoch(self) -> int:
        return self.num_examples // self.batch_size

    def epoch(self, epoch_idx: int) -> Iterator[dict]:
        """One epoch's batches in its shuffled order."""
        order = self._epoch_order(epoch_idx)
        for i in range(self.steps_per_epoch()):
            idx = order[i * self.batch_size : (i + 1) * self.batch_size]
            yield {k: v[idx] for k, v in self.arrays.items()}

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        """The endless stream from global step `start_step`; skipped batches
        are never gathered (only their epoch's permutation is drawn)."""
        spe = self.steps_per_epoch()
        epoch_idx, offset = divmod(start_step, spe)
        while True:
            order = self._epoch_order(epoch_idx)
            for i in range(offset, spe):
                idx = order[i * self.batch_size : (i + 1) * self.batch_size]
                yield {k: v[idx] for k, v in self.arrays.items()}
            epoch_idx, offset = epoch_idx + 1, 0


class ShardedNpzDataset:
    """A dataset over many `.npz` shards with the same keys, at most one
    shard's arrays in host memory.

    Each epoch permutes the shard order (`RandomState((seed * 100003 + e)
    % 2**31)`) and the examples within each shard (`RandomState((seed *
    100003 + e * 131071 + shard * 7919 + 1) % 2**31)`), and draws batches
    within one shard at a time, each shard's ragged tail dropped. Resuming
    at a step reads no shard before it.

    `paths_or_pattern`: a directory (its `*.npz`, sorted), a glob pattern,
    or a list of paths."""

    def __init__(self, paths_or_pattern, batch_size: int, seed: int = 0):
        if isinstance(paths_or_pattern, (list, tuple)):
            paths = [str(p) for p in paths_or_pattern]
        else:
            p = str(paths_or_pattern)
            pattern = os.path.join(p, "*.npz") if os.path.isdir(p) else p
            paths = sorted(_glob.glob(pattern))
        if not paths:
            raise FileNotFoundError(f"no .npz shards match {paths_or_pattern!r}")
        self.paths = paths
        self.batch_size = batch_size
        self.seed = seed
        # Each shard's example count from its smallest array (kp_vis): no
        # image is read here.
        self._counts: list[int] = []
        keys: Optional[frozenset] = None
        for path in paths:
            with np.load(path) as z:
                files = frozenset(z.files)
                count_key = "kp_vis" if "kp_vis" in files else sorted(files)[0]
                n = int(z[count_key].shape[0])
            if keys is None:
                keys = files
            elif files != keys:
                raise ValueError(
                    f"shard {path!r} keys {sorted(files)} differ from the "
                    f"first shard's {sorted(keys)}"
                )
            self._counts.append(n)
        self.keys = keys
        self._spe = [n // batch_size for n in self._counts]
        if sum(self._spe) == 0:
            raise ValueError(
                f"every shard is smaller than one batch ({batch_size}); "
                "use larger shards or a smaller batch"
            )
        self.num_examples = sum(self._counts)
        self._cache: tuple[Optional[str], Optional[dict]] = (None, None)

    def _load(self, shard_idx: int) -> dict:
        path = self.paths[shard_idx]
        if self._cache[0] != path:
            self._cache = (None, None)  # release the previous shard first
            with np.load(path) as z:
                arrays = {k: z[k] for k in z.files}
            n = len(arrays[min(arrays, key=lambda k: arrays[k].ndim)])
            if n != self._counts[shard_idx]:
                raise ValueError(f"shard {path!r} changed size on disk")
            _check_mask_labels(arrays, f"shard {path!r}")
            self._cache = (path, arrays)
        return self._cache[1]

    def _perm(self, epoch_idx: int, shard_idx: int) -> np.ndarray:
        s = (self.seed * 100003 + epoch_idx * 131071 + shard_idx * 7919 + 1) % (2**31)
        return np.random.RandomState(s).permutation(self._counts[shard_idx])

    def _shard_order(self, epoch_idx: int) -> np.ndarray:
        s = (self.seed * 100003 + epoch_idx) % (2**31)
        return np.random.RandomState(s).permutation(len(self.paths))

    def steps_per_epoch(self) -> int:
        return sum(self._spe)

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        """The endless stream from global step `start_step`."""
        epoch_idx, offset = divmod(start_step, self.steps_per_epoch())
        while True:
            for si in self._shard_order(epoch_idx):
                k = self._spe[si]
                if offset >= k:  # the whole shard lies before the resume point
                    offset -= k
                    continue
                perm = self._perm(epoch_idx, int(si))
                arrays = self._load(int(si))
                for i in range(offset, k):
                    idx = perm[i * self.batch_size : (i + 1) * self.batch_size]
                    yield {key: v[idx] for key, v in arrays.items()}
                offset = 0
            epoch_idx += 1

    def epoch(self, epoch_idx: int) -> Iterator[dict]:
        """Exactly one epoch's batches."""
        gen = self.batches(start_step=epoch_idx * self.steps_per_epoch())
        for _ in range(self.steps_per_epoch()):
            yield next(gen)


def shard_npz(src: str, out_dir: str, shard_size: int) -> list[str]:
    """Split a dataset `.npz` into `shard_NNNNN.npz` files of `shard_size`
    examples under `out_dir`, one shard's slice in memory at a time (np.load
    reads each key lazily). Returns the shard paths."""
    if shard_size <= 0:
        raise ValueError("shard_size must be positive")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    with np.load(src) as z:
        keys = list(z.files)
        n = z[keys[0]].shape[0]
        for k in keys:
            if z[k].shape[0] != n:
                raise ValueError(f"key {k!r} has {z[k].shape[0]} examples, expected {n}")
        for shard_idx, start in enumerate(range(0, n, shard_size)):
            stop = min(start + shard_size, n)
            path = os.path.join(out_dir, f"shard_{shard_idx:05d}.npz")
            np.savez(path, **{k: z[k][start:stop] for k in keys})
            paths.append(path)
    return paths


def open_dataset(path: str, batch_size: int, seed: int = 0):
    """`NpzDataset` for one `.npz` file; `ShardedNpzDataset` for a directory
    or a glob pattern of shards (the CLIs' --dataset)."""
    if os.path.isdir(path) or any(c in path for c in "*?["):
        return ShardedNpzDataset(path, batch_size, seed=seed)
    return NpzDataset(path, batch_size, seed=seed)


@dataclasses.dataclass
class PrefetchStats:
    """What a prefetcher measured, one entry a batch handed over: the host
    seconds the consumer waited for it (`wait_s`) and, on the card, the pair
    of timing events around its host-to-device copies (`h2d_events`; read
    `start.elapsed_time(end)` after a synchronize)."""

    wait_s: list = dataclasses.field(default_factory=list)
    h2d_events: list = dataclasses.field(default_factory=list)


def prefetch_to_device(
    iterator: Iterator[dict],
    size: int = 2,
    device: torch.device | str = "cuda",
    stats: Optional[PrefetchStats] = None,
    rows: Optional[slice] = None,
) -> Iterator[dict]:
    """The batches of `iterator` (dicts of numpy arrays) as tensors on
    `device`, staged by a background thread with at most `size` batches in
    flight.

    On the card each array is copied into pinned host memory and sent with a
    `non_blocking` copy on a side stream; the consumer's current stream waits
    on an event recorded after the copies, and each tensor is marked as used
    by that stream (`record_stream`), so the allocator reuses no buffer while
    the step still reads it. A failed pin or copy raises; no batch stays on
    the host for want of a card (`device` defaults to the card and raises
    without one). On the CPU the arrays are wrapped as they are. With
    `rows` (a rank's rows of a global batch, `parallel/mesh.Mesh.batch_rows`)
    only those rows of each array are staged.

    A loader's exception is raised in the consumer. Closing (or dropping)
    the generator stops the worker, which then takes no further batch."""
    device = device_lib.resolve(device)
    cuda = device.type == "cuda"
    side = torch.cuda.Stream(device) if cuda else None
    q: queue.Queue = queue.Queue()
    tokens = threading.Semaphore(size)
    end = object()
    stop = threading.Event()

    def stage(batch: dict):
        if rows is not None:
            batch = {k: v[rows] for k, v in batch.items()}
        tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}
        if not cuda:
            return tensors, None, None
        pinned = {k: t.pin_memory() for k, t in tensors.items()}
        start = torch.cuda.Event(enable_timing=True) if stats is not None else None
        with torch.cuda.stream(side):
            if start is not None:
                start.record(side)
            # The caching host allocator keeps each pinned buffer until its
            # copy has run, so dropping `pinned` on return is safe.
            out = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
            done = torch.cuda.Event(enable_timing=start is not None)
            done.record(side)
        return out, done, start

    def worker():
        try:
            for batch in iterator:
                while not tokens.acquire(timeout=0.2):
                    if stop.is_set():
                        return
                if stop.is_set():
                    return
                q.put(stage(batch))
        except Exception as exc:  # handed to the consumer, which raises it
            q.put(exc)
        finally:
            q.put(end)

    t = threading.Thread(target=worker, name="prefetch_to_device", daemon=True)
    t.start()
    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            if stats is not None:
                stats.wait_s.append(time.perf_counter() - t0)
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            tokens.release()  # free the slot as soon as the batch is handed over
            batch, done, start = item
            if cuda:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(done)
                for v in batch.values():
                    v.record_stream(consumer)
                if stats is not None:
                    stats.h2d_events.append((start, done))
            yield batch
    finally:
        stop.set()
        while not q.empty():  # drop the staged batches still queued
            q.get_nowait()


def make_synthetic_dataset(
    path: Optional[str],
    num_examples: int,
    source_size: int = 320,
    seed: int = 0,
    asset=None,
    include_3d: bool = False,
    include_verts3d: bool = False,
    synth=None,
    device: torch.device | str = "cuda",
) -> dict:
    """Render a dataset with the port's own generator (`synthetic.sample_draws`
    + `render_batch` at `source_size`², the LBS and raster forward kernels on
    the card) in chunks of at most 64 examples, one `torch.Generator` seeded
    by `seed` drawing them in turn. Returns the arrays, and writes them to
    `path` with `np.savez_compressed` when given.

    Stored as the reference stores them: images and masks uint8, kp2d and
    kp_vis, gt_pose and gt_betas float32; with `include_3d` joints3d [N, J, 3]
    and rotmats [N, J, 3, 3] under the bare names the training targets use
    (betas_l2 reads gt_betas through `train.fit_dataset`'s alias); with
    `include_verts3d` verts3d [N, V, 3]. `synth` (a SyntheticConfig, the
    default stream when None) picks the distribution and the target
    renderer: targets='hard' writes z-buffered masks. The file reads with
    the reference's NpzDataset and the other way round; the pixels differ
    from the reference's, as jax.random and torch draw different numbers."""
    from indirect_learning_pose_shape_tpu_torch.data import synthetic
    from indirect_learning_pose_shape_tpu_torch.models import network as net
    from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib

    device = device_lib.resolve(device)
    if asset is None:
        asset = assets_lib.load_asset()
    base = net.ModelConfig()
    model_cfg = dataclasses.replace(
        base, image_size=source_size,
        raster=dataclasses.replace(base.raster, image_size=source_size),
    )
    consts = net.build_consts(asset, model_cfg, device)
    synth_cfg = synth if synth is not None else synthetic.SyntheticConfig()
    chunk = min(num_examples, 64)
    gen = torch.Generator(device=device).manual_seed(seed)
    parts: list[dict] = []
    for start in range(0, num_examples, chunk):
        draws = synthetic.sample_draws(gen, chunk, consts, synth_cfg, source_size)
        b = synthetic.render_batch(
            draws, consts, model_cfg, synth_cfg, include_3d=include_3d or include_verts3d
        )
        # Storage dtypes on the device, so the transfer is a quarter of float32.
        out = {
            "images": torch.clamp((b["image"] + 1.0) * 127.5, 0, 255).to(torch.uint8),
            "masks": b["part_labels"].to(torch.uint8),
            "kp2d": b["kp2d"].float(),
            "kp_vis": b["kp_vis"].float(),
            "gt_pose": b["gt_pose"].float(),
            "gt_betas": b["gt_betas"].float(),
        }
        if include_3d:
            out["joints3d"] = b["gt_joints3d"].float()
            out["rotmats"] = b["gt_rotmats"].float()
        if include_verts3d:
            out["verts3d"] = b["gt_verts"].float()
        take = min(chunk, num_examples - start)
        parts.append({k: v[:take].cpu().numpy() for k, v in out.items()})
    arrays = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    if path:
        np.savez_compressed(path, **arrays)
    return arrays
