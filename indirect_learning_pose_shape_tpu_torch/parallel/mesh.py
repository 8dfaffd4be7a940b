"""The process-group mesh and its collectives (port of parallel/mesh.py).

The reference shards one global-view program over a `jax.sharding.Mesh`
and XLA inserts every collective. Here each rank is a process that runs the
step on its own rows, and the collectives are explicit `torch.distributed`
calls, placed so that a run on an `n_data x n_render` mesh computes the
numbers of one process on the same global batch, up to float32 reduction
order:

- rank = data index · n_render + render index (the reference's
  `reshape(n_data, n_render)`); the *data group* of a rank is the ranks
  with its render index, its *render group* the ranks with its data index;
- the batch is split over the data index, the parameters are replicated;
- every loss term is a global sum over partial sums (`all_reduce_partial`),
  BatchNorm's statistics a global sum that every rank consumes further
  (`all_reduce_shared`);
- after `backward()` the gradients are summed over the world in flattened
  buckets (`all_reduce_grads`), before the update clips them. Under a render
  axis every render rank of a data shard already holds that shard's whole
  gradient (the raster's backward sums the vertex gradient over the render
  group), so the world sum is divided by n_render.

The port's forward is functional (`network.forward_train(model, consts,
...)`), so DistributedDataParallel's forward hooks would never fire; the
gradient all-reduce is called by `train.train_step`.

Backends: NCCL by default. gloo only where the caller names it (the CPU
tests, several ranks sharing one card); gloo on the card reduces CUDA
tensors with `all_reduce` and `broadcast`, which is all this module uses.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from indirect_learning_pose_shape_tpu_torch.utils import device as device_lib

BUCKET_BYTES = 25 << 20  # gradient all-reduce bucket (DDP's default size)


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of an n_data x n_render mesh over the process group.
    `world_group` is the whole group; `data_group` the ranks with this
    rank's render index, `render_group` those with its data index (None
    when n_render is 1: nothing is row-sharded then)."""

    world: int
    rank: int
    n_data: int
    n_render: int
    device: torch.device
    backend: str
    world_group: Any
    data_group: Any
    render_group: Any

    @property
    def data_index(self) -> int:
        return self.rank // self.n_render

    @property
    def render_index(self) -> int:
        return self.rank % self.n_render

    def batch_rows(self, global_batch: int) -> slice:
        """This rank's rows of a global batch (its data index's block)."""
        if global_batch % self.n_data:
            raise ValueError(
                f"global batch {global_batch} not divisible by the data axis ({self.n_data})"
            )
        b = global_batch // self.n_data
        return slice(self.data_index * b, (self.data_index + 1) * b)


def _group(ranks: list[int], world: int):
    return dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)


def mesh_2d(n_data: int, n_render: int, device: torch.device | str | None = None) -> Mesh:
    """The n_data x n_render mesh over the initialized process group, on
    `device` (default: this rank's card); every rank must call it (group
    creation is collective). Raises when the mesh needs more ranks than were
    launched, or leaves some idle."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    need = n_data * n_render
    if need > world:
        raise ValueError(f"requested {need} devices, have {world}")
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: launch with torchrun (train.main joins it) or parallel.mesh.spawn"
        )
    rank, backend = dist.get_rank(), dist.get_backend()
    if need < world:
        raise ValueError(
            f"requested {need} devices of the {world} launched ranks: a mesh spans "
            "every rank (launch as many as the mesh needs)"
        )
    device = device_lib.resolve("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:  # this rank's card (torchrun, spawn set it)
        device = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend reduces CUDA tensors only; name 'gloo' for the CPU")
    data_groups = [_group([d * n_render + r for d in range(n_data)], world) for r in range(n_render)]
    render_groups = (
        [_group([d * n_render + r for r in range(n_render)], world) for d in range(n_data)]
        if n_render > 1 else None
    )
    return Mesh(
        world=world, rank=rank, n_data=n_data, n_render=n_render, device=device,
        backend=backend, world_group=dist.group.WORLD,
        data_group=data_groups[rank % n_render],
        render_group=None if render_groups is None else render_groups[rank // n_render],
    )


def make_mesh(num_devices: Optional[int] = None, device: torch.device | str | None = None) -> Mesh:
    """1-D data-parallel mesh over `num_devices` ranks (None: all launched)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return mesh_2d(world if num_devices is None else num_devices, 1, device)


def init_from_env(backend: str = "nccl") -> bool:
    """Join the process group that `torchrun` describes in the environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); with NCCL, each rank takes
    the card of its LOCAL_RANK. Returns False, doing nothing, outside
    torchrun or when a group already exists."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ:
        return False
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://")
    return True


# --- Differentiable collectives ----------------------------------------------


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=op, group=group)
    return y


class _AllReduceShared(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllReducePartial(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def all_reduce_shared(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of `x` over `group`, a value every rank consumes further (BN
    statistics). Its backward sums the cotangent over the group, as
    SyncBatchNorm's does: each rank's partial feeds every rank's use."""
    return _AllReduceShared.apply(x, group)


def all_reduce_partial(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over `group` of partial loss sums: the forward gives every rank
    the global value; the backward passes each rank its own cotangent
    unchanged, so the gradients summed over the ranks are the global one."""
    return _AllReducePartial.apply(x, group)


def sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """`x` itself; its gradient is summed over `group` (each rank's
    gradient covers only its part of what `x` feeds)."""
    return _SumGrad.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of `x` over `group` (no gradient)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


# --- Parameters, gradients, batches -------------------------------------------


@torch.no_grad()
def all_reduce_grads(params, mesh: Mesh) -> int:
    """Sum the `.grad` of `params` over the world, in flattened buckets of
    up to BUCKET_BYTES, divided by n_render (see the module docstring).
    Returns the bytes reduced."""
    grads = [p.grad for p in params if p.grad is not None]
    total, bucket, size = 0, [], 0

    def flush():
        flat = torch.cat([g.reshape(-1) for g in bucket])
        dist.all_reduce(flat, group=mesh.world_group)
        if mesh.n_render > 1:
            flat.mul_(1.0 / mesh.n_render)
        offset = 0
        for g in bucket:
            g.copy_(flat[offset : offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat.numel() * flat.element_size()

    for g in grads:
        if bucket and (size + g.numel() * g.element_size() > BUCKET_BYTES or g.dtype != bucket[0].dtype):
            total += flush()
            bucket, size = [], 0
        bucket.append(g)
        size += g.numel() * g.element_size()
    if bucket:
        total += flush()
    return total


@torch.no_grad()
def replicate(module: torch.nn.Module, mesh: Mesh) -> None:
    """Broadcast every parameter and buffer of `module` from rank 0."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0, group=mesh.world_group)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's rows of a global batch: every array or tensor with a
    batch dimension sliced by `mesh.batch_rows`; 0-dim values kept."""
    out = {}
    for k, v in batch.items():
        out[k] = v if v.ndim == 0 else v[mesh.batch_rows(v.shape[0])]
    return out


@torch.no_grad()
def gather_band(x: torch.Tensor, index: int, count: int, group, dim: int = 0) -> torch.Tensor:
    """The whole tensor from every rank's equal band along `dim`: this
    rank's `x`, band `index` of `count`, written into zeros, then summed over
    `group` (adding zeros is exact; gloo reduces CUDA tensors but does not
    gather them)."""
    shape = list(x.shape)
    h = shape[dim]
    shape[dim] = h * count
    out = x.new_zeros(shape)
    out.narrow(dim, index * h, h).copy_(x)
    dist.all_reduce(out, group=group)
    return out


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's rows of a batch-major tensor (`mesh.batch_rows`) -> the
    whole batch, on every rank of its data group."""
    return gather_band(x, mesh.data_index, mesh.n_data, mesh.data_group)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank (an all-reduce on the mesh's device: gloo and
    NCCL alike)."""
    dist.all_reduce(torch.zeros(1, device=mesh.device), group=mesh.world_group)


# --- Spawning ranks (tests, the dry run, several ranks on one card) ---------


def _to_host(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _worker(fn, rank, world, backend, device, init, results, args, timeout):
    try:
        dev = torch.device(device)
        if dev.type == "cpu":  # one thread a rank: ranks share the host, and their ops are small
            torch.set_num_threads(1)
        if backend == "nccl":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
        )
        # Pickled by value here: the queue's own pickler would pass tensors
        # as shared memory, which dies with this process.
        results.put((rank, True, pickle.dumps(_to_host(fn(dev, *args)))))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(
    fn: Callable,
    n: int,
    backend: str = "nccl",
    device: torch.device | str = "cuda",
    args: tuple = (),
    timeout: float = 600.0,
) -> list:
    """Run `fn(device, *args)` on `n` new processes joined in one process
    group; returns each rank's result (tensors moved to the host), in rank
    order. `fn` must be importable (a module-level function).

    The group meets through a `file://` store in a fresh temporary
    directory, so concurrent runs never contend for a TCP port. With NCCL
    rank r runs on card r; with gloo every rank runs on `device`. A rank
    that raises or dies makes this raise, after every rank is stopped; so
    does a run longer than `timeout` seconds (also each collective's
    limit)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ilps_spawn_") as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_worker, args=(fn, r, n, backend, str(device), init, results, args, timeout))
            for r in range(n)
        ]
        for p in procs:
            p.start()
        out: dict[int, Any] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < n:
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"rank(s) {dead} died (exit codes "
                                           f"{[procs[r].exitcode for r in dead]})") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{n} ranks did not finish in {timeout} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
                out[rank] = pickle.loads(value)
        finally:
            for p in procs:
                p.join(timeout=30 if len(out) == n else 1)
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [out[r] for r in range(n)]
