"""Row-sharded ("spatially parallel") rendering over an n_data x n_render
mesh (port of parallel/render_sp.py).

The separable raster is `fyᵀ @ fx` contracted over the vertex slots, so a
render rank that builds only its rows of `fy` computes its rows of the score
image with no communication; the one collective is in the backward, the sum
of the vertex-slot gradient [B, C·S, 2] over the render group (`Rows.sum_grad`).
The hard z-buffer raster shards the same way at tile granularity: its tiles
are numbered row-major, so a block of tile rows is a band of image rows.

`constrainer(mesh)` gives the hook, a `Rows`: this rank's band of image
rows, and the collectives over its render group. The raster
(`ops/raster.py`, separable route only: the reference's kernel route is never
row-sharded), the hard raster (`ops/raster_hard.py`), the synthetic targets
and the losses take it; the losses sum their pixel terms over the mesh
(`losses.py`), so every rank sees the one-process value.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from indirect_learning_pose_shape_tpu_torch import losses
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.parallel import mesh as mesh_lib

# The batch entries that are images of the targets: row-sharded with the
# prediction render (the reference's `_constrain_batch`).
ROW_KEYS = ("silhouette", "part_labels")


def render_mesh(n_data: int, n_render: int, device: torch.device | str | None = None) -> mesh_lib.Mesh:
    """The 2-D (data, render) mesh over the n_data · n_render launched ranks."""
    return mesh_lib.mesh_2d(n_data, n_render, device)


@dataclasses.dataclass(frozen=True, eq=False)
class Rows:
    """This rank's share of the image rows: band `index` of `count`, and the
    render group that holds the other bands."""

    index: int
    count: int
    group: Any

    def band(self, size: int) -> slice:
        """This rank's rows of a `size`-row image; raises unless divisible."""
        if size % self.count:
            raise ValueError(f"image_size {size} not divisible by render axis {self.count}")
        h = size // self.count
        return slice(self.index * h, (self.index + 1) * h)

    def sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        """`x`, with its gradient summed over the render group."""
        return mesh_lib.sum_grad(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole image from every rank's band of rows along `dim`
        (`mesh.gather_band` over the render group)."""
        return mesh_lib.gather_band(x, self.index, self.count, self.group, dim)

    def targets(self, batch: dict) -> dict:
        """`batch` with its image targets (ROW_KEYS) cut to this band."""
        out = dict(batch)
        for k in ROW_KEYS:
            if k in out:
                out[k] = out[k][:, self.band(out[k].shape[1])]
        return out


def constrainer(mesh: Optional[mesh_lib.Mesh]) -> Optional[Rows]:
    """The row-sharding hook of `mesh`: None without a mesh or a render axis."""
    if mesh is None or mesh.n_render == 1:
        return None
    return Rows(mesh.render_index, mesh.n_render, mesh.render_group)


def _rows(cfg: raster.RasterConfig, mesh: mesh_lib.Mesh) -> tuple[Optional[Rows], slice]:
    """The hook of `mesh` and this rank's band of rows; raises unless the
    image's rows divide over the render axis."""
    if cfg.image_size % mesh.n_render:
        raise ValueError(
            f"image_size {cfg.image_size} not divisible by render axis {mesh.n_render}"
        )
    rows = constrainer(mesh)
    return rows, slice(None) if rows is None else rows.band(cfg.image_size)


def rasterize_spatial(
    verts2d: torch.Tensor, layout: raster.PartLayout, cfg: raster.RasterConfig, mesh: mesh_lib.Mesh
) -> dict[str, torch.Tensor]:
    """Row-sharded soft rasterization of the global batch `verts2d` [B, V, 2]
    (the same on every rank): this rank's block of `soft_rasterize`'s
    output, probs [B/n_data, H/n_render, W, C+1] and silhouette
    [B/n_data, H/n_render, W] (batch rows by data index, image rows by
    render index). Requires image_size divisible by the render axis."""
    rows, _ = _rows(cfg, mesh)
    v = verts2d[mesh.batch_rows(verts2d.shape[0])]
    return raster.soft_rasterize(v, layout, cfg, impl="separable", rows=rows)


def spatial_render_loss_grad(
    verts2d: torch.Tensor,
    target_sil: torch.Tensor,
    layout: raster.PartLayout,
    cfg: raster.RasterConfig,
    mesh: mesh_lib.Mesh,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(BCE loss, its gradient in verts2d) through the row-sharded render, on
    the global batch `verts2d` and target silhouettes [B, H, W]: the loss
    is the global one on every rank, the gradient this rank's batch rows
    [B/n_data, V, 2] (the backward sums the vertex gradient over the render
    group)."""
    rows, band = _rows(cfg, mesh)
    batch = mesh.batch_rows(verts2d.shape[0])
    v = verts2d[batch].detach().requires_grad_(True)
    out = raster.soft_rasterize(v, layout, cfg, impl="separable", rows=rows)
    loss = losses.silhouette_bce(out["silhouette"], target_sil[batch][:, band], mesh)
    (grad,) = torch.autograd.grad(loss, v)
    return loss.detach(), grad
