"""Entry points of the port (counterpart of the reference's root
`__graft_entry__.py`, which stays the JAX package's).

`entry()` gives the flagship forward step (encoder → IEF → SMPL →
projection) and example inputs, on the card unless the caller asks for the
CPU. `dryrun_multichip(n)` runs the multi-GPU training path on `n` gloo
ranks on the CPU at the reference's tiny shapes and makes the reference's
checks, in its order, with its assertions:

1. the fused step (synthetic batch + update) and the split path (the batch
   of this rank's rows, then `train_step`) on an n-rank data-parallel mesh,
   with the mixed supervision (j3d, rotmat, betas_l2) on;
2. with n >= 4 (even, 32 rows dividing over n/2), a 2 x n/2 row-sharded
   render equal to the local render within 1e-5;
3. the row-sharded (SP) train step's loss equal to the data-parallel loss
   within rtol 2e-3, from fresh same-seed states on the step-0 batch;
4. the same with hard z-buffer targets at 64² (two tile rows of 32), on an
   n/2 x 2 mesh at a global batch of n (the reference's 2 x 2 at batch 4 for
   n = 4: a mesh here spans every launched rank).

    python -c "from indirect_learning_pose_shape_tpu_torch import entry; entry.dryrun_multichip(4)"
"""

from __future__ import annotations

import dataclasses
import math

import torch

from indirect_learning_pose_shape_tpu_torch import configs, train
from indirect_learning_pose_shape_tpu_torch.data.synthetic import SyntheticConfig
from indirect_learning_pose_shape_tpu_torch.models import network as net
from indirect_learning_pose_shape_tpu_torch.models.encoder import EncoderConfig
from indirect_learning_pose_shape_tpu_torch.models.ief import IEFConfig
from indirect_learning_pose_shape_tpu_torch.ops import raster
from indirect_learning_pose_shape_tpu_torch.parallel import mesh as mesh_lib
from indirect_learning_pose_shape_tpu_torch.parallel import render_sp
from indirect_learning_pose_shape_tpu_torch.utils import assets as assets_lib


def _flagship_cfg(image_size: int = 256) -> net.ModelConfig:
    return net.ModelConfig(
        image_size=image_size,
        encoder=EncoderConfig(depth=18),
        raster=raster.RasterConfig(image_size=image_size, num_parts=24),
    )


def entry(device: torch.device | str = "cuda"):
    """(fn, example_args): the flagship forward step and a batch of 4
    zero images at 256², seed-0 weights, on `device`."""
    cfg = _flagship_cfg(256)
    model, consts = net.init(assets_lib.load_asset(), cfg, seed=0, device=device)

    @torch.no_grad()
    def forward_step(model, consts, images):
        outputs = net.forward(model, consts, images, cfg, train=False)
        return outputs["theta"], outputs["verts"], outputs["kp2d"]

    images = torch.zeros((4, 256, 256, 3), device=consts.smpl.v_template.device)
    return forward_step, (model, consts, images)


def _dryrun_cfg(n: int) -> configs.TrainConfig:
    model_cfg = net.ModelConfig(
        image_size=32,
        encoder=EncoderConfig(depth=18, width=16, compute_dtype=torch.float32),
        ief=IEFConfig(hidden_dims=(128,)),
        raster=raster.RasterConfig(image_size=32, num_parts=24),
    )
    w = dict(configs.CONFIG5_DATA_PARALLEL.loss_weights)
    w.update(j3d=5.0, rotmat=1.0, betas_l2=0.02)
    return dataclasses.replace(
        configs.CONFIG5_DATA_PARALLEL, model=model_cfg, batch_size=2 * n, num_devices=n,
        loss_weights=tuple(w.items()),
    )


def _fused_loss(cfg: configs.TrainConfig, asset, device) -> tuple[float, dict]:
    """One fused step from a fresh state on the run's mesh: (loss, terms)."""
    ts, consts = train.init_state(cfg, asset, device)
    mesh = train._auto_mesh(cfg, device)
    assert mesh is not None
    mesh_lib.replicate(ts.model, mesh)
    terms = train.fused_step(ts, consts, cfg, mesh)
    return float(terms["total"]), terms


def _dryrun_rank(device, n: int) -> dict:
    cfg = _dryrun_cfg(n)
    asset = assets_lib.synthetic_asset(num_verts=864, seed=1)

    # Fused path first, on the fresh step-0 state: its loss is the value the
    # SP step below must reproduce.
    ts, consts = train.init_state(cfg, asset, device)
    mesh = train._auto_mesh(cfg, device)
    mesh_lib.replicate(ts.model, mesh)
    terms = train.fused_step(ts, consts, cfg, mesh)
    loss = float(terms["total"])
    assert math.isfinite(loss), f"non-finite loss {loss}"
    assert "j3d" in terms and "rotmat" in terms, "mixed terms missing"
    # Split path: the generated batch holds this rank's rows only.
    batch = train.make_batch(ts.seed, ts.step, cfg.batch_size, consts, cfg, mesh)
    assert batch["image"].shape[0] == cfg.batch_size // n, "batch must be sharded"
    terms2 = train.train_step(ts, batch, consts, cfg, mesh)
    assert math.isfinite(float(terms2["total"]))

    out = {"loss": loss}
    if n >= 4 and n % 2 == 0 and 32 % (n // 2) == 0:
        mesh2 = render_sp.render_mesh(2, n // 2, device)
        gen = torch.Generator(device=device).manual_seed(7)
        verts2d = torch.rand((2, consts.smpl.num_verts, 2), generator=gen, device=device) * 32.0
        rcfg = cfg.model.raster
        sp = render_sp.rasterize_spatial(verts2d, consts.part_layout, rcfg, mesh2)
        local = raster.soft_rasterize(verts2d, consts.part_layout, rcfg, impl="separable")
        rows = render_sp.constrainer(mesh2).band(rcfg.image_size)
        want = local["silhouette"][mesh2.batch_rows(2)][:, rows]
        err = float((sp["silhouette"] - want).abs().max())
        assert err < 1e-5, f"spatial render mismatch {err}"
        assert sp["silhouette"].shape == (1, 32 // (n // 2), 32), "render must be row-sharded"

        # The SP training step: both renders row-sharded, from a fresh
        # same-seed state on the step-0 batch.
        sp_cfg = dataclasses.replace(cfg, render_devices=n // 2, num_devices=n)
        sp_loss, _ = _fused_loss(sp_cfg, asset, device)
        assert math.isfinite(sp_loss), f"non-finite SP loss {sp_loss}"
        assert abs(sp_loss - loss) <= 2e-3 * abs(loss) + 1e-5, (
            f"SP train-step loss {sp_loss:.6f} does not match the 1-D data-parallel "
            f"step's {loss:.6f} (same seed, same step-0 batch)"
        )

        # Hard (z-buffer) targets shard at tile granularity (32-px tile
        # rows): 64² gives two bands.
        hard_model = dataclasses.replace(
            cfg.model, image_size=64, raster=dataclasses.replace(cfg.model.raster, image_size=64)
        )
        hard_cfg = dataclasses.replace(
            cfg, model=hard_model, batch_size=n, num_devices=n, synthetic=SyntheticConfig(targets="hard")
        )
        hard_loss, _ = _fused_loss(hard_cfg, asset, device)
        assert math.isfinite(hard_loss)
        hard_sp_loss, _ = _fused_loss(dataclasses.replace(hard_cfg, render_devices=2), asset, device)
        assert abs(hard_sp_loss - hard_loss) <= 2e-3 * abs(hard_loss) + 1e-5, (
            f"hard-target SP loss {hard_sp_loss:.6f} != 1-D hard loss {hard_loss:.6f} "
            "(same seed, same step-0 batch)"
        )
        out.update(err=err, sp_loss=sp_loss, hard_loss=hard_loss, hard_sp_loss=hard_sp_loss)
    return out


def dryrun_multichip(n_devices: int) -> None:
    """Spawn `n_devices` gloo ranks on the CPU, run the checks of the module
    docstring on each (any failure raises here) and print the reference's
    success line."""
    r = mesh_lib.spawn(_dryrun_rank, n_devices, backend="gloo", device="cpu", args=(n_devices,))[0]
    note = ""
    if "sp_loss" in r:
        note = (
            f", 2x{n_devices // 2} render mesh err {r['err']:.1e}"
            f", SP train-step loss {r['sp_loss']:.4f} == 1-D loss {r['loss']:.4f} "
            f"(asserted, rtol 2e-3)"
            f", hard-target SP loss {r['hard_sp_loss']:.4f} == 1-D {r['hard_loss']:.4f} (asserted)"
        )
    print(
        f"dryrun_multichip OK: {n_devices} devices, global batch {2 * n_devices}, "
        f"loss {r['loss']:.4f}{note}"
    )
