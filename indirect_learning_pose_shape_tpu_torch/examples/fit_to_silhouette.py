"""Fit SMPL parameters to a target silhouette (port of
examples/fit_to_silhouette.py).

The network-free form of indirect learning: gradient descent on (θ, β,
cam) through SMPL, the weak-perspective camera and the soft raster against
silhouette BCE + soft IoU + keypoint losses and a shape prior, the
reference's plain update `p - lr·g`. On the card each step runs the LBS
kernel once (with its residuals), the raster forward kernel once and the
raster backward kernel once.

    python -m indirect_learning_pose_shape_tpu_torch.examples.fit_to_silhouette \\
        [--steps 300] [--size 128] [--batch 4] [--lr 0.05] [--out D] [--device cuda|cpu]

The target bodies (pose 0.3·N(0, 1), betas N(0, 1), camera (0.9, 0, 0))
come from a generator seeded 0; the fit starts from the rest pose, mean
shape and camera (0.85, 0.02, -0.02). `--out` writes before/after overlays
(matplotlib).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch import losses
from indirect_learning_pose_shape_tpu_torch.models import smpl
from indirect_learning_pose_shape_tpu_torch.ops import camera, raster
from indirect_learning_pose_shape_tpu_torch.utils import assets
from indirect_learning_pose_shape_tpu_torch.utils import device as device_lib


@dataclasses.dataclass
class Problem:
    consts: smpl.SMPLConsts
    layout: raster.PartLayout
    rcfg: raster.RasterConfig
    target_sil: torch.Tensor  # [B, S, S]
    target_kp: torch.Tensor  # [B, K, 2] pixels
    vis: torch.Tensor  # [B, K]
    smpl_impl: str = "auto"  # models/smpl.py: 'kernel' on the card, 'torch' the plain version
    raster_impl: str = "auto"  # ops/raster.py

    @property
    def size(self) -> int:
        return self.rcfg.image_size


def render(p: Problem, pose, betas, cam) -> tuple[torch.Tensor, torch.Tensor]:
    """(soft silhouette [B, S, S], keypoints [B, K, 2] in pixels)."""
    out = smpl.smpl_forward(p.consts, pose, betas, impl=p.smpl_impl)
    v2d = camera.project_pixel(out["verts"], cam, p.size)
    sil = raster.soft_rasterize(v2d, p.layout, p.rcfg, impl=p.raster_impl)["silhouette"]
    return sil, camera.project_pixel(out["kp3d"], cam, p.size)


def make_problem(asset, size: int, batch: int, device, gt=None) -> Problem:
    """The consts, the 24-part layout and the target render of `gt`
    ({'pose', 'betas', 'cam'}; drawn from a generator seeded 0 when None)."""
    device = device_lib.resolve(device)
    consts = smpl.smpl_consts(asset, device=device)
    layout = raster.build_part_layout(
        asset.part_labels().clip(0, 23), 24, positions=asset.v_template, device=device
    )
    p = Problem(consts, layout, raster.RasterConfig(image_size=size, num_parts=24), None, None, None)
    if gt is None:
        gen = torch.Generator().manual_seed(0)
        gt = {
            "pose": 0.3 * torch.randn((batch, 72), generator=gen),
            "betas": torch.randn((batch, 10), generator=gen),
            "cam": torch.tensor([0.9, 0.0, 0.0]).repeat(batch, 1),
        }
    with torch.no_grad():
        p.target_sil, p.target_kp = render(p, *(gt[k].to(device) for k in ("pose", "betas", "cam")))
    p.vis = torch.ones(p.target_kp.shape[:2], device=device)
    return p


def initial_params(batch: int, device) -> dict[str, torch.Tensor]:
    return {
        "pose": torch.zeros((batch, 72), device=device),
        "betas": torch.zeros((batch, 10), device=device),
        "cam": torch.tensor([0.85, 0.02, -0.02], device=device).repeat(batch, 1),
    }


def loss_fn(p: Problem, params: dict) -> torch.Tensor:
    sil, kp2d = render(p, params["pose"], params["betas"], params["cam"])
    return (
        losses.silhouette_bce(sil, p.target_sil)
        + losses.silhouette_iou(sil, p.target_sil)
        + 10.0 * losses.keypoint_l2(kp2d, p.target_kp, p.vis, p.size)
        + 1e-3 * losses.shape_reg(params["betas"])
    )


def loss_and_grads(p: Problem, params: dict) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The loss at `params` and its gradient with respect to each of them."""
    for v in params.values():
        v.requires_grad_(True)
    loss = loss_fn(p, params)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def step(p: Problem, params: dict, lr: float) -> torch.Tensor:
    """One update `p - lr·g` in place; returns the loss before it."""
    loss, grads = loss_and_grads(p, params)
    with torch.no_grad():
        for k, g in grads.items():
            params[k].sub_(lr * g)
    return loss


def fit(p: Problem, params: dict, steps: int, lr: float) -> list[float]:
    """`steps` updates; the loss before each, read once at the end."""
    return torch.stack([step(p, params, lr) for _ in range(steps)]).tolist()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--out", default=None, help="write before/after overlays here")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    p = make_problem(assets.load_asset(), args.size, args.batch, args.device)
    params = initial_params(args.batch, p.target_sil.device)
    with torch.no_grad():
        sil0, _ = render(p, params["pose"], params["betas"], params["cam"])
    t0 = time.perf_counter()
    loss0 = float(step(p, params, args.lr))
    print(f"first step: {time.perf_counter() - t0:.1f} s, loss {loss0:.4f}")
    t0 = time.perf_counter()
    history = fit(p, params, args.steps - 1, args.lr)
    ms = (time.perf_counter() - t0) / max(args.steps - 1, 1) * 1e3
    loss = float(loss_fn(p, params).detach()) if args.steps > 1 else loss0
    print(f"loss after {args.steps} steps: {loss:.4f}  ({ms:.1f} ms/step)")
    if args.steps > 1 and not loss < loss0:
        print(f"optimization did not descend: {[loss0, *history[:3]]} ...", file=sys.stderr)
        return 1

    if args.out:
        from indirect_learning_pose_shape_tpu_torch.predict import save_overlay

        os.makedirs(args.out, exist_ok=True)
        with torch.no_grad():
            sil1, kp1 = render(p, params["pose"], params["betas"], params["cam"])
        img = np.repeat(p.target_sil[0].cpu().numpy()[..., None], 3, axis=-1) * 2 - 1
        save_overlay(os.path.join(args.out, "before.png"), img, sil0[0].cpu().numpy(),
                     p.target_kp[0].cpu().numpy())
        save_overlay(os.path.join(args.out, "after.png"), img, sil1[0].cpu().numpy(), kp1[0].cpu().numpy())
        print(f"wrote before/after overlays to {args.out}")
    print("OK: gradients through raster -> camera -> SMPL recover the target")
    return 0


if __name__ == "__main__":
    sys.exit(main())
