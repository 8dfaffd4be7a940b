"""The numbers the output check compares, each against a limit of its own
(`portbench/limits/<workload>.json`, which names the ones compared; the
rest are printed for the record).

Training (the first three steps, which set-up drives through the window's
own call, the first of them the eager warm-up before the capture):

- `loss1_rel`, `loss_rel`: |loss − loss_ref| / |loss_ref| of the first
  step, and the largest over the steps;
- `grad_leaf`: the first gradient as Adam got it (its first moment after
  one step over 1 − β₁), by the worst leaf: | ‖g‖ − ‖g_ref‖ | over the
  larger of ‖g_ref‖ and the median leaf's ‖g_ref‖ (`grad_median`: the
  median leaf; `grad_diff_median`: the median leaf's ‖g − g_ref‖ over the
  same);
- `change_leaf`: the parameters' change over the steps, by the worst leaf
  in the same way (`change_median`), leaving out the leaves whose reference
  gradient is under a thousandth of the median leaf's (rounding alone
  moves them under Adam);
- `bn_rel`: the first step's BatchNorm batch statistics (the program's
  worked out from its running statistics), by the worst layer and
  statistic: ‖s − s_ref‖ / ‖s_ref‖ over the channels;
- `kp1_rel`: the first step's keypoint term, as `loss1_rel`;
- `replay_*`: the same numbers of one replay of the window's graph after
  the window, the reference's step taken from the program's state copied
  before it (`loss_rel`, `grad_leaf`, `change_leaf`, `bn_rel` and the
  rest; the gradient from Adam's first moment before and after it,
  (m' − β₁ m) / (1 − β₁)).

Serving (a sample of the window's requests): `theta_rel`, the largest gap
of the regressor's output Θ over the largest distance of the reference's Θ
from Θ₀; the largest absolute gaps of the vertices (`verts_m`, metres),
the 2D keypoints (`kp2d_px`, pixels) and the silhouette (`sil`); and the
same of the head alone (`*_geo`): the program's against the reference's
SMPL, projection and silhouette from the program's own Θ.
"""

from __future__ import annotations

import math
import statistics

import torch


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def _gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's | ‖prog‖ − ‖ref‖ | over the larger of its ‖ref‖ and the
    median leaf's."""
    keys = list(keys)
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog.get(k, 0.0) - ref[k]) / max(ref[k], med) if max(ref[k], med) > 0 else math.inf
            for k in keys}


def train_numbers(prog: dict, ref: dict, start: dict) -> tuple[dict, dict]:
    """prog/ref: {"loss": [...], "terms": [{term: value}] a step, "first_grad":
    {leaf: tensor}, "params": {leaf: tensor}}; start: the leaves before step
    1. A leaf the program's optimizer holds no state for reads a gradient
    of 0. Returns (numbers, notes)."""
    losses = [abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"])]
    terms = [{k: abs(tp[k] - tr[k]) / abs(tr[k]) if tr[k] else abs(tp[k]) for k in tr if k in tp}
             for tp, tr in zip(prog["terms"], ref["terms"])]
    gp, gr = _norms(prog["first_grad"]), _norms(ref["first_grad"])
    gd = _norms({k: prog["first_grad"][k].double() - ref["first_grad"][k].double()
                 for k in gr if k in prog["first_grad"]})
    grad = _gaps(gp, gr, gr)
    med = statistics.median(gr.values())
    moved = [k for k in gr if gr[k] >= 1e-3 * med]
    cp = _norms({k: prog["params"][k].double() - start[k].double() for k in moved})
    cr = _norms({k: ref["params"][k].double() - start[k].double() for k in moved})
    change = _gaps(cp, cr, moved)
    bn = {f"{k}.{s}": float(torch.linalg.vector_norm(prog["bn1"][k][i].double() - r[i].double())
                             / torch.linalg.vector_norm(r[i].double()))
          for k, r in ref["bn1"].items() for i, s in enumerate(("mean", "var"))}
    numbers = {"loss_rel": max(losses), "loss1_rel": losses[0], "kp1_rel": terms[0].get("kp", 0.0),
               "grad_leaf": max(grad.values()), "grad_median": statistics.median(grad.values()),
               "grad_diff_median": statistics.median(gd.get(k, gr[k]) / max(gr[k], med) for k in gr),
               "change_leaf": max(change.values()), "change_median": statistics.median(change.values()),
               "bn_rel": max(bn.values())}
    notes = {"grad_worst": max(grad, key=grad.get), "change_worst": max(change, key=change.get),
             "bn_worst": max(bn, key=bn.get),
             "left_out": sorted(set(gr) - set(moved)),
             "loss": prog["loss"], "loss_ref": ref["loss"], "term_gaps": terms}
    return numbers, notes


REPLAYED = ("loss_rel", "kp1_rel", "grad_leaf", "grad_median", "grad_diff_median", "change_leaf",
            "change_median", "bn_rel")


def replay_names(numbers: dict) -> dict:
    """`train_numbers` of one replayed step, under `replay_` names."""
    return {f"replay_{k}": numbers[k] for k in REPLAYED}


def serve_numbers(prog: dict, ref: dict, theta0: torch.Tensor, geo: dict | None = None) -> dict:
    """prog/ref: {"theta", "verts", "kp2d"[, "silhouette"]} float tensors;
    `geo`, when given, the reference's geometry from the program's own theta
    (`reference/serve.geometry`): the `*_geo` gaps then judge SMPL, the
    projection and the raster apart from the encoder."""
    def gap(a, b, k):
        return float((a[k].double() - b[k].double()).abs().max())

    spread = float((ref["theta"].double() - theta0.double()).abs().max())
    out = {"verts_m": gap(prog, ref, "verts"), "kp2d_px": gap(prog, ref, "kp2d"),
           "theta_rel": gap(prog, ref, "theta") / spread}
    if "silhouette" in ref:
        out["sil"] = gap(prog, ref, "silhouette")
    if geo is not None:
        out.update(verts_geo_m=gap(prog, geo, "verts"), kp2d_geo_px=gap(prog, geo, "kp2d"))
        if "silhouette" in geo:
            out["sil_geo"] = gap(prog, geo, "silhouette")
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each limited number beside its limit; correct when every one is
    finite and within it."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
