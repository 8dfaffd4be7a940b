"""PyTorch port, losses: every term and `total_loss` against the JAX
reference on the same numpy inputs, at rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu import losses as jlosses
from indirect_learning_pose_shape_tpu_torch import losses

B, H, C, K, J, V = 2, 16, 5, 7, 6, 40
WEIGHTS = {
    "sil_bce": 1.0, "sil_iou": 1.0, "part_ce": 1.0, "kp": 5.0, "shape_reg": 1e-3,
    "pose_reg": 1e-3, "j3d": 2.0, "v3d": 0.5, "rotmat": 1.0, "betas_l2": 0.02,
}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    score = (rng.rand(B, C, H * H) * 3 * (rng.rand(B, 1, H * H) > 0.3)).astype(np.float32)
    s_total = score.sum(1)
    bg = 1.0
    probs = np.concatenate([bg / (bg + s_total)[:, None], score / (bg + s_total)[:, None]], 1)
    outputs = {
        "silhouette": (s_total / (bg + s_total)).reshape(B, H, H),
        "score_cp": score,
        "s_total": s_total,
        "bg_gamma": bg,
        "probs": probs.transpose(0, 2, 1).reshape(B, H, H, C + 1),
        "kp2d": f(B, K, 2) * 40 + 60,
        "pose": f(B, 72) * 0.3,
        "pose_prior": f(B, 69) * 0.3,
        "betas": f(B, 10),
        "joints": f(B, J, 3),
        "verts": f(B, V, 3),
        "rotmats": f(B, J, 3, 3),
    }
    labels = rng.randint(0, C + 1, (B, H, H)).astype(np.int32)
    labels[0, :4] = 0
    targets = {
        "silhouette": (rng.rand(B, H, H) > 0.5).astype(np.float32),
        "part_labels": labels,
        "kp2d": f(B, K, 2) * 40 + 60,
        "kp_vis": (rng.rand(B, K) > 0.3).astype(np.float32),
        "joints3d": f(B, J, 3),
        "verts3d": f(B, V, 3),
        "rotmats": f(B, J, 3, 3),
        "betas": f(B, 10),
    }
    return outputs, targets


def _t(tree):
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in tree.items()}


CASES = {
    "silhouette_bce": lambda m, o, t: m.silhouette_bce(o["silhouette"], t["silhouette"]),
    "silhouette_iou": lambda m, o, t: m.silhouette_iou(o["silhouette"], t["silhouette"]),
    "part_seg_ce": lambda m, o, t: m.part_seg_ce(o["probs"], t["part_labels"]),
    "part_seg_ce_scores": lambda m, o, t: m.part_seg_ce_scores(
        o["score_cp"], o["s_total"], o["bg_gamma"], t["part_labels"]),
    "keypoint_l2": lambda m, o, t: m.keypoint_l2(o["kp2d"], t["kp2d"], t["kp_vis"], 128),
    "shape_reg": lambda m, o, t: m.shape_reg(o["betas"]),
    "pose_reg": lambda m, o, t: m.pose_reg(o["pose_prior"]),
    "joints3d_l2": lambda m, o, t: m.joints3d_l2(o["joints"], t["joints3d"]),
    "verts3d_l2": lambda m, o, t: m.verts3d_l2(o["verts"], t["verts3d"]),
    "rotmat_frob": lambda m, o, t: m.rotmat_frob(o["rotmats"], t["rotmats"]),
    "betas_l2": lambda m, o, t: m.betas_l2(o["betas"], t["betas"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_term_matches_jax(name):
    o, t = _data()
    want = float(CASES[name](jlosses, _j(o), _j(t)))
    got = CASES[name](losses, _t(o), _t(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5)


@pytest.mark.parametrize("form", ["score", "probs"])
def test_total_loss_matches_jax(form):
    """total_loss and its terms, and its gradient in every differentiated output."""
    o, t = _data(seed=1)
    drop = "probs" if form == "score" else "score_cp"
    o = {k: v for k, v in o.items() if k != drop}
    diff = [k for k, v in o.items() if isinstance(v, np.ndarray) and k != "s_total"]

    def jtotal(xs):
        return jlosses.total_loss({**_j(o), **xs}, _j(t), WEIGHTS, 128)

    (jt, jterms), jgrad = jax.value_and_grad(jtotal, has_aux=True)(
        {k: jnp.asarray(o[k]) for k in diff}
    )
    xs = {k: torch.from_numpy(o[k]).requires_grad_(True) for k in diff}
    total, terms = losses.total_loss({**_t(o), **xs}, _t(t), WEIGHTS, 128)
    assert set(terms) == set(jterms)
    for k in jterms:
        np.testing.assert_allclose(float(terms[k]), float(jterms[k]), rtol=1e-5, err_msg=k)
    total.backward()
    for k in diff:
        g = np.asarray(jgrad[k])
        if xs[k].grad is None:  # an output no term reads
            assert not g.any(), k
            continue
        scale = float(np.abs(g).max()) + 1e-12
        np.testing.assert_allclose(xs[k].grad.numpy() / scale, g / scale, atol=1e-5, err_msg=k)


def test_zero_weights_are_skipped():
    o, t = _data()
    total, terms = losses.total_loss(_t(o), _t(t), {"kp": 5.0, "sil_bce": 0.0}, 128)
    assert set(terms) == {"kp", "total"}
    np.testing.assert_allclose(float(total), 5.0 * float(terms["kp"]), rtol=1e-6)


def test_part_ce_scores_equals_probs_form():
    """The score form equals part_seg_ce of the normalized probabilities."""
    o, t = _data(seed=2)
    o, t = _t(o), _t(t)
    a = losses.part_seg_ce_scores(o["score_cp"], o["s_total"], o["bg_gamma"], t["part_labels"])
    b = losses.part_seg_ce(o["probs"], t["part_labels"])
    np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
    # bf16 scores: the one-hot pick accumulates in float32 and picks exactly.
    s16 = o["score_cp"].to(torch.bfloat16)
    c = losses.part_seg_ce_scores(s16, s16.float().sum(1), o["bg_gamma"], t["part_labels"])
    assert c.dtype == torch.float32
    d = jlosses.part_seg_ce_scores(
        jnp.asarray(s16.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(s16.float().sum(1).numpy()), 1.0, jnp.asarray(t["part_labels"].numpy()),
    )
    np.testing.assert_allclose(float(c), float(d), rtol=1e-5)


def test_part_ce_scores_bf16_value_and_gradient_match_jax():
    """bf16 scores (the training render under train_score_dtype='bfloat16'):
    the label pick summed in float32, s_total summed in float32 from the
    same bf16 scores, and the gradient back through the bf16 scores, against
    JAX on the same bf16 values: value at 1e-5, gradient (bf16) within one
    bf16 ulp of the largest entry."""
    o, t = _data(seed=3)
    s16 = torch.from_numpy(o["score_cp"]).to(torch.bfloat16)
    labels = t["part_labels"]

    def jf(s):
        return jlosses.part_seg_ce_scores(s, jnp.sum(s, axis=1, dtype=jnp.float32), 1.0, jnp.asarray(labels))

    js = jnp.asarray(s16.float().numpy()).astype(jnp.bfloat16)
    want, jgrad = jax.value_and_grad(jf)(js)
    x = s16.clone().requires_grad_(True)
    got = losses.part_seg_ce_scores(x, torch.sum(x, dim=1, dtype=torch.float32), 1.0, torch.from_numpy(labels))
    got.backward()
    assert got.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    g, jg = x.grad.float().numpy(), np.asarray(jgrad).astype(np.float32)
    assert np.abs(jg).max() > 0
    np.testing.assert_allclose(g, jg, atol=2.0**-8 * np.abs(jg).max())
