"""PyTorch port, augmentation: the flip tables, every refusal and its
message, and the config against the reference's `data/augment.py`;
`mirror_raw_batch` and `jitter_bboxes` on the reference's own draws
(`jax.random` from the same key, injected) against JAX's; the draws' law.
All exact: the same float32 operations on the same numbers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu import configs as jconfigs
from indirect_learning_pose_shape_tpu.data import augment as jaug
from indirect_learning_pose_shape_tpu_torch import configs
from indirect_learning_pose_shape_tpu_torch.data import augment as aug


def test_tables_and_config_match_reference():
    assert aug._KP_SWAPS == jaug._KP_SWAPS
    assert aug._SMPL_LR == jaug._SMPL_LR
    assert aug._PART_CONVENTIONS == jaug._PART_CONVENTIONS
    fields = [f.name for f in dataclasses.fields(aug.AugmentConfig)]
    assert fields == [f.name for f in dataclasses.fields(jaug.AugmentConfig)]
    assert dataclasses.asdict(aug.AugmentConfig()) == dataclasses.asdict(jaug.AugmentConfig())


@pytest.mark.parametrize("name", sorted(set(configs.PRESETS) - {"hmr2_vith"}))  # hmr2_vith: the port's alone
def test_presets_carry_the_reference_augment(name):
    got = dataclasses.asdict(configs.PRESETS[name].augment)
    assert got == dataclasses.asdict(jconfigs.PRESETS[name].augment)


def _outcome(fn, *args):
    try:
        return ("ok", np.asarray(fn(*args)).tolist())
    except ValueError as e:
        return ("error", str(e))


@pytest.mark.parametrize("num_parts, convention, pairs", [
    (24, "smpl24", ()), (14, "smpl24", ()), (31, "smpl24", ()), (31, "s31-smpl-prefix", ()),
    (24, "s31-smpl-prefix", ()), (24, "none", ()), (24, "up-s31", ()),
    (10, "custom", ((1, 2), (5, 9))), (10, "custom", ((0, 2),)), (10, "custom", ((3, 11),)),
])
def test_part_label_flip_perm_matches_reference(num_parts, convention, pairs):
    """Each table and each refusal, message included, as the reference's."""
    got = _outcome(aug.part_label_flip_perm, num_parts, convention, pairs)
    assert got == _outcome(jaug.part_label_flip_perm, num_parts, convention, pairs)


@pytest.mark.parametrize("num_kp", [14, 17, 19, 21])
def test_kp_flip_perm_matches_reference(num_kp):
    assert _outcome(aug.kp_flip_perm, num_kp) == _outcome(jaug.kp_flip_perm, num_kp)


def _raw(B=6, H=24, W=32, K=19, seed=0):
    rng = np.random.RandomState(seed)
    masks = np.zeros((B, H, W), np.uint8)
    masks[:, 4:20, 6:12] = 17  # left shoulder, left of frame
    masks[:, 4:20, 20:26] = 18
    masks[:, 2:4, 2:30] = 25  # an id past the 24 parts: unswapped
    return {
        "images": rng.randint(0, 255, (B, H, W, 3)).astype(np.uint8),
        "masks": masks,
        "kp2d": (rng.rand(B, K, 2) * [W, H]).astype(np.float32),
        "kp_vis": (rng.rand(B, K) > 0.3).astype(np.float32),
    }


def _jax_draws(key, cfg, B):
    """The draws of the reference's preprocess_raw_batch from `key`."""
    k_flip, k_box = jax.random.split(key)
    ks, kt = jax.random.split(k_box)
    flip = jax.random.bernoulli(k_flip, cfg.flip_prob, (B,))
    scale = jax.random.uniform(ks, (B, 1), minval=1.0 - cfg.scale_jitter, maxval=1.0 + cfg.scale_jitter)
    shift = jax.random.uniform(kt, (B, 2), minval=-cfg.trans_jitter, maxval=cfg.trans_jitter)
    return k_flip, k_box, {k: torch.from_numpy(np.array(v)) for k, v in
                           (("flip", flip), ("scale", scale), ("shift", shift))}


@pytest.mark.parametrize("num_kp", [19, 17, 14])
def test_mirror_raw_batch_matches_jax(num_kp):
    """Per-sample flips, flipped and unflipped items in one batch."""
    raw = _raw(K=num_kp)
    cfg = aug.AugmentConfig(enabled=True)
    k_flip, _, draws = _jax_draws(jax.random.PRNGKey(3), jaug.AugmentConfig(enabled=True), 6)
    assert 0 < int(draws["flip"].sum()) < 6
    want = jaug.mirror_raw_batch({k: jnp.asarray(v) for k, v in raw.items()}, k_flip,
                                 jaug.AugmentConfig(enabled=True))
    got = aug.mirror_raw_batch({k: torch.from_numpy(v) for k, v in raw.items()}, draws["flip"], cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    f = draws["flip"].numpy()
    assert (got["masks"].numpy()[f][:, 4:20, 20:26] == 18).all()  # 17 mirrored onto 18's side...
    assert (got["masks"].numpy()[f][:, 4:20, 6:12] == 17).all()  # ...and swapped


def test_mirror_flip_prob_zero_returns_the_batch():
    raw = {k: torch.from_numpy(v) for k, v in _raw(K=21).items()}  # no table for 21 needed
    cfg = aug.AugmentConfig(enabled=True, flip_prob=0.0)
    assert aug.mirror_raw_batch(raw, torch.ones(6, dtype=torch.bool), cfg) is raw


def test_jitter_bboxes_matches_jax():
    cfg = jaug.AugmentConfig(enabled=True)
    _, k_box, draws = _jax_draws(jax.random.PRNGKey(5), cfg, 4)
    boxes = np.array([[24, 20, 30], [10, 5, 60], [40.25, 38.5, 20], [8, 8, 8]], np.float32)
    want = np.asarray(jaug.jitter_bboxes(jnp.asarray(boxes), k_box, cfg))
    got = aug.jitter_bboxes(torch.from_numpy(boxes), draws["scale"], draws["shift"]).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_draws_law():
    """flip ~ Bernoulli(p), scale ~ U(1 - s, 1 + s), shift ~ U(-t, t), a
    function of the generator's seed."""
    cfg = aug.AugmentConfig(enabled=True, flip_prob=0.3, scale_jitter=0.2, trans_jitter=0.1)
    d = aug.sample_draws(torch.Generator().manual_seed(0), 4000, cfg)
    assert d["flip"].dtype == torch.bool and d["flip"].shape == (4000,)
    assert abs(d["flip"].float().mean().item() - 0.3) < 0.03
    assert d["scale"].shape == (4000, 1) and d["shift"].shape == (4000, 2)
    assert 0.8 <= d["scale"].min() and d["scale"].max() <= 1.2
    assert -0.1 <= d["shift"].min() and d["shift"].max() <= 0.1
    assert abs(d["scale"].mean().item() - 1.0) < 0.01 and abs(d["shift"].mean().item()) < 0.005
    again = aug.sample_draws(torch.Generator().manual_seed(0), 4000, cfg)
    assert all(torch.equal(d[k], again[k]) for k in d)
    for p, want in ((0.0, False), (1.0, True)):
        flips = aug.sample_draws(torch.Generator().manual_seed(1), 64, dataclasses.replace(cfg, flip_prob=p))
        assert (flips["flip"] == want).all()
