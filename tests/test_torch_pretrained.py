"""PyTorch port, weight import (models/pretrained.py,
tools/import_resnet_weights.py) and `train.init_state` with `pretrained`
and `mean_params`, against the JAX reference on the CPU.

The torchvision-format ResNet-18 state dict is built in the test (random
values under torchvision's keys and shapes; no network here).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indirect_learning_pose_shape_tpu import configs as jconfigs
from indirect_learning_pose_shape_tpu import train as jtrain
from indirect_learning_pose_shape_tpu.models import encoder as jenc
from indirect_learning_pose_shape_tpu.models import pretrained as jpre
from indirect_learning_pose_shape_tpu_torch import configs, train
from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.models import pretrained as pre
from indirect_learning_pose_shape_tpu_torch.tools import import_resnet_weights


def _torchvision_sd(depth=18, seed=0) -> dict:
    """torchvision's ResNet keys and shapes (conv1, bn1, layer{1..4}.{b}.…,
    downsample.0/.1, fc), random values; BN statistics positive."""
    rng = np.random.RandomState(seed)
    fresh = enc.Encoder(enc.EncoderConfig(depth=depth), torch.Generator().manual_seed(0))
    sd = {}
    for k, v in fresh.state_dict().items():
        parts = k.split(".")
        if parts[0] in ("stem", "bn_stem"):
            base = "conv1" if parts[0] == "stem" else "bn1"
        else:
            stage, block = int(parts[0][1]), int(parts[0][3:])
            name = {"proj": "downsample.0", "bn_proj": "downsample.1"}.get(parts[1], parts[1])
            base = f"layer{stage + 1}.{block}.{name}"
        leaf = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
        key = f"{base}.weight" if len(parts) == 1 or parts[-1] in ("conv1", "conv2", "conv3", "proj") \
            else f"{base}.{leaf[parts[-1]]}"
        shape = tuple(v.shape)
        if parts[-1] == "var":
            sd[key] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        elif parts[-1] == "scale":
            sd[key] = rng.uniform(0.5, 1.0, shape).astype(np.float32)
        elif len(shape) == 4:
            sd[key] = (rng.randn(*shape) * np.sqrt(1.0 / np.prod(shape[1:]))).astype(np.float32)
        else:
            sd[key] = (0.1 * rng.randn(*shape)).astype(np.float32)
        if key.endswith("running_var"):
            sd[key.replace("running_var", "num_batches_tracked")] = np.asarray(7, np.int64)
    sd["fc.weight"] = rng.randn(1000, fresh.cfg.feature_dim).astype(np.float32)
    sd["fc.bias"] = np.zeros(1000, np.float32)
    return sd


@pytest.fixture(scope="module")
def sd():
    return _torchvision_sd()


def test_map_state_dict_equals_jax(sd):
    params, state = pre.map_state_dict(sd, 18)
    jparams, jstate = jpre.map_state_dict(sd, 18)
    got, want = {}, {}
    pre._flatten({"params": params, "state": state}, "", got)
    jpre._flatten({"params": jparams, "state": jstate}, "", want)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    pre.verify_against_init(params, state, 18)
    with pytest.raises(ValueError, match="missing"):
        pre.verify_against_init({k: v for k, v in params.items() if k != "s3b1"}, state, 18)


def test_imported_features_match_jax(sd, tmp_path):
    """The tool's npz (from a .pth read with weights_only=True) loaded into
    the port's encoder, against JAX's encoder on the same trees: float32
    features within 1e-4."""
    pth = str(tmp_path / "resnet18.pth")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, pth)
    out = str(tmp_path / "enc18.npz")
    assert import_resnet_weights.main([pth, out, "--depth", "18"]) == 0
    model = enc.Encoder(enc.EncoderConfig(depth=18, compute_dtype=torch.float32), torch.Generator().manual_seed(5))
    pre.load_encoder(model, out)
    params, state, depth = jpre.load_encoder_npz(out)
    assert depth == 18
    x = np.random.RandomState(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    jcfg = jenc.EncoderConfig(depth=18, compute_dtype=jnp.float32)
    ref, _ = jax.jit(lambda p, s, im: jenc.encoder_apply(p, s, im, jcfg, train=False))(params, state, x)
    with torch.no_grad():
        got = enc.encoder_apply(model.eval(), torch.from_numpy(x)).numpy()
    ref = np.asarray(ref)
    assert np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, atol=1e-4 * np.abs(ref).max())


def test_npz_crosses_both_ways(sd, tmp_path):
    params, state = pre.map_state_dict(sd, 18)
    pre.save_encoder_npz(str(tmp_path / "port.npz"), params, state, 18)
    jpre.save_encoder_npz(str(tmp_path / "jax.npz"), *jpre.map_state_dict(sd, 18), 18)
    for writer, reader in (("port", jpre.load_encoder_npz), ("jax", pre.load_encoder_npz)):
        p, s, depth = reader(str(tmp_path / f"{writer}.npz"))
        assert depth == 18
        got, want = {}, {}
        pre._flatten({"params": p, "state": s}, "", got)
        pre._flatten({"params": params, "state": state}, "", want)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=(writer, k))


def test_init_state_applies_files_as_jax(sd, tmp_path, tiny_asset):
    """`init_state` with both files: the encoder and IEF's Θ₀ are the
    files', as in the reference's `init_state`."""
    enc_path = str(tmp_path / "enc.npz")
    pre.save_encoder_npz(enc_path, *pre.map_state_dict(sd, 18), 18)
    theta = np.random.RandomState(2).randn(85).astype(np.float32)
    mean_path = str(tmp_path / "mean.npz")
    np.savez(mean_path, mean_theta=theta)
    cfg = dataclasses.replace(configs.CONFIG4_FULL, pretrained=enc_path, mean_params=mean_path)
    ts, _ = train.init_state(cfg, tiny_asset, device="cpu")
    jcfg = dataclasses.replace(jconfigs.CONFIG4_FULL, pretrained=enc_path, mean_params=mean_path)
    jts, _ = jtrain.init_state(jcfg, tiny_asset)
    np.testing.assert_array_equal(ts.model.ief.mean_theta.detach().numpy(), theta)
    np.testing.assert_array_equal(np.asarray(jts.params["ief"]["mean_theta"]), theta)
    from indirect_learning_pose_shape_tpu_torch.utils import convert

    want = convert.encoder_to_state_dict(
        jax.tree.map(np.asarray, jts.params["encoder"]), jax.tree.map(np.asarray, jts.model_state["encoder"])
    )
    got = ts.model.encoder.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("case", ["depth", "shape", "mean_theta_size"])
def test_init_state_refusals(sd, tmp_path, tiny_asset, case):
    """A ResNet-18 file for a ResNet-34 config, a width-64 file for a
    width-32 encoder, an 80-value mean file for an 85-value Θ: both
    packages refuse."""
    path = str(tmp_path / "f.npz")
    if case == "mean_theta_size":
        np.savez(path, mean_theta=np.zeros(80, np.float32))
        kw, match = dict(mean_params=path), "theta_dim=85"
        base, jbase = configs.CONFIG4_FULL, jconfigs.CONFIG4_FULL
    else:
        pre.save_encoder_npz(path, *pre.map_state_dict(sd, 18), 18)
        kw = dict(pretrained=path)
        if case == "depth":
            base, jbase, match = configs.CONFIG4_R34, jconfigs.CONFIG4_R34, "ResNet-18"
        else:
            def narrow(c):
                return dataclasses.replace(c, model=dataclasses.replace(
                    c.model, encoder=dataclasses.replace(c.model.encoder, width=32)))
            base, jbase, match = narrow(configs.CONFIG4_FULL), narrow(jconfigs.CONFIG4_FULL), "shapes"
    with pytest.raises(ValueError, match=match):
        train.init_state(dataclasses.replace(base, **kw), tiny_asset, device="cpu")
    with pytest.raises(ValueError, match=match):
        jtrain.init_state(dataclasses.replace(jbase, **kw), tiny_asset)


def test_encoder_trees_round_trip(tmp_path):
    """`encoder_trees` (the port's encoder as a --pretrained file) is the
    inverse of `load_encoder`, and its trees have the reference's layout."""
    cfg = enc.EncoderConfig(depth=50, width=8)
    src = enc.Encoder(cfg, torch.Generator().manual_seed(3))
    path = str(tmp_path / "r50.npz")
    pre.save_encoder_npz(path, *pre.encoder_trees(src), 50)
    dst = enc.Encoder(cfg, torch.Generator().manual_seed(4))
    pre.load_encoder(dst, path)
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    params, state, _ = jpre.load_encoder_npz(path)
    ref_p, ref_s = jenc.encoder_init(jax.random.PRNGKey(0), jenc.EncoderConfig(depth=50, width=8))
    shapes = jax.tree.map(lambda x: tuple(x.shape), (params, state))
    assert shapes == jax.tree.map(lambda x: tuple(x.shape), (ref_p, ref_s))
