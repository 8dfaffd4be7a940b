"""Pretrained-backbone import (port of models/pretrained.py).

`map_state_dict` maps a torchvision-format ResNet state dict (`resnet18`,
`resnet34`, `resnet50`; `conv1`, `bn1`, `layer{1..4}.{b}.…`,
`downsample.0/.1`) onto the reference's encoder trees: `stem`/`bn_stem`,
blocks `s{stage}b{block}` with `conv1`/`bn1`/… and `proj`/`bn_proj`, conv
weights HWIO, BatchNorm `scale`/`bias` in params and `mean`/`var` in state.
`save_encoder_npz` / `load_encoder_npz` keep the reference's flat file
(`__depth__`, `params/...`, `state/...`), so a file written by either
package loads in the other; `load_encoder` copies one into the port's
`Encoder` (HWIO -> OIHW through `utils/convert.py`), refusing a depth or a
shape the encoder does not have; `encoder_trees` is the inverse.

CLI front end: `tools/import_resnet_weights.py` (.pth -> .npz, offline).
"""

from __future__ import annotations

import numpy as np
import torch

from indirect_learning_pose_shape_tpu_torch.models import encoder as enc
from indirect_learning_pose_shape_tpu_torch.utils import convert


def _conv_w(sd, key):
    # torch conv weight [out, in, kh, kw] -> HWIO [kh, kw, in, out]
    return np.ascontiguousarray(np.asarray(sd[key], np.float32).transpose(2, 3, 1, 0))


def _bn(sd, prefix):
    p = {
        "scale": np.asarray(sd[f"{prefix}.weight"], np.float32),
        "bias": np.asarray(sd[f"{prefix}.bias"], np.float32),
    }
    s = {
        "mean": np.asarray(sd[f"{prefix}.running_mean"], np.float32),
        "var": np.asarray(sd[f"{prefix}.running_var"], np.float32),
    }
    return p, s


def map_state_dict(sd: dict, depth: int) -> tuple[dict, dict]:
    """torchvision ResNet state dict -> (encoder params, encoder state), numpy
    trees in the reference's layout. torchvision's layer{1..4}.{b} is stage
    {0..3}; `downsample.0/.1` is proj/bn_proj."""
    if depth not in enc._STAGE_BLOCKS:
        raise ValueError(f"unsupported depth {depth}")
    n_convs = 3 if depth >= 50 else 2
    params = {"stem": _conv_w(sd, "conv1.weight")}
    params["bn_stem"], bn_state = _bn(sd, "bn1")
    state = {"bn_stem": bn_state}
    for stage, n in enumerate(enc._STAGE_BLOCKS[depth]):
        for b in range(n):
            src = f"layer{stage + 1}.{b}"
            p: dict = {}
            s: dict = {}
            for c in range(1, n_convs + 1):
                p[f"conv{c}"] = _conv_w(sd, f"{src}.conv{c}.weight")
                p[f"bn{c}"], s[f"bn{c}"] = _bn(sd, f"{src}.bn{c}")
            if f"{src}.downsample.0.weight" in sd:
                p["proj"] = _conv_w(sd, f"{src}.downsample.0.weight")
                p["bn_proj"], s["bn_proj"] = _bn(sd, f"{src}.downsample.1")
            params[f"s{stage}b{b}"] = p
            state[f"s{stage}b{b}"] = s
    return params, state


# --- flat npz (de)serialization of the nested trees --------------------------


def _flatten(tree: dict, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            _flatten(v, key, out)
        else:
            out[key] = np.asarray(v)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_encoder_npz(path: str, params: dict, state: dict, depth: int) -> None:
    flat: dict = {"__depth__": np.asarray(depth)}
    _flatten(params, "params", flat)
    _flatten(state, "state", flat)
    np.savez_compressed(path, **flat)


def load_encoder_npz(path: str) -> tuple[dict, dict, int]:
    """(encoder params, encoder state, depth) as numpy trees."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    depth = int(flat.pop("__depth__"))
    tree = _unflatten(flat)
    return tree["params"], tree["state"], depth


def encoder_trees(encoder: enc.Encoder) -> tuple[dict, dict]:
    """The port's `Encoder` as the reference's (params, state) numpy trees
    (conv weights HWIO): what `save_encoder_npz` writes."""
    params: dict = {}
    state: dict = {}
    for key, v in encoder.state_dict().items():
        *path, leaf = key.split(".")
        tree = state if leaf in ("mean", "var") else params
        for p in path:
            tree = tree.setdefault(p, {})
        v = v.detach().cpu().float().numpy()
        tree[leaf] = np.ascontiguousarray(v.transpose(2, 3, 1, 0)) if v.ndim == 4 else v
    return params, state


def verify_against_init(params: dict, state: dict, depth: int) -> None:
    """Key and shape check of the trees against a fresh ResNet-`depth`
    (width 64) `Encoder`."""
    fresh = enc.Encoder(enc.EncoderConfig(depth=depth), torch.Generator().manual_seed(0))
    want = {k: tuple(v.shape) for k, v in fresh.state_dict().items()}
    got = {k: v.shape for k, v in convert.encoder_to_state_dict(params, state).items()}
    if set(got) != set(want):
        raise ValueError(
            f"encoder tree mismatch: missing={sorted(set(want) - set(got))} "
            f"extra={sorted(set(got) - set(want))}"
        )
    for k, shape in want.items():
        if got[k] != shape:
            raise ValueError(f"{k}: shape {got[k]} != expected {shape}")


def load_encoder(encoder: enc.Encoder, path: str) -> None:
    """Copy the backbone of `path` (a `save_encoder_npz` file) into
    `encoder`. Refuses a file of another depth, and one whose keys or shapes
    differ from the encoder's (another width)."""
    params, state, depth = load_encoder_npz(path)
    if depth != encoder.cfg.depth:
        raise ValueError(
            f"pretrained file {path!r} is a ResNet-{depth}; the config asks for depth "
            f"{encoder.cfg.depth}"
        )
    arrays = convert.encoder_to_state_dict(params, state)
    got = {k: v.shape for k, v in arrays.items()}
    want = {k: tuple(v.shape) for k, v in encoder.state_dict().items()}
    if got != want:
        raise ValueError(
            "pretrained encoder shapes do not match the configured encoder "
            f"(width {encoder.cfg.width}?): {got} vs {want}"
        )
    convert.load_state_arrays(encoder, arrays)
