"""Weight bridge: the reference's `(params, state)` pytree -> the port's
`Model.state_dict()`.

The pytree comes as nested dicts/lists of numpy arrays (`jax.device_get`
of the reference's params and state, or any numpy copy of them):

    params = {"encoder": {"stem": HWIO, "bn_stem": {"scale", "bias"},
                          "s0b0": {"conv1": HWIO, "bn1": {...}, ...}, ...},
              "ief": {"layers": [{"w": [in, out], "b": [out]}, ...],
                      "mean_theta": [theta_dim]}}
    state  = {"encoder": {"bn_stem": {"mean", "var"}, "s0b0": {...}, ...}}

Conv weights go HWIO → OIHW, IEF weights [in, out] → Linear's [out, in];
BN scale/bias/mean/var and `mean_theta` carry over. Loading is strict: a
missing, extra or misshapen key raises.
"""

from __future__ import annotations

import numpy as np
import torch

_HWIO_TO_OIHW = (3, 2, 0, 1)


def _flatten(tree: dict, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            _flatten(v, key + ".", out)
        else:
            out[key] = np.asarray(v)


def encoder_to_state_dict(params: dict, state: dict) -> dict[str, np.ndarray]:
    """The reference's encoder (params, state) subtrees -> `Encoder.state_dict()`
    keys and layouts (numpy float32)."""
    flat: dict[str, np.ndarray] = {}
    _flatten(params, "", flat)
    _flatten(state, "", flat)
    return {
        k: np.ascontiguousarray(v.transpose(_HWIO_TO_OIHW) if v.ndim == 4 else v, dtype=np.float32)
        for k, v in flat.items()
    }


def jax_to_state_dict(params: dict, state: dict) -> dict[str, np.ndarray]:
    """Reference pytree -> the port's state_dict keys and layouts (numpy)."""
    out = {
        f"encoder.{k}": v
        for k, v in encoder_to_state_dict(params["encoder"], state["encoder"]).items()
    }
    ief = params["ief"]
    for i, layer in enumerate(ief["layers"]):
        out[f"ief.layers.{i}.weight"] = np.asarray(layer["w"]).T
        out[f"ief.layers.{i}.bias"] = np.asarray(layer["b"])
    out["ief.mean_theta"] = np.asarray(ief["mean_theta"])
    return {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in out.items()}


def load_state_arrays(model: torch.nn.Module, arrays: dict) -> None:
    """Load numpy arrays keyed like `model.state_dict()`. Strict: raises
    RuntimeError on a missing or extra key and on a shape that differs."""
    model.load_state_dict(
        {k: torch.tensor(np.asarray(v, np.float32)) for k, v in arrays.items()},
        strict=True,
    )


def load_jax_params(model: torch.nn.Module, params: dict, state: dict) -> None:
    """Copy the reference's (params, state) into `model`, strictly."""
    load_state_arrays(model, jax_to_state_dict(params, state))
