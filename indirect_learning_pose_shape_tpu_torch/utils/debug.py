"""Numerics debugging (port of utils/debug.py).

- `enable_nan_checks()`: autograd's anomaly mode, which names the forward op
  whose backward produced a NaN.
- `checked(fn)`: `fn` that raises FloatingPointError when an output is not
  finite.
- `assert_finite(tensors, name)`: raises naming the first non-finite leaf of
  a tensor, a list or a (nested) dict such as a state_dict.
"""

from __future__ import annotations

import functools

import torch


def enable_nan_checks(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def _leaves(obj, path: str = ""):
    if torch.is_tensor(obj):
        yield path, obj
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            yield from _leaves(v, f"{path}[{i}]")


def assert_finite(tensors, name: str = "tensors") -> None:
    for path, leaf in _leaves(tensors):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise FloatingPointError(f"non-finite values in {name}{path}")


def checked(fn):
    """`fn` whose floating-point outputs are checked after each call."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        assert_finite(out, f"output of {getattr(fn, '__name__', 'fn')}")
        return out

    return wrapper
