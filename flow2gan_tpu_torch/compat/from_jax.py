"""Carry the JAX package's generator parameters into the port.

Input is the flax parameter tree (`variables["params"]`) as nested dicts of
numpy arrays; output is the port's `state_dict`. The port's module names
follow the flax tree, so the conversion renames `<name>_<i>` list entries to
`<name>.<i>` and re-lays the kernels:

- Dense kernel (I, O) -> Linear weight (O, I), always transposed (square
  matrices included);
- Conv kernel (k, I, O) -> Conv1d weight (O, I, k); the depthwise kernel
  (k, 1, C) -> (C, 1, k) is the same rule;
- PReLU `alpha`, BiasNorm `bias` / `log_scale`, ChannelScale `scale` and
  all biases carry across as they are.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_LIST_ENTRY = re.compile(r"^(blocks|estimators)_(\d+)$")


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (key,)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _convert_leaf(leaf: str, value: np.ndarray):
    if leaf == "kernel":
        if value.ndim == 2:
            return "weight", value.T
        if value.ndim == 3:
            return "weight", value.transpose(2, 1, 0)
        raise ValueError(f"unexpected kernel rank {value.ndim}")
    return leaf, value


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax generator params -> port state_dict (float32 tensors)."""
    out = {}
    for path, value in _flatten(params).items():
        *modules, leaf = path
        modules = [
            ".".join(m.groups()) if (m := _LIST_ENTRY.match(name)) else name
            for name in modules
        ]
        name, value = _convert_leaf(leaf, value)
        # np.array, not np.ascontiguousarray: the latter turns a scalar
        # (BiasNorm log_scale) into shape (1,)
        out[".".join([*modules, name])] = torch.from_numpy(
            np.array(value, dtype=np.float32, order="C")
        )
    return out


def load_jax_params(model: nn.Module, params: Mapping) -> nn.Module:
    """Fill every parameter of `model` from the flax tree, strictly: a port
    parameter left unfilled, a JAX leaf left unused or a shape mismatch
    raises."""
    sd = jax_params_to_state_dict(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(sd))
    unused = sorted(set(sd) - set(own))
    if missing or unused:
        raise KeyError(f"JAX params do not match the port: missing {missing}, unused {unused}")
    bad = [k for k in own if tuple(own[k].shape) != tuple(sd[k].shape)]
    if bad:
        raise ValueError(
            "shape mismatch: "
            + ", ".join(f"{k} {tuple(sd[k].shape)} vs {tuple(own[k].shape)}" for k in bad)
        )
    model.load_state_dict(sd, strict=True)
    return model
