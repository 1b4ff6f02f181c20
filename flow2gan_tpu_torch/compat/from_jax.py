"""Carry the JAX package's generator and discriminator parameters into the
port.

Input is the flax parameter tree (`variables["params"]`) as nested dicts of
numpy arrays; output is the port's `state_dict`. The port's module names
follow the flax tree, so the conversion renames the list entries
`<name>_<i>` to `<name>.<i>` (`blocks`, `estimators`, `discriminators`,
`convs`; the discriminators' `band_convs_<b>_<i>` to `band_convs.<b>.<i>`)
and re-lays the kernels:

- Dense kernel (I, O) -> Linear weight (O, I), always transposed (square
  matrices included);
- Conv kernel (k, I, O) -> Conv1d weight (O, I, k); the depthwise kernel
  (k, 1, C) -> (C, 1, k) is the same rule;
- 2-D conv kernel (kh, kw, I, O) (flax's HWIO) -> Conv2d weight (O, I, kh,
  kw);
- Embed `embedding` (vocab, dim) -> Embedding `weight` (vocab, dim), not
  transposed (the token family's `token_embed`);
- PReLU `alpha`, BiasNorm `bias` / `log_scale`, ChannelScale `scale` and
  all biases carry across as they are.

`discriminator_0` / `discriminator_1` are module names, not list entries, on
both sides. `load_gan_params` fills a generator and a `Discriminators` from
a `{"generator": ..., "discriminator": ...}` tree.

A `.ckpt` file the JAX package wrote (`load_jax_checkpoint`, which
`training/checkpoint.py` offers too) holds the params under "model", a GAN trainer's as
`{"generator": ..., "discriminator": ...}` there; `generator_params` picks
the generator's tree out of either. Only weights cross: the optimizer
states are laid out otherwise (JAX keeps one per leaf, the port one per
shape group).
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Mapping, Union

import numpy as np
import torch
from torch import nn

from flow2gan_tpu_torch.compat import flax_msgpack

_LIST_ENTRY = re.compile(r"^(blocks|estimators|discriminators|convs|band_convs)_(\d+(?:_\d+)?)$")


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
        if value.ndim == 4:
            return "weight", value.transpose(3, 2, 0, 1)
        raise ValueError(f"unexpected kernel rank {value.ndim}")
    if leaf == "embedding":
        return "weight", value
    return leaf, value


def jax_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax params (a generator's or a `Discriminators`') -> port state_dict
    (float32 tensors)."""
    out = {}
    for path, value in _flatten(params).items():
        *modules, leaf = path
        modules = [
            f"{m[1]}.{m[2].replace('_', '.')}" if (m := _LIST_ENTRY.match(name)) else name
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


def is_jax_checkpoint(path: Union[str, Path]) -> bool:
    """A `.ckpt` file is the JAX package's (flax msgpack), as that package
    tells its files from `.pt` ones."""
    return str(path).endswith(".ckpt")


def load_jax_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """A checkpoint the JAX package wrote, as nested dicts with numpy
    leaves (`compat/flax_msgpack.py`)."""
    return flax_msgpack.loads(Path(path).read_bytes())


def generator_params(tree: Mapping, load_gan: bool = True) -> Mapping:
    """The generator's flax params in what a `.ckpt` holds: a params tree,
    a checkpoint (its "model"), or a GAN checkpoint, whose "generator" is
    taken where `load_gan` is true and raises otherwise."""
    tree = tree["model"] if "model" in tree else tree
    if "generator" in tree:
        if not load_gan:
            raise ValueError("this is a GAN checkpoint: pass --load-gan to take its generator")
        tree = tree["generator"]
    return tree


def load_gan_params(generator: nn.Module, discriminators: nn.Module, params: Mapping):
    """Fill a generator and a `Discriminators` from the GAN stage's tree
    `{"generator": ..., "discriminator": ...}`, or a GAN checkpoint holding
    it as "model", each strictly; another top-level key raises."""
    params = params["model"] if "model" in params else params
    if set(params) != {"generator", "discriminator"}:
        raise KeyError(f"a GAN tree holds 'generator' and 'discriminator', not {sorted(params)}")
    load_jax_params(generator, params["generator"])
    load_jax_params(discriminators, params["discriminator"])
    return generator, discriminators
