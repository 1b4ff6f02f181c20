"""Carry a checkpoint in the reference's naming (the released `.pt` files)
into the port; the counterpart of `flow2gan_tpu/compat/torch_convert.py`.

The reference is a PyTorch model too, so a weight keeps its torch layout; what
differs is naming and a few shapes:

- the time and cond MLPs are `nn.Sequential`s there (`time_mlp.0`,
  `cond_mlp.1`) and attributes here (`time_mlp_0`, `cond_mlp_1`);
- PReLU's parameter is `weight` there and `alpha` here;
- the pointwise projections may be 1x1 `Conv1d`s there, (O, I, 1), where the
  port has `Linear`s, (O, I); ChannelScale's scale is (C, 1) there and (C,)
  here;
- DDP's `module.` prefix is stripped, and a GAN checkpoint's `generator.`
  entries are unwrapped (its discriminators dropped);
- buffers with no parameter counterpart (STFT windows, the loss's and the
  mel frontend's filterbanks, batch-norm counters) are skipped.

The conversion is strict: every port parameter must be filled, and a key that
is neither skipped nor mapped raises.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Mapping, Union

import torch
from torch import nn

from flow2gan_tpu_torch.compat.from_jax import (
    generator_params,
    is_jax_checkpoint,
    load_jax_checkpoint,
    load_jax_params,
)

StateDict = Dict[str, torch.Tensor]

# reference state-dict entries with no parameter counterpart in the port
_SKIP_PATTERNS = (
    re.compile(r"(^|\.)loss_spec\."),
    re.compile(r"(^|\.)(fft|ifft)\.window$"),
    re.compile(r"(^|\.)mel\."),
    re.compile(r"(^|\.)mel_recon_modules\."),
    re.compile(r"(^|\.)spec_fn\."),
    re.compile(r"num_batches_tracked$"),
)
_RENAMES = (
    (re.compile(r"\btime_mlp\.(\d+)\."), r"time_mlp_\1."),
    (re.compile(r"\bcond_mlp\.(\d+)\."), r"cond_mlp_\1."),
)


def load_torch_file(path: Union[str, Path], load_gan: bool = False) -> StateDict:
    """The tensors of a `.pt` file: a raw state dict, or the "model" entry of
    a checkpoint container; with `load_gan`, the "generator" entry of a GAN
    trainer checkpoint's "model". A GAN trainer checkpoint without
    `load_gan` raises."""
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    if isinstance(obj.get("generator"), dict):
        if not load_gan:
            raise ValueError(f"{path} is a GAN checkpoint: pass --load-gan to take its generator")
        obj = obj["generator"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def strip_prefixes(state_dict: Mapping[str, torch.Tensor],
                   unwrap_generator: bool = False) -> StateDict:
    """Strip DDP's `module.` prefixes; with `unwrap_generator`, keep only a
    GAN checkpoint's `generator.` entries, unprefixed."""
    out = {}
    for k, v in state_dict.items():
        k = k.removeprefix("module.")
        if unwrap_generator:
            if not k.startswith("generator."):
                continue
            k = k.removeprefix("generator.")
        out[k] = v
    return out


def _port_name(name: str, own: Mapping[str, torch.Tensor]):
    for pattern, repl in _RENAMES:
        name = pattern.sub(repl, name)
    if name in own:
        return name
    if name.endswith(".weight") and name.removesuffix(".weight") + ".alpha" in own:
        return name.removesuffix(".weight") + ".alpha"  # PReLU
    return None


def _fit(value: torch.Tensor, shape: torch.Size, name: str) -> torch.Tensor:
    """`value` in the port's shape: equal shapes as they are, else only unit
    dimensions may differ (a 1x1 conv's (O, I, 1) against a Linear's (O, I),
    ChannelScale's (C, 1) against (C,)). A weight is never transposed: both
    sides lay it out as torch does."""
    if value.shape == shape:
        return value
    if [d for d in value.shape if d != 1] == [d for d in shape if d != 1]:
        return value.reshape(shape)
    raise ValueError(f"cannot fit {name} of shape {tuple(value.shape)} into {tuple(shape)}")


def reference_to_state_dict(state_dict: Mapping[str, torch.Tensor],
                            own: Mapping[str, torch.Tensor]) -> StateDict:
    """Convert a reference-named generator state dict (prefixes stripped)
    onto the port's state dict `own`, strictly; float32 like `own`."""
    out, unexpected = {}, []
    for name, value in state_dict.items():
        if any(p.search(name) for p in _SKIP_PATTERNS):
            continue
        target = _port_name(name, own)
        if target is None:
            unexpected.append(name)
            continue
        out[target] = _fit(value, own[target].shape, name).to(own[target].dtype)
    missing = sorted(set(own) - set(out))
    if missing or unexpected:
        raise KeyError(f"the checkpoint does not match the port: missing {missing[:10]} "
                       f"({len(missing)}), unexpected {unexpected[:10]} ({len(unexpected)})")
    return out


def to_port_state_dict(state_dict: Mapping[str, torch.Tensor], model: nn.Module) -> StateDict:
    """`state_dict` in the port's naming: the port's own names are taken as
    they are, anything else goes through `reference_to_state_dict`."""
    sd = strip_prefixes(state_dict,
                        unwrap_generator=any(k.startswith("generator.") for k in state_dict))
    own = model.state_dict()
    if set(sd) == set(own):
        return dict(sd)
    return reference_to_state_dict(sd, own)


def load_weights(model: nn.Module, path: Union[str, Path]) -> nn.Module:
    """Fill `model` from a `.pt` file: the port's `state_dict`, a trainer
    checkpoint (its "model" entry) or a reference-named checkpoint; or from
    a JAX package `.ckpt` (its params, a trainer checkpoint's "model", or a
    GAN checkpoint's generator), as strictly."""
    if is_jax_checkpoint(path):
        return load_jax_params(model, generator_params(load_jax_checkpoint(path)))
    model.load_state_dict(to_port_state_dict(load_torch_file(path), model), strict=True)
    return model
