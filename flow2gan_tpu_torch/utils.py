"""Small shared helpers of the PyTorch port (counterpart of
`flow2gan_tpu/utils.py`, kept as an own copy so the port never imports the
JAX package)."""

from __future__ import annotations

import json
import pathlib

import torch


def make_valid_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Float mask (batch, max_len) that is 1.0 at positions < length."""
    if lengths.ndim != 1:
        raise ValueError(f"lengths must be 1-D, got shape {tuple(lengths.shape)}")
    seq = torch.arange(max_len, device=lengths.device)
    return (seq[None, :] < lengths[:, None]).to(torch.float32)


def safe_log(x: torch.Tensor, clip_val: float = 1e-7) -> torch.Tensor:
    """log(max(x, clip_val))."""
    return torch.log(torch.clamp(x, min=clip_val))


def disable_tf32() -> None:
    """Run float32 matmuls and cuDNN convolutions in full IEEE float32.

    The JAX package computes its DFTs at `Precision.HIGHEST`; on the card
    cuDNN convolutions default to TF32 (about three decimal digits), which
    would put the port 1e-3 away from it. Both flags are process-wide and are
    not restored: `api.get_model` calls this once when it builds a model on
    the card, so concurrent calls never see the flags change under them.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class AttributeDict(dict):
    """dict with attribute access and JSON pretty-printing."""

    def __getattr__(self, key):
        if key in self:
            return self[key]
        raise AttributeError(f"No such attribute '{key}'")

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, key):
        if key in self:
            del self[key]
            return
        raise AttributeError(f"No such attribute '{key}'")

    def __str__(self, indent: int = 2):
        tmp = {}
        for k, v in self.items():
            if isinstance(v, pathlib.Path):
                v = str(v)
            try:
                json.dumps(v)
            except TypeError:
                v = str(v)
            tmp[k] = v
        return json.dumps(tmp, indent=indent, sort_keys=True)
