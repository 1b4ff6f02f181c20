"""Small shared helpers of the PyTorch port (counterpart of
`flow2gan_tpu/utils.py`, kept as an own copy so the port never imports the
JAX package)."""

from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import pathlib
from datetime import datetime

import numpy as np
import torch
import torch.distributed


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
    """Run float32 matmuls and cuDNN convolutions in full IEEE float32, and
    accumulate bfloat16 matmuls in float32 throughout.

    The JAX package computes its DFTs at `Precision.HIGHEST`; on the card
    cuDNN convolutions default to TF32 (about three decimal digits), which
    would put the port 1e-3 away from it. XLA accumulates bfloat16 dots in
    float32, while cuBLAS may round the partial sums of a split-K bfloat16
    GEMM to bfloat16 unless told not to. The flags are process-wide and are
    not restored: `api.get_model` and the trainer call this once on the
    card, so concurrent calls never see the flags change under them.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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


def str2bool(v):
    """argparse-friendly bool parser."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def setup_logger(log_filename, rank: int = 0, world_size: int = 1) -> None:
    """Log INFO and above to `log_filename`-<date-time> and to the console.
    With `world_size` > 1 each line carries "(rank/world_size)", and a rank
    other than 0 logs to the console only (only rank 0 writes files)."""
    formatter = "%(asctime)s %(levelname)s [%(filename)s:%(lineno)d] %(message)s"
    if world_size > 1:
        formatter = formatter.replace("] ", f"] ({rank}/{world_size}) ", 1)
    if rank != 0:
        logging.basicConfig(format=formatter, level=logging.INFO, force=True)
        return
    log_filename = f"{log_filename}-{datetime.now().strftime('%Y-%m-%d-%H-%M-%S')}"
    os.makedirs(os.path.dirname(log_filename), exist_ok=True)
    logging.basicConfig(filename=log_filename, format=formatter, level=logging.INFO,
                        filemode="w", force=True)
    console = logging.StreamHandler()
    console.setFormatter(logging.Formatter(formatter))
    logging.getLogger("").addHandler(console)


class MetricsTracker(collections.defaultdict):
    """Sample-weighted metric sums (plain floats); `str` prints each per
    sample."""

    def __init__(self):
        super().__init__(int)

    def __add__(self, other: "MetricsTracker") -> "MetricsTracker":
        ans = MetricsTracker()
        for k, v in self.items():
            ans[k] = v
        for k, v in other.items():
            ans[k] = ans[k] + v
        return ans

    def norm_items(self):
        samples = self["samples"] if "samples" in self else 1
        return [(k, float(v) / samples) for k, v in self.items() if k != "samples"]

    def reduce(self, device: torch.device) -> None:
        """Sum every metric over the ranks (float64 on `device`, the
        process group's); a no-op in one process."""
        if not torch.distributed.is_initialized() or torch.distributed.get_world_size() == 1:
            return
        keys = sorted(self)
        values = torch.tensor([float(self[k]) for k in keys], dtype=torch.float64, device=device)
        torch.distributed.all_reduce(values)
        for k, v in zip(keys, values.tolist()):
            self[k] = v

    def __str__(self) -> str:
        ans = "".join(f"{k}={v:.4g}, " for k, v in self.norm_items())
        return ans + f"over {self['samples']:.2f} samples."

    def write_summary(self, tb_writer, prefix: str, batch_idx: int) -> None:
        """Each metric per sample as a TensorBoard scalar `{prefix}{name}`."""
        for k, v in self.norm_items():
            tb_writer.add_scalar(prefix + k, v, batch_idx)


# viridis at nine evenly spaced points, interpolated to 256 colours
_COLOURS = np.array([(68, 1, 84), (71, 44, 122), (59, 81, 139), (44, 113, 142), (33, 144, 141),
                     (39, 173, 129), (92, 200, 99), (170, 220, 50), (253, 231, 37)], np.float64)
_COLOUR_TABLE = np.stack([np.interp(np.linspace(0.0, 1.0, 256), np.linspace(0.0, 1.0, 9), c)
                          for c in _COLOURS.T], axis=-1).round().astype(np.uint8)


def plot_feature(spectrogram: np.ndarray) -> np.ndarray:
    """A (channels, frames) feature as an (channels, frames, 3) uint8 image
    for TensorBoard: min-max scaled through a viridis colour table, the
    lowest channel at the bottom. One pixel per value, with no axes or
    colour bar (the JAX package draws a matplotlib figure)."""
    x = np.asarray(spectrogram, np.float64)
    lo, hi = np.nanmin(x), np.nanmax(x)
    scaled = np.nan_to_num((x - lo) / (hi - lo) if hi > lo else np.zeros_like(x))
    return _COLOUR_TABLE[np.round(scaled * 255).astype(np.int64)][::-1].copy()
