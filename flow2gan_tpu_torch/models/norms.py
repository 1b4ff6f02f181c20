"""Normalisation primitives, counterpart of `flow2gan_tpu/models/norms.py`.
Channels-last: the channel dim is the last axis.

Training form: `BiasNorm` and `ChannelScale` pass their learned scale through
`limit_param_value`, which is the identity forward and in backward flips the
gradient's sign to push the parameter back into its range, while a per-call
Bernoulli(0.6) gate is on. The gates of one forward are a tensor `gates` of
0/1 floats, one per limiter of the model, indexed by each module's
`gate_index` (the generator numbers them); a test passes its own, training
draws them on the device (`MelAudioGenerator.draw`), so no gate is read on
the host. `gates=None` is the eval form.

The flip depends on the sign of the gradient, so it is not linear in it: in a
multi-process run each call's flip is decided on the gradient summed over
the ranks (one small all-reduce per call in backward), as one process on the
global batch decides it, and applied to each rank's part.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from flow2gan_tpu_torch.parallel import dist


class LimitParamValue(torch.autograd.Function):
    """Identity forward; backward as the JAX package's `_limit_value_bwd`:
    where the gate is on, a positive gradient of an x below `lo` and a
    negative one of an x above `hi` change sign, so that descent moves x
    back into [lo, hi]. The sign is the global batch's gradient's."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, gate: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
        ctx.save_for_backward(x, gate)
        ctx.bounds = (lo, hi)
        return x.clone()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, gate = ctx.saved_tensors
        lo, hi = ctx.bounds
        active = gate > 0.5
        total = g
        if dist.world_size() > 1:
            total = g.clone()
            dist.all_reduce_sum_([total])
        flip = ((active & (total > 0) & (x < lo)) | (active & (total < 0) & (x > hi)))
        return torch.where(flip, -g, g), None, None, None


def limit_param_value(x: torch.Tensor, lo: float, hi: float,
                      gate: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`x` itself when `gate` is None (eval), else `LimitParamValue`; `gate`
    is a 0-dim float tensor, 1 for on."""
    if gate is None:
        return x
    return LimitParamValue.apply(x, gate, float(lo), float(hi))


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, or as it is in float64 (a float64 reference run)."""
    return x if x.dtype == torch.float64 else x.float()


class BiasNorm(nn.Module):
    """x * rsqrt(mean((x - bias)^2, channel)) * exp(log_scale), with the
    statistics in float32; log_scale is limited to [-1.5, 1.5] in training."""

    log_scale_min = -1.5
    log_scale_max = 1.5

    def __init__(self, num_channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.log_scale = nn.Parameter(torch.tensor(1.0))
        self.gate_index = 0

    def limited_log_scale(self, gates: Optional[torch.Tensor] = None) -> torch.Tensor:
        """log_scale, through its limiter where `gates` are given."""
        if gates is None:
            return self.log_scale
        return limit_param_value(self.log_scale, self.log_scale_min, self.log_scale_max,
                                 gates[self.gate_index])

    def forward(self, x: torch.Tensor, gates: Optional[torch.Tensor] = None) -> torch.Tensor:
        log_scale = self.limited_log_scale(gates)
        d = at_least_float32(x - self.bias)
        scales = torch.rsqrt((d * d).mean(dim=-1, keepdim=True)) * torch.exp(log_scale)
        return x * scales.to(x.dtype)


class ChannelScale(nn.Module):
    """Learned per-channel residual scale, limited to [0.5, 1.0] in training."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.gate_index = 0

    def limited_scale(self, gates: Optional[torch.Tensor] = None) -> torch.Tensor:
        """scale, through its limiter where `gates` are given."""
        if gates is None:
            return self.scale
        return limit_param_value(self.scale, 0.5, 1.0, gates[self.gate_index])

    def forward(self, x: torch.Tensor, gates: Optional[torch.Tensor] = None) -> torch.Tensor:
        return x * self.limited_scale(gates).to(x.dtype)


LIMITERS = (BiasNorm, ChannelScale)


def number_limiters(model: nn.Module) -> int:
    """Give each limiter of `model` its `gate_index`, in module order; return
    how many there are (the length of the model's `gates`)."""
    limiters = [m for m in model.modules() if isinstance(m, LIMITERS)]
    for i, m in enumerate(limiters):
        m.gate_index = i
    return len(limiters)


class PReLU(nn.Module):
    """Per-channel parametric ReLU on the last axis (torch semantics)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)
