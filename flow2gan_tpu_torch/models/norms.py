"""Normalisation primitives in eval form, counterpart of
`flow2gan_tpu/models/norms.py`. Channels-last: the channel dim is the last
axis. The training-time parameter limiter (`limit_param_value`) and its
gates belong to the training path and are not here yet."""

from __future__ import annotations

import torch
from torch import nn


class BiasNorm(nn.Module):
    """x * rsqrt(mean((x - bias)^2, channel)) * exp(log_scale), with the
    statistics in float32."""

    def __init__(self, num_channels: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(num_channels))
        self.log_scale = nn.Parameter(torch.tensor(1.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = (x - self.bias).float()
        scales = torch.rsqrt((d * d).mean(dim=-1, keepdim=True)) * torch.exp(
            self.log_scale
        )
        return x * scales.to(x.dtype)


class ChannelScale(nn.Module):
    """Learned per-channel residual scale."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.scale.to(x.dtype)


class PReLU(nn.Module):
    """Per-channel parametric ReLU on the last axis (torch semantics)."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)
