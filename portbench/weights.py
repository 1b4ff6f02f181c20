"""Random weights for a configuration, made on the device from the run's
seed in one draw, in float32 (the type the configurations serve and train
in), and handed alike to the program and to the reference.

The scheme follows the model's own initialisation, kept a little away from
its constants so that no term is trivially zero or one: matrices and convs
N(0, 0.015^2) clipped at two deviations, biases N(0, 0.01^2), BiasNorm's
log-scale 1 + N(0, 0.05^2), the residual scales 1 + N(0, 0.02^2) (some
above their limit of 1, so that the limiters' sign flip is exercised in
training) and PReLU slopes 0.25 + N(0, 0.02^2)."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch

# the last part of a parameter's name -> (mean, deviation, clip in deviations)
_SCHEME = {
    "log_scale": (1.0, 0.05, None),
    "scale": (1.0, 0.02, None),
    "alpha": (0.25, 0.02, None),
    "bias": (0.0, 0.01, None),
    "weight": (0.0, 0.015, 2.0),
}


def make_weights(specs: Sequence[Tuple[str, tuple]], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for the (name, shape) list `specs`, from one normal
    draw of a generator on `device` seeded with `seed`."""
    sizes = [math.prod(shape) for _, shape in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(specs, z.split(sizes)):
        mean, dev, clip = _SCHEME[name.rsplit(".", 1)[-1]]
        if clip is not None:
            part = part.clamp(-clip, clip)
        out[name] = (part * dev + mean).reshape(shape)
    return out
