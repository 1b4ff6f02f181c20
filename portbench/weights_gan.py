"""Random discriminator weights for the GAN cells, made on the device from
the run's seed in one draw, in float32, and handed alike to the program
and to the reference.

The scale is the discriminators' own initialisation, LeCun-normal
(`init_discriminators`): every conv kernel N(0, 1 / fan_in), fan_in = in
channels x kernel height x kernel width, clipped at two deviations; the
biases, which that initialisation zeroes, N(0, 0.01^2), so that no term
starts at its constant."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch


def make_disc_weights(specs: Sequence[Tuple[str, tuple]], seed: int,
                      device: torch.device) -> Dict[str, torch.Tensor]:
    """{name: tensor} for the (name, shape) list `specs` of conv kernels
    (out, in, kh, kw) and biases, from one normal draw of a generator on
    `device` seeded with `seed`."""
    sizes = [math.prod(shape) for _, shape in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    z = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape), part in zip(specs, z.split(sizes)):
        if name.endswith(".weight"):
            part = part.clamp(-2.0, 2.0) * math.prod(shape[1:]) ** -0.5
        else:
            part = part * 0.01
        out[name] = part.reshape(shape)
    return out
