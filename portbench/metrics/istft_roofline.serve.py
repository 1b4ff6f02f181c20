"""The fused iSTFT kernel's share of its roofline over the traced window's
launches, each at its own shape, weighted by time."""

from portbench.metrics._common import on_device, roofline


def read(obs):
    return roofline(obs["istft_s"], obs["istft_bound_s"]) if on_device(obs) else None
