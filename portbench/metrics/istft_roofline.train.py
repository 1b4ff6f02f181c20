"""The fused iSTFT kernel's share of its roofline over the traced training
steps' launches, weighted by time, averaged over the ranks."""

from portbench.metrics._common import mean, on_device, ranks, roofline


def read(obs):
    return mean(roofline(o["istft_s"], o["istft_bound_s"]) for o in ranks(obs) if on_device(o))
