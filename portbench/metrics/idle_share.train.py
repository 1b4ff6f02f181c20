"""Share of the traced window in which no device operation ran, a
collective's spin counted as idle, averaged over the ranks, in %."""

from portbench.metrics._common import mean, on_device, ranks


def read(obs):
    return mean(100.0 * (1.0 - o["busy_s"] / o["window_s"]) for o in ranks(obs) if on_device(o))
