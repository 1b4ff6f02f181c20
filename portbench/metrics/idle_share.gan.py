"""Share of the traced window of GAN steps in which no device operation
ran (the union of the device's operations' intervals, as `idle_share.train`
reads it), in %."""

from portbench.metrics._common import on_device


def read(obs):
    return 100.0 * (1.0 - obs["busy_s"] / obs["window_s"]) if on_device(obs) else None
