"""Share of the traced window in which no device operation ran: one minus
the union of their intervals over the window, in %."""

from portbench.metrics._common import on_device


def read(obs):
    return 100.0 * (1.0 - obs["busy_s"] / obs["window_s"]) if on_device(obs) else None
