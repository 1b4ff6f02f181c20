"""Kernel launches per request in the traced window (profiler), a count
that repeats exactly: the solver and API layer's launches."""

from portbench.metrics._common import on_device


def read(obs):
    return obs["kernels"] / obs["requests"] if on_device(obs) and obs.get("requests") else None
