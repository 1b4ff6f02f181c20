"""Device ms of a generator step: the mean of the program's `gan.g_step`
spans over the traced window's G steps (each span's CUDA events, the
step's device work and its waits)."""

import statistics

from portbench.metrics._gan import span_ms


def read(obs):
    ms = span_ms(obs, "gan.g_step")
    return statistics.fmean(ms) if ms else None
