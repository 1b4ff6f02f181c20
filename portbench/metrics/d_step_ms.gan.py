"""Device ms of a discriminator step: the mean of the program's
`gan.d_step` spans over the traced window's D steps (each span's CUDA
events, the step's device work and its waits)."""

import statistics

from portbench.metrics._gan import span_ms


def read(obs):
    ms = span_ms(obs, "gan.d_step")
    return statistics.fmean(ms) if ms else None
