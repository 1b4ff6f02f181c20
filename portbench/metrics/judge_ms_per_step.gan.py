"""Device ms of the discriminators' forward per GAN step: the program's
`gan.judge` spans (the MPD and the MRD on each signal judged, on both
sides) summed over the traced window, over its D and G steps."""

from portbench.metrics._gan import span_ms


def read(obs):
    judge = span_ms(obs, "gan.judge")
    steps = [span_ms(obs, "gan.d_step"), span_ms(obs, "gan.g_step")]
    n = sum(len(s) for s in steps if s)
    return sum(judge) / n if judge and n else None
