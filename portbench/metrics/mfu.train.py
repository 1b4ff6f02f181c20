"""The whole step's share of the card's float32 peak: three times the FM
loss's forward operations per step (counted from shapes, each rank's rows)
over the traced window's wall time times 67 TFLOP/s, averaged over the
ranks, in %."""

from portbench import yardstick
from portbench.metrics._common import mean, on_device, ranks


def read(obs):
    return mean(100.0 * o["flop"] / (o["window_s"] * yardstick.FP32_FLOP_PER_S)
                for o in ranks(obs) if on_device(o))
