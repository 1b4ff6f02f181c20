"""The whole call's share of the card's float32 peak: the model operations
of the traced window's calls (counted from their shapes) over its wall time
times 67 TFLOP/s, in %."""

from portbench import yardstick
from portbench.metrics._common import on_device


def read(obs):
    if not on_device(obs):
        return None
    return 100.0 * obs["flop"] / (obs["window_s"] * yardstick.FP32_FLOP_PER_S)
