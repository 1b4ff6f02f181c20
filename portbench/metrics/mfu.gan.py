"""The GAN steps' share of the card's float32 peak: the operations of the
traced window's D and G steps (counted from shapes, `yardstick_gan.py`,
each step counted by the program's `gan.d_steps` and `gan.g_steps`, the
driver's `flop`) over the window's wall time times 67 TFLOP/s, in %."""

from portbench import yardstick
from portbench.metrics._common import on_device


def read(obs):
    if not on_device(obs) or "flop" not in obs:
        return None
    return 100.0 * obs["flop"] / (obs["window_s"] * yardstick.FP32_FLOP_PER_S)
