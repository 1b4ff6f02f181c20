"""The GAN cells' arithmetic: the operations of a discriminator step and of
a generator step counted from shapes. Nothing here reads the program.

Operations are counted as `yardstick.py` counts them: matmuls and convs
at 2 a multiply-add, FFTs as 2.5 N log2 N, elementwise work not at all. A
backward pass that gives the gradients of the weights and of the inputs is
twice its forward, one that gives only the input's gradient once. The
recompute of a rematerialised rollout is not counted: it is not work the
step needs.
"""

from __future__ import annotations

import math
from typing import Sequence

from portbench import yardstick


def _conv(batch: int, h: int, w: int, c_in: int, c_out: int, kh: int, kw: int) -> float:
    """A conv's operations at its output's (h, w)."""
    return 2.0 * batch * h * w * c_out * c_in * kh * kw


def _out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


def mpd_flop(periods: Sequence[int], batch: int, length: int,
             channels: Sequence[int] = (32, 128, 512, 1024, 1024)) -> float:
    """One forward of the multi-period discriminator on (batch, length)."""
    total = 0.0
    widths = (1, *channels)
    for p in periods:
        h = math.ceil(length / p)
        for i in range(5):
            h = _out(h, 5, 3 if i < 4 else 1, 2)
            total += _conv(batch, h, p, widths[i], widths[i + 1], 5, 1)
        total += _conv(batch, h, p, widths[-1], 1, 3, 1)
    return total


def mrd_flop(fft_sizes: Sequence[int], channels: int, hop_factor: float,
             bands: Sequence[Sequence[float]], batch: int, length: int) -> float:
    """One forward of the multi-resolution discriminator on (batch,
    length): the STFTs (as FFTs, and the window) and every band's convs."""
    total = 0.0
    for n in fft_sizes:
        frames = 1 + length // int(n * hop_factor)
        bins = n // 2 + 1
        total += batch * frames * (yardstick.fft_flop(n) + n)
        width_sum = 0
        for lo, hi in bands:
            w = int(hi * bins) - int(lo * bins)
            total += _conv(batch, frames, w, 2, channels, 3, 9)
            for _ in range(3):
                w = _out(w, 9, 2, 4)
                total += _conv(batch, frames, w, channels, channels, 3, 9)
            total += _conv(batch, frames, w, channels, channels, 3, 3)
            width_sum += w
        total += _conv(batch, frames, width_sum, channels, 1, 3, 3)
    return total


def judge_flop(gan: dict, batch: int, length: int) -> float:
    """One forward of both discriminators on one signal."""
    return (mpd_flop(gan["mpd_periods"], batch, length)
            + mrd_flop(gan["mrd_fft_sizes"], gan["mrd_channels"], gan["mrd_hop_factor"],
                       gan["mrd_bands"], batch, length))


def mel_flop(n_fft: int, hop: int, n_mels: int, batch: int, length: int) -> float:
    """A magnitude mel spectrogram: an FFT a frame, the window, the filters."""
    frames = 1 + length // hop
    return batch * frames * (yardstick.fft_flop(n_fft) + n_fft + 2 * (n_fft // 2 + 1) * n_mels)


def mel_recon_flop(gan: dict, batch: int, length: int) -> float:
    """The multi-scale mels of one signal."""
    return sum(mel_flop(n, n // 4, m, batch, length)
               for n, m in zip(gan["mel_recon_n_ffts"], gan["mel_recon_n_mels"]))


def rollout_flop(cfg: dict, batch: int, length: int, n_steps: int) -> float:
    """One forward of the n-step rollout on (batch, length) crops: the cond
    encoder once, every branch at each Euler step over the x0's length."""
    frames = 1 + length // cfg["mel_hop_length"]
    return (yardstick.cond_encoder_flop(cfg, batch, frames)
            + n_steps * yardstick.estimate_flop(cfg, batch, frames * cfg["mel_hop_length"]))


def frontend_flop(cfg: dict, batch: int, length: int) -> float:
    return mel_flop(cfg["mel_n_fft"], cfg["mel_hop_length"], cfg["n_mels"], batch, length)


def d_step_flop(cfg: dict, batch: int, length: int, n_steps: int) -> float:
    """A discriminator step: the frontend, the eval-form rollout, both
    discriminators forward on the real and the generated signal, and their
    backward (weights and inputs)."""
    judge = judge_flop(cfg["gan"], batch, length)
    return frontend_flop(cfg, batch, length) + rollout_flop(cfg, batch, length, n_steps) + 6 * judge


def g_step_flop(cfg: dict, batch: int, length: int, n_steps: int) -> float:
    """A generator step: the frontend, the train-form rollout forward and
    backward, both discriminators forward on the real and the generated
    signal and backward to the generated signal, the mels of both signals
    and their backward to the generated one."""
    gan = cfg["gan"]
    return (frontend_flop(cfg, batch, length) + 3 * rollout_flop(cfg, batch, length, n_steps)
            + 3 * judge_flop(gan, batch, length) + 3 * mel_recon_flop(gan, batch, length))
