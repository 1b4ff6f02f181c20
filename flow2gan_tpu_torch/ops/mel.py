"""Mel frontend in PyTorch, counterpart of `flow2gan_tpu/ops/mel.py`: HTK mel
scale, norm=None (torchaudio's `MelSpectrogram` defaults)."""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from flow2gan_tpu_torch.ops.stft import stft
from flow2gan_tpu_torch.utils import safe_log


def _hz_to_mel(freq) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def _mel_to_hz(mel) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=32)
def melscale_fbanks(
    n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int
) -> np.ndarray:
    """HTK triangular mel filterbank (n_freqs, n_mels), computed in float64
    and cast to float32."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    f_pts = _mel_to_hz(m_pts)
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = (-1.0 * slopes[:, :-2]) / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def spectrogram(audio: torch.Tensor, n_fft: int, hop_length: int, power: float = 2.0):
    """|STFT|^power of (B, L) -> (B, frames, n_fft//2 + 1), time-major."""
    mag = torch.abs(stft(audio, n_fft, hop_length))
    return mag if power == 1.0 else mag**power


class LogMelSpectrogram(nn.Module):
    """(B, L) waveform -> (B, n_mels, frames) log of mel-weighted STFT
    magnitudes."""

    def __init__(
        self,
        sampling_rate: int = 24000,
        n_fft: int = 1024,
        hop_length: int = 256,
        n_mels: int = 100,
    ):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        fb = melscale_fbanks(
            n_fft // 2 + 1, 0.0, float(sampling_rate // 2), n_mels, sampling_rate
        )
        self.register_buffer("fb", torch.from_numpy(fb), persistent=False)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        mag = spectrogram(audio, self.n_fft, self.hop_length, power=1.0)
        return safe_log(mag @ self.fb).transpose(-1, -2)
