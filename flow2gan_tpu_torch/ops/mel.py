"""Mel frontends and the FM loss's linear filterbank in PyTorch, counterpart
of `flow2gan_tpu/ops/mel.py`: HTK mel scale, norm=None (torchaudio's
`MelSpectrogram` defaults). `LogMelSpectrogram` conditions the generator;
`MelSpectrogram` (no log) is a scale of the GAN stage's mel loss;
`LinearFilterSpectrogram` is the spectral-energy-scaled FM loss's filterbank
power spectrogram as a module."""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from flow2gan_tpu_torch.ops.stft import stft
from flow2gan_tpu_torch.utils import safe_log


def _hz_to_mel(freq) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def _mel_to_hz(mel) -> np.ndarray:
    return 700.0 * (10.0 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


def _triangular_filterbank(all_freqs: np.ndarray, f_pts: np.ndarray) -> np.ndarray:
    """Triangular filters (n_freqs, len(f_pts) - 2) with corners f_pts, in
    float64, cast to float32 (torchaudio's formulation)."""
    f_diff = f_pts[1:] - f_pts[:-1]
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = (-1.0 * slopes[:, :-2]) / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def melscale_fbanks(
    n_freqs: int, f_min: float, f_max: float, n_mels: int, sample_rate: int
) -> np.ndarray:
    """HTK triangular mel filterbank (n_freqs, n_mels)."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    m_pts = np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2)
    return _triangular_filterbank(all_freqs, _mel_to_hz(m_pts))


@functools.lru_cache(maxsize=32)
def linear_fbanks(
    n_freqs: int, f_min: float, f_max: float, n_filter: int, sample_rate: int
) -> np.ndarray:
    """Linear-frequency triangular filterbank (n_freqs, n_filter), as
    torchaudio's `linear_fbanks`: the filters of the spectral-scaled FM loss."""
    all_freqs = np.linspace(0.0, sample_rate // 2, n_freqs)
    return _triangular_filterbank(all_freqs, np.linspace(f_min, f_max, n_filter + 2))


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


class MelSpectrogram(nn.Module):
    """(B, L) waveform -> (B, n_mels, frames) mel-weighted |STFT|^power, with
    no log: the frontend of one scale of the GAN stage's multi-scale mel
    reconstruction loss (`models/gan.py`)."""

    def __init__(self, sampling_rate: int, n_fft: int, hop_length: int, n_mels: int,
                 power: float = 1.0):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.power = power
        fb = melscale_fbanks(
            n_fft // 2 + 1, 0.0, float(sampling_rate // 2), n_mels, sampling_rate
        )
        self.register_buffer("fb", torch.from_numpy(fb), persistent=False)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        mag = spectrogram(audio, self.n_fft, self.hop_length, power=self.power)
        return (mag @ self.fb).transpose(-1, -2)


def linear_filter_spectrogram(audio: torch.Tensor, fb: torch.Tensor, n_fft: int,
                              hop_length: int, power: float = 2.0) -> torch.Tensor:
    """(B, L) waveform -> (B, frames, n_filter) |STFT|^power through the
    linear filterbank `fb` (`linear_fbanks`), time-major: the spectrogram
    that the spectral-energy-scaled FM loss weighs by (`models/generator.py
    _loss_spec`), and `LinearFilterSpectrogram`'s transposed."""
    return spectrogram(audio, n_fft, hop_length, power=power) @ fb


class LinearFilterSpectrogram(nn.Module):
    """(B, L) waveform -> (B, n_filter, frames) `linear_filter_spectrogram`
    through a linear triangular filterbank over [f_min, f_max] (f_max
    defaults to Nyquist, the hop to n_fft // 2)."""

    def __init__(self, sample_rate: int, n_filter: int, n_fft: int,
                 hop_length: Optional[int] = None, f_min: float = 0.0,
                 f_max: Optional[float] = None, power: float = 2.0):
        super().__init__()
        self.n_fft = n_fft
        self.hop_length = hop_length if hop_length is not None else n_fft // 2
        self.power = power
        f_max = f_max if f_max is not None else float(sample_rate // 2)
        fb = linear_fbanks(n_fft // 2 + 1, f_min, f_max, n_filter, sample_rate)
        self.register_buffer("fb", torch.from_numpy(fb), persistent=False)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return linear_filter_spectrogram(audio, self.fb, self.n_fft, self.hop_length,
                                         self.power).transpose(-1, -2)
