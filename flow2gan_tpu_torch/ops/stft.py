"""STFT / iSTFT in PyTorch, counterpart of `flow2gan_tpu/ops/stft.py`.

Both transforms are written as matmuls against precomputed DFT matrices, the
formulation the JAX package uses at `Precision.HIGHEST`, so the two agree to
float32 rounding. Layout is time-major: spectrograms are (batch, frames,
freq). Semantics match `torch.stft` / `torch.istft` with ``center=True``, a
periodic Hann window and onesided output.

`istft` here is the plain version of the fused iSTFT kernel
(`ops/fused_istft.py`): the CPU runs it, and on the card it is the oracle the
kernel is held against.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def hann_window_np(win_length: int) -> np.ndarray:
    """Periodic Hann window, identical to torch.hann_window(win_length)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def num_frames(length: int, hop_length: int) -> int:
    """Frame count of a center-padded STFT: 1 + length // hop."""
    return 1 + length // hop_length


def frame_signal(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Reflect-pad n_fft//2 on both sides and slice (B, L) into overlapping
    frames (B, 1 + L // hop, n_fft)."""
    if n_fft % hop_length != 0:
        raise NotImplementedError(
            "frame_signal requires n_fft % hop_length == 0 "
            f"(got n_fft={n_fft}, hop={hop_length})"
        )
    pad = n_fft // 2
    x = F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
    return x.unfold(-1, n_fft, hop_length)


@functools.lru_cache(maxsize=32)
def _rdft_matrices(n_fft: int):
    """Forward rDFT as two matrices (n_fft, F): X = x@C + i x@S."""
    F_ = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(F_)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _irdft_matrices(n_fft: int):
    """Inverse onesided rDFT as two matrices (F, n_fft):
    x = Re @ A + Im @ B, with the DC/Nyquist bins weighted once."""
    F_ = n_fft // 2 + 1
    k = np.arange(F_)[:, None].astype(np.float64)
    n = np.arange(n_fft)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * k * n / n_fft
    c = np.full((F_, 1), 2.0)
    c[0, 0] = 1.0
    if n_fft % 2 == 0:
        c[-1, 0] = 1.0
    A = (c * np.cos(ang) / n_fft).astype(np.float32)
    B = (-c * np.sin(ang) / n_fft).astype(np.float32)
    return A, B


@functools.lru_cache(maxsize=64)
def _istft_envelope(n_frames: int, n_fft: int, hop: int) -> np.ndarray:
    """Overlap-added squared-window envelope over the trimmed output range
    [n_fft//2, n_fft//2 + (n_frames-1)*hop), float32.

    torch.istft asserts a nonzero envelope; the 1e-11 floor only guards the
    very edges, every config here satisfies NOLA.
    """
    w = hann_window_np(n_fft).astype(np.float64) ** 2
    out_len = (n_frames - 1) * hop + n_fft
    env = np.zeros(out_len, dtype=np.float64)
    for i in range(n_frames):
        env[i * hop : i * hop + n_fft] += w
    start = n_fft // 2
    env = env[start : start + (n_frames - 1) * hop]
    env = np.maximum(env, 1e-11)
    return env.astype(np.float32)


def const_tensor(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A cached constant on `device`. It is made outside inference mode even
    when the first call comes from inside it, so that later calls with
    autograd on can still use it."""
    with torch.inference_mode(False):
        return torch.from_numpy(array).to(device)


@functools.lru_cache(maxsize=32)
def _stft_consts(n_fft: int, device: torch.device):
    C, S = _rdft_matrices(n_fft)
    return tuple(const_tensor(a, device) for a in (hann_window_np(n_fft), C, S))


@functools.lru_cache(maxsize=32)
def _istft_consts(n_fft: int, device: torch.device):
    A, B = _irdft_matrices(n_fft)
    return tuple(const_tensor(a, device) for a in (hann_window_np(n_fft), A, B))


@functools.lru_cache(maxsize=64)
def envelope(n_frames: int, n_fft: int, hop: int, device: torch.device) -> torch.Tensor:
    """`_istft_envelope` as a tensor on `device`."""
    return const_tensor(_istft_envelope(n_frames, n_fft, hop), device)


def stft(x: torch.Tensor, n_fft: int, hop_length: int) -> torch.Tensor:
    """Onesided STFT of (B, L) -> complex64 (B, 1 + L // hop, n_fft//2 + 1)."""
    window, C, S = _stft_consts(n_fft, x.device)
    frames = frame_signal(x, n_fft, hop_length) * window
    return torch.complex(frames @ C, frames @ S)


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add (B, n_frames, n_fft) -> (B, (n_frames-1)*hop + n_fft),
    as k = n_fft // hop shifted adds of hop-wide blocks."""
    b, n_frames, n_fft = frames.shape
    k = n_fft // hop
    if k * hop != n_fft:
        raise NotImplementedError("overlap-add requires n_fft % hop == 0")
    fr = frames.reshape(b, n_frames, k, hop)
    out = frames.new_zeros(b, n_frames + k - 1, hop)
    for j in range(k):
        out[:, j : j + n_frames] += fr[:, :, j]
    return out.reshape(b, (n_frames + k - 1) * hop)


def istft(
    spec: torch.Tensor, n_fft: int, hop_length: int, length: Optional[int] = None
) -> torch.Tensor:
    """Inverse of `stft`: complex (B, n_frames, n_fft//2 + 1) -> (B, length).

    `length` defaults to (n_frames - 1) * hop (the torch default); a longer
    one is zero-padded, a shorter one trimmed.
    """
    window, A, B = _istft_consts(n_fft, spec.device)
    n_frames = spec.shape[-2]
    frames = (spec.real @ A + spec.imag @ B) * window
    y = _overlap_add(frames, hop_length)
    default_len = (n_frames - 1) * hop_length
    start = n_fft // 2
    y = y[:, start : start + default_len] / envelope(
        n_frames, n_fft, hop_length, spec.device
    )
    if length is not None:
        if length <= default_len:
            y = y[:, :length]
        else:
            y = F.pad(y, (0, length - default_len))
    return y


def spec_to_real(spec: torch.Tensor) -> torch.Tensor:
    """Pack complex (..., T, F) as real (..., T, 2F): [Re | Im] on channels."""
    return torch.cat([spec.real, spec.imag], dim=-1)


def real_to_spec(x: torch.Tensor) -> torch.Tensor:
    """Inverse of `spec_to_real`: real (..., T, 2F) -> complex (..., T, F)."""
    f = x.shape[-1] // 2
    return torch.complex(x[..., :f], x[..., f:])


def stft_lens(audio_lens: torch.Tensor, hop_length: int) -> torch.Tensor:
    """Valid-frame counts: 1 + lens // hop."""
    return 1 + audio_lens // hop_length
