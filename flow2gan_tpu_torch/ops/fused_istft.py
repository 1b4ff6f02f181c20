"""Fused iSTFT: the hand-written CUDA kernel `csrc/fused_istft.cu` and its
wrapper, the port of the Pallas TPU kernel in
`flow2gan_tpu/ops/pallas_istft.py`.

`istft_kernel` launches the kernel and takes CUDA tensors only. `fused_istft`
is what the model calls: it launches the kernel for a CUDA tensor and runs
the plain version, `istft_plain` (`ops.stft.istft`), only for a CPU tensor.
`launches` counts the kernel's launches, so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from flow2gan_tpu_torch.ops import cuda_build
from flow2gan_tpu_torch.ops.stft import _irdft_matrices, const_tensor, envelope, hann_window_np
from flow2gan_tpu_torch.ops.stft import istft as istft_plain

launches = 0


def supported(n_fft: int, hop_length: int) -> bool:
    """The kernel takes any hop that divides n_fft (the TPU kernel also
    needed 128-aligned hops, a lane limit Hopper does not have)."""
    return n_fft % hop_length == 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_istft")
    lib.fused_istft_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p
    ]
    lib.fused_istft_launch.restype = ctypes.c_int
    return lib


def kernel_weights_np(n_fft: int, hop_length: int) -> np.ndarray:
    """(k, 2F, hop padded to a multiple of 4) float32: W[j, 2q + r, c] is
    row q of the window-folded iDFT matrix A (r = 0) or B (r = 1) at column
    j * hop + c, so that one frame of view_as_real(spec) times W[j] is that
    frame's j-th hop slice. The zero pad columns let the kernel copy W in
    16-byte pieces."""
    A, B = _irdft_matrices(n_fft)
    window = hann_window_np(n_fft)[None, :]
    k = n_fft // hop_length
    w = np.stack([A * window, B * window], axis=1).reshape(-1, n_fft)  # (2F, n_fft)
    w = w.reshape(-1, k, hop_length).transpose(1, 0, 2)
    pad = -hop_length % 4
    return np.ascontiguousarray(np.pad(w, ((0, 0), (0, 0), (0, pad))))


@functools.lru_cache(maxsize=32)
def _kernel_weights(n_fft: int, hop_length: int, device: torch.device) -> torch.Tensor:
    return const_tensor(kernel_weights_np(n_fft, hop_length), device)


def istft_kernel(
    spec: torch.Tensor, n_fft: int, hop_length: int, length: Optional[int] = None
) -> torch.Tensor:
    """Launch the fused iSTFT kernel: complex64 (B, T_f, n_fft//2+1) on the
    card -> float32 (B, length), the same function as `istft_plain`."""
    global launches
    if spec.device.type != "cuda":
        raise ValueError(f"istft_kernel needs a CUDA tensor, got one on {spec.device}")
    if spec.dtype != torch.complex64:
        raise TypeError(f"istft_kernel takes complex64, got {spec.dtype}")
    if spec.ndim != 3 or spec.shape[-1] != n_fft // 2 + 1:
        raise ValueError(f"expected (B, T_f, {n_fft // 2 + 1}), got {tuple(spec.shape)}")
    if not spec.is_contiguous():
        raise ValueError("istft_kernel needs a contiguous spectrogram")
    if not supported(n_fft, hop_length):
        raise NotImplementedError(f"fused iSTFT needs n_fft % hop == 0 ({n_fft}, {hop_length})")
    if spec.device.index != torch.cuda.current_device():
        raise ValueError(f"spectrogram is on {spec.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    batch, t_f, n_freq = spec.shape
    if length is None:
        length = (t_f - 1) * hop_length
    if batch < 1 or t_f < 1 or length < 1:
        raise ValueError(f"empty iSTFT: batch {batch}, frames {t_f}, length {length}")
    w = _kernel_weights(n_fft, hop_length, spec.device)
    env = envelope(t_f, n_fft, hop_length, spec.device)
    out = torch.empty(batch, length, dtype=torch.float32, device=spec.device)
    err = _library().fused_istft_launch(
        torch.view_as_real(spec).data_ptr(), w.data_ptr(), env.data_ptr(),
        out.data_ptr(), batch, t_f, n_freq, n_fft, hop_length, length,
        torch.cuda.current_stream(spec.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_istft launch failed: cudaError {err}")
    launches += 1
    return out


def fused_istft(
    spec: torch.Tensor, n_fft: int, hop_length: int, length: Optional[int] = None
) -> torch.Tensor:
    """The kernel for a CUDA tensor; the plain version for a CPU tensor."""
    if spec.device.type == "cpu":
        return istft_plain(spec, n_fft, hop_length, length=length)
    return istft_kernel(spec, n_fft, hop_length, length=length)
