"""The eval-form elementwise chain of a ConvNeXt block: the hand-written CUDA
kernels `csrc/convnext_chain.cu`, their wrappers and their plain versions.

`models/convnext.py ConvNeXtBlock` runs its eval form (no limiter gates, no
gradient, float32) as

    y = norm_film(x, mask, dwconv, BiasNorm, c, te, f)   # one kernel
    h = prelu_(pwconv1(y), alpha)                         # one kernel, in place
    out = linear_residual(h, pwconv2, x, scale)           # GEMM, then one kernel

with the GEMMs (pwconv1, pwconv2, the cond and time projections) in cuBLAS.
On the card pwconv2's bias is added in `scaled_residual`, not in the GEMM:
cuBLAS's bias epilogue ran pwconv2 at the stream's batch-1 shapes up to
1.9x slower than the plain product (PERF.md §6).
For a CUDA tensor each wrapper launches its kernel, or raises on what the
kernel does not take; for a CPU tensor it runs its plain version, which is
the block's eager arithmetic op for op, so that the CPU's eval form gives
what it gave before, bit for bit. Each launch adds 1 to the tracing counter
`convnext.norm_film_launches`, `convnext.prelu_launches` or
`convnext.residual_launches` (while its switch is on).

How the first kernel cuts its work comes from here (`norm_film_plan`), and
how many float4 a thread of the other two takes (`stream_unroll`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.ops import cuda_build

KERNEL_SIZES = (7,)  # the depthwise taps the kernel is built for
MAX_CHANNELS = 1024  # 8 float4 a lane
# rows a tile of `convnext_norm_film`, most first: the first that gives every
# SM a block; a warp takes two rows from ROWS_PER_WARP_FROM rows a tile up
TILE_ROWS = (16, 8, 4, 2, 1)
ROWS_PER_WARP_FROM = 8
STREAM_THREADS = 256  # a block of `prelu_inplace` and `scaled_residual`
STREAM_UNROLL = 4  # float4 a thread, where the grid keeps two waves of blocks


def norm_film_plain(x: torch.Tensor, mask: Optional[torch.Tensor], dw_weight: torch.Tensor,
                    dw_bias: torch.Tensor, norm_bias: torch.Tensor, log_scale: torch.Tensor,
                    c: Optional[torch.Tensor] = None, te: Optional[torch.Tensor] = None,
                    f: int = 1) -> torch.Tensor:
    """The function of `convnext_norm_film`: the masked x (B, T, C) through
    the SAME depthwise conv (weight (C, 1, k)) and BiasNorm, then, where c
    (B, >= ceil(T / f), C) is given, plus c's row t // f and times (1 + te)
    (te (B, C)). As the eager block computes it."""
    if mask is not None:
        x = x * mask.to(x.dtype)
    y = F.conv1d(x.transpose(1, 2), dw_weight, dw_bias, padding="same",
                 groups=dw_weight.shape[0]).transpose(1, 2)
    d = y - norm_bias
    y = y * (torch.rsqrt((d * d).mean(dim=-1, keepdim=True)) * torch.exp(log_scale))
    if c is not None:
        if f != 1:
            c = c.repeat_interleave(f, dim=1)
        y = y + c[:, : y.shape[1]]
        y = y * (1.0 + te)[:, None, :]
    return y


def prelu_plain(h: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The function of `prelu_inplace`: per-channel PReLU on the last axis."""
    return torch.where(h >= 0, h, alpha * h)


def scaled_residual_plain(h: torch.Tensor, residual: torch.Tensor, scale: Optional[torch.Tensor],
                          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The function of `scaled_residual`: (h + bias) + scale * residual, per
    channel, without the bias or the scale where they are None."""
    if bias is not None:
        h = h + bias
    return h + (residual if scale is None else residual * scale)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("convnext_chain")
    lib.convnext_norm_film_launch.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                                              + [ctypes.c_void_p])
    lib.prelu_inplace_launch.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.scaled_residual_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    for fn in (lib.convnext_norm_film_launch, lib.prelu_inplace_launch,
               lib.scaled_residual_launch):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=256)
def norm_film_plan(batch: int, frames: int, sm_count: int) -> Tuple[int, int]:
    """(rows_per_tile, rows_per_warp) of `convnext_norm_film`: the most rows
    a tile in TILE_ROWS, no more than the frames, that still gives each of
    the card's `sm_count` SMs a block (one row where none does), and two
    rows a warp from ROWS_PER_WARP_FROM rows a tile up (the warp then reads
    each staged row and its weights once for two outputs)."""
    rows = next((r for r in TILE_ROWS if r <= frames and batch * -(-frames // r) >= sm_count), 1)
    return rows, 2 if rows >= ROWS_PER_WARP_FROM else 1


def stream_unroll(n4: int, sm_count: int) -> int:
    """float4 a thread of `prelu_inplace` / `scaled_residual` over n4 float4:
    STREAM_UNROLL where that still leaves two blocks for each SM, else 1."""
    blocks = -(-n4 // (STREAM_THREADS * STREAM_UNROLL))
    return STREAM_UNROLL if blocks >= 2 * sm_count else 1


def _check_cuda(name: str, x: torch.Tensor, *tensors: Optional[torch.Tensor]) -> None:
    """x and every given tensor: contiguous float32 on x's device, which is
    the current device; 16-byte aligned, as the kernels read float4."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got one on {x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}'s input is on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for t in (x, *tensors):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name}: a tensor on {t.device}, the input on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} takes float32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} needs contiguous, 16-byte aligned tensors")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _launch_norm_film(x, mask, dw_weight, dw_bias, norm_bias, log_scale, c, te, f):
    if x.ndim != 3 or x.numel() == 0:
        raise ValueError(f"expected a non-empty (B, T, C), got {tuple(x.shape)}")
    batch, frames, channels = x.shape
    k = dw_weight.shape[-1]
    if k not in KERNEL_SIZES or channels % 4 or not 4 <= channels <= MAX_CHANNELS:
        raise NotImplementedError(f"convnext_norm_film takes k in {KERNEL_SIZES} and channels a "
                                  f"multiple of 4 up to {MAX_CHANNELS}, got k {k}, C {channels}")
    if (dw_weight.shape != (channels, 1, k) or dw_bias.shape != (channels,)
            or norm_bias.shape != (channels,) or log_scale.numel() != 1):
        raise ValueError("convnext_norm_film: parameters do not match the input's channels")
    if mask is not None and mask.shape not in ((batch, frames), (batch, frames, 1)):
        raise ValueError(f"mask {tuple(mask.shape)} does not match the input {tuple(x.shape)}")
    if (c is None) != (te is None):
        raise ValueError("convnext_norm_film takes the cond and the time projection together")
    t_c = 0
    if c is not None:
        if c.ndim != 3 or c.shape[0] != batch or c.shape[2] != channels:
            raise ValueError(f"cond {tuple(c.shape)} does not match the input {tuple(x.shape)}")
        t_c = c.shape[1]
        if t_c * f < frames:
            raise ValueError(f"cond of {t_c} rows does not cover {frames} frames at factor {f}")
        if te.shape != (batch, channels):
            raise ValueError(f"time projection {tuple(te.shape)}, expected {(batch, channels)}")
    _check_cuda("convnext_norm_film", x, mask, dw_weight, dw_bias, norm_bias, log_scale, c, te)
    rows, per_warp = norm_film_plan(batch, frames, _sm_count(x.device.index))
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    err = _library().convnext_norm_film_launch(
        x.data_ptr(), _ptr(mask), dw_weight.data_ptr(), dw_bias.data_ptr(), norm_bias.data_ptr(),
        log_scale.data_ptr(), _ptr(c), _ptr(te), out.data_ptr(), batch, frames, channels, k, f,
        t_c, rows, per_warp, _stream(x))
    if err != 0:
        raise RuntimeError(f"convnext_norm_film launch failed: cudaError {err}")
    tracing.count("convnext.norm_film_launches")
    return out


def _check_rows(name: str, h: torch.Tensor, width: int) -> None:
    """h: rows of `width` channels, a multiple of 4, indexable in 32 bits."""
    if h.numel() == 0 or h.shape[-1] != width or width % 4:
        raise ValueError(f"{name}: (..., {width}) with {width} a multiple of 4, "
                         f"got {tuple(h.shape)}")
    if h.numel() >= 2**31:
        raise ValueError(f"{name} indexes in 32 bits, got {h.numel()} elements")


def norm_film(x: torch.Tensor, mask: Optional[torch.Tensor], dw_weight: torch.Tensor,
              dw_bias: torch.Tensor, norm_bias: torch.Tensor, log_scale: torch.Tensor,
              c: Optional[torch.Tensor] = None, te: Optional[torch.Tensor] = None,
              f: int = 1) -> torch.Tensor:
    """`norm_film_plain`'s function: the kernel for a CUDA tensor, a new
    contiguous (B, T, C); the plain version for a CPU one."""
    if x.device.type == "cpu":
        return norm_film_plain(x, mask, dw_weight, dw_bias, norm_bias, log_scale, c, te, f)
    return _launch_norm_film(x, mask, dw_weight, dw_bias, norm_bias, log_scale, c, te, f)


def _launch_prelu(h, alpha):
    _check_cuda("prelu_inplace", h, alpha)
    _check_rows("prelu_inplace", h, alpha.numel())
    unroll = stream_unroll(h.numel() // 4, _sm_count(h.device.index))
    err = _library().prelu_inplace_launch(h.data_ptr(), alpha.data_ptr(), h.numel(),
                                          alpha.numel(), unroll, _stream(h))
    if err != 0:
        raise RuntimeError(f"prelu_inplace launch failed: cudaError {err}")
    tracing.count("convnext.prelu_launches")
    return h


def _launch_residual(h, residual, scale, bias):
    width = h.shape[-1]
    if residual.shape != h.shape or any(t is not None and t.shape != (width,)
                                        for t in (scale, bias)):
        raise ValueError(f"scaled_residual: h {tuple(h.shape)}, residual {tuple(residual.shape)}, "
                         f"scale and bias of {width} channels or None")
    _check_cuda("scaled_residual", h, residual, scale, bias)
    _check_rows("scaled_residual", h, width)
    unroll = stream_unroll(h.numel() // 4, _sm_count(h.device.index))
    err = _library().scaled_residual_launch(h.data_ptr(), residual.data_ptr(), _ptr(scale),
                                            _ptr(bias), h.numel(), width, unroll, _stream(h))
    if err != 0:
        raise RuntimeError(f"scaled_residual launch failed: cudaError {err}")
    tracing.count("convnext.residual_launches")
    return h


def prelu_(h: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """`prelu_plain`'s function: for a CUDA tensor the kernel, in place in h,
    which it returns; for a CPU one the plain version, a new tensor."""
    if h.device.type == "cpu":
        return prelu_plain(h, alpha)
    return _launch_prelu(h, alpha)


def scaled_residual_(h: torch.Tensor, residual: torch.Tensor, scale: Optional[torch.Tensor],
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`scaled_residual_plain`'s function: for a CUDA tensor the kernel, in
    place in h, which it returns; for a CPU one the plain version."""
    if h.device.type == "cpu":
        return scaled_residual_plain(h, residual, scale, bias)
    return _launch_residual(h, residual, scale, bias)


def linear_residual(h: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    residual: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    """`F.linear(h, weight, bias) + scale * residual`: on the card the
    product without its bias, which `scaled_residual` adds with the
    residual; on the CPU the linear with its bias and the plain version, as
    the eager block computes it."""
    if h.device.type == "cpu":
        return scaled_residual_plain(F.linear(h, weight, bias), residual, scale)
    return scaled_residual_(F.linear(h, weight), residual, scale, bias)
