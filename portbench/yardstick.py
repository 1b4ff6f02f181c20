"""The benchmark's arithmetic: the card's peaks, the kernels' least bytes and
operations, the model's operations counted from shapes, the kernel families
by name, and the statistics of a run. Nothing here reads the program.

The peaks, the bound arithmetic and the families are copied from
`chip_smoke.py` (`HBM_BYTES_PER_S`, `FP32_FLOP_PER_S`, `istft_bound_ms`,
`adjoint_bound_ms`, `_GEMM_NAMES`, `_family`), so that a later change to that
script does not move the yardstick.
"""

from __future__ import annotations

import math
import re
import statistics
from typing import Dict, Iterable, List, Sequence

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and the float32 rate outside
# the tensor cores (the configurations run float32 with TF32 off)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# kernel names of GEMMs (cuBLAS, cuBLASLt and CUTLASS kernels, split-K reductions)
GEMM_NAMES = re.compile(r"gemm|nvjet|xmma|cutlass|splitkreduce", re.IGNORECASE)
NCCL = "nccl"
ADJOINT = "fused_istft_adjoint"
ISTFT = "fused_istft"


def family(name: str) -> str:
    """A device operation's family by its kernel name."""
    for key in (ADJOINT, ISTFT, "conv_depthwise"):
        if key in name:
            return key
    if name.startswith("nccl"):
        # a collective's kernel spins on the card until every rank arrives
        return NCCL
    if name.startswith(("Memcpy", "Memset")):
        return "copies (DMA)"
    return "gemm" if GEMM_NAMES.search(name) else "elementwise, reductions, copies"


def fft_flop(n: int) -> float:
    """A real FFT of n points: 2.5 n log2 n."""
    return 2.5 * n * math.log2(n)


def istft_bound_s(n_fft: int, batch: int, t_f: int, length: int) -> float:
    """The least time of an iSTFT on the card: the spectrogram read once and
    the waveform written once, against an inverse real FFT per frame, the
    window and overlap-add (2 N a frame) and the envelope divide (one a
    sample); the larger of the two."""
    frames = batch * t_f
    bytes_ = frames * (n_fft // 2 + 1) * 8 + batch * length * 4
    flop = frames * (fft_flop(n_fft) + 2 * n_fft) + batch * length
    return max(bytes_ / HBM_BYTES_PER_S, flop / FP32_FLOP_PER_S)


def adjoint_bound_s(n_fft: int, batch: int, t_f: int, length: int) -> float:
    """The iSTFT adjoint's: the waveform's gradient read once, the
    spectrogram's written once; a forward real FFT a frame, the window (N a
    frame) and the envelope divide (one a sample)."""
    bytes_ = batch * length * 4 + batch * t_f * (n_fft // 2 + 1) * 8
    flop = batch * t_f * (fft_flop(n_fft) + n_fft) + batch * length
    return max(bytes_ / HBM_BYTES_PER_S, flop / FP32_FLOP_PER_S)


def branch_shapes(cfg: dict, batch: int, length: int) -> List[tuple]:
    """(n_fft, batch, frames, length) of each branch's iSTFT for a (batch,
    length) waveform."""
    return [(n, batch, 1 + length // h, length) for n, h in zip(cfg["n_ffts"], cfg["hop_lengths"])]


def _stft_flop(n_fft: int, frames: int) -> float:
    return frames * (fft_flop(n_fft) + n_fft)


def cond_encoder_flop(cfg: dict, batch: int, frames: int) -> float:
    c, h, k = cfg["cond_enc_channels"], cfg["cond_enc_hidden_factor"], cfg["cond_enc_conv_kernel_size"]
    per_block = 2 * frames * (c * k + 2 * c * c * h)
    return batch * (2 * frames * cfg["n_mels"] * c * 3 + cfg["cond_enc_num_layers"] * per_block)


def estimate_flop(cfg: dict, batch: int, length: int) -> float:
    """Operations of one evaluation of every branch on a (batch, length)
    waveform: the STFT (as FFTs), the decoder's matmuls and convs, the
    iSTFT (as FFTs). Elementwise work is not counted."""
    total = 0.0
    cc, tc, h = cfg["cond_enc_channels"], cfg["time_embed_channels"], cfg["hidden_factor"]
    for i, (n_fft, hop) in enumerate(zip(cfg["n_ffts"], cfg["hop_lengths"])):
        c, k, layers = cfg["channels"][i], cfg["conv_kernel_sizes"][i], cfg["num_layers"][i]
        t = 1 + length // hop
        up = cfg["mel_hop_length"] // hop
        t_cond = t if up == 1 else -(-t // up)
        width = n_fft + 2
        per_row = (
            2 * _stft_flop(n_fft, t)  # forward STFT and the iSTFT
            + 2 * t * width * c * 2  # in and out projections
            + 2 * tc * tc * h * 2  # time MLP
            + 2 * t_cond * cc * cc * h * 2  # cond MLP
            + layers * (2 * t * c * k + 2 * t_cond * cc * c + 2 * tc * c + 2 * t * c * c * h * 2)
        )
        total += batch * per_row
    return total


def serve_flop(cfg: dict, batch: int, frames: int, n_steps: int) -> float:
    """Operations of one serving call: the cond encoder once, the branches
    at each Euler step."""
    length = frames * cfg["mel_hop_length"]
    return cond_encoder_flop(cfg, batch, frames) + n_steps * estimate_flop(cfg, batch, length)


def fm_forward_flop(cfg: dict, batch: int, length: int) -> float:
    """Operations of the FM loss's forward pass on a (batch, length) crop:
    the log-mel (an FFT a frame and the filters), the cond encoder, the
    branches once, the loss's two filtered power spectra."""
    mel_frames = 1 + length // cfg["mel_hop_length"]
    mel = batch * (_stft_flop(cfg["mel_n_fft"], mel_frames)
                   + 2 * mel_frames * (cfg["mel_n_fft"] // 2 + 1) * cfg["n_mels"])
    loss_frames = 1 + length // cfg["loss_hop_length"]
    loss = 2 * batch * (_stft_flop(cfg["loss_n_fft"], loss_frames)
                        + 2 * loss_frames * (cfg["loss_n_fft"] // 2 + 1) * cfg["loss_n_filters"])
    return mel + cond_encoder_flop(cfg, batch, mel_frames) + estimate_flop(cfg, batch, length) + loss


# ------------------------------------------------------------ statistics

def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def spread(values: Iterable[float]) -> float:
    """The distance between the first and third quartiles over the median,
    as `statistics.quantiles(values, n=4)` gives them."""
    values = list(values)
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def merged(intervals: Iterable[tuple]) -> List[tuple]:
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def sum_by(pairs: Iterable[tuple]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for k, v in pairs:
        out[k] = out.get(k, 0.0) + v
    return out
