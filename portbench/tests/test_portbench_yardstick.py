"""The benchmark's arithmetic against hand counts at one shape."""

import math
import statistics

import pytest

from portbench import yardstick
from portbench.tests.tiny import TINY


def test_istft_bound_is_the_larger_of_bytes_and_operations():
    # n_fft 512, batch 16, 94 frames, 24064 samples
    bytes_ = 16 * 94 * 257 * 8 + 16 * 24064 * 4
    flop = 16 * 94 * (2.5 * 512 * 9 + 2 * 512) + 16 * 24064
    assert yardstick.istft_bound_s(512, 16, 94, 24064) == pytest.approx(
        max(bytes_ / 3.35e12, flop / 67e12), rel=1e-12)
    assert bytes_ / 3.35e12 > flop / 67e12  # bound by bytes at this shape


def test_adjoint_bound():
    bytes_ = 256 * 36000 * 4 + 256 * 282 * 65 * 8
    flop = 256 * 282 * (2.5 * 128 * 7 + 128) + 256 * 36000
    assert yardstick.adjoint_bound_s(128, 256, 282, 36000) == pytest.approx(
        max(bytes_ / 3.35e12, flop / 67e12), rel=1e-12)


def test_model_flop_by_hand_at_the_tiny_config():
    batch, length = 2, 640  # 10 mel frames at hop 64
    cfg = TINY
    total = 0.0
    for n_fft, hop, c in ((128, 64, 64), (64, 32, 48)):
        t = 1 + length // hop
        t_cond = t if hop == 64 else -(-t // 2)
        stft = t * (2.5 * n_fft * math.log2(n_fft) + n_fft)
        proj = 2 * t * (n_fft + 2) * c * 2
        time_mlp = 2 * 32 * 96 * 2
        cond_mlp = 2 * t_cond * 48 * 144 * 2
        block = 2 * t * c * 7 + 2 * t_cond * 48 * c + 2 * 32 * c + 2 * t * c * 3 * c * 2
        total += batch * (2 * stft + proj + time_mlp + cond_mlp + 2 * block)
    assert yardstick.estimate_flop(cfg, batch, length) == pytest.approx(total, rel=1e-12)
    enc = batch * (2 * 10 * 20 * 48 * 3 + 2 * 2 * 10 * (48 * 7 + 2 * 48 * 144))
    assert yardstick.cond_encoder_flop(cfg, batch, 10) == pytest.approx(enc, rel=1e-12)
    assert yardstick.serve_flop(cfg, batch, 10, 4) == pytest.approx(enc + 4 * total, rel=1e-12)


def test_families():
    assert yardstick.family("void (anonymous namespace)::fused_istft_adjoint_kernel(float)") \
        == yardstick.ADJOINT
    assert yardstick.family("fused_istft_kernel(float2 const*)") == yardstick.ISTFT
    assert yardstick.family("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == yardstick.NCCL
    assert yardstick.family("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n") == "gemm"
    assert yardstick.family("Memcpy DtoH (Device -> Pageable)") == "copies (DMA)"
    assert yardstick.family("vectorized_elementwise_kernel") == "elementwise, reductions, copies"


def test_statistics():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert yardstick.percentile(xs, 50) == 3.0
    assert yardstick.percentile(xs, 95) == pytest.approx(4.8)
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert yardstick.spread(xs) == pytest.approx((q3 - q1) / med)
    assert yardstick.merged([(3, 5), (0, 1), (4, 6), (1, 2)]) == [(0, 2), (3, 6)]
