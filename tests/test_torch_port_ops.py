"""The port's DSP ops (`flow2gan_tpu_torch.ops`) against the JAX package's on
the same numpy inputs.

Tolerances, relative to max|reference|: 5e-6 for the iSTFT (float32 matmul
iDFT plus overlap-add, summed in another order), 1e-5 for the other ops.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow2gan_tpu.ops import mel as jmel
from flow2gan_tpu.ops import stft as jstft
from flow2gan_tpu.ops.pallas_istft import istft_pallas
from flow2gan_tpu.ops.pallas_istft import supported as pallas_supported
from flow2gan_tpu.utils import make_valid_mask as j_make_valid_mask
from flow2gan_tpu.utils import safe_log as j_safe_log

from flow2gan_tpu_torch.ops import fused_istft as fused
from flow2gan_tpu_torch.ops import mel as pmel
from flow2gan_tpu_torch.ops import stft as pstft
from flow2gan_tpu_torch.utils import make_valid_mask, safe_log

ISTFT_PAIRS = [(512, 256), (256, 128), (1024, 256), (128, 64)]
H100_SMS = 132  # the SM count of the H100 SXM the tile rule was tuned on


def _audio(b, length, seed=0):
    return (0.3 * np.random.RandomState(seed).randn(b, length)).astype(np.float32)


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-12)


def _spec(b, length, n_fft, hop, seed=0):
    """One spectrogram as numpy complex64, the same input for both sides."""
    return np.array(jstft.stft(jnp.asarray(_audio(b, length, seed)), n_fft, hop))


@pytest.mark.parametrize("n_fft,hop", ISTFT_PAIRS)
@pytest.mark.parametrize("length", [8000, 12001])
def test_stft_matches_jax(n_fft, hop, length):
    x = _audio(2, length)
    ref = np.asarray(jstft.stft(jnp.asarray(x), n_fft, hop, method="matmul"))
    ours = pstft.stft(torch.from_numpy(x), n_fft, hop).numpy()
    assert ours.shape[1] == pstft.num_frames(length, hop)
    assert _rel_err(ours, ref) < 1e-5


@pytest.mark.parametrize("n_fft,hop", ISTFT_PAIRS)
def test_frame_signal_and_window_match_jax(n_fft, hop):
    x = _audio(2, 3001)
    ref = np.asarray(jstft.frame_signal(jnp.asarray(x), n_fft, hop))
    np.testing.assert_array_equal(pstft.frame_signal(torch.from_numpy(x), n_fft, hop).numpy(), ref)
    np.testing.assert_array_equal(pstft.hann_window_np(n_fft), jstft.hann_window_np(n_fft))


@pytest.mark.parametrize("n_fft,hop", ISTFT_PAIRS)
@pytest.mark.parametrize("length", [None, "pad", "trim"])
def test_plain_istft_matches_jax_matmul(n_fft, hop, length):
    spec = _spec(3, 8000, n_fft, hop)
    default = (spec.shape[1] - 1) * hop
    length = {None: None, "pad": default + 333, "trim": default - 1000}[length]
    ref = np.asarray(jstft.istft(jnp.asarray(spec), n_fft, hop, length=length, method="matmul"))
    ours = pstft.istft(torch.from_numpy(spec), n_fft, hop, length=length).numpy()
    assert _rel_err(ours, ref) < 5e-6
    if length is not None and length > default:
        np.testing.assert_array_equal(ours[:, default:], 0.0)


@pytest.mark.parametrize("n_fft,hop", [p for p in ISTFT_PAIRS if pallas_supported(*p)])
@pytest.mark.parametrize("length", [None, "pad", "trim"])
def test_plain_istft_matches_pallas_interpret(n_fft, hop, length):
    spec = _spec(2, 8000, n_fft, hop, seed=1)
    default = (spec.shape[1] - 1) * hop
    length = {None: None, "pad": default + 200, "trim": default - 700}[length]
    ref = np.asarray(istft_pallas(jnp.asarray(spec), n_fft, hop, length=length, interpret=True))
    ours = pstft.istft(torch.from_numpy(spec), n_fft, hop, length=length).numpy()
    assert _rel_err(ours, ref) < 5e-6


def _fft_frames(spec: np.ndarray, n_fft):
    """The kernel's per-frame arithmetic in numpy complex64, vectorised over
    frames: the Hermitian pack into M = n_fft/2 points, the Stockham passes
    (`_stockham_inverse`), and the even/odd unpack (the complex result read
    as floats). Returns (..., n_fft) frames, unwindowed and scaled by n_fft."""
    twiddles, _ = fused.kernel_tables_np(n_fft)
    half = (twiddles[:, 0] + 1j * twiddles[:, 1]).astype(np.complex64)
    m_pts = n_fft // 2
    x = spec.astype(np.complex64)  # a copy
    x[..., 0] = x[..., 0].real  # the imaginary parts at DC and Nyquist are dropped
    x[..., m_pts] = x[..., m_pts].real
    xm, xc = x[..., :m_pts], np.conj(x[..., m_pts:0:-1])  # X[m], conj X[M - m]
    z = _stockham_inverse((xm + xc) + 1j * half * (xm - xc), n_fft)
    return np.stack([z.real, z.imag], axis=-1).reshape(*z.shape[:-1], n_fft)


def _stockham_inverse(z: np.ndarray, n_fft):
    """The kernels' Stockham passes over the last axis, M = n_fft/2 points
    (radix 2 first where log2 M is odd, else radix 4, then radix 4), with
    twiddles from their table: the unnormalised inverse FFT of z."""
    twiddles, _ = fused.kernel_tables_np(n_fft)
    half = (twiddles[:, 0] + 1j * twiddles[:, 1]).astype(np.complex64)
    tw = np.concatenate([half, -half])  # the kernel's e^{i (theta + pi)} = -e^{i theta}
    m_pts = n_fft // 2
    log2m = int(np.log2(m_pts))
    s = 1
    for radix in [2 if log2m % 2 else 4] + [4] * ((log2m - 1) // 2):
        step = m_pts // radix
        r = np.arange(step)
        base = r & ~(s - 1)
        ins = [z[..., j * step : (j + 1) * step] for j in range(radix)]
        if radix == 2:
            outs = [ins[0] + ins[1], ins[0] - ins[1]]
        else:
            a, b, c, d = ins
            outs = [a + c + (b + d), (a - c) + 1j * (b - d), a + c - (b + d), (a - c) - 1j * (b - d)]
        y = np.empty_like(z)
        y[..., radix * base + (r - base)] = outs[0]
        for j in range(1, radix):
            y[..., radix * base + (r - base) + j * s] = outs[j] * tw[2 * j * base]
        z, s = y, s * radix
    assert s == m_pts
    return z


def _tile(plan: fused.TilePlan, i):
    """(t0, t1, fa, fb): tile i's rows [t0, t1) and frames [fa, fb), as the
    kernel computes them."""
    t0 = plan.t_lo + i * plan.rows_per_tile
    t1 = min(t0 + plan.rows_per_tile, plan.t_lo + plan.rows)
    return t0, t1, max(t0 - plan.k + 1, 0), min(t0 + plan.rows_per_tile, plan.t_f)


def _chunks(plan: fused.TilePlan, i):
    """Tile i's frames as (lo, hi) chunks in the kernel's order, last frames
    first, so each output sums its frames from the latest to the earliest,
    as the plain overlap-add does. At least one chunk, possibly empty, so
    that a tile with no frames still writes its zeros."""
    _, _, fa, fb = _tile(plan, i)
    c = plan.frames_per_chunk
    n = max(-(-(fb - fa) // c), 1)
    return [(max(fb - (j + 1) * c, fa), fb - j * c) for j in range(n)]


def _tile_writes(plan: fused.TilePlan):
    """Per tile: its rows t, its chunks of frames and the output index of
    each (row, column), as the kernel's store maps them."""
    c = np.arange(plan.hop)
    for i in range(plan.tiles):
        t0, t1, _, _ = _tile(plan, i)
        t = np.arange(t0, t1)
        yield i, t, _chunks(plan, i), t[:, None] * plan.hop + c - plan.n_fft // 2


def _fft_form(spec: np.ndarray, plan: fused.TilePlan):
    """The CUDA kernel's arithmetic in numpy: `_fft_frames`, then per tile
    and chunk (last frames first) the windowed overlap-add of frames
    f = t - j, j = 0 .. k-1, and the store, which divides by the envelope
    below out_len and writes zeros up to `length`."""
    b = spec.shape[0]
    hop, k = plan.hop, plan.k
    _, window = fused.kernel_tables_np(plan.n_fft)
    frames = _fft_frames(spec, plan.n_fft)
    out_len = min(plan.length, (plan.t_f - 1) * hop)
    env = np.ones(plan.length, np.float32)  # ones past out_len, never divided by
    env[:out_len] = pstft._istft_envelope(plan.t_f, plan.n_fft, hop)[:out_len]
    out = np.full((b, plan.length), np.nan, np.float32)
    for _, t, chunks, idx in _tile_writes(plan):
        acc = np.zeros((b, len(t), hop), np.float32)
        for lo, hi in chunks:
            for j in range(k):
                f = t - j
                sel = (f >= lo) & (f < hi)
                acc[:, sel] += window[j * hop : (j + 1) * hop] * frames[:, f[sel], j * hop : (j + 1) * hop]
        keep = (idx >= 0) & (idx < plan.length)
        vals = np.where(idx < out_len, acc / env[np.clip(idx, 0, plan.length - 1)], 0.0)
        out[:, idx[keep]] = vals[:, keep]
    return out


@pytest.mark.parametrize("n_fft,hop", ISTFT_PAIRS + [(64, 32)])
@pytest.mark.parametrize("t_f,length", [(33, None), (33, 5000), (33, 3000), (2, None), (1, 64)])
def test_kernel_formulation_matches_plain(n_fft, hop, t_f, length):
    """The kernel's FFT form, tile map and overlap-add reproduce the plain
    iSTFT, including T_f <= k, `length` above and below the default, and
    nonzero imaginary parts at DC and Nyquist (which both ignore)."""
    rng = np.random.RandomState(t_f)
    n_freq = n_fft // 2 + 1
    spec = (rng.randn(3, t_f, n_freq) + 1j * rng.randn(3, t_f, n_freq)).astype(np.complex64)
    assert np.abs(spec[..., [0, -1]].imag).min() > 0
    length_ = (t_f - 1) * hop if length is None else length
    ours = _fft_form(spec, fused.tile_plan(3, t_f, n_fft, hop, length_, H100_SMS))
    ref = pstft.istft(torch.from_numpy(spec), n_fft, hop, length=length).numpy()
    assert _rel_err(ours, ref) < 5e-6


@pytest.mark.parametrize("n_fft", fused.N_FFTS)
def test_fft_frames_match_irfft(n_fft):
    """Pack, Stockham passes and unpack give n_fft * irfft of the spectrum
    with its DC and Nyquist imaginary parts dropped, to float32 rounding."""
    rng = np.random.RandomState(n_fft)
    spec = (rng.randn(4, n_fft // 2 + 1) + 1j * rng.randn(4, n_fft // 2 + 1)).astype(np.complex64)
    ref = spec.astype(np.complex128)
    ref[:, [0, -1]] = ref[:, [0, -1]].real
    ref = n_fft * np.fft.irfft(ref, n_fft)
    assert _rel_err(_fft_frames(spec, n_fft), ref) < 2e-6


@pytest.mark.parametrize("n_fft", fused.N_FFTS)
def test_kernel_tables_match_float64(n_fft):
    """The twiddle and window tables are the float64 values rounded once to
    float32: within half an ulp of float32 at 1."""
    twiddles, window = fused.kernel_tables_np(n_fft)
    assert twiddles.dtype == window.dtype == np.float32
    assert twiddles.shape == (n_fft // 2, 2) and window.shape == (n_fft,)
    ang = 2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    half_ulp = np.finfo(np.float32).eps / 2
    assert np.abs(twiddles[:, 0] - np.cos(ang)).max() <= half_ulp
    assert np.abs(twiddles[:, 1] - np.sin(ang)).max() <= half_ulp
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    assert np.abs(window * n_fft - hann).max() <= half_ulp


@pytest.mark.parametrize("n_fft,hop,t_f,length,rows_per_tile,frames_per_chunk", [
    (512, 128, 40, 5000, 2, 5),  # R < k
    (512, 128, 40, 5000, 4, 7),  # R = k
    (512, 128, 40, 5000, 3, 2),  # chunks smaller than the tile's frames
    (1024, 256, 3, 900, 2, 5),  # T_f <= k, length above the default
    (256, 256, 5, 1000, 2, 2),  # k = 1
])
def test_tile_map_writes_each_output_once(n_fft, hop, t_f, length, rows_per_tile,
                                          frames_per_chunk):
    """Every output index is written by exactly one tile; each tile's chunks
    cover its frames once; every frame a row overlaps is among them. The
    arithmetic on that map still matches the plain version."""
    plan = fused.TilePlan(n_fft, hop, t_f, length, rows_per_tile, frames_per_chunk)
    writes = np.zeros(length, int)
    for i, t, chunks, idx in _tile_writes(plan):
        np.add.at(writes, idx[(idx >= 0) & (idx < length)], 1)
        _, _, fa, fb = _tile(plan, i)
        covered = np.concatenate([np.arange(lo, hi) for lo, hi in chunks])
        assert sorted(covered) == list(range(fa, fb))
        assert all(hi - lo <= frames_per_chunk for lo, hi in chunks)
        needed = {f for f in range(t_f) for row in t if 0 <= row - f < plan.k}
        assert needed <= set(covered.tolist())
    np.testing.assert_array_equal(writes, 1)
    rng = np.random.RandomState(5)
    spec = (rng.randn(2, t_f, n_fft // 2 + 1) + 1j * rng.randn(2, t_f, n_fft // 2 + 1)
            ).astype(np.complex64)
    ref = pstft.istft(torch.from_numpy(spec), n_fft, hop, length=length).numpy()
    assert _rel_err(_fft_form(spec, plan), ref) < 5e-6


@pytest.mark.parametrize("n_fft,hop,t_f,length", [
    (512, 256, 95, 24064), (256, 128, 189, 24064), (128, 64, 377, 24064),
    (1024, 512, 88, 44544), (512, 256, 175, 44544), (256, 128, 349, 44544),
])
def test_tile_plan_fills_the_card_at_main_shapes(n_fft, hop, t_f, length):
    """Batch 16 at each main-path shape gives at least two blocks for each
    of the H100's SMs, in one chunk of frames per tile that fits the
    shared-memory budget, with halo frames at most a third of the tile's."""
    plan = fused.tile_plan(16, t_f, n_fft, hop, length, H100_SMS)
    assert 16 * plan.tiles >= 2 * H100_SMS
    assert plan.rows_per_tile >= fused.HALO_ROWS * (plan.k - 1)
    assert plan.rows_per_tile + plan.k - 1 == plan.frames_per_chunk
    assert 8 * n_fft * plan.frames_per_chunk <= fused.FRAME_BUFFER_BYTES
    assert plan.smem_bytes <= 227 * 1024 // 4  # four blocks fit on an SM
    assert all(len(_chunks(plan, i)) == 1 for i in range(plan.tiles))


@pytest.mark.parametrize("sm_count", [66, 114, 264])
def test_tile_plan_follows_the_sm_count(sm_count):
    """A card with fewer SMs gets fewer, longer tiles, one with more gets
    more blocks, each within the halo floor and the frame budget."""
    n_fft, hop, t_f, length = 128, 64, 377, 24064
    plan = fused.tile_plan(16, t_f, n_fft, hop, length, sm_count)
    h100 = fused.tile_plan(16, t_f, n_fft, hop, length, H100_SMS)
    assert (plan.rows_per_tile - h100.rows_per_tile) * (H100_SMS - sm_count) > 0
    assert 16 * plan.tiles >= 2 * sm_count
    assert plan.rows_per_tile >= fused.HALO_ROWS * (plan.k - 1)
    assert 8 * n_fft * plan.frames_per_chunk <= fused.FRAME_BUFFER_BYTES


def test_fused_istft_uses_plain_version_on_cpu_only():
    spec = torch.from_numpy(_spec(2, 4000, 256, 128))
    np.testing.assert_array_equal(
        fused.fused_istft(spec, 256, 128, length=4000).numpy(),
        pstft.istft(spec, 256, 128, length=4000).numpy(),
    )
    with pytest.raises(ValueError, match="CUDA"):
        fused._launch_istft(spec, 256, 128, 4000)
    assert fused.supported(128, 64) and not fused.supported(512, 200)
    assert fused.supported(64, 32) and fused.supported(1024, 512) and fused.supported(1024, 1)
    assert not fused.supported(2048, 512) and not fused.supported(32, 16)
    assert not fused.supported(96, 32)


def test_cached_constants_outlive_inference_mode():
    """Constants first made inside `torch.inference_mode` (as a served call
    makes them) still serve a later call that records autograd."""
    for cached in (pstft._stft_consts, pstft._istft_consts, pstft.envelope):
        cached.cache_clear()
    audio = torch.from_numpy(np.random.RandomState(4).randn(2, 2000).astype(np.float32))
    with torch.inference_mode():
        ref = pstft.istft(pstft.stft(audio, 256, 128), 256, 128, length=2000)
    audio.requires_grad_(True)
    out = pstft.istft(pstft.stft(audio, 256, 128), 256, 128, length=2000)
    out.square().sum().backward()
    torch.testing.assert_close(out.detach(), ref, rtol=0, atol=0)
    assert audio.grad is not None and torch.isfinite(audio.grad).all()


def test_logmel_matches_jax():
    x = _audio(2, 12000, seed=3)
    kw = dict(sampling_rate=24000, n_fft=1024, hop_length=256, n_mels=100)
    ref = np.asarray(jmel.LogMelSpectrogram(**kw)(jnp.asarray(x)))
    ours = pmel.LogMelSpectrogram(**kw)(torch.from_numpy(x)).numpy()
    assert _rel_err(ours, ref) < 1e-5
    np.testing.assert_array_equal(
        pmel.melscale_fbanks(513, 0.0, 12000.0, 100, 24000),
        jmel.melscale_fbanks(513, 0.0, 12000.0, 100, 24000),
    )


def test_spectrogram_power_matches_jax():
    x = _audio(2, 5000, seed=4)
    ref = np.asarray(jmel.spectrogram(jnp.asarray(x), 256, 64, power=2.0))
    ours = pmel.spectrogram(torch.from_numpy(x), 256, 64, power=2.0).numpy()
    assert _rel_err(ours, ref) < 1e-5


def test_packing_and_masks_match_jax():
    spec = _spec(2, 3000, 128, 64)
    packed = pstft.spec_to_real(torch.from_numpy(spec))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jstft.spec_to_real(jnp.asarray(spec))))
    np.testing.assert_array_equal(pstft.real_to_spec(packed).numpy(), spec)
    lens = np.asarray([3000, 1234])
    np.testing.assert_array_equal(
        pstft.stft_lens(torch.from_numpy(lens), 64).numpy(),
        np.asarray(jstft.stft_lens(jnp.asarray(lens), 64)),
    )
    np.testing.assert_array_equal(
        make_valid_mask(torch.from_numpy(lens), 3100).numpy(),
        np.asarray(j_make_valid_mask(jnp.asarray(lens), 3100)),
    )
    x = np.asarray([1e-9, 1e-7, 0.5, 3.0], np.float32)
    np.testing.assert_allclose(
        safe_log(torch.from_numpy(x)).numpy(), np.asarray(j_safe_log(jnp.asarray(x))), rtol=1e-6
    )
