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


def _kernel_formulation(spec: np.ndarray, n_fft, hop, length):
    """The CUDA kernel's arithmetic in numpy: output hop-row t sums
    view_as_real(spec)[t - j] @ W[j] over the k shifts j, then the store
    maps (t, c) to output index t * hop + c - n_fft // 2, divides by the
    envelope below out_len and writes zeros up to `length`."""
    b, t_f, n_freq = spec.shape
    w = fused.kernel_weights_np(n_fft, hop).astype(np.float64)  # (k, 2F, hop + pad)
    assert w.shape[-1] % 4 == 0 and not w[..., hop:].any()
    w = w[..., :hop]
    k = n_fft // hop
    a = np.stack([spec.real, spec.imag], axis=-1).reshape(b, t_f, 2 * n_freq)
    rows = np.zeros((b, t_f + k - 1, hop))
    for j in range(k):
        rows[:, j : j + t_f] += a @ w[j]
    flat = rows.reshape(b, -1)
    half, default = n_fft // 2, (t_f - 1) * hop
    out_len = min(length, default)
    out = np.zeros((b, length))
    env = pstft._istft_envelope(t_f, n_fft, hop)
    out[:, :out_len] = flat[:, half : half + out_len] / env[:out_len]
    return out


@pytest.mark.parametrize("n_fft,hop", ISTFT_PAIRS)
@pytest.mark.parametrize("t_f,length", [(33, None), (33, 5000), (33, 3000), (2, None), (1, 64)])
def test_kernel_formulation_matches_plain(n_fft, hop, t_f, length):
    """The weight layout and index map the kernel uses reproduce the plain
    iSTFT, including T_f <= k and `length` above and below the default."""
    rng = np.random.RandomState(t_f)
    n_freq = n_fft // 2 + 1
    spec = (rng.randn(3, t_f, n_freq) + 1j * rng.randn(3, t_f, n_freq)).astype(np.complex64)
    length_ = (t_f - 1) * hop if length is None else length
    ours = _kernel_formulation(spec, n_fft, hop, length_)
    ref = pstft.istft(torch.from_numpy(spec), n_fft, hop, length=length).numpy()
    assert _rel_err(ours, ref) < 5e-6


def test_fused_istft_uses_plain_version_on_cpu_only():
    spec = torch.from_numpy(_spec(2, 4000, 256, 128))
    np.testing.assert_array_equal(
        fused.fused_istft(spec, 256, 128, length=4000).numpy(),
        pstft.istft(spec, 256, 128, length=4000).numpy(),
    )
    with pytest.raises(ValueError, match="CUDA"):
        fused.istft_kernel(spec, 256, 128)
    assert fused.supported(128, 64) and not fused.supported(512, 200)


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
