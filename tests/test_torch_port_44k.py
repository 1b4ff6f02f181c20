"""mel_44k_128band_512x_base, the 44.1 kHz config, against the JAX package:
its (1024, 512), (512, 256) and (256, 128) branches at full width with one
layer per stack, and its 128-band log-mel frontend at n_fft 2048. Tolerances,
relative to max|reference|: 1e-4 for the served slice (float32, as
`test_torch_port_models.py`), 1e-5 for the frontend (as
`test_torch_port_api.py`)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow2gan_tpu.models import build_generator as j_build_generator
from flow2gan_tpu.models.config import get_generator_config as j_get_config
from flow2gan_tpu.ops.mel import LogMelSpectrogram as JLogMel

from flow2gan_tpu_torch.compat.from_jax import load_jax_params
from flow2gan_tpu_torch.models import build_generator, get_generator_config
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram

NAME = "mel_44k_128band_512x_base"
SHALLOW_44K = dict(get_generator_config(NAME), num_layers=(1, 1, 1), cond_enc_num_layers=1)


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("with_lens", [False, True])
def test_44k_infer_from_noise_matches_jax(with_lens):
    jcfg = j_get_config(NAME)
    jcfg.update(SHALLOW_44K)
    jm = j_build_generator(jcfg)
    init = jax.jit(lambda rngs, cond: jm.init(rngs, cond, n_timesteps=1, method="infer"))
    params = init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                  jnp.zeros((1, 128, 8)))["params"]
    rng = np.random.RandomState(44)
    params = jax.tree.map(lambda p: (np.asarray(p) + 0.005 * rng.randn(*np.shape(p)))
                          .astype(np.float32), params)
    frames = 12
    length = frames * 512
    cond = rng.randn(2, 128, frames).astype(np.float32)
    noise = (0.1 * rng.randn(2, length)).astype(np.float32)
    lens = np.asarray([length, length - 1500]) if with_lens else None
    ref = jax.jit(lambda p, x0, c, lens: jm.apply(
        {"params": p}, x0, c, audio_lens=lens, n_timesteps=1, clamp_pred=False,
        method="infer_from_noise"))(params, noise, cond, lens)
    pm = load_jax_params(build_generator(SHALLOW_44K), params).eval()
    assert [est.n_fft for est in pm.estimators] == [1024, 512, 256]
    with torch.no_grad():
        ours = pm.infer_from_noise(torch.from_numpy(noise), torch.from_numpy(cond),
                                   audio_lens=None if lens is None else torch.from_numpy(lens))
    assert _rel_err(ours.numpy(), ref) < 1e-4


def test_44k_log_mel_matches_jax():
    cfg = get_generator_config(NAME)
    kw = dict(sampling_rate=cfg.sampling_rate, n_fft=cfg.mel_n_fft,
              hop_length=cfg.mel_hop_length, n_mels=cfg.n_mels)
    assert (kw["n_fft"], kw["n_mels"]) == (2048, 128)
    # broadband, so that every band holds energy far above the float32
    # rounding of the DFT (a bare sine leaves the top bands at 1e-5 of its
    # peak, where the two frameworks' rounding differs in the log)
    t = np.arange(22050) / 44100.0
    noise = np.random.RandomState(5).randn(2, t.size)
    audio = (np.stack([0.4 * np.sin(2 * np.pi * 330.0 * t), np.zeros_like(t)])
             + 0.1 * noise).astype(np.float32)
    ref = np.asarray(jax.jit(JLogMel(**kw))(jnp.asarray(audio)))
    ours = LogMelSpectrogram(**kw)(torch.from_numpy(audio)).numpy()
    assert ours.shape == ref.shape == (2, 128, 22050 // 512 + 1)
    assert _rel_err(ours, ref) < 1e-5
