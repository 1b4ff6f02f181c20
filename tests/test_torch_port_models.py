"""The port's modules and its serving slice against the JAX package.

JAX parameters (flax init, then perturbed from a numpy seed so no bias is
zero and no scale is one) go through `compat/from_jax.py` into the port;
inputs are made with numpy and handed to both. Tolerance: 1e-4 relative to
max|reference| for modules and the slice (float32 everywhere; sums taken in
another order through up to 4 Euler steps).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow2gan_tpu.models import build_generator as j_build_generator
from flow2gan_tpu.models import convnext as jconv
from flow2gan_tpu.models import norms as jnorms
from flow2gan_tpu.models.config import get_generator_config as j_get_config

from flow2gan_tpu_torch.compat.from_jax import jax_params_to_state_dict, load_jax_params
from flow2gan_tpu_torch.models import build_generator, convnext, get_generator_config, norms

TOL = 1e-4

# every architectural feature at toy widths; channels[1] == time_embed_channels
# makes estimators.1's time_embed_proj a square Linear, which guards the
# converter's always-transpose rule
SMALL_CFG = dict(
    get_generator_config("mel_24k_tiny"),
    n_mels=16, mel_n_fft=256, mel_hop_length=64,
    n_ffts=(64, 32), hop_lengths=(32, 16), channels=(48, 32),
    time_embed_channels=32, num_layers=(2, 2), conv_kernel_sizes=(7, 7),
    cond_enc_channels=32, cond_enc_num_layers=2,
)
# full width, shallow
BASE_SHALLOW_CFG = dict(
    get_generator_config("mel_24k_base"), num_layers=(1, 1, 1), cond_enc_num_layers=1
)


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-12)


def _perturbed(params, seed, scale=0.01):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p) + scale * rng.randn(*np.shape(p))).astype(np.float32), params
    )


def _to_port(module: torch.nn.Module, params) -> torch.nn.Module:
    module.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return module.eval()


def test_bias_norm_and_prelu_match_jax():
    x = np.random.RandomState(0).randn(2, 9, 24).astype(np.float32)
    jm = jnorms.BiasNorm(24)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1, 0.1)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    ours = _to_port(norms.BiasNorm(24), params)(torch.from_numpy(x))
    assert _rel_err(ours.detach().numpy(), ref) < 1e-5

    jm = jnorms.PReLU(24)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 2, 0.1)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    ours = _to_port(norms.PReLU(24), params)(torch.from_numpy(x))
    np.testing.assert_array_equal(ours.detach().numpy(), np.asarray(ref))


@pytest.mark.parametrize("factor", [1, 2])
@pytest.mark.parametrize("masked", [False, True])
def test_convnext_block_matches_jax(factor, masked):
    rng = np.random.RandomState(factor)
    B, T, C, Cc, Ct = 2, 19, 24, 16, 8
    x = rng.randn(B, T, C).astype(np.float32)
    cond = rng.randn(B, -(-T // factor), Cc).astype(np.float32)
    temb = rng.randn(B, Ct).astype(np.float32)
    mask = (np.arange(T)[None, :, None] < np.asarray([T, 11])[:, None, None]).astype(np.float32)
    mask = mask if masked else None
    jm = jconv.ConvNeXtBlock(C, 3 * C, use_cond=True, use_time=True, cond_upsample_factor=factor)
    args = [jnp.asarray(a) if a is not None else None for a in (x, cond, temb, mask)]
    params = _perturbed(jm.init(jax.random.PRNGKey(0), *args)["params"], 3)
    ref = jm.apply({"params": params}, *args)
    pm = convnext.ConvNeXtBlock(
        C, 3 * C, conditioned=True, cond_channels=Cc, time_embed_channels=Ct,
        cond_upsample_factor=factor,
    )
    t_args = [torch.from_numpy(a) if a is not None else None for a in (x, cond, temb, mask)]
    ours = _to_port(pm, params)(*t_args)
    assert _rel_err(ours.detach().numpy(), ref) < TOL


def test_cond_encoder_matches_jax():
    x = np.random.RandomState(4).randn(2, 13, 16).astype(np.float32)
    jm = jconv.CondEncoder(cond_dim=16, channels=32, num_layers=2)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 5)
    ref = jm.apply({"params": params}, jnp.asarray(x))
    ours = _to_port(convnext.CondEncoder(cond_dim=16, channels=32, num_layers=2), params)(
        torch.from_numpy(x)
    )
    assert _rel_err(ours.detach().numpy(), ref) < TOL


@pytest.mark.parametrize("n_fft,hop", [(512, 256), (256, 128), (128, 64)])
@pytest.mark.parametrize("with_lens", [False, True])
def test_audio_convnext_branch_matches_jax(n_fft, hop, with_lens):
    """Each mel_24k_base branch's STFT shape at narrow width, cond at the
    256-sample mel hop (upsample factor 1, 2 and 4)."""
    rng = np.random.RandomState(n_fft)
    B, L = 2, 4096
    audio = (0.1 * rng.randn(B, L)).astype(np.float32)
    cond = rng.randn(B, L // 256, 24).astype(np.float32)
    t = np.asarray([0.0, 0.5], np.float32)
    lens = np.asarray([L, L - 700]) if with_lens else None
    kw = dict(n_fft=n_fft, hop_length=hop, cond_hop_length=256, channels=32,
              cond_channels=24, time_embed_channels=16, num_layers=2)
    jm = jconv.AudioConvNeXt(**kw)
    jargs = dict(audio=jnp.asarray(audio), cond=jnp.asarray(cond), t=jnp.asarray(t),
                 audio_lens=None if lens is None else jnp.asarray(lens))
    params = _perturbed(jm.init(jax.random.PRNGKey(0), **jargs)["params"], 6)
    ref = jm.apply({"params": params}, **jargs)
    pm = _to_port(convnext.AudioConvNeXt(**kw), params)
    ours = pm(torch.from_numpy(audio), torch.from_numpy(cond), torch.from_numpy(t),
              audio_lens=None if lens is None else torch.from_numpy(lens))
    assert _rel_err(ours.detach().numpy(), ref) < TOL


_CONFIGS = {
    "small": SMALL_CFG,
    "tiny": get_generator_config("mel_24k_tiny"),
    "base_shallow": BASE_SHALLOW_CFG,
    # the options no named config turns off
    "small_plain": dict(SMALL_CFG, use_cond_encoder=False, pred_x1=False,
                        use_residual_scale=False, branch_reduction="sum"),
}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX module, perturbed params, port model, config), built once per config."""
    cfg = _CONFIGS[name]
    jcfg = j_get_config("mel_24k_base")
    jcfg.update(cfg)
    jm = j_build_generator(jcfg)
    cond = jnp.zeros((1, cfg["n_mels"], 16))
    params = jm.init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                     cond, n_timesteps=1, method="infer")["params"]
    params = _perturbed(params, 7, 0.005)
    return jm, params, load_jax_params(build_generator(cfg), params).eval(), cfg


@pytest.mark.parametrize("name,batch,frames", [("small", 2, 24), ("tiny", 2, 20),
                                               ("base_shallow", 1, 16), ("small_plain", 2, 12)])
@pytest.mark.parametrize("n_timesteps", [1, 2, 4])
@pytest.mark.parametrize("with_lens", [False, True])
def test_infer_from_noise_matches_jax(name, batch, frames, n_timesteps, with_lens):
    jm, params, pm, cfg = _pair(name)
    rng = np.random.RandomState(n_timesteps)
    L = frames * cfg["mel_hop_length"]
    cond = rng.randn(batch, cfg["n_mels"], frames).astype(np.float32)
    noise = (0.1 * rng.randn(batch, L)).astype(np.float32)
    lens = np.asarray([L - 300, L][:batch]) if with_lens else None
    ref = jm.apply({"params": params}, jnp.asarray(noise), jnp.asarray(cond),
                   audio_lens=None if lens is None else jnp.asarray(lens),
                   n_timesteps=n_timesteps, clamp_pred=False, method="infer_from_noise")
    with torch.no_grad():
        ours = pm.infer_from_noise(
            torch.from_numpy(noise), torch.from_numpy(cond),
            audio_lens=None if lens is None else torch.from_numpy(lens),
            n_timesteps=n_timesteps,
        )
    assert _rel_err(ours.numpy(), ref) < TOL


def test_converter_is_strict():
    _, params, _, cfg = _pair("small")
    extra = dict(params, stray={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(build_generator(cfg), extra)
    short = {k: v for k, v in params.items() if k != "cond_encoder"}
    with pytest.raises(KeyError, match="cond_encoder"):
        load_jax_params(build_generator(cfg), short)
    # a square Dense kernel is transposed like any other
    k = params["estimators_1"]["decoder"]["blocks_0"]["time_embed_proj"]["kernel"]
    assert k.shape[0] == k.shape[1]
    sd = jax_params_to_state_dict(params)
    np.testing.assert_array_equal(
        sd["estimators.1.decoder.blocks.0.time_embed_proj.weight"].numpy(), k.T
    )
