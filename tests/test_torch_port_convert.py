"""Released checkpoints in the reference's naming, carried into the port by
`compat/from_reference.py`, against the JAX package's `torch_convert`.

The reference-named state dict is built here from the JAX package's
parameter tree in the reference's layout (torch Conv1d and Linear weights,
some projections as 1x1 convs, PReLU `weight`, ChannelScale (C, 1), the
buffers a released file carries); the JAX converter must map it back to those
parameters exactly, and the port must load it to the same weights as
`load_jax_params` of the same parameters, and so give the same outputs.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow2gan_tpu.compat.torch_convert import convert_torch_state_dict
from flow2gan_tpu.models import build_generator as j_build_generator
from flow2gan_tpu.models.config import get_generator_config as j_get_config

from flow2gan_tpu_torch import api
from flow2gan_tpu_torch.compat import from_reference
from flow2gan_tpu_torch.compat.from_jax import load_jax_params
from flow2gan_tpu_torch.models import build_generator, get_generator_config
from flow2gan_tpu_torch.utils import AttributeDict

# every architectural feature at toy widths; channels[1] == time_embed_channels
# makes a square Linear, which a converter must not transpose
SMALL_CFG = dict(
    get_generator_config("mel_24k_tiny"),
    n_mels=16, mel_n_fft=256, mel_hop_length=64,
    n_ffts=(64, 32), hop_lengths=(32, 16), channels=(48, 32),
    time_embed_channels=32, num_layers=(2, 2), conv_kernel_sizes=(7, 7),
    cond_enc_channels=32, cond_enc_num_layers=2,
)
# the projections stored as 1x1 Conv1d weights (O, I, 1); the others are Linear (O, I)
_CONV_1X1 = {"in_proj", "out_proj", "cond_mlp_0", "cond_mlp_2", "cond_proj", "pwconv1", "pwconv2"}
# buffers of a released file that have no parameter counterpart
_BUFFERS = ("estimators.0.fft.window", "estimators.1.ifft.window", "loss_spec.spec.window",
            "mel.mel_scale.fb", "spec_fn.window", "cond_encoder.norm_stats.num_batches_tracked")


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def reference_state_dict(params, conv_1x1=_CONV_1X1):
    """The flax tree in the reference's naming and layout (numpy)."""
    out = {}
    for (*mods, leaf), v in _flat(params):
        name = ".".join(mods)
        for group in ("estimators", "blocks", "time_mlp", "cond_mlp"):
            name = name.replace(f"{group}_", f"{group}.")
        if leaf == "kernel":
            leaf = "weight"
            if v.ndim == 3:
                v = v.transpose(2, 1, 0)  # (k, I, O) -> Conv1d (O, I, k)
            else:
                v = v.T[..., None] if mods[-1] in conv_1x1 else v.T
        elif leaf == "alpha":
            leaf = "weight"  # nn.PReLU
        elif leaf == "scale":
            v = v[:, None]  # ChannelScale (C, 1)
        out[f"{name}.{leaf}"] = np.ascontiguousarray(v)
    for b in _BUFFERS:
        out[b] = np.ones(4, np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _params(name="small"):
    cfg = SMALL_CFG if name == "small" else get_generator_config(name)
    jcfg = j_get_config("mel_24k_base")
    jcfg.update(cfg)
    jm = j_build_generator(jcfg)
    init = jax.jit(lambda rngs, cond: jm.init(rngs, cond, n_timesteps=1, method="infer"))
    params = init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                  jnp.zeros((1, cfg["n_mels"], 8)))["params"]
    rng = np.random.RandomState(3)
    params = jax.tree.map(lambda p: (np.asarray(p) + 0.01 * rng.randn(*np.shape(p)))
                          .astype(np.float32), params)
    return cfg, params


def _save(sd, path):
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def test_jax_converter_maps_the_reference_state_dict_back_exactly():
    _, params = _params()
    back, missing, unexpected = convert_torch_state_dict(reference_state_dict(params), params,
                                                         strict=True)
    assert not missing and not unexpected
    for (path, a), (_, b) in zip(_flat(params), _flat(jax.tree.map(np.asarray, back))):
        np.testing.assert_array_equal(a, b, err_msg="/".join(path))


@pytest.mark.parametrize("wrap", ["plain", "ddp", "gan", "container", "all_linear"])
def test_reference_checkpoint_loads_as_load_jax_params_does(tmp_path, wrap):
    """DDP's `module.` prefix, a GAN checkpoint's `generator.` (its
    discriminators dropped), a {"model": ...} container and a file with
    Linear weights where the others have 1x1 convs all give the weights
    `load_jax_params` gives, and the same outputs."""
    cfg, params = _params()
    sd = reference_state_dict(params, conv_1x1=set() if wrap == "all_linear" else _CONV_1X1)
    if wrap == "ddp":
        sd = {f"module.{k}": v for k, v in sd.items()}
    elif wrap == "gan":
        sd = {**{f"generator.{k}": v for k, v in sd.items()},
              "discriminators.0.convs.0.weight": np.ones((4, 1, 3), np.float32)}
    path = tmp_path / "ref.pt"
    if wrap == "container":
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}, "epoch": 3}, path)
    else:
        _save(sd, path)
    ours = from_reference.load_weights(build_generator(cfg), path).eval()
    theirs = load_jax_params(build_generator(cfg), params).eval()
    for k, v in theirs.state_dict().items():
        torch.testing.assert_close(ours.state_dict()[k], v, rtol=0, atol=0)
    rng = np.random.RandomState(0)
    cond = torch.from_numpy(rng.randn(2, 16, 12).astype(np.float32))
    noise = torch.from_numpy((0.1 * rng.randn(2, 12 * 64)).astype(np.float32))
    with torch.no_grad():
        a = ours.infer_from_noise(noise, cond, n_timesteps=2)
        b = theirs.infer_from_noise(noise, cond, n_timesteps=2)
    assert (a - b).abs().max().item() <= 1e-6


def test_a_1x1_conv_weight_and_a_linear_weight_load_alike():
    cfg, params = _params()
    model = build_generator(cfg)
    as_conv = from_reference.to_port_state_dict(
        {k: torch.from_numpy(v) for k, v in reference_state_dict(params).items()}, model)
    as_linear = from_reference.to_port_state_dict(
        {k: torch.from_numpy(v) for k, v in reference_state_dict(params, set()).items()}, model)
    name = "estimators.0.decoder.blocks.0.pwconv1.weight"
    assert as_conv[name].shape == model.state_dict()[name].shape
    for k in as_conv:
        torch.testing.assert_close(as_conv[k], as_linear[k], rtol=0, atol=0)
    # a square projection keeps its orientation
    square = "estimators.1.decoder.blocks.0.time_embed_proj.weight"
    k = params["estimators_1"]["decoder"]["blocks_0"]["time_embed_proj"]["kernel"]
    assert k.shape[0] == k.shape[1]
    np.testing.assert_array_equal(as_conv[square].numpy(), k.T)


def test_the_conversion_is_strict():
    cfg, params = _params()
    model = build_generator(cfg)
    sd = {k: torch.from_numpy(v) for k, v in reference_state_dict(params).items()}
    with pytest.raises(KeyError, match="unexpected.*stray.weight"):
        from_reference.to_port_state_dict({**sd, "stray.weight": torch.zeros(2)}, model)
    short = {k: v for k, v in sd.items() if not k.startswith("cond_encoder.in_norm")}
    with pytest.raises(KeyError, match="missing.*cond_encoder.in_norm"):
        from_reference.to_port_state_dict(short, model)
    bad = dict(sd, **{"cond_encoder.in_proj.weight": torch.zeros(3, 3, 3)})
    with pytest.raises(ValueError, match="cannot fit cond_encoder.in_proj.weight"):
        from_reference.to_port_state_dict(bad, model)


def test_get_model_reads_a_released_name_and_its_file(tmp_path, monkeypatch):
    """`hf_model_name` picks the config and the step count; the weights come
    from the local file. The 44.1 kHz config is cut to one layer per stack
    here, so that its file stays small."""
    asked = []

    def shallow(name):
        asked.append(name)
        return AttributeDict(get_generator_config(name), num_layers=(1, 1, 1),
                             cond_enc_num_layers=1)

    monkeypatch.setattr(api, "get_generator_config", shallow)
    name = "mel_44k_128band_512x_base"
    cfg = shallow(name)
    model = build_generator(cfg)
    path = tmp_path / "universal-44k-mel-128band-512x-2-step.pt"
    _save({k: v.numpy() for k, v in model.state_dict().items()}, path)  # the port's own naming
    vm = api.get_model(hf_model_name="universal-44k-mel-128band-512x-2-step", checkpoint=path,
                       device="cpu")
    assert asked == [name, name] and vm.n_timesteps == 2 and vm.config.n_mels == 128
    for k, v in model.state_dict().items():
        torch.testing.assert_close(vm.module.state_dict()[k], v, rtol=0, atol=0)
    assert api.get_model(hf_model_name="libritts-mel-4-step", checkpoint=_save(
        {k: v.numpy() for k, v in build_generator(shallow("mel_24k_base")).state_dict().items()},
        tmp_path / "l.pt"), device="cpu").n_timesteps == 4
    with pytest.raises(FileNotFoundError, match="k2-fsa/Flow2GAN"):
        api.get_model(hf_model_name="universal-44k-mel-128band-512x-2-step", device="cpu")
