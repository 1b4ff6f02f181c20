"""The JAX package's `.ckpt` files in the port, on the CPU: the stdlib msgpack
decoder against `flax.serialization.msgpack_restore` on bytes that the JAX
trainer's `save_checkpoint` wrote, `get_model` and `bin/infer` serving those
files against the JAX package's `get_model` (within 1e-4 of the largest
|sample|), the GAN layout, and the refusals: a resume from a JAX checkpoint,
and a dtype numpy cannot read."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import flax.serialization
import jax
import jax.numpy as jnp

from flow2gan_tpu import api as japi
from flow2gan_tpu.models.discriminators import Discriminators as JDiscriminators
from flow2gan_tpu.training import checkpoint as jckpt
from flow2gan_tpu.training.optim import scaled_adam

import flow2gan_tpu_torch
from flow2gan_tpu_torch.bin import infer, pretrain
from flow2gan_tpu_torch.compat import flax_msgpack
from flow2gan_tpu_torch.compat.from_jax import generator_params, load_gan_params
from flow2gan_tpu_torch.compat.from_reference import load_weights
from flow2gan_tpu_torch.data import audio_io
from flow2gan_tpu_torch.models import build_generator, get_generator_config
from flow2gan_tpu_torch.models import discriminators as pd
from flow2gan_tpu_torch.training import checkpoint as ckpt

from .test_torch_port_trainer import _args, _corpus
from .test_torch_port_train import _pair

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _same_tree(ours, ref, path="") -> None:
    """Equal structure, types and values, arrays bit for bit with their
    dtypes."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and list(ours) == list(ref), path
        for k in ref:
            _same_tree(ours[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, np.ndarray):
        assert isinstance(ours, np.ndarray) and ours.dtype == ref.dtype, path
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    else:
        assert type(ours) is type(ref) and (ours == ref or ours is ref), (path, ours, ref)


def _trainer_checkpoint(path: Path, params, gan: bool = False) -> None:
    """A checkpoint as the JAX trainers write one: the model, the float64
    average, ScaledAdam's state, the scheduler, the sampler and the train
    params."""
    opt = scaled_adam(clipping_scale=2.0)
    model = params
    optimizer = opt.init(params)
    if gan:
        params_d = jax.jit(JDiscriminators((2,), (128,)).init)(
            jax.random.PRNGKey(1), jnp.zeros((1, 512)), jnp.zeros((1, 512)))["params"]
        model = {"generator": params, "discriminator": params_d}
        optimizer = {"g": optimizer, "d": opt.init(params_d)}
    jckpt.save_checkpoint(
        path, params=model,
        model_avg=jax.tree.map(lambda x: np.asarray(x, np.float64), params),
        optimizer_state=optimizer, scheduler_state={"batch": 12, "epoch": 2},
        train_params={"batch_idx_train": 12, "model_name": "mel_24k_tiny",
                      "env_info": {"git-sha1": "abc", "backend": "cpu"}, "train_disc": gan},
        sampler_state={"epoch": 2, "dl_states": [{"consumed": 5, "epoch": 2}],
                       "rng_py": {"version": 3, "state": [1, 2, 3], "gauss": None}})


def test_decoder_equals_flax_on_a_trainer_checkpoint(tmp_path, monkeypatch):
    """Every entry of a trainer checkpoint (ScaledAdam's state, the
    scheduler, the sampler, None, strings), and an array flax split into
    chunks (MAX_CHUNK_SIZE lowered here only)."""
    _, params, _, _ = _pair("tiny")
    path = tmp_path / "epoch-2.ckpt"
    monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", 4096)
    _trainer_checkpoint(path, params)
    data = path.read_bytes()
    assert b"__msgpack_chunked_array__" in data
    ours, ref = flax_msgpack.loads(data), flax.serialization.msgpack_restore(data)
    _same_tree(ours, ref)
    assert ours["sampler"]["rng_py"]["gauss"] is None and ours["model_name"] == "mel_24k_tiny"
    assert ckpt.load_jax_checkpoint(path).keys() == ref.keys()
    extra = {"c": 1 + 2j, "n": np.int16(-3), "big": 2**40, "neg": -2**33, "b": b"\x00\x01",
             "f": 0.25, "t": True, "e": np.zeros((0, 3), np.float32)}
    blob = flax.serialization.msgpack_serialize(extra)
    _same_tree(flax_msgpack.loads(blob), flax.serialization.msgpack_restore(blob))
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.loads(data[:-3])


def test_a_dtype_numpy_cannot_read_is_named(tmp_path):
    """bfloat16 leaves, read where no package teaches numpy the dtype (as on
    the card's machine): the error names it."""
    path = tmp_path / "bf16.ckpt"
    path.write_bytes(flax.serialization.msgpack_serialize(
        {"model": {"w": jnp.ones((2, 3), jnp.bfloat16)}}))
    code = ("import sys\nfrom flow2gan_tpu_torch.training.checkpoint import load_jax_checkpoint\n"
            "try:\n    load_jax_checkpoint(sys.argv[1])\nexcept ValueError as e:\n"
            "    print(e)\n    assert 'ml_dtypes' not in sys.modules\n    sys.exit(0)\nsys.exit(3)\n")
    proc = subprocess.run([sys.executable, "-c", code, str(path)], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "'bfloat16'" in proc.stdout


def _serve_jax(vm, noise, cond):
    return np.asarray(jax.jit(lambda v, x0, c: vm.module.apply(
        v, x0, c, n_timesteps=2, method="infer_from_noise"))(vm.variables, noise, cond))


def test_get_model_serves_jax_checkpoints_as_jax_does(tmp_path):
    """{'model': params}, a trainer checkpoint and a GAN checkpoint (its
    generator), each served at 2 steps on the same noise as the JAX
    package's get_model serves the generator's file."""
    _, params, _, cfg = _pair("tiny")
    bare = tmp_path / "bare.ckpt"
    bare.write_bytes(flax.serialization.msgpack_serialize({"model": params}))
    _trainer_checkpoint(tmp_path / "trainer.ckpt", params)
    _trainer_checkpoint(tmp_path / "gan.ckpt", params, gan=True)
    rng = np.random.RandomState(0)
    cond = rng.randn(2, cfg["n_mels"], 16).astype(np.float32)
    noise = (0.1 * rng.randn(2, 16 * cfg["mel_hop_length"])).astype(np.float32)
    ref = _serve_jax(japi.get_model("mel_24k_tiny", checkpoint=str(bare)), noise, cond)
    assert np.abs(ref - _serve_jax(japi.get_model("mel_24k_tiny", checkpoint=str(
        tmp_path / "trainer.ckpt")), noise, cond)).max() == 0.0
    for name in ("bare", "trainer", "gan"):
        vm = flow2gan_tpu_torch.get_model("mel_24k_tiny", checkpoint=tmp_path / f"{name}.ckpt",
                                          device="cpu")
        with torch.no_grad():
            ours = vm.module.infer_from_noise(torch.from_numpy(noise), torch.from_numpy(cond),
                                              n_timesteps=2).numpy()
        assert np.abs(ours - ref).max() <= 1e-4 * np.abs(ref).max(), name


def test_jax_checkpoints_load_strictly_and_only_their_weights(tmp_path):
    _, params, _, _ = _pair("tiny")
    _trainer_checkpoint(tmp_path / "gan.ckpt", params, gan=True)
    loaded = ckpt.load_jax_checkpoint(tmp_path / "gan.ckpt")
    with pytest.raises(ValueError, match="--load-gan"):
        generator_params(loaded, load_gan=False)
    gen = build_generator(get_generator_config("mel_24k_tiny"))
    disc = pd.Discriminators((2,), (128,))
    load_gan_params(gen, disc, loaded)
    assert torch.equal(disc.discriminator_1.discriminators[0].conv_post.bias,
                       torch.from_numpy(np.asarray(loaded["model"]["discriminator"][
                           "discriminator_1"]["discriminators_0"]["conv_post"]["bias"])))
    # a tree that lacks a parameter raises, as the port's .pt loading does
    missing = dict(params)
    missing.pop("cond_encoder")
    path = tmp_path / "missing.ckpt"
    path.write_bytes(flax.serialization.msgpack_serialize({"model": missing}))
    with pytest.raises(KeyError, match="cond_encoder"):
        load_weights(build_generator(get_generator_config("mel_24k_tiny")), path)


def test_bin_infer_takes_jax_checkpoints(tmp_path):
    _, params, _, _ = _pair("tiny")
    manifest = _corpus(tmp_path, n=3)
    _trainer_checkpoint(tmp_path / "trainer.ckpt", params)
    _trainer_checkpoint(tmp_path / "gan.ckpt", params, gan=True)
    common = ["--model-name", "mel_24k_tiny", "--recordings", str(manifest), "--root-path",
              str(tmp_path), "--device", "cpu", "--num-workers", "1", "--batch-size", "2"]
    outs = {}
    for name, extra in (("trainer", []), ("gan", ["--load-gan", "true"])):
        written = infer.main([*common, "--checkpoint", str(tmp_path / f"{name}.ckpt"), *extra,
                              "--output-dir", str(tmp_path / f"out_{name}")])
        assert len(written) == 3
        outs[name] = [audio_io.read_wav(p)[0] for p in written]
        assert all(np.isfinite(w).all() for w in outs[name])
    for a, b in zip(outs["trainer"], outs["gan"]):
        np.testing.assert_array_equal(a, b)  # the same generator
    with pytest.raises(ValueError, match="--load-gan"):
        infer.main([*common, "--checkpoint", str(tmp_path / "gan.ckpt"), "--output-dir",
                    str(tmp_path / "no")])


def test_resume_from_a_jax_checkpoint_raises(tmp_path):
    """Its optimizer state is laid out per leaf, the port's per shape group:
    only the weights cross."""
    _, params, _, _ = _pair("tiny")
    manifest = _corpus(tmp_path, n=2)
    _trainer_checkpoint(tmp_path / "checkpoint-12.ckpt", params)
    args = pretrain.get_parser().parse_args(_args(tmp_path / "exp", manifest, "--resume-from",
                                                  str(tmp_path / "checkpoint-12.ckpt")))
    with pytest.raises(ValueError, match="JAX checkpoint.*cannot resume"):
        pretrain.run(args)
