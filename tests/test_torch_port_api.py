"""The port's public API, its device policy and its import boundary."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow2gan_tpu.ops.mel import LogMelSpectrogram as JLogMel

import flow2gan_tpu_torch
from flow2gan_tpu_torch import api
from flow2gan_tpu_torch.ops.tokenizer import MelKMeansTokenizer

REPO = Path(__file__).resolve().parents[1]


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, load without jax, flax
    or the JAX package, and without the packages the card's machine lacks
    (tensorboardX, tensorboard, matplotlib, msgpack)."""
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in (REPO / "flow2gan_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules + ['chip_smoke']!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'flow2gan_tpu',"
        " 'tensorboardX', 'tensorboard', 'matplotlib', 'msgpack')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert {
        "flow2gan_tpu_torch.ops.fused_istft", "flow2gan_tpu_torch.models.generator",
        "flow2gan_tpu_torch.training.optim", "flow2gan_tpu_torch.training.train_step",
        "flow2gan_tpu_torch.training.checkpoint", "flow2gan_tpu_torch.training.hooks",
        "flow2gan_tpu_torch.training.err", "flow2gan_tpu_torch.data.audio_io",
        "flow2gan_tpu_torch.data.dataset", "flow2gan_tpu_torch.bin.pretrain",
        "flow2gan_tpu_torch.bin.save_averaged_model", "flow2gan_tpu_torch.compat.from_reference",
        "flow2gan_tpu_torch.data.native_audio", "flow2gan_tpu_torch.bin.infer",
        "flow2gan_tpu_torch.bin.infer_dir", "flow2gan_tpu_torch.models.discriminators",
        "flow2gan_tpu_torch.models.gan", "flow2gan_tpu_torch.training.gan_step",
        "flow2gan_tpu_torch.bin.finetune", "flow2gan_tpu_torch.parallel",
        "flow2gan_tpu_torch.parallel.dist", "flow2gan_tpu_torch.ops.tokenizer",
        "flow2gan_tpu_torch.bin.train_tokenizer", "flow2gan_tpu_torch.training.env",
        "flow2gan_tpu_torch.training.diagnostics", "flow2gan_tpu_torch.utils_tb",
        "flow2gan_tpu_torch.compat.flax_msgpack",
    } <= set(modules) and len(modules) >= 41


def test_recipes_call_only_the_port():
    """No recipe of the port calls the JAX package or the JAX repo's
    scripts/: every step is a `flow2gan_tpu_torch` module or recipe."""
    recipes = sorted((REPO / "flow2gan_tpu_torch" / "recipes").glob("*.sh"))
    assert {p.name for p in recipes} >= {"run_libritts.sh", "infer_dir.sh",
                                         "preflight_pipeline.sh", "drive_generalization.sh"}
    for path in recipes:
        text = path.read_text()
        assert "flow2gan_tpu." not in text and "flow2gan_tpu/" not in text, path.name
        assert not re.search(r"(^|[\s\"'/])scripts/", text), path.name
        assert "flow2gan_tpu_torch.bin." in text, path.name


def test_card_check_bounds_are_the_yardsticks():
    """The card check's kernel bounds are `portbench/yardstick.py`'s at every
    shape it times the iSTFT and its adjoint, and it keeps no peak, bound or
    kernel family of its own."""
    import chip_smoke
    from portbench import yardstick

    shapes = chip_smoke.MAIN_SHAPES + chip_smoke.TRAIN_SHAPES + chip_smoke.REFERENCE_BATCH_SHAPES
    for n_fft, hop, batch, t_f, length in shapes:
        assert chip_smoke.bound_ms("istft", n_fft, hop, batch, t_f, length) == (
            1e3 * yardstick.istft_bound_s(n_fft, batch, t_f, length))
        assert chip_smoke.bound_ms("adjoint", n_fft, hop, batch, t_f, length) == (
            1e3 * yardstick.adjoint_bound_s(n_fft, batch, t_f, length))
    assert chip_smoke.yardstick is yardstick
    for name in ("HBM_BYTES_PER_S", "FP32_FLOP_PER_S", "istft_bound_ms", "adjoint_bound_ms",
                 "_GEMM_NAMES", "_family", "NCCL_FAMILY"):
        assert not hasattr(chip_smoke, name), name


def test_get_model_needs_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.get_model("mel_24k_tiny")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.get_model("mel_24k_tiny", device="cuda")
    model = api.get_model("mel_24k_tiny", device="cpu")
    assert model.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in model.module.parameters())


def test_get_model_on_the_card_turns_tf32_off(monkeypatch):
    """get_model sets both TF32 flags off before it builds on the card, once
    and without restoring them, so no concurrent call can see them flip."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)

    def stop(config):
        raise LookupError("stop before the build")

    monkeypatch.setattr(api, "get_generator_config", stop)
    with pytest.raises(LookupError):
        api.get_model("mel_24k_tiny", device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    with pytest.raises(LookupError):
        api.get_model("mel_24k_tiny", device="cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_get_model_rejects_what_it_cannot_serve():
    with pytest.raises(FileNotFoundError,
                       match="downloads nothing.*libritts-mel-1-step.pt from k2-fsa/Flow2GAN"):
        api.get_model(hf_model_name="libritts-mel-1-step", device="cpu")
    with pytest.raises(ValueError, match="Unknown released model"):
        api.get_model(hf_model_name="libritts-mel-3-step", checkpoint="x.pt", device="cpu")
    # a token config takes only a codebook fit for its own frontend and vocabulary
    wrong = MelKMeansTokenizer(np.zeros((64, 100), np.float32), 24000, 1024, 256, 100)
    with pytest.raises(ValueError, match="mel_n_fft=1024, model config expects 256"):
        api.get_model("token_24k_tiny", device="cpu", tokenizer=wrong)
    with pytest.raises(ValueError, match="Unsupported model name"):
        api.get_model("mel_99k", device="cpu")


@pytest.mark.parametrize("n_timesteps", [1, 2, 4])
def test_infer_is_seeded_and_shaped(n_timesteps):
    model = flow2gan_tpu_torch.get_model("mel_24k_tiny", device="cpu", seed=3)
    cond = np.random.RandomState(0).randn(2, 20, 12).astype(np.float32)
    a = model.infer(cond, n_timesteps=n_timesteps)
    b = model.infer(cond, n_timesteps=n_timesteps)
    c = model.infer(cond, n_timesteps=n_timesteps, seed=1)
    assert a.shape == (2, 12 * 64) and a.dtype == torch.float32
    assert torch.isfinite(a).all() and a.abs().max() <= 1.0
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    other = flow2gan_tpu_torch.get_model("mel_24k_tiny", device="cpu", seed=4)
    assert not torch.equal(a, other.infer(cond, n_timesteps=n_timesteps))


def test_checkpoint_round_trip(tmp_path):
    model = api.get_model("mel_24k_tiny", device="cpu", seed=5)
    path = tmp_path / "gen.pt"
    torch.save(model.module.state_dict(), path)
    loaded = api.get_model("mel_24k_tiny", checkpoint=path, device="cpu", seed=0)
    cond = np.random.RandomState(1).randn(1, 20, 8).astype(np.float32)
    torch.testing.assert_close(loaded.infer(cond, n_timesteps=2), model.infer(cond, n_timesteps=2),
                               rtol=0, atol=0)


def test_mel_and_reconstruct_match_jax_frontend():
    model = api.get_model("mel_24k_tiny", device="cpu")
    audio = (0.3 * np.random.RandomState(2).randn(2, 3000)).astype(np.float32)
    cfg = model.config
    ref = np.asarray(JLogMel(sampling_rate=cfg.sampling_rate, n_fft=cfg.mel_n_fft,
                             hop_length=cfg.mel_hop_length, n_mels=cfg.n_mels)(jnp.asarray(audio)))
    mel = model.mel(audio).numpy()
    assert np.abs(mel - ref).max() / np.abs(ref).max() < 1e-5
    wav = model.reconstruct(audio, n_timesteps=2)
    assert wav.shape == (2, mel.shape[-1] * cfg.mel_hop_length)
    assert torch.isfinite(wav).all()
