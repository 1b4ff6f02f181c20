"""Public model API of the port: `get_model` builds a named config's
generator and returns a `VocoderModel` that serves mel -> waveform synthesis,
counterpart of `flow2gan_tpu/api.py`."""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch
from torch import nn

from flow2gan_tpu_torch.models import MelAudioGenerator, build_generator, get_generator_config
from flow2gan_tpu_torch.models.convnext import DepthwiseConv1d
from flow2gan_tpu_torch.models.norms import BiasNorm
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram
from flow2gan_tpu_torch.utils import AttributeDict, disable_tf32


class VocoderModel:
    """A generator and its log-mel frontend on one device.

    `infer(mel)` takes (B, n_mels, frames) log-mels and returns (B, frames *
    hop) waveforms; `mel(audio)` takes (B, L) and returns (B, n_mels,
    frames); `reconstruct(audio)` is `infer(mel(audio))`. Inputs may be numpy
    arrays or tensors; outputs are float32 tensors on the model's device.
    """

    def __init__(self, module: MelAudioGenerator, config: AttributeDict, device: torch.device):
        self.module = module.eval()
        self.config = config
        self.device = device
        self.mel_fn = LogMelSpectrogram(
            sampling_rate=config.sampling_rate,
            n_fft=config.mel_n_fft,
            hop_length=config.mel_hop_length,
            n_mels=config.n_mels,
        ).to(device)

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    @torch.inference_mode()
    def mel(self, audio) -> torch.Tensor:
        return self.mel_fn(self._tensor(audio))

    @torch.inference_mode()
    def infer(self, cond, n_timesteps: int = 1, clamp_pred: bool = True,
              seed: int = 0) -> torch.Tensor:
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return self.module.infer(
            self._tensor(cond), n_timesteps=n_timesteps, clamp_pred=clamp_pred, generator=gen
        )

    def reconstruct(self, audio, n_timesteps: int = 1) -> torch.Tensor:
        return self.infer(self.mel(audio), n_timesteps=n_timesteps)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init of the JAX package's scheme, drawn from `generator`:
    truncated-normal (std 0.015, cut at 2 std) conv/linear weights with zero
    biases, and BiasNorm biases N(0, 1e-2^2). The other parameters keep the
    constant init their modules give them."""
    for module in model.modules():
        if isinstance(module, BiasNorm):
            module.bias.copy_(torch.randn(module.bias.shape, generator=generator) * 1e-2)
        elif isinstance(module, (nn.Linear, nn.Conv1d, DepthwiseConv1d)):
            nn.init.trunc_normal_(module.weight, std=0.015, a=-0.03, b=0.03, generator=generator)
            nn.init.zeros_(module.bias)
    return model


def get_model(
    model_name: str = "mel_24k_base",
    checkpoint: Optional[Union[str, Path]] = None,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    hf_model_name: Optional[str] = None,
) -> VocoderModel:
    """Build a vocoder from a named config.

    With `checkpoint=None` the weights are a random init drawn from `seed`;
    otherwise `checkpoint` is a `.pt` file holding the port's own
    `state_dict`. `device` defaults to "cuda", and there is no fallback: with
    no card this raises unless the caller passes `device="cpu"`. On the card
    it turns TF32 off for the process (`utils.disable_tf32`), so every
    inference call runs in IEEE float32.
    """
    if hf_model_name is not None:
        raise NotImplementedError(
            f"cannot fetch {hf_model_name!r}: the port downloads nothing and does "
            "not read reference-named checkpoints yet; pass checkpoint=<port .pt>"
        )
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if device.type == "cuda":
        disable_tf32()
    cfg = get_generator_config(model_name)
    module = build_generator(cfg)
    if checkpoint is None:
        init_weights(module, torch.Generator().manual_seed(seed))
    else:
        state = torch.load(Path(checkpoint), map_location="cpu", weights_only=True)
        module.load_state_dict(state, strict=True)
    return VocoderModel(module.to(device), cfg, device)
