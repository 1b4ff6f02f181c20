"""The FM pretraining step and the validation loss, counterpart of
`flow2gan_tpu/training/train_step.py`: the mel frontend, the loss with its
draws, backward, the ScaledAdam update and the step's metrics.

Randomness: one `torch.Generator` per step on the model's device, seeded
from (seed, batch index) by `step_generator`, the port's `fold_in`. The step
reads nothing back from the device: its metrics are device tensors, and the
trainer fetches them once per step.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from flow2gan_tpu_torch.models.generator import MelAudioGenerator
from flow2gan_tpu_torch.training.optim import ScaledAdam


def step_generator(seed: int, batch_idx: int, device: torch.device) -> torch.Generator:
    """The generator of batch `batch_idx` under `seed`, on `device`."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + batch_idx) % 2**63)


def fm_train_step(
    model: MelAudioGenerator,
    optimizer: ScaledAdam,
    mel_fn: Callable[[torch.Tensor], torch.Tensor],
    batch: Dict[str, torch.Tensor],
    lr: float,
    generator: torch.Generator,
) -> Dict[str, torch.Tensor]:
    """One step on `batch` ("audio" (B, L), "audio_lens" (B,), on the
    model's device); returns the loss and clip_scale (device tensors), the
    lr and the sample count."""
    audio, lens = batch["audio"], batch["audio_lens"]
    with torch.no_grad():
        cond = mel_fn(audio)
    draws = model.draw(audio, cond.shape[-1], generator, train=True)
    loss = model(cond, audio, lens, draws)
    optimizer.zero_grad()
    loss.backward()
    optimizer.step(lr)
    return {"loss": loss.detach(), "lr": lr, "clip_scale": optimizer.clip_scale,
            "samples": audio.shape[0]}


@torch.no_grad()
def fm_eval_loss(
    model: MelAudioGenerator,
    mel_fn: Callable[[torch.Tensor], torch.Tensor],
    batch: Dict[str, torch.Tensor],
    generator: torch.Generator,
) -> torch.Tensor:
    """Validation loss: t and x0 drawn, the eval form otherwise (no gates,
    no branch dropout, no mel noise)."""
    audio, lens = batch["audio"], batch["audio_lens"]
    cond = mel_fn(audio)
    return model(cond, audio, lens, model.draw(audio, cond.shape[-1], generator, train=False))
