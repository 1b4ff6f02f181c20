"""The FM pretraining step and the validation loss, counterpart of
`flow2gan_tpu/training/train_step.py`: the conditioning frontend (the
log-mel, or the tokenizer of a token config), the loss with its draws,
backward, the ScaledAdam update and the step's metrics.

Randomness: one `torch.Generator` per step on the model's device, seeded
from (seed, batch index) by `step_generator`, the port's `fold_in`. The step
reads nothing back from the device: its metrics are device tensors, and the
trainer fetches them once per step.

In a multi-process run (`parallel.dist`) each rank holds its rows of the
global batch; the step draws for the global batch, divides its masked sum by
the global count, sums the gradients and the loss over the ranks, and so
equals one process on the global batch. The loss it returns is the global
loss on every rank.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.models.generator import BaseAudioGenerator
from flow2gan_tpu_torch.parallel import dist
from flow2gan_tpu_torch.training.optim import ScaledAdam


def step_generator(seed: int, batch_idx: int, device: torch.device) -> torch.Generator:
    """The generator of batch `batch_idx` under `seed`, on `device`."""
    return torch.Generator(device=device).manual_seed((seed * 1_000_003 + batch_idx) % 2**63)


def _global_count(model: BaseAudioGenerator, audio: torch.Tensor,
                  lens: torch.Tensor) -> torch.Tensor:
    """The loss denominator of the global batch (this rank's count where
    there is one rank)."""
    count = model.loss_count(lens, audio.shape[-1])
    dist.all_reduce_sum_([count])
    return count


def fm_train_step(
    model: BaseAudioGenerator,
    optimizer: ScaledAdam,
    cond_fn: Callable[[torch.Tensor], torch.Tensor],
    batch: Dict[str, torch.Tensor],
    lr: float,
    generator: torch.Generator,
) -> Dict[str, torch.Tensor]:
    """One step on `batch` ("audio" (B, L), "audio_lens" (B,), on the
    model's device: this rank's rows of the global batch), conditioned on
    `cond_fn(audio)`; returns the
    global loss and clip_scale (device tensors), the lr and this rank's
    sample count."""
    with tracing.span("fm.step", root=True):
        audio, lens = batch["audio"], batch["audio_lens"]
        with tracing.span("fm.frontend"), torch.no_grad():
            cond = cond_fn(audio)
        shard = dist.shard()
        with tracing.span("fm.draws"):
            draws = model.draw(audio, cond.shape[-1], generator, train=True, shard=shard)
        with tracing.span("fm.forward"):
            count = _global_count(model, audio, lens) if shard.count > 1 else None
            loss = model(cond, audio, lens, draws, count=count)
        with tracing.span("fm.backward"):
            optimizer.zero_grad()
            loss.backward()
        loss = loss.detach()
        with tracing.span("dist.grads"):
            dist.all_reduce_grads_([p for g in optimizer.groups for p in g.params], [loss])
        optimizer.step(lr)
    return {"loss": loss, "lr": lr, "clip_scale": optimizer.clip_scale,
            "samples": audio.shape[0]}


@torch.no_grad()
def fm_eval_loss(
    model: BaseAudioGenerator,
    cond_fn: Callable[[torch.Tensor], torch.Tensor],
    batch: Dict[str, torch.Tensor],
    generator: torch.Generator,
) -> torch.Tensor:
    """Validation loss of the global batch: t and x0 drawn, the eval form
    otherwise (no gates, no branch dropout, no mel noise)."""
    audio, lens = batch["audio"], batch["audio_lens"]
    cond = cond_fn(audio)
    shard = dist.shard()
    draws = model.draw(audio, cond.shape[-1], generator, train=False, shard=shard)
    count = _global_count(model, audio, lens) if shard.count > 1 else None
    loss = model(cond, audio, lens, draws, count=count)
    dist.all_reduce_sum_([loss])
    return loss
