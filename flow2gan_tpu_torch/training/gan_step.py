"""The GAN fine-tuning steps (stage 2), counterpart of
`flow2gan_tpu/training/gan_step.py`.

- The D step rolls the generator out in eval form under `torch.no_grad()`
  (JAX's `stop_gradient`: no graph is recorded), judges the real and the
  generated audio, and updates the discriminators.
- The G step rolls out in train form, differentiating the whole n-step
  Euler solve (3n fused-iSTFT launches forward, 3n adjoint launches
  backward), judges the result with the discriminators, the real audio's
  judgement under `no_grad`, and updates the generator only: backward is
  asked for the generator's parameters alone, so the discriminators get no
  gradient and their optimizer does not move.
- The eval step is the G objective in eval form, under `no_grad`.

Each optimizer's Eden2 lr is read from its own update count, as in the JAX
package. The draws of a step are one `RolloutDraws`, made by the caller
(`BaseAudioGenerator.draw_rollout`, or a test). The steps read nothing back
from the device: their metrics are device tensors. The JAX package's scanned
rollout exists only for the TPU compiler and is not ported; `remat_rollout`
recomputes each Euler step in backward instead of keeping its activations.

Spans (`tracing`, off by default): each training step is a root span with
device time, `gan.d_step` or `gan.g_step`, counted by `gan.d_steps` and
`gan.g_steps`; inside it `gan.rollout` (the generator's solve, the eval form
in D and the train form in G), `gan.judge` (`Discriminators.judge`'s,
once per signal judged), `gan.losses` (the loss terms) and `gan.backward`
(device).

In a multi-process run (`parallel.dist`) each rank holds its rows of the
global batch and the draws are the global batch's rows (`draw_rollout`'s
shard). Every loss term is a mean over equal-size per-row blocks, so a
rank's objective is its mean divided by the world size, its share of the
global mean; the steps sum the moved side's gradients and the metrics over
the ranks and so equal one process on the global batch.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.models.discriminators import Discriminators
from flow2gan_tpu_torch.models.gan import (
    discriminator_loss,
    feature_matching_loss,
    generator_loss,
    mel_recon_loss,
)
from flow2gan_tpu_torch.models.generator import BaseAudioGenerator, RolloutDraws
from flow2gan_tpu_torch.parallel import dist
from flow2gan_tpu_torch.training.optim import ScaledAdam

Batch = Dict[str, torch.Tensor]  # "audio" (B, L), "audio_lens" (B,)
Metrics = Dict[str, torch.Tensor]


class GANLossScales(NamedTuple):
    """The loss weights; the defaults are the reference trainer's."""

    disc_mp: float = 1.0
    disc_mr: float = 0.1
    gen_mp: float = 1.0
    gen_mr: float = 0.1
    fmap_mp: float = 1.0
    fmap_mr: float = 0.1
    mel_recon: float = 45.0


def make_gan_loss_fns(
    generator: BaseAudioGenerator,
    discriminators: Discriminators,
    cond_fn: Callable[[torch.Tensor], torch.Tensor],
    mel_recon_fns,
    n_timesteps: int = 1,
    scales: GANLossScales = GANLossScales(),
    remat_rollout: bool = False,
):
    """The D and G objectives, each (batch, draws) -> (loss, metrics), the
    rollout conditioned on `cond_fn(audio)` (the log-mel, or the tokenizer
    of a token config; the mel reconstruction loss keeps `mel_recon_fns`).
    The D objective rolls out in eval form whatever `draws` holds; the G
    objective in the form `draws` gives (train form with gates)."""

    def fake_audio(batch: Batch, cond: torch.Tensor, draws: RolloutDraws, remat: bool):
        with tracing.span("gan.rollout"):
            fake = generator.rollout(cond, draws, batch["audio_lens"], n_timesteps, remat=remat)
        return fake[..., : batch["audio"].shape[-1]]

    def d_loss_fn(batch: Batch, draws: RolloutDraws) -> Tuple[torch.Tensor, Metrics]:
        audio = batch["audio"]
        with torch.no_grad():
            fake = fake_audio(batch, cond_fn(audio), RolloutDraws(draws.x0), remat=False)
        real_mp, real_mr = discriminators.judge(audio)
        fake_mp, fake_mr = discriminators.judge(fake)
        with tracing.span("gan.losses"):
            disc_mp = discriminator_loss(real_mp[0], fake_mp[0])
            disc_mr = discriminator_loss(real_mr[0], fake_mr[0])
            loss = scales.disc_mp * disc_mp + scales.disc_mr * disc_mr
        return loss, {"loss_d": loss, "disc_loss_mp": disc_mp, "disc_loss_mr": disc_mr}

    def g_loss_fn(batch: Batch, draws: RolloutDraws) -> Tuple[torch.Tensor, Metrics]:
        audio = batch["audio"]
        with torch.no_grad():
            cond = cond_fn(audio)
            real_mp, real_mr = discriminators.judge(audio)
        fake = fake_audio(batch, cond, draws, remat=remat_rollout)
        fake_mp, fake_mr = discriminators.judge(fake)
        with tracing.span("gan.losses"):
            metrics = {
                "gen_loss_mp": generator_loss(fake_mp[0]),
                "gen_loss_mr": generator_loss(fake_mr[0]),
                "feat_map_loss_mp": feature_matching_loss(real_mp[1], fake_mp[1]),
                "feat_map_loss_mr": feature_matching_loss(real_mr[1], fake_mr[1]),
                "mel_recon_loss": mel_recon_loss(audio, fake, mel_recon_fns),
            }
            loss = (scales.gen_mp * metrics["gen_loss_mp"] + scales.gen_mr * metrics["gen_loss_mr"]
                    + scales.fmap_mp * metrics["feat_map_loss_mp"]
                    + scales.fmap_mr * metrics["feat_map_loss_mr"]
                    + scales.mel_recon * metrics["mel_recon_loss"])
        return loss, {"loss_g": loss, **metrics}

    return d_loss_fn, g_loss_fn


def _global(metrics: Metrics, params) -> Metrics:
    """The metrics of one rank's objective, detached and summed over the
    ranks together with `params`' gradients (each a 1/world share already);
    in one process just detached."""
    out = {k: v.detach() for k, v in metrics.items()}
    dist.all_reduce_grads_(params, list(out.values()))
    return out


def _share(loss_fn, world: int):
    """`loss_fn` with its loss and metrics divided by the world size: a
    rank's share of the global batch's means."""
    if world == 1:
        return loss_fn

    def share(batch: Batch, draws: RolloutDraws):
        loss, metrics = loss_fn(batch, draws)
        return loss / world, {k: v / world for k, v in metrics.items()}

    return share


def make_gan_steps(
    generator: BaseAudioGenerator,
    discriminators: Discriminators,
    cond_fn: Callable[[torch.Tensor], torch.Tensor],
    mel_recon_fns,
    optimizer_g: ScaledAdam,
    optimizer_d: ScaledAdam,
    lr_g_fn: Callable[[int], float],
    lr_d_fn: Callable[[int], float],
    n_timesteps: int = 1,
    scales: GANLossScales = GANLossScales(),
    remat_rollout: bool = False,
    keep_grads: bool = False,
):
    """(d_step, g_step, eval_step), each (batch, draws) -> metrics; the two
    training steps update their side in place and free its gradients, or
    with `keep_grads` leave them in `.grad` until that side's next step
    (`--inf-check` ranks them when the step was clipped to zero). The D/G
    alternation is the caller's loop. The metrics are the global batch's on
    every rank."""
    world = dist.world_size()
    d_loss_fn, g_loss_fn = (_share(fn, world) for fn in make_gan_loss_fns(
        generator, discriminators, cond_fn, mel_recon_fns, n_timesteps, scales, remat_rollout))
    params_g = [p for g in optimizer_g.groups for p in g.params]
    params_d = [p for g in optimizer_d.groups for p in g.params]

    def train_step(side: str, loss_fn, optimizer: ScaledAdam, params, lr_fn, batch: Batch,
                   draws: RolloutDraws) -> Metrics:
        device = batch["audio"].device
        with tracing.span(f"gan.{side}_step", root=True, device=device):
            tracing.count(f"gan.{side}_steps")
            loss, metrics = loss_fn(batch, draws)
            optimizer.zero_grad()
            with tracing.span("gan.backward", device=device):
                loss.backward(inputs=params)
            metrics = _global(metrics, params)
            lr = lr_fn(optimizer.step_count)
            optimizer.step(lr)
            if not keep_grads:
                optimizer.zero_grad()
        return {**metrics, f"lr_{side}": lr, "clip_scale": optimizer.clip_scale,
                "samples": batch["audio"].shape[0]}

    def d_step(batch: Batch, draws: RolloutDraws) -> Metrics:
        return train_step("d", d_loss_fn, optimizer_d, params_d, lr_d_fn, batch, draws)

    def g_step(batch: Batch, draws: RolloutDraws) -> Metrics:
        return train_step("g", g_loss_fn, optimizer_g, params_g, lr_g_fn, batch, draws)

    @torch.no_grad()
    def eval_step(batch: Batch, draws: RolloutDraws) -> Metrics:
        metrics = g_loss_fn(batch, RolloutDraws(draws.x0))[1]
        dist.all_reduce_sum_(list(metrics.values()))
        return metrics

    return d_step, g_step, eval_step
