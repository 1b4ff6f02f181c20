"""The GAN stage's losses, counterpart of `flow2gan_tpu/models/gan.py`: hinge
losses for the discriminators and the generator, L1 feature matching with
the real side detached, and the multi-scale log-mel L1 reconstruction loss.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from flow2gan_tpu_torch.ops.mel import MelSpectrogram
from flow2gan_tpu_torch.utils import safe_log


def discriminator_loss(score_real: List[torch.Tensor], score_fake: List[torch.Tensor]) -> torch.Tensor:
    """Hinge D loss: sum over discriminators of mean(relu(1 - real)) +
    mean(relu(1 + fake))."""
    loss = 0.0
    for s_real, s_fake in zip(score_real, score_fake):
        loss = loss + torch.relu(1.0 - s_real).mean() + torch.relu(1.0 + s_fake).mean()
    return loss


def generator_loss(score_fake: List[torch.Tensor]) -> torch.Tensor:
    """Hinge G loss: sum over discriminators of mean(relu(1 - fake))."""
    loss = 0.0
    for s_fake in score_fake:
        loss = loss + torch.relu(1.0 - s_fake).mean()
    return loss


def feature_matching_loss(fmap_real: List[List[torch.Tensor]],
                          fmap_fake: List[List[torch.Tensor]]) -> torch.Tensor:
    """Sum of mean |real - fake| over every feature map; the real side is
    detached."""
    loss = 0.0
    for f_real, f_fake in zip(fmap_real, fmap_fake):
        for r, f in zip(f_real, f_fake):
            loss = loss + (r.detach() - f).abs().mean()
    return loss


def make_mel_recon_fns(
    sampling_rate: int,
    mel_recon_n_ffts: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048),
    mel_recon_n_mels: Sequence[int] = (5, 10, 20, 40, 80, 160, 320),
) -> nn.ModuleList:
    """The mel frontends of the multi-scale loss (hop n_fft // 4, power 1),
    as a module list so that `.to(device)` moves their filterbanks."""
    return nn.ModuleList(
        MelSpectrogram(sampling_rate=sampling_rate, n_fft=n_fft, hop_length=n_fft // 4,
                       n_mels=n_mels, power=1.0)
        for n_fft, n_mels in zip(mel_recon_n_ffts, mel_recon_n_mels)
    )


def mel_recon_loss(real: torch.Tensor, fake: torch.Tensor, mel_fns) -> torch.Tensor:
    """Sum over scales of mean |log mel(real) - log mel(fake)|."""
    loss = 0.0
    for fn in mel_fns:
        loss = loss + (safe_log(fn(real)) - safe_log(fn(fake))).abs().mean()
    return loss
