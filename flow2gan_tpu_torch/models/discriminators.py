"""HiFi-GAN multi-period and DAC-style multi-resolution discriminators of the
GAN stage, counterpart of `flow2gan_tpu/models/discriminators.py`, in NCHW.

- `DiscriminatorP`: reflect-pad the time axis to a multiple of the period,
  fold (B, T) into (B, 1, T/p, p), five (5, 1) convs with 32/128/512/1024/1024
  channels, stride (3, 1) four times then (1, 1), each followed by
  leaky_relu(0.1), then a (3, 1) `conv_post`. Feature maps: convs 1..4 and
  `conv_post`.
- `DiscriminatorR`: remove DC, normalise to 0.8 of the peak, STFT at hop w/4;
  real and imaginary parts are 2 input channels (B, 2, T, F), split into 5
  frequency bands, each through (3, 9) convs (strides (1, 1), then (1, 2)
  three times) and a (3, 3) conv; the bands are concatenated on the
  frequency axis (dim 3) before a (3, 3) `conv_post`.

Module names follow the flax tree (`discriminator_0.discriminators.<i>.convs.<j>`,
`discriminator_1.discriminators.<i>.band_convs.<b>.<j>`), so
`compat/from_jax.py` carries a JAX tree by renaming. `init_discriminators`
draws flax's default init.

`num_embeddings` gives a sub-discriminator (and the MPD and MRD bundles,
each of theirs) the reference's conditional term: a zero-initialised `emb`
table of the last conv's width, and with a `cond_embedding_id` (B,) the
score gains h = sum over channels of emb[id] * x, x the input of
`conv_post`, added after `conv_post` (whose feature map stays without it),
where the JAX package adds it. `Discriminators` builds none, as in the JAX
package.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.ops.stft import stft

Judgement = Tuple[List[torch.Tensor], List[List[torch.Tensor]]]  # (scores, fmaps), one each


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.1)


def _embedding(num_embeddings: Optional[int], dim: int) -> Optional[nn.Embedding]:
    if num_embeddings is None:
        return None
    emb = nn.Embedding(num_embeddings, dim)
    nn.init.zeros_(emb.weight)
    return emb


def _post(conv_post: nn.Conv2d, emb: Optional[nn.Embedding], x: torch.Tensor,
          cond_embedding_id: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv_post(x), and that plus the embedding term where there is one:
    (feature map, score)."""
    out = conv_post(x)
    if emb is None or cond_embedding_id is None:
        return out, out
    h = (emb(cond_embedding_id)[:, :, None, None] * x).sum(dim=1, keepdim=True)
    return out, out + h


class DiscriminatorP(nn.Module):
    CHANNELS = (32, 128, 512, 1024, 1024)  # the five convs' outputs

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3, *,
                 num_embeddings: Optional[int] = None):
        super().__init__()
        self.period = period
        channels = (1, *self.CHANNELS)
        strides = [stride] * 4 + [1]
        self.convs = nn.ModuleList(
            nn.Conv2d(channels[i], channels[i + 1], (kernel_size, 1), (strides[i], 1),
                      padding=(kernel_size // 2, 0))
            for i in range(5)
        )
        self.conv_post = nn.Conv2d(channels[-1], 1, (3, 1), padding=(1, 0))
        self.emb = _embedding(num_embeddings, channels[-1])

    def forward(self, x: torch.Tensor, cond_embedding_id: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(B, T) -> score (B, N) and the five feature maps."""
        b, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x[:, None], (0, p - t % p), mode="reflect")[:, 0]
            t = x.shape[1]
        x = x.reshape(b, 1, t // p, p)
        fmap = []
        for i, conv in enumerate(self.convs):
            x = _leaky(conv(x))
            if i > 0:
                fmap.append(x)
        out, x = _post(self.conv_post, self.emb, x, cond_embedding_id)
        fmap.append(out)
        return x.flatten(1), fmap


class DiscriminatorR(nn.Module):
    BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))

    def __init__(self, window_length: int, channels: int = 32, hop_factor: float = 0.25, *,
                 num_embeddings: Optional[int] = None):
        super().__init__()
        self.window_length = window_length
        self.hop_length = int(window_length * hop_factor)
        n_bins = window_length // 2 + 1
        self.bands = [(int(b0 * n_bins), int(b1 * n_bins)) for b0, b1 in self.BANDS]

        def stack():
            convs = [nn.Conv2d(2, channels, (3, 9), padding=(1, 4))]
            convs += [nn.Conv2d(channels, channels, (3, 9), (1, 2), padding=(1, 4))
                      for _ in range(3)]
            convs.append(nn.Conv2d(channels, channels, (3, 3), padding=(1, 1)))
            return nn.ModuleList(convs)

        self.band_convs = nn.ModuleList(stack() for _ in self.bands)
        self.conv_post = nn.Conv2d(channels, 1, (3, 3), padding=(1, 1))
        self.emb = _embedding(num_embeddings, channels)

    def spectrogram(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, 2, frames, n_bins): the DC-free, peak-normalised
        signal's STFT, real and imaginary parts as channels."""
        x = x - x.mean(dim=-1, keepdim=True)
        x = 0.8 * x / (x.abs().amax(dim=-1, keepdim=True) + 1e-9)
        spec = stft(x, self.window_length, self.hop_length)
        return torch.stack([spec.real, spec.imag], dim=1)

    def forward(self, x: torch.Tensor, cond_embedding_id: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(B, T) -> score (B, 1, frames, F') and the 21 feature maps."""
        z = self.spectrogram(x)
        fmap, outs = [], []
        for (b0, b1), convs in zip(self.bands, self.band_convs):
            band = z[..., b0:b1]
            for i, conv in enumerate(convs):
                band = _leaky(conv(band))
                if i > 0:
                    fmap.append(band)
            outs.append(band)
        out, x = _post(self.conv_post, self.emb, torch.cat(outs, dim=3), cond_embedding_id)
        fmap.append(out)
        return x, fmap


class _MultiDiscriminator(nn.Module):
    """A list of sub-discriminators, each judging a signal on its own."""

    def judge(self, x: torch.Tensor, bandwidth_id: Optional[torch.Tensor] = None) -> Judgement:
        """Every sub-discriminator's score and feature maps for (B, T) x,
        conditioned on `bandwidth_id` where they have embeddings."""
        scores, fmaps = [], []
        for d in self.discriminators:
            score, fmap = d(x, bandwidth_id)
            scores.append(score)
            fmaps.append(fmap)
        return scores, fmaps

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor,
                bandwidth_id: Optional[torch.Tensor] = None):
        """(scores real, scores fake, fmaps real, fmaps fake), as the JAX
        module returns them."""
        real, fake = self.judge(y, bandwidth_id), self.judge(y_hat, bandwidth_id)
        return real[0], fake[0], real[1], fake[1]


class MultiPeriodDiscriminator(_MultiDiscriminator):
    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11), *,
                 num_embeddings: Optional[int] = None):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorP(p, num_embeddings=num_embeddings)
                                            for p in periods)


class MultiResolutionDiscriminator(_MultiDiscriminator):
    def __init__(self, fft_sizes: Sequence[int] = (2048, 1024, 512), *,
                 num_embeddings: Optional[int] = None):
        super().__init__()
        self.discriminators = nn.ModuleList(DiscriminatorR(w, num_embeddings=num_embeddings)
                                            for w in fft_sizes)


class Discriminators(nn.Module):
    """The MPD (`discriminator_0`) and the MRD (`discriminator_1`)."""

    def __init__(self, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 fft_sizes: Sequence[int] = (2048, 1024, 512)):
        super().__init__()
        self.discriminator_0 = MultiPeriodDiscriminator(periods)
        self.discriminator_1 = MultiResolutionDiscriminator(fft_sizes)

    def judge(self, x: torch.Tensor) -> Tuple[Judgement, Judgement]:
        """(MPD, MRD) judgements of one signal, each in a `gan.judge` span
        (index 0 and 1) with device time."""
        out = []
        for i, d in enumerate((self.discriminator_0, self.discriminator_1)):
            with tracing.span("gan.judge", i, device=x.device):
                out.append(d.judge(x))
        return out[0], out[1]

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        return self.discriminator_0(y, y_hat), self.discriminator_1(y, y_hat)


@torch.no_grad()
def init_discriminators(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """flax's default init, drawn from `generator`: LeCun-normal kernels (a
    normal truncated at 2 std, rescaled so that its std is
    sqrt(1 / fan_in), fan_in = in_channels * kh * kw) and zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            nn.init.zeros_(m.bias)
    return module
