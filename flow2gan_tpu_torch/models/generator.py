"""Flow-matching generators (endpoint / x1-prediction form), counterpart of
`flow2gan_tpu/models/generator.py`: the Euler solve that serves, and the
flow-matching loss that pretrains.

`BaseAudioGenerator` holds the branches, the solve and the loss;
`MelAudioGenerator` is conditioned on log-mels, (B, n_mels, frames) in the
reference layout, transposed once to channels-last; `TokenAudioGenerator` on
discrete tokens (B, frames) through an embedding table (`ops/tokenizer.py`
makes them). Either way the conditioning's last axis is its frames, one per
`cond_hop_length` samples.

The Euler solve is an unrolled Python loop over 1/2/4 steps. The JAX
package's scanned and rematerialised rollouts exist only for the TPU
compiler's limits and are not ported.

The loss's random draws (x0, t, the limiters' gates, the branch-dropout
weights, the mel noise) are one `FMDraws`: training draws it on the device
from a `torch.Generator` (`draw`), a test builds it from numpy, since JAX and
torch draw different numbers from one seed.

The GAN stage differentiates the whole n-step solve in train form
(`rollout`), whose draws are one `RolloutDraws` (`draw_rollout`): x0, and
the limiters' gates of each Euler step. The JAX package draws a fresh gate at
every limiter call, so the cond encoder's limiters draw once per rollout and
each branch's once per step.

In a multi-process run each process holds its rows of the global batch
(`Shard`): the draws are made for the global batch from the step's
generator on every rank, and each rank takes its rows, so that the run
equals one process on the global batch. The loss of one rank is then its
masked sum over the global batch's count (`loss_count`, summed over the
ranks by the caller), its share of the global loss.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Sequence

import torch
import torch.utils.checkpoint
from torch import nn

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.models.convnext import AudioConvNeXt, CondEncoder
from flow2gan_tpu_torch.models.norms import number_limiters
from flow2gan_tpu_torch.ops.mel import linear_fbanks, linear_filter_spectrogram
from flow2gan_tpu_torch.ops.stft import num_frames, stft_lens
from flow2gan_tpu_torch.parallel.dist import Shard
from flow2gan_tpu_torch.utils import make_valid_mask


@dataclasses.dataclass
class FMDraws:
    """The random draws of one flow-matching loss.

    x0: (B, L) noise endpoint, already scaled by `init_noise_scale`;
    t: (B,) flow times in [0, 1);
    gates: (n_limiters,) 0/1 floats, or None for the eval form;
    branch_weight: (B, n_branches) branch-dropout weights, or None;
    cond_noise: (B, frames, n_mels) noise added to the mels, or None (always
    for tokens).
    """

    x0: torch.Tensor
    t: torch.Tensor
    gates: Optional[torch.Tensor] = None
    branch_weight: Optional[torch.Tensor] = None
    cond_noise: Optional[torch.Tensor] = None


@dataclasses.dataclass
class RolloutDraws:
    """The random draws of one Euler rollout.

    x0: (B, frames * cond_hop_length) noise endpoint, already scaled by
    `init_noise_scale`;
    gates: (n_timesteps, n_limiters) 0/1 floats, or None for the eval form.
    Row s gates the branches' limiters at Euler step s; the cond encoder,
    which runs once, reads its own limiters' entries of row 0.
    """

    x0: torch.Tensor
    gates: Optional[torch.Tensor] = None


def branch_dropout_weight(branch_idx: torch.Tensor, do_drop: torch.Tensor,
                          num_branches: int) -> torch.Tensor:
    """(B, num_branches) weights: for the examples where `do_drop` (B, 1) is
    true, branch `branch_idx` (B,) is zeroed and the others scaled by
    nb / (nb - 1), so the expectation is unchanged; 1 elsewhere (the JAX
    package's `process_model`)."""
    rows = torch.arange(branch_idx.shape[0], device=branch_idx.device)
    mask = torch.ones(branch_idx.shape[0], num_branches, device=branch_idx.device)
    mask[rows, branch_idx] = 0.0
    mask = mask * (num_branches / (num_branches - 1))
    return torch.where(do_drop, mask, torch.ones_like(mask))


@contextlib.contextmanager
def _recomputing():
    """Around `checkpoint`'s recompute of an Euler step in backward."""
    tracing.count("solve.recomputed_steps")
    yield


class BaseAudioGenerator(nn.Module):
    """Multi-branch endpoint-FM generator on encoded conditioning of
    `cond_dim` channels, one frame per `cond_hop_length` samples; the
    subclasses turn their conditioning into it (`_encode_cond`)."""

    def __init__(
        self,
        cond_dim: int = 100,
        cond_hop_length: int = 256,
        n_ffts: Sequence[int] = (512, 256, 128),
        hop_lengths: Sequence[int] = (256, 128, 64),
        channels: Sequence[int] = (768, 512, 384),
        time_embed_channels: int = 512,
        hidden_factor: int = 3,
        conv_kernel_sizes: Sequence[int] = (7, 7, 7),
        num_layers: Sequence[int] = (8, 8, 8),
        use_cond_encoder: bool = True,
        cond_enc_channels: int = 512,
        cond_enc_hidden_factor: int = 3,
        cond_enc_conv_kernel_size: int = 7,
        cond_enc_num_layers: int = 4,
        use_residual_scale: bool = True,
        init_noise_scale: float = 0.1,
        pred_x1: bool = True,
        branch_reduction: str = "mean",
        sampling_rate: int = 24000,
        spec_scaling_loss: bool = True,
        loss_n_filters: int = 256,
        loss_n_fft: int = 1024,
        loss_hop_length: int = 256,
        loss_power: float = 0.5,
        loss_eps: float = 1e-7,
        loss_scale_min: float = 1e-2,
        loss_scale_max: float = 1e2,
        branch_dropout: float = 0.05,
        compute_dtype: Optional[str] = None,
    ):
        super().__init__()
        # the ConvNeXt stacks' compute dtype ("bfloat16"; None is float32);
        # the parameters, the STFTs, the Euler state and the loss stay float32
        dtype = getattr(torch, compute_dtype) if compute_dtype else None
        n = len(n_ffts)
        if not (len(hop_lengths) == len(channels) == len(conv_kernel_sizes) == len(num_layers) == n):
            raise ValueError("per-branch config tuples must all have one entry per branch")
        if branch_reduction not in ("mean", "sum"):
            raise ValueError(f"branch_reduction must be 'mean' or 'sum', got {branch_reduction!r}")
        self.cond_dim = cond_dim
        self.cond_hop_length = cond_hop_length
        self.init_noise_scale = init_noise_scale
        self.pred_x1 = pred_x1
        self.branch_reduction = branch_reduction
        self.spec_scaling_loss = spec_scaling_loss
        self.loss_n_fft = loss_n_fft
        self.loss_hop_length = loss_hop_length
        self.loss_power = loss_power
        self.loss_eps = loss_eps
        self.loss_scale_min = loss_scale_min
        self.loss_scale_max = loss_scale_max
        self.branch_dropout = branch_dropout
        self.cond_encoder = (
            CondEncoder(
                cond_dim=cond_dim,
                channels=cond_enc_channels,
                hidden_factor=cond_enc_hidden_factor,
                conv_kernel_size=cond_enc_conv_kernel_size,
                num_layers=cond_enc_num_layers,
                use_residual_scale=use_residual_scale,
                dtype=dtype,
            )
            if use_cond_encoder
            else None
        )
        self.estimators = nn.ModuleList(
            AudioConvNeXt(
                n_fft=n_ffts[i],
                hop_length=hop_lengths[i],
                cond_hop_length=cond_hop_length,
                channels=channels[i],
                cond_channels=cond_enc_channels if use_cond_encoder else cond_dim,
                time_embed_channels=time_embed_channels,
                hidden_factor=hidden_factor,
                conv_kernel_size=conv_kernel_sizes[i],
                num_layers=num_layers[i],
                use_residual_scale=use_residual_scale,
                dtype=dtype,
            )
            for i in range(n)
        )
        # each limiter runs once per loss, so one gate each
        self.num_limiters = number_limiters(self)
        fb = linear_fbanks(loss_n_fft // 2 + 1, 0.0, float(sampling_rate // 2), loss_n_filters,
                           sampling_rate)
        self.register_buffer("loss_fbank", torch.from_numpy(fb), persistent=False)

    def process_model(
        self,
        x: torch.Tensor,
        cond: torch.Tensor,
        t: torch.Tensor,
        audio_lens: Optional[torch.Tensor] = None,
        gates: Optional[torch.Tensor] = None,
        branch_weight: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Run every branch on waveform x (B, L) at flow time t (B,) and fuse,
        each example's branches weighted by `branch_weight` (B, n_branches)
        where branch dropout is on."""
        outs = []
        for i, est in enumerate(self.estimators):
            with tracing.span("branch", i):
                outs.append(est(x, cond, t, audio_lens=audio_lens, gates=gates))
        outs = torch.stack(outs, dim=1)
        if branch_weight is not None:
            outs = outs * branch_weight[..., None]
        return outs.mean(dim=1) if self.branch_reduction == "mean" else outs.sum(dim=1)

    def _loss_spec(self, audio: torch.Tensor) -> torch.Tensor:
        """Linear-filterbank power spectrogram, time-major (B, T_s, n_filters)."""
        return linear_filter_spectrogram(audio, self.loss_fbank, self.loss_n_fft,
                                         self.loss_hop_length)

    def _loss_mask(self, audio_lens: torch.Tensor, length: int) -> torch.Tensor:
        """The loss's mask over the samples (B, L), or with
        `spec_scaling_loss` over the loss spectrogram's frames (B, T_s, 1)."""
        if not self.spec_scaling_loss:
            return make_valid_mask(audio_lens, length)
        frames = num_frames(length, self.loss_hop_length)
        return make_valid_mask(stft_lens(audio_lens, self.loss_hop_length), frames)[..., None]

    def loss_count(self, audio_lens: torch.Tensor, length: int) -> torch.Tensor:
        """The denominator of `compute_loss` for a batch of (B, `length`)
        waveforms: the masked element count."""
        count = self._loss_mask(audio_lens, length).sum()
        return count * self.loss_fbank.shape[-1] if self.spec_scaling_loss else count

    def compute_loss(
        self,
        pred: torch.Tensor,
        ref: torch.Tensor,
        audio_lens: torch.Tensor,
        gt_audio: Optional[torch.Tensor] = None,
        count: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Masked MSE, or with `spec_scaling_loss` the squared error's
        linear-filterbank power spectrum weighted by (gt power + eps)^-power,
        clamped to [loss_scale_min, loss_scale_max], which up-weights quiet
        spectral regions. The masked sum is divided by `count` where given
        (the global batch's `loss_count`), else by this batch's."""
        err = pred - ref
        mask = self._loss_mask(audio_lens, err.shape[-1])
        if not self.spec_scaling_loss:
            total = (err**2 * mask).sum()
            return total / (mask.sum() if count is None else count)
        if gt_audio is None:
            raise ValueError("the spectral-energy-scaled loss needs gt_audio")
        gt_spec = self._loss_spec(gt_audio)
        err_spec = self._loss_spec(err)
        spec_scale = torch.clamp((gt_spec + self.loss_eps) ** -self.loss_power,
                                 min=self.loss_scale_min, max=self.loss_scale_max)
        total = (err_spec * spec_scale * mask).sum()
        return total / ((mask.sum() * err_spec.shape[-1]) if count is None else count)

    def flow_matching_loss(
        self,
        x0: torch.Tensor,
        x1: torch.Tensor,
        cond: torch.Tensor,
        audio_lens: torch.Tensor,
        t: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        gates: Optional[torch.Tensor] = None,
        branch_weight: Optional[torch.Tensor] = None,
        count: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """FM loss with the endpoint target at flow time t (B,), drawn from
        `generator` when not given; cond is encoded, channels-last."""
        if t is None:
            t = torch.rand(x0.shape[0], generator=generator, device=x0.device)
        x = (1.0 - t[:, None]) * x0 + t[:, None] * x1
        ref = x1 if self.pred_x1 else x1 - x0
        pred = self.process_model(x, cond, t, audio_lens=audio_lens, gates=gates,
                                  branch_weight=branch_weight)
        return self.compute_loss(pred, ref, audio_lens, gt_audio=x1, count=count)

    def draw(self, audio: torch.Tensor, n_frames: int, generator: torch.Generator,
             train: bool = True, shard: Shard = Shard()) -> FMDraws:
        """The draws of one loss on (B, L) `audio` with `n_frames`
        conditioning frames, from `generator` (on audio's device): x0 ~ N(0,
        init_noise_scale^2), t ~ U(0, 1); in training also the gates
        (Bernoulli 0.6), branch dropout and the mel noise (`_cond_noise`), as
        far as the config turns them on.
        `audio` is `shard`'s rows of the global batch: every draw is made for
        the global batch and cut to those rows (the gates, one per limiter,
        are whole)."""
        b, dev = audio.shape[0] * shard.count, audio.device
        x0 = shard.rows(torch.randn((b, audio.shape[-1]), generator=generator, device=dev)
                        * self.init_noise_scale)
        t = shard.rows(torch.rand(b, generator=generator, device=dev))
        if not train:
            return FMDraws(x0, t)
        gates = (torch.rand(self.num_limiters, generator=generator, device=dev) < 0.6).float()
        weight = None
        nb = len(self.estimators)
        if self.branch_dropout > 0.0 and nb > 1:
            idx = torch.randint(0, nb, (b,), generator=generator, device=dev)
            drop = torch.rand(b, 1, generator=generator, device=dev) < self.branch_dropout
            weight = shard.rows(branch_dropout_weight(idx, drop, nb))
        noise = self._cond_noise(b, n_frames, generator, dev)
        return FMDraws(x0, t, gates, weight, None if noise is None else shard.rows(noise))

    def _cond_noise(self, batch: int, n_frames: int, generator: torch.Generator,
                    device) -> Optional[torch.Tensor]:
        """The noise added to the conditioning in training, (batch, n_frames,
        cond_dim), or None: none by default."""
        return None

    def forward(self, cond: torch.Tensor, audio: torch.Tensor, audio_lens: torch.Tensor,
                draws: FMDraws, count: Optional[torch.Tensor] = None) -> torch.Tensor:
        """FM loss. cond: the subclass's conditioning, frames on its last
        axis; audio: (B, L); `count` as in `compute_loss`."""
        with tracing.span("cond_encoder"):
            cond = self._encode_cond(cond, draws.cond_noise, draws.gates)
        return self.flow_matching_loss(draws.x0, audio, cond, audio_lens, t=draws.t,
                                       gates=draws.gates, branch_weight=draws.branch_weight,
                                       count=count)

    def _euler_step(self, x: torch.Tensor, cond: torch.Tensor, t: float, dt: float,
                    audio_lens: Optional[torch.Tensor], gates: Optional[torch.Tensor]):
        t_vec = torch.full((x.shape[0],), t, dtype=x.dtype, device=x.device)
        pred = self.process_model(x, cond, t_vec, audio_lens=audio_lens, gates=gates)
        vt = (pred - x) / (1.0 - t) if self.pred_x1 else pred
        return x + vt * dt

    def solve(
        self,
        noise: torch.Tensor,
        cond: torch.Tensor,
        audio_lens: Optional[torch.Tensor] = None,
        n_timesteps: int = 1,
        clamp_pred: bool = False,
        gates: Optional[torch.Tensor] = None,
        remat: bool = False,
    ) -> torch.Tensor:
        """Fixed-grid Euler solve from x0 = noise, unrolled. `gates`
        (n_timesteps, n_limiters) gives the train form, row s at step s;
        None is the eval form. `remat` recomputes each step's forward in
        backward (`torch.utils.checkpoint`) instead of keeping its
        activations, each recompute counted by `solve.recomputed_steps`."""
        dt = 1.0 / n_timesteps
        x = noise
        for step in range(n_timesteps):
            args = (x, cond, step * dt, dt, audio_lens, None if gates is None else gates[step])
            with tracing.span("solve.step", step):
                if remat:
                    x = torch.utils.checkpoint.checkpoint(
                        self._euler_step, *args, use_reentrant=False,
                        context_fn=lambda: (contextlib.nullcontext(), _recomputing()))
                else:
                    x = self._euler_step(*args)
        if clamp_pred:
            x = torch.clamp(x, -1.0, 1.0)
        return x

    def _encode_cond(self, cond: torch.Tensor, cond_noise: Optional[torch.Tensor] = None,
                     gates: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conditioning -> (B, frames, channels), channels-last and
        encoded."""
        raise NotImplementedError

    def _cond_encoder(self, cond: torch.Tensor, gates: Optional[torch.Tensor]) -> torch.Tensor:
        return self.cond_encoder(cond, gates=gates) if self.cond_encoder is not None else cond

    def draw_rollout(self, batch: int, n_frames: int, n_timesteps: int,
                     generator: torch.Generator, train: bool = True,
                     shard: Shard = Shard()) -> RolloutDraws:
        """The draws of one rollout of `batch` rows over `n_frames`
        conditioning frames, from `generator` (on its device): x0 ~ N(0,
        init_noise_scale^2), then in training a Bernoulli(0.6) gate per
        limiter and step. The rows are `shard`'s of the global batch, whose
        x0 is drawn whole."""
        dev = generator.device
        x0 = shard.rows(torch.randn(batch * shard.count, n_frames * self.cond_hop_length,
                                    generator=generator, device=dev) * self.init_noise_scale)
        if not train:
            return RolloutDraws(x0)
        gates = torch.rand(n_timesteps, self.num_limiters, generator=generator, device=dev) < 0.6
        return RolloutDraws(x0, gates.float())

    def rollout(
        self,
        cond: torch.Tensor,
        draws: RolloutDraws,
        audio_lens: Optional[torch.Tensor] = None,
        n_timesteps: int = 1,
        remat: bool = False,
    ) -> torch.Tensor:
        """The GAN stage's Euler solve from the conditioning (frames on its
        last axis) to (B, frames * cond_hop_length), unclamped: in train form when `draws` has
        gates (differentiable through every step), else the eval form of
        `infer_from_noise`. Branch dropout and mel noise stay off, as the
        fine-tuning config sets them."""
        gates = draws.gates
        if gates is not None and gates.shape[0] != n_timesteps:
            raise ValueError(f"gates hold {gates.shape[0]} steps, the solve takes {n_timesteps}")
        with tracing.span("cond_encoder"):
            cond = self._encode_cond(cond, gates=None if gates is None else gates[0])
        return self.solve(draws.x0, cond, audio_lens, n_timesteps, gates=gates, remat=remat)

    def infer(
        self,
        cond: torch.Tensor,
        audio_lens: Optional[torch.Tensor] = None,
        n_timesteps: int = 1,
        clamp_pred: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Waveforms (B, frames * cond_hop_length) from the conditioning
        (frames on its last axis); x0 is drawn from `generator` (on cond's
        device)."""
        return self.infer_from_noise(self.draw_x0(cond, generator), cond, audio_lens, n_timesteps,
                                     clamp_pred)

    def draw_x0(self, cond: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """`infer`'s x0 for the conditioning: (B, frames * cond_hop_length)
        float32 draws of N(0, init_noise_scale^2) from `generator`."""
        return torch.randn(
            cond.shape[0], cond.shape[-1] * self.cond_hop_length,
            generator=generator, device=cond.device, dtype=torch.float32,
        ) * self.init_noise_scale

    def infer_from_noise(
        self,
        noise: torch.Tensor,
        cond: torch.Tensor,
        audio_lens: Optional[torch.Tensor] = None,
        n_timesteps: int = 1,
        clamp_pred: bool = False,
    ) -> torch.Tensor:
        """`infer` with the caller's x0, for seeded generation and parity.

        On the card this expects TF32 off (`utils.disable_tf32`, which
        `api.get_model` calls), so matmuls and cuDNN convs run in IEEE float32.
        """
        with tracing.span("cond_encoder"):
            cond = self._encode_cond(cond)
        return self.solve(noise, cond, audio_lens, n_timesteps, clamp_pred)


class MelAudioGenerator(BaseAudioGenerator):
    """Conditioned on log-mels (B, n_mels, frames): `cond_dim` is n_mels,
    `cond_hop_length` the mel hop; `max_add_noise_scale` > 0 adds noise of
    a per-example scale to the mels in training."""

    def __init__(self, n_mels: int = 100, mel_hop_length: int = 256,
                 max_add_noise_scale: float = 0.0, **kwargs):
        super().__init__(cond_dim=n_mels, cond_hop_length=mel_hop_length, **kwargs)
        self.n_mels = n_mels
        self.mel_hop_length = mel_hop_length
        self.max_add_noise_scale = max_add_noise_scale

    def _cond_noise(self, batch, n_frames, generator, device):
        if self.max_add_noise_scale <= 0.0:
            return None
        scale = torch.rand(batch, 1, 1, generator=generator, device=device) * self.max_add_noise_scale
        return torch.randn(batch, n_frames, self.n_mels, generator=generator, device=device) * scale

    def _encode_cond(self, cond, cond_noise=None, gates=None):
        cond = cond.transpose(-1, -2)  # (B, frames, n_mels)
        if cond_noise is not None:
            cond = cond + cond_noise
        return self._cond_encoder(cond, gates)


class TokenAudioGenerator(BaseAudioGenerator):
    """Conditioned on token ids (B, frames) in [0, vocab_size): an
    embedding table of `cond_dim` channels feeds the cond encoder in place
    of the mels; no conditioning noise. The table stays float32 under
    `compute_dtype`, as flax's `Embed` does, and the cond encoder casts.
    An id outside the table raises on the CPU and trips a device-side assert
    on the card (the JAX package's lookup gives NaN or wraps), so callers
    that take ids from users check them first (`api.VocoderModel.infer`)."""

    def __init__(self, vocab_size: int = 1024, cond_dim: int = 256,
                 token_hop_length: int = 256, **kwargs):
        super().__init__(cond_dim=cond_dim, cond_hop_length=token_hop_length, **kwargs)
        self.token_embed = nn.Embedding(vocab_size, cond_dim)

    def _encode_cond(self, cond, cond_noise=None, gates=None):
        return self._cond_encoder(self.token_embed(cond), gates)
