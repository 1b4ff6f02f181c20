"""Mel-conditioned flow-matching generator (endpoint / x1-prediction form),
inference path; counterpart of `flow2gan_tpu/models/generator.py`.

The Euler solve is an unrolled Python loop over 1/2/4 steps. The JAX
package's scanned and rematerialised rollouts exist only for the TPU
compiler's limits and are not ported. Conditioning enters as (B, n_mels,
frames), the reference layout, and is transposed once to channels-last.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from flow2gan_tpu_torch.models.convnext import AudioConvNeXt, CondEncoder


class MelAudioGenerator(nn.Module):
    """Multi-branch endpoint-FM generator conditioned on log-mels."""

    def __init__(
        self,
        n_ffts: Sequence[int] = (512, 256, 128),
        hop_lengths: Sequence[int] = (256, 128, 64),
        channels: Sequence[int] = (768, 512, 384),
        time_embed_channels: int = 512,
        hidden_factor: int = 3,
        conv_kernel_sizes: Sequence[int] = (7, 7, 7),
        num_layers: Sequence[int] = (8, 8, 8),
        use_cond_encoder: bool = True,
        n_mels: int = 100,
        mel_hop_length: int = 256,
        cond_enc_channels: int = 512,
        cond_enc_hidden_factor: int = 3,
        cond_enc_conv_kernel_size: int = 7,
        cond_enc_num_layers: int = 4,
        use_residual_scale: bool = True,
        init_noise_scale: float = 0.1,
        pred_x1: bool = True,
        branch_reduction: str = "mean",
        istft_impl: str = "auto",
    ):
        super().__init__()
        n = len(n_ffts)
        if not (len(hop_lengths) == len(channels) == len(conv_kernel_sizes) == len(num_layers) == n):
            raise ValueError("per-branch config tuples must all have one entry per branch")
        if branch_reduction not in ("mean", "sum"):
            raise ValueError(f"branch_reduction must be 'mean' or 'sum', got {branch_reduction!r}")
        self.mel_hop_length = mel_hop_length
        self.init_noise_scale = init_noise_scale
        self.pred_x1 = pred_x1
        self.branch_reduction = branch_reduction
        self.cond_encoder = (
            CondEncoder(
                cond_dim=n_mels,
                channels=cond_enc_channels,
                hidden_factor=cond_enc_hidden_factor,
                conv_kernel_size=cond_enc_conv_kernel_size,
                num_layers=cond_enc_num_layers,
                use_residual_scale=use_residual_scale,
            )
            if use_cond_encoder
            else None
        )
        self.estimators = nn.ModuleList(
            AudioConvNeXt(
                n_fft=n_ffts[i],
                hop_length=hop_lengths[i],
                cond_hop_length=mel_hop_length,
                channels=channels[i],
                cond_channels=cond_enc_channels if use_cond_encoder else n_mels,
                time_embed_channels=time_embed_channels,
                hidden_factor=hidden_factor,
                conv_kernel_size=conv_kernel_sizes[i],
                num_layers=num_layers[i],
                use_residual_scale=use_residual_scale,
                istft_impl=istft_impl,
            )
            for i in range(n)
        )

    def process_model(
        self,
        x: torch.Tensor,
        cond: torch.Tensor,
        t: torch.Tensor,
        audio_lens: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Run every branch on waveform x (B, L) at flow time t (B,) and fuse
        (eval form: no branch dropout)."""
        outs = torch.stack(
            [est(x, cond, t, audio_lens=audio_lens) for est in self.estimators], dim=1
        )
        return outs.mean(dim=1) if self.branch_reduction == "mean" else outs.sum(dim=1)

    def solve(
        self,
        noise: torch.Tensor,
        cond: torch.Tensor,
        audio_lens: Optional[torch.Tensor] = None,
        n_timesteps: int = 1,
        clamp_pred: bool = False,
    ) -> torch.Tensor:
        """Fixed-grid Euler solve from x0 = noise, unrolled."""
        dt = 1.0 / n_timesteps
        x = noise
        for step in range(n_timesteps):
            t = step * dt
            t_vec = torch.full((noise.shape[0],), t, dtype=noise.dtype, device=noise.device)
            pred = self.process_model(x, cond, t_vec, audio_lens=audio_lens)
            vt = (pred - x) / (1.0 - t) if self.pred_x1 else pred
            x = x + vt * dt
        if clamp_pred:
            x = torch.clamp(x, -1.0, 1.0)
        return x

    def _encode_cond(self, cond: torch.Tensor) -> torch.Tensor:
        cond = cond.transpose(-1, -2)  # (B, frames, n_mels)
        return self.cond_encoder(cond) if self.cond_encoder is not None else cond

    def infer(
        self,
        cond: torch.Tensor,
        audio_lens: Optional[torch.Tensor] = None,
        n_timesteps: int = 1,
        clamp_pred: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Waveforms (B, frames * mel_hop_length) from mels (B, n_mels,
        frames); x0 is drawn from `generator` (on cond's device)."""
        noise = torch.randn(
            cond.shape[0], cond.shape[-1] * self.mel_hop_length,
            generator=generator, device=cond.device, dtype=torch.float32,
        ) * self.init_noise_scale
        return self.infer_from_noise(noise, cond, audio_lens, n_timesteps, clamp_pred)

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
        return self.solve(noise, self._encode_cond(cond), audio_lens, n_timesteps, clamp_pred)
