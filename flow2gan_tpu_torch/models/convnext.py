"""ConvNeXt-1D blocks and the per-branch STFT-domain model, counterpart of
`flow2gan_tpu/models/convnext.py`.

Layout is channels-last (B, T, C) as in the JAX package, so the pointwise
convs are `nn.Linear`s; the depthwise and input convs transpose to
PyTorch's (B, C, T) around `F.conv1d`. Attribute names follow the JAX
parameter tree (`blocks_3` becomes `blocks.3`), which keeps
`compat/from_jax.py` a renaming of leaves.

`dtype` is the compute dtype (None: float32), with the semantics of flax's
`Dense(dtype=...)` and `Conv(dtype=...)`: every linear and conv casts its
input, weight and bias to it, while the parameters stay float32. No
`torch.autocast`: the casts are where the JAX package makes them, and every
mask or float32 parameter that meets an activation is cast to the
activation's dtype first, since torch would otherwise promote the product,
and all that follows, back to float32. The decoder returns float32, so the
iSTFT, the Euler update and the loss stay float32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.models.norms import BiasNorm, ChannelScale, PReLU, at_least_float32
from flow2gan_tpu_torch.ops import convnext_chain as chain
from flow2gan_tpu_torch.ops import convnext_chain_train as train_chain
from flow2gan_tpu_torch.ops import fused_istft as fused
from flow2gan_tpu_torch.ops.stft import real_to_spec, spec_to_real, stft, stft_lens
from flow2gan_tpu_torch.utils import make_valid_mask


def sinusoidal_pos_emb(t: torch.Tensor, dim: int, scale: float = 1000.0) -> torch.Tensor:
    """Sinusoidal embedding of flow time t: (B,) -> (B, dim), sin then cos."""
    if dim % 2:
        raise ValueError(f"embedding dim must be even, got {dim}")
    half = dim // 2
    t = at_least_float32(t)
    freqs = torch.exp(
        torch.arange(half, dtype=t.dtype, device=t.device)
        * (-math.log(10000.0) / (half - 1))
    )
    arg = scale * t[:, None] * freqs[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=-1)


def _cast(dtype: Optional[torch.dtype], *tensors: torch.Tensor):
    return tensors if dtype is None else tuple(t.to(dtype) for t in tensors)


def _conv_same(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int = 1,
               dtype: Optional[torch.dtype] = None):
    """SAME-padded stride-1 conv of channels-last (B, T, C_in) -> (B, T, C_out)
    in the compute dtype (see `_dense` for where the bias goes)."""
    def conv(x, weight, bias=None):
        return F.conv1d(x.transpose(1, 2), weight, bias, padding="same",
                        groups=groups).transpose(1, 2)

    if dtype is None:
        return conv(x, weight, bias)
    x, weight, bias = _cast(dtype, x, weight, bias)
    return conv(x, weight) + bias


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """`layer(x)` in the compute dtype. In a low-precision dtype the product
    is rounded before the bias is added, as flax does (a bias fused into the
    GEMM would round once, and move every output by up to one ulp)."""
    if dtype is None:
        return layer(x)
    x, weight, bias = _cast(dtype, x, layer.weight, layer.bias)
    return F.linear(x, weight) + bias


class SameConv1d(nn.Conv1d):
    """A stride-1 SAME-padded `Conv1d` on channels-last (B, T, C_in) ->
    (B, T, C_out), in the compute dtype `compute_dtype` (`_conv_same`); a
    module of its own, so that hooks see its output, as flax's `Conv` is a
    module."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_same(x, self.weight, self.bias, dtype=self.compute_dtype)


class DepthwiseConv1d(nn.Module):
    """Depthwise k-tap conv with SAME zero padding on (B, T, C)."""

    def __init__(self, channels: int, kernel_size: int = 7, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(channels, 1, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv_same(x, self.weight, self.bias, groups=self.weight.shape[0], dtype=self.dtype)


def takes_chain(x: torch.Tensor, gates: Optional[torch.Tensor],
                dtype: Optional[torch.dtype]) -> bool:
    """Whether a block runs its eval form through `ops/convnext_chain.py`:
    no limiter gates, no gradient, float32 compute on a float32 input. The
    train form (`takes_train_chain`) and a low-precision compute dtype do
    not."""
    return (gates is None and dtype is None and x.dtype == torch.float32
            and not torch.is_grad_enabled())


def takes_train_chain(x: torch.Tensor, dtype: Optional[torch.dtype]) -> bool:
    """Whether a block runs its train form through
    `ops/convnext_chain_train.py`'s Function: grad enabled, float32 compute
    on a float32 input on the card, gates given or not. A low-precision
    compute dtype and the CPU take the eager chain and autograd."""
    return (x.is_cuda and dtype is None and x.dtype == torch.float32
            and torch.is_grad_enabled())


class ConvNeXtBlock(nn.Module):
    """depthwise conv -> BiasNorm -> (+cond) -> (x(1+time)) -> MLP -> +residual.

    `conditioned` adds the cond and time inputs (the JAX block's
    use_cond=use_time=True, as in the decoder; the cond encoder's blocks
    have neither). When cond runs at 1/`cond_upsample_factor` of x's frame
    rate, it is projected at its native rate and the projection repeated:
    pointwise ops commute with a nearest repeat.

    Unless a forward hook watches one of the block's modules:
    - the eval form (`takes_chain`: no grad) runs the elementwise chain
      through `ops/convnext_chain.py`: on the card three kernels around the
      GEMMs, each such block counted by `convnext.fused_blocks`; on the CPU
      their plain versions, the eager arithmetic;
    - the train form on the card (`takes_train_chain`: grad enabled) runs
      through `ops/convnext_chain_train.py`'s autograd Function, hand-written
      kernels around the GEMMs forward and backward, each such block counted
      by `convnext.train_fused_blocks`.
    Any other block on the card takes the eager chain and counts
    `convnext.eager_blocks` (no grad: bf16, hooked, gates given) or
    `convnext.train_eager_blocks` (grad enabled: bf16, hooked).
    """

    def __init__(
        self,
        channels: int,
        hidden_channels: int,
        kernel_size: int = 7,
        conditioned: bool = False,
        cond_channels: int = 0,
        time_embed_channels: int = 0,
        use_residual_scale: bool = True,
        cond_upsample_factor: int = 1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.cond_upsample_factor = cond_upsample_factor
        self.dwconv = DepthwiseConv1d(channels, kernel_size, dtype)
        self.norm = BiasNorm(channels)
        self.cond_proj = nn.Linear(cond_channels, channels) if conditioned else None
        self.time_embed_proj = (
            nn.Linear(time_embed_channels, channels) if conditioned else None
        )
        self.pwconv1 = nn.Linear(channels, hidden_channels)
        self.act = PReLU(hidden_channels)
        self.pwconv2 = nn.Linear(hidden_channels, channels)
        self.residual_scale = ChannelScale(channels) if use_residual_scale else None

    def forward(
        self,
        x: torch.Tensor,
        cond: Optional[torch.Tensor] = None,
        time_embed: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        gates: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if takes_chain(x, gates, self.dtype) and not self._watched():
            return self._chain(x, cond, time_embed, mask)
        if takes_train_chain(x, self.dtype) and not self._watched():
            return self._train_chain(x, cond, time_embed, mask, gates)
        if x.is_cuda:
            tracing.count("convnext.train_eager_blocks" if torch.is_grad_enabled()
                          else "convnext.eager_blocks")
        residual = x
        if mask is not None:
            x = x * mask.to(x.dtype)
        x = self.norm(self.dwconv(x), gates)
        if self.cond_proj is not None:
            c = _dense(self.cond_proj, cond, self.dtype)
            if self.cond_upsample_factor != 1:
                c = c.repeat_interleave(self.cond_upsample_factor, dim=1)
            x = x + c[:, : x.shape[1]]
            x = x * (1.0 + _dense(self.time_embed_proj, time_embed, self.dtype))[:, None, :]
        x = _dense(self.pwconv2, self.act(_dense(self.pwconv1, x, self.dtype)), self.dtype)
        if self.residual_scale is not None:
            residual = self.residual_scale(residual, gates)
        return x + residual

    def _watched(self) -> bool:
        """Whether a forward hook watches a module the chain runs past (the
        trainers' diagnostics and `--inf-check` hook every module): then the
        block runs the eager chain, which calls each of them."""
        return any(m._forward_hooks or m._forward_pre_hooks for m in self.children())

    def _chain(self, x: torch.Tensor, cond: Optional[torch.Tensor],
               time_embed: Optional[torch.Tensor], mask: Optional[torch.Tensor]) -> torch.Tensor:
        """The eval form through `ops/convnext_chain.py`: its three kernels
        around the GEMMs on the card, their plain versions on the CPU."""
        if x.is_cuda:
            tracing.count("convnext.fused_blocks")
            # the kernels read whole rows; the cond encoder's first input is
            # the transposed view its input conv returns
            x = x.contiguous()
        c = te = None
        if self.cond_proj is not None:
            c, te = self.cond_proj(cond), self.time_embed_proj(time_embed)
        y = chain.norm_film(x, mask, self.dwconv.weight, self.dwconv.bias, self.norm.bias,
                            self.norm.log_scale, c, te, self.cond_upsample_factor)
        h = chain.prelu_(self.pwconv1(y), self.act.alpha)
        scale = None if self.residual_scale is None else self.residual_scale.scale
        return chain.linear_residual(h, self.pwconv2.weight, self.pwconv2.bias, x, scale)

    def _train_chain(self, x: torch.Tensor, cond: Optional[torch.Tensor],
                     time_embed: Optional[torch.Tensor], mask: Optional[torch.Tensor],
                     gates: Optional[torch.Tensor]) -> torch.Tensor:
        """The train form through `ops/convnext_chain_train.py`'s Function:
        its kernels on the card, their plain versions on the CPU. The
        limiters act on the log-scale and the residual scale before they
        enter it, so their flips stay in autograd."""
        if x.is_cuda:
            tracing.count("convnext.train_fused_blocks")
        c = te = None
        if self.cond_proj is not None:
            c, te = self.cond_proj(cond), self.time_embed_proj(time_embed)
        scale = None if self.residual_scale is None else self.residual_scale.limited_scale(gates)
        # the kernels read whole rows (see `_chain`)
        return train_chain.TrainChain.apply(
            x.contiguous(), mask, self.dwconv.weight, self.dwconv.bias, self.norm.bias,
            self.norm.limited_log_scale(gates), c, te, self.pwconv1.weight, self.pwconv1.bias,
            self.act.alpha, self.pwconv2.weight, self.pwconv2.bias, scale,
            self.cond_upsample_factor)


class CondEncoder(nn.Module):
    """ConvNeXt encoder over the conditioning features, run once per call and
    shared by all branches. Input (B, T, cond_dim)."""

    def __init__(
        self,
        cond_dim: int = 100,
        channels: int = 512,
        hidden_factor: int = 3,
        conv_kernel_size: int = 7,
        num_layers: int = 4,
        use_residual_scale: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.in_proj = SameConv1d(cond_dim, channels, 3, dtype)
        self.in_norm = BiasNorm(channels)
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(
                channels,
                channels * hidden_factor,
                conv_kernel_size,
                use_residual_scale=use_residual_scale,
                dtype=dtype,
            )
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                gates: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.in_norm(self.in_proj(x), gates)
        for block in self.blocks:
            x = block(x, mask=mask, gates=gates)
        return x


class ConvNeXtDecoder(nn.Module):
    """Per-branch trunk over packed Fourier coefficients (B, T_f, in_channels)."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        channels: int = 512,
        cond_channels: int = 512,
        time_embed_channels: int = 512,
        hidden_factor: int = 3,
        conv_kernel_size: int = 7,
        num_layers: int = 8,
        use_residual_scale: bool = True,
        cond_upsample_factor: int = 1,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.dtype = dtype
        self.time_embed_channels = time_embed_channels
        self.cond_upsample_factor = cond_upsample_factor
        self.in_proj = nn.Linear(in_channels, channels)
        self.in_norm = BiasNorm(channels)
        time_hidden = time_embed_channels * hidden_factor
        self.time_mlp_0 = nn.Linear(time_embed_channels, time_hidden)
        self.time_mlp_2 = nn.Linear(time_hidden, time_embed_channels)
        cond_hidden = cond_channels * hidden_factor
        self.cond_mlp_0 = nn.Linear(cond_channels, cond_hidden)
        self.cond_mlp_1 = PReLU(cond_hidden)
        self.cond_mlp_2 = nn.Linear(cond_hidden, cond_channels)
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(
                channels,
                channels * hidden_factor,
                conv_kernel_size,
                conditioned=True,
                cond_channels=cond_channels,
                time_embed_channels=time_embed_channels,
                use_residual_scale=use_residual_scale,
                cond_upsample_factor=cond_upsample_factor,
                dtype=dtype,
            )
            for _ in range(num_layers)
        )
        self.out_proj = nn.Linear(channels, out_channels)

    def forward(
        self,
        x: torch.Tensor,
        cond: torch.Tensor,
        t: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        gates: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        if self.cond_upsample_factor != 1:
            # trim or zero-pad the native-rate cond so its repeat covers x's
            # frames; the padded tail carries proj-chain(0), as projecting
            # zero-padded repeated rows would
            need = -(-x.shape[1] // self.cond_upsample_factor)
            cond = cond[:, :need] if need <= cond.shape[1] else F.pad(
                cond, (0, 0, 0, need - cond.shape[1])
            )
        dtype = self.dtype
        x = self.in_norm(_dense(self.in_proj, x, dtype), gates)
        emb = sinusoidal_pos_emb(t, self.time_embed_channels)
        time_embed = _dense(self.time_mlp_2, F.silu(_dense(self.time_mlp_0, emb, dtype)), dtype)
        cond = _dense(self.cond_mlp_2, self.cond_mlp_1(_dense(self.cond_mlp_0, cond, dtype)), dtype)
        for block in self.blocks:
            x = block(x, cond=cond, time_embed=time_embed, mask=mask, gates=gates)
        return at_least_float32(_dense(self.out_proj, x, dtype))


class AudioConvNeXt(nn.Module):
    """One resolution branch: wav -> STFT -> ConvNeXt decode -> iSTFT -> wav.

    Input audio (B, L), cond (B, T_c, C_c). The iSTFT is `fused.fused_istft`:
    the fused kernel (and its adjoint kernel in backward) for CUDA tensors,
    the plain versions for CPU ones; a CUDA tensor never takes the plain
    version. `gates` (the limiters' training gates, `models/norms.py`) is
    None in the eval form. `dtype` is the decoder's compute dtype; the STFT
    and the iSTFT stay float32.
    """

    def __init__(
        self,
        n_fft: int = 512,
        hop_length: int = 256,
        cond_hop_length: int = 256,
        channels: int = 768,
        cond_channels: int = 512,
        time_embed_channels: int = 512,
        hidden_factor: int = 3,
        conv_kernel_size: int = 7,
        num_layers: int = 8,
        use_residual_scale: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if cond_hop_length % hop_length:
            raise ValueError("cond_hop_length must be an integer multiple of hop_length")
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.cond_upsample_factor = cond_hop_length // hop_length
        self.decoder = ConvNeXtDecoder(
            in_channels=n_fft + 2,
            out_channels=n_fft + 2,
            channels=channels,
            cond_channels=cond_channels,
            time_embed_channels=time_embed_channels,
            hidden_factor=hidden_factor,
            conv_kernel_size=conv_kernel_size,
            num_layers=num_layers,
            use_residual_scale=use_residual_scale,
            cond_upsample_factor=self.cond_upsample_factor,
            dtype=dtype,
        )

    @staticmethod
    def upsample_cond(cond: torch.Tensor, fft_frames: int) -> torch.Tensor:
        """Truncate or zero-pad cond (B, T_c, C) to (B, fft_frames, C); the
        factor-1 case of the JAX `upsample_cond`."""
        cur = cond.shape[1]
        if fft_frames <= cur:
            return cond[:, :fft_frames]
        return F.pad(cond, (0, 0, 0, fft_frames - cur))

    def forward(
        self,
        audio: torch.Tensor,
        cond: torch.Tensor,
        t: torch.Tensor,
        audio_lens: Optional[torch.Tensor] = None,
        gates: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        length = audio.shape[-1]
        x = spec_to_real(stft(audio, self.n_fft, self.hop_length))  # (B, T_f, n_fft + 2)
        fft_frames = x.shape[1]
        if self.cond_upsample_factor == 1:
            cond = self.upsample_cond(cond, fft_frames)
        mask = None
        if audio_lens is not None:
            fft_lens = stft_lens(audio_lens, self.hop_length)
            mask = make_valid_mask(fft_lens, fft_frames)[..., None]
        x = self.decoder(x, cond=cond, t=t, mask=mask, gates=gates)
        if mask is not None:
            x = x * mask
        return fused.fused_istft(real_to_spec(x), self.n_fft, self.hop_length, length=length)
