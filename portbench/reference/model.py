"""The plain reference of the measured vocoder: the multi-branch endpoint
flow-matching generator (Flow2GAN, k2-fsa/Flow2GAN), written in plain
PyTorch from the model's equations, float32, with no kernel of the port.

It imports nothing of the program. Its modules carry the parameter names
and shapes of the port's `state_dict`, so that one set of weights, made by
the benchmark, loads into both. Where the port computes a transform as a
matmul against a DFT matrix or with its own CUDA kernel, this uses
`torch.stft` / `torch.istft` (cuFFT on the card). Departures, each with its
reason:

- the inverse STFT zeroes the imaginary part of the DC and Nyquist bins
  first: a real inverse transform ignores them by definition, while
  cuFFT's complex-to-real transform reads them;
- the inverse STFT stops at the frames' own length, (frames - 1) * hop,
  and pads zeros up to the waveform's length, as the model defines its
  output (the overlap-add tail past the last frame centre is not output);
- the limiters' gradient sign flip (`apply_limiters`) is applied after
  backward to each limited parameter's summed gradient, which equals
  flipping at the call, since each limited parameter is used once per loss.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


# ------------------------------------------------------------------ DSP

def hann(n_fft: int, device) -> torch.Tensor:
    n = torch.arange(n_fft, dtype=torch.float64, device=device)
    return (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / n_fft)).float()


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centred, reflect-padded, periodic-Hann onesided STFT: (B, L) ->
    complex (B, 1 + L // hop, n_fft // 2 + 1), frames first."""
    spec = torch.stft(x, n_fft, hop, window=hann(n_fft, x.device), center=True,
                      pad_mode="reflect", return_complex=True)
    return spec.transpose(1, 2)


def istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """Inverse of `stft` for (B, frames, bins) -> (B, length): the frames'
    own (frames - 1) * hop samples, then zeros (or a cut) to `length`."""
    spec = spec.clone()
    spec.imag[..., 0] = 0.0
    spec.imag[..., -1] = 0.0
    own = (spec.shape[1] - 1) * hop
    y = torch.istft(spec.transpose(1, 2), n_fft, hop, window=hann(n_fft, spec.device),
                    center=True, length=own)
    return F.pad(y, (0, length - own)) if length > own else y[:, :length]


def _triangles(all_freqs: np.ndarray, corners: np.ndarray) -> np.ndarray:
    diff = corners[1:] - corners[:-1]
    slopes = corners[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / diff[:-1]
    up = slopes[:, 2:] / diff[1:]
    return np.maximum(0.0, np.minimum(down, up)).astype(np.float32)


def mel_filters(n_fft: int, n_mels: int, sr: int) -> np.ndarray:
    """HTK triangular mel filters over 0..sr/2, no normalisation:
    (n_fft // 2 + 1, n_mels)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)

    mels = np.linspace(hz_to_mel(0.0), hz_to_mel(sr // 2), n_mels + 2)
    corners = 700.0 * (10.0 ** (mels / 2595.0) - 1.0)
    return _triangles(np.linspace(0.0, sr // 2, n_fft // 2 + 1), corners)


def linear_filters(n_fft: int, n_filters: int, sr: int) -> np.ndarray:
    """Linear-frequency triangular filters over 0..sr/2: (bins, n_filters)."""
    corners = np.linspace(0.0, float(sr // 2), n_filters + 2)
    return _triangles(np.linspace(0.0, sr // 2, n_fft // 2 + 1), corners)


def log_mel(audio: torch.Tensor, cfg: dict) -> torch.Tensor:
    """(B, L) -> (B, n_mels, frames): log(max(|STFT| @ mel filters, 1e-7))."""
    fb = torch.from_numpy(mel_filters(cfg["mel_n_fft"], cfg["n_mels"],
                                      cfg["sampling_rate"])).to(audio.device)
    mag = stft(audio, cfg["mel_n_fft"], cfg["mel_hop_length"]).abs()
    return torch.log(torch.clamp(mag @ fb, min=1e-7)).transpose(1, 2)


# --------------------------------------------------------------- modules

class BiasNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(c))
        self.log_scale = nn.Parameter(torch.tensor(1.0))

    def forward(self, x):
        d = x - self.bias
        return x * (torch.rsqrt((d * d).mean(-1, keepdim=True)) * torch.exp(self.log_scale))


class ChannelScale(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))

    def forward(self, x):
        return x * self.scale


class PReLU(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((c,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.alpha * x)


class DWConv(nn.Module):
    def __init__(self, c: int, k: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c, 1, k))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):  # (B, T, C), SAME zero padding
        k = self.weight.shape[-1]
        y = F.conv1d(F.pad(x.transpose(1, 2), ((k - 1) // 2, k // 2)), self.weight, self.bias,
                     groups=self.weight.shape[0])
        return y.transpose(1, 2)


class Block(nn.Module):
    """dwconv -> BiasNorm -> (+ cond projection, x (1 + time projection)) ->
    pointwise MLP with PReLU -> + scaled residual. Module order as the
    port's, which fixes the limiters' gate numbers."""

    def __init__(self, c: int, hidden: int, k: int, cond_c: int = 0, time_c: int = 0):
        super().__init__()
        self.dwconv = DWConv(c, k)
        self.norm = BiasNorm(c)
        if cond_c:
            self.cond_proj = nn.Linear(cond_c, c)
            self.time_embed_proj = nn.Linear(time_c, c)
        self.pwconv1 = nn.Linear(c, hidden)
        self.act = PReLU(hidden)
        self.pwconv2 = nn.Linear(hidden, c)
        self.residual_scale = ChannelScale(c)
        self.conditioned = bool(cond_c)

    def forward(self, x, cond=None, time=None, mask=None, up: int = 1):
        res = x
        if mask is not None:
            x = x * mask
        x = self.norm(self.dwconv(x))
        if self.conditioned:
            c = self.cond_proj(cond)
            if up != 1:
                c = c.repeat_interleave(up, dim=1)
            x = (x + c[:, : x.shape[1]]) * (1.0 + self.time_embed_proj(time))[:, None, :]
        return self.pwconv2(self.act(self.pwconv1(x))) + self.residual_scale(res)


class CondEncoder(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        c = cfg["cond_enc_channels"]
        self.in_proj = nn.Conv1d(cfg["n_mels"], c, 3)
        self.in_norm = BiasNorm(c)
        self.blocks = nn.ModuleList(
            Block(c, c * cfg["cond_enc_hidden_factor"], cfg["cond_enc_conv_kernel_size"])
            for _ in range(cfg["cond_enc_num_layers"]))

    def forward(self, mel):  # (B, n_mels, T) -> (B, T, C)
        x = F.conv1d(F.pad(mel, (1, 1)), self.in_proj.weight, self.in_proj.bias).transpose(1, 2)
        x = self.in_norm(x)
        for b in self.blocks:
            x = b(x)
        return x


class Decoder(nn.Module):
    def __init__(self, cfg: dict, i: int):
        super().__init__()
        n_fft, c = cfg["n_ffts"][i], cfg["channels"][i]
        tc, cc, h = cfg["time_embed_channels"], cfg["cond_enc_channels"], cfg["hidden_factor"]
        self.in_proj = nn.Linear(n_fft + 2, c)
        self.in_norm = BiasNorm(c)
        self.time_mlp_0 = nn.Linear(tc, tc * h)
        self.time_mlp_2 = nn.Linear(tc * h, tc)
        self.cond_mlp_0 = nn.Linear(cc, cc * h)
        self.cond_mlp_1 = PReLU(cc * h)
        self.cond_mlp_2 = nn.Linear(cc * h, cc)
        self.blocks = nn.ModuleList(Block(c, c * h, cfg["conv_kernel_sizes"][i], cc, tc)
                                    for _ in range(cfg["num_layers"][i]))
        self.out_proj = nn.Linear(c, n_fft + 2)


class Branch(nn.Module):
    """One resolution: wave -> STFT -> ConvNeXt decoder -> iSTFT -> wave."""

    def __init__(self, cfg: dict, i: int):
        super().__init__()
        self.n_fft, self.hop = cfg["n_ffts"][i], cfg["hop_lengths"][i]
        self.up = cfg["mel_hop_length"] // self.hop
        self.time_c = cfg["time_embed_channels"]
        self.decoder = Decoder(cfg, i)

    def forward(self, x, cond, t, lens=None):
        d = self.decoder
        length = x.shape[-1]
        spec = stft(x, self.n_fft, self.hop)
        h = torch.cat([spec.real, spec.imag], -1)
        frames = h.shape[1]
        need = frames if self.up == 1 else -(-frames // self.up)
        cond = cond[:, :need] if need <= cond.shape[1] else F.pad(
            cond, (0, 0, 0, need - cond.shape[1]))
        mask = None
        if lens is not None:
            valid = 1 + lens // self.hop
            mask = (torch.arange(frames, device=x.device)[None] < valid[:, None]).float()[..., None]
        h = d.in_norm(d.in_proj(h))
        half = self.time_c // 2
        freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=x.device)
                          * (-math.log(10000.0) / (half - 1)))
        arg = 1000.0 * t.float()[:, None] * freqs[None]
        time = d.time_mlp_2(F.silu(d.time_mlp_0(torch.cat([arg.sin(), arg.cos()], -1))))
        cond = d.cond_mlp_2(d.cond_mlp_1(d.cond_mlp_0(cond)))
        for b in d.blocks:
            h = b(h, cond, time, mask, self.up)
        h = d.out_proj(h)
        if mask is not None:
            h = h * mask
        nb = self.n_fft // 2 + 1
        return istft(torch.complex(h[..., :nb], h[..., nb:]), self.n_fft, self.hop, length)


class Generator(nn.Module):
    """The mel-conditioned generator: the cond encoder, then the branches'
    mean as the endpoint (x1) prediction."""

    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        self.cond_encoder = CondEncoder(cfg)
        self.estimators = nn.ModuleList(Branch(cfg, i) for i in range(len(cfg["n_ffts"])))

    def limiters(self) -> List[nn.Module]:
        """The limited modules in gate order (the port numbers them in
        module order)."""
        return [m for m in self.modules() if isinstance(m, (BiasNorm, ChannelScale))]

    def predict(self, x, cond, t, lens=None, branch_weight=None):
        outs = torch.stack([b(x, cond, t, lens) for b in self.estimators], 1)
        if branch_weight is not None:
            outs = outs * branch_weight[..., None]
        return outs.mean(1)

    @torch.no_grad()
    def infer(self, mel: torch.Tensor, noise: torch.Tensor, n_steps: int) -> torch.Tensor:
        """Euler from x0 = noise over n_steps, clamped to [-1, 1]."""
        cond = self.cond_encoder(mel)
        x, dt = noise, 1.0 / n_steps
        for s in range(n_steps):
            t = s * dt
            pred = self.predict(x, cond, torch.full((x.shape[0],), t, device=x.device))
            x = x + (pred - x) / (1.0 - t) * dt
        return x.clamp(-1.0, 1.0)

    def loss_sum(self, audio, lens, mel, x0, t, branch_weight):
        """The spectral-energy-scaled FM loss's masked sum over these rows,
        and their masked count: the loss is the sum over the global batch
        over the count of the global batch."""
        cfg = self.cfg
        x = (1.0 - t[:, None]) * x0 + t[:, None] * audio
        pred = self.predict(x, self.cond_encoder(mel), t, lens, branch_weight)
        fb = torch.from_numpy(linear_filters(cfg["loss_n_fft"], cfg["loss_n_filters"],
                                             cfg["sampling_rate"])).to(audio.device)

        def spec(y):
            return stft(y, cfg["loss_n_fft"], cfg["loss_hop_length"]).abs() ** 2 @ fb

        gt, err = spec(audio), spec(pred - audio)
        scale = torch.clamp((gt + cfg["loss_eps"]) ** -cfg["loss_power"],
                            min=cfg["loss_scale_min"], max=cfg["loss_scale_max"])
        frames = err.shape[1]
        valid = 1 + lens // cfg["loss_hop_length"]
        mask = (torch.arange(frames, device=audio.device)[None] < valid[:, None]).float()[..., None]
        return (err * scale * mask).sum(), mask.sum() * err.shape[-1]


def apply_limiters(model: Generator, gates: torch.Tensor) -> None:
    """The limiters' backward rule on the summed gradients: where a
    limiter's gate is on, a positive gradient of a value below the range
    and a negative one of a value above it change sign (BiasNorm's
    log-scale in [-1.5, 1.5], the residual scale in [0.5, 1])."""
    for i, m in enumerate(model.limiters()):
        p, lo, hi = ((m.log_scale, -1.5, 1.5) if isinstance(m, BiasNorm) else (m.scale, 0.5, 1.0))
        g = p.grad
        flip = (gates[i] > 0.5) & (((g > 0) & (p < lo)) | ((g < 0) & (p > hi)))
        p.grad = torch.where(flip, -g, g)


def build(cfg: dict, weights: Optional[dict] = None, device="cpu") -> Generator:
    model = Generator(cfg)
    if weights is not None:
        model.load_state_dict(weights, strict=True)
    return model.to(device)


def param_specs(cfg: dict) -> Sequence[tuple]:
    """(name, shape) of every parameter, in order, without allocating."""
    with torch.device("meta"):
        return [(n, tuple(p.shape)) for n, p in Generator(cfg).named_parameters()]
