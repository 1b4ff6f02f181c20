"""The plain reference of the GAN fine-tuning stage (Flow2GAN's stage 2,
k2-fsa/Flow2GAN): the multi-period and multi-resolution discriminators, the
GAN losses, and one discriminator step and one generator step over the
reference generator (`model.py`) and optimizer (`optim.py`), in plain
PyTorch and float32, with no kernel of the port.

It imports nothing of the program. Its modules carry the parameter names
and shapes of the port's `state_dict` (`discriminator_0.discriminators.<i>
.convs.<j>`, `discriminator_1.discriminators.<i>.band_convs.<b>.<j>`, each
sub-discriminator's `conv_post`), so that one set of weights loads into
both.

- The multi-period discriminator (HiFi-GAN, Kong et al. 2020,
  arXiv:2010.05646): for each period p, the waveform reflect-padded at its
  end to a multiple of p and folded to (B, 1, T / p, p), five (5, 1) convs
  of 32/128/512/1024/1024 channels, stride (3, 1) four times then (1, 1),
  each followed by leaky ReLU(0.1), and a (3, 1) `conv_post`; its score is
  `conv_post`'s output, flattened.
- The multi-resolution discriminator (DAC, Kumar et al. 2023,
  arXiv:2306.06546): for each window w, the waveform with its mean removed
  and scaled to 0.8 of its peak, its complex STFT at hop w / 4 as two
  channels (B, 2, frames, bins), split into five bands of the bins
  ([0, 0.1, 0.25, 0.5, 0.75, 1] of them), each band through a (3, 9) conv,
  three (3, 9) convs of stride (1, 2) and a (3, 3) conv, each followed by
  leaky ReLU(0.1); the bands concatenated on the frequency axis before a
  (3, 3) `conv_post`.
- The losses: hinge losses, L1 feature matching with the real side
  detached, the multi-scale log-mel L1 (log of max(mel, 1e-7), magnitude
  mels at hop n_fft / 4).

Departures from the published descriptions, each with its reason:

- no weight normalisation: Flow2GAN turns it off (ScaledAdam makes it
  unnecessary), and the port holds plain kernels;
- the feature maps are every conv's output but the first's, and
  `conv_post`'s (5 a period, 21 a resolution), as Flow2GAN's code keeps
  them; HiFi-GAN also keeps the first conv's;
- the multi-resolution STFT is centred and reflect-padded, with a periodic
  Hann window (Flow2GAN's spectrogram), not DAC's padding to the hop;
- the generator step's limiters: each limited parameter is used once in
  the cond encoder or once per Euler step in a branch, and each use flips
  its own gradient by its own gate (Zipformer's limit rule). The flip
  depends on the sign of the gradient, so it is decided on each use's
  gradient over the whole batch: every use reads its own leaf copy of the
  parameter, and the flips are applied, and the uses summed, after the
  last block's backward.

Row blocks: the steps are computed in blocks of rows, each block's loss
weighted by its share of the batch's rows, and the gradients summed. That
is exact: every loss term is a mean over tensors whose leading axis is the
batch's rows, each row the same size, so the batch's mean is the
rows-weighted sum of the blocks' means; and every operation before it acts
on each row alone (the generator's BiasNorm normalises each position over
its channels, the MPD folds each row, the MRD removes each row's own mean
and divides by each row's own peak).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference import data, model as ref
from portbench.reference.check import matmul_precision
from portbench.reference.optim import ScaledAdam, eden2_lr, step_seed

SLOPE = 0.1
BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))


def _leaky(x):
    return F.leaky_relu(x, SLOPE)


class PeriodDiscriminator(nn.Module):
    def __init__(self, period: int, channels=(32, 128, 512, 1024, 1024)):
        super().__init__()
        self.period = period
        widths = (1, *channels)
        self.convs = nn.ModuleList(
            nn.Conv2d(widths[i], widths[i + 1], (5, 1), (3 if i < 4 else 1, 1), padding=(2, 0))
            for i in range(5))
        self.conv_post = nn.Conv2d(widths[-1], 1, (3, 1), padding=(1, 0))

    def forward(self, x):
        b, t = x.shape
        p = self.period
        if t % p:
            x = F.pad(x[:, None], (0, p - t % p), mode="reflect")[:, 0]
        x = x.reshape(b, 1, -1, p)
        fmap = []
        for i, conv in enumerate(self.convs):
            x = _leaky(conv(x))
            if i > 0:
                fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.flatten(1), fmap


class ResolutionDiscriminator(nn.Module):
    def __init__(self, window: int, channels: int = 32, hop_factor: float = 0.25,
                 bands: Sequence[Sequence[float]] = BANDS):
        super().__init__()
        self.window, self.hop = window, int(window * hop_factor)
        bins = window // 2 + 1
        self.bands = [(int(lo * bins), int(hi * bins)) for lo, hi in bands]

        def stack():
            return nn.ModuleList(
                [nn.Conv2d(2, channels, (3, 9), padding=(1, 4))]
                + [nn.Conv2d(channels, channels, (3, 9), (1, 2), padding=(1, 4)) for _ in range(3)]
                + [nn.Conv2d(channels, channels, (3, 3), padding=(1, 1))])

        self.band_convs = nn.ModuleList(stack() for _ in self.bands)
        self.conv_post = nn.Conv2d(channels, 1, (3, 3), padding=(1, 1))

    def forward(self, x):
        x = x - x.mean(-1, keepdim=True)
        x = 0.8 * x / (x.abs().amax(-1, keepdim=True) + 1e-9)
        spec = ref.stft(x, self.window, self.hop)
        z = torch.stack([spec.real, spec.imag], 1)
        fmap, outs = [], []
        for (lo, hi), convs in zip(self.bands, self.band_convs):
            h = z[..., lo:hi]
            for i, conv in enumerate(convs):
                h = _leaky(conv(h))
                if i > 0:
                    fmap.append(h)
            outs.append(h)
        x = self.conv_post(torch.cat(outs, -1))
        fmap.append(x)
        return x, fmap


class Bundle(nn.Module):
    def __init__(self, discriminators: List[nn.Module]):
        super().__init__()
        self.discriminators = nn.ModuleList(discriminators)

    def forward(self, x):
        """(scores, feature maps), one of each per sub-discriminator."""
        outs = [d(x) for d in self.discriminators]
        return [s for s, _ in outs], [f for _, f in outs]


class Discriminators(nn.Module):
    """The MPD (`discriminator_0`) and the MRD (`discriminator_1`), from the
    configuration's `gan` block."""

    def __init__(self, gan: dict):
        super().__init__()
        self.discriminator_0 = Bundle([PeriodDiscriminator(p) for p in gan["mpd_periods"]])
        self.discriminator_1 = Bundle([
            ResolutionDiscriminator(w, gan["mrd_channels"], gan["mrd_hop_factor"], gan["mrd_bands"])
            for w in gan["mrd_fft_sizes"]])

    def forward(self, x):
        return self.discriminator_0(x), self.discriminator_1(x)


def disc_param_specs(gan: dict) -> Sequence[tuple]:
    """(name, shape) of every discriminator parameter, in order."""
    with torch.device("meta"):
        return [(n, tuple(p.shape)) for n, p in Discriminators(gan).named_parameters()]


# ------------------------------------------------------------------ losses

def hinge_d(real: List[torch.Tensor], fake: List[torch.Tensor]) -> torch.Tensor:
    return sum(torch.relu(1.0 - r).mean() + torch.relu(1.0 + f).mean() for r, f in zip(real, fake))


def hinge_g(fake: List[torch.Tensor]) -> torch.Tensor:
    return sum(torch.relu(1.0 - f).mean() for f in fake)


def feature_matching(real: List[List[torch.Tensor]],
                     fake: List[List[torch.Tensor]]) -> torch.Tensor:
    return sum((r.detach() - f).abs().mean() for rs, fs in zip(real, fake) for r, f in zip(rs, fs))


def mel_recon(real: torch.Tensor, fake: torch.Tensor, gan: dict, sr: int) -> torch.Tensor:
    total = 0.0
    for n_fft, n_mels in zip(gan["mel_recon_n_ffts"], gan["mel_recon_n_mels"]):
        fb = torch.from_numpy(ref.mel_filters(n_fft, n_mels, sr)).to(real.device)

        def log_mel(y):
            return torch.log(torch.clamp(ref.stft(y, n_fft, n_fft // 4).abs() @ fb, min=1e-7))

        total = total + (log_mel(real) - log_mel(fake)).abs().mean()
    return total


# ------------------------------------------------------- generator rollout

def _limited(gen: ref.Generator):
    """Each limiter's (module path, limited parameter's name, lo, hi),
    in gate order."""
    out = []
    names = {m: n for n, m in gen.named_modules()}
    for m in gen.limiters():
        if isinstance(m, ref.BiasNorm):
            attr, lo, hi = "log_scale", -1.5, 1.5
        else:
            attr, lo, hi = "scale", 0.5, 1.0
        out.append((names[m], attr, lo, hi))
    return out


def euler(x, pred, t: float, dt: float):
    return x + (pred - x) / (1.0 - t) * dt


def eval_rollout(gen: ref.Generator, mel, x0, lens, n_steps: int):
    """The eval-form Euler solve from x0, unclamped."""
    cond, x, dt = gen.cond_encoder(mel), x0, 1.0 / n_steps
    for s in range(n_steps):
        t = torch.full((x.shape[0],), s * dt, device=x.device)
        x = euler(x, gen.predict(x, cond, t, lens), s * dt, dt)
    return x


class TrainRollout:
    """The train-form solve over blocks of rows: each limited parameter's
    use (the cond encoder's once, a branch's once per Euler step) reads a
    leaf copy of its own; `finish` flips each use's whole-batch gradient by
    its gate (the cond encoder's from row 0 of `gates`, a branch's at step s
    from row s) and adds the uses into the parameters' `.grad`."""

    def __init__(self, gen: ref.Generator, gates: torch.Tensor, n_steps: int):
        self.gen, self.gates, self.n_steps = gen, gates, n_steps
        self.limited = _limited(gen)
        params = dict(gen.named_parameters())
        self.uses = []  # (gate row, limiter index, leaf)
        for i, (path, attr, _, _) in enumerate(self.limited):
            rows = [0] if path.startswith("cond_encoder") else range(n_steps)
            for s in rows:
                leaf = params[f"{path}.{attr}"].detach().clone().requires_grad_()
                self.uses.append((s, i, leaf))

    def _swap(self, prefix: str, row: int) -> Dict[str, torch.Tensor]:
        """The leaf copies, keyed by their names within the submodule at
        `prefix`, of the uses at gate row `row`."""
        out = {}
        for s, i, leaf in self.uses:
            path, attr = self.limited[i][:2]
            if s == row and path.startswith(prefix):
                out[f"{path[len(prefix):]}.{attr}".lstrip(".")] = leaf
        return out

    def __call__(self, mel, x0, lens):
        gen, dt = self.gen, 1.0 / self.n_steps
        cond = torch.func.functional_call(gen.cond_encoder, self._swap("cond_encoder.", 0), (mel,))
        x = x0
        for s in range(self.n_steps):
            t = torch.full((x.shape[0],), s * dt, device=x.device)
            preds = [torch.func.functional_call(b, self._swap(f"estimators.{k}.", s),
                                                (x, cond, t, lens))
                     for k, b in enumerate(gen.estimators)]
            x = euler(x, torch.stack(preds, 1).mean(1), s * dt, dt)
        return x

    def leaves(self) -> List[torch.Tensor]:
        return [leaf for _, _, leaf in self.uses]

    def finish(self) -> None:
        params = dict(self.gen.named_parameters())
        for s, i, leaf in self.uses:
            path, attr, lo, hi = self.limited[i]
            p = params[f"{path}.{attr}"]
            g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
            gate = self.gates[s, i]
            flip = (gate > 0.5) & (((g > 0) & (p < lo)) | ((g < 0) & (p > hi)))
            g = torch.where(flip, -g, g)
            p.grad = g if p.grad is None else p.grad + g


# -------------------------------------------------------------- the steps

def d_loss(gen: ref.Generator, disc: Discriminators, gan: dict, audio, lens, mel, x0,
           n_steps: int) -> torch.Tensor:
    """The discriminator objective on these rows: the eval-form rollout
    without a graph, cut to the crop, both signals judged, the scaled hinge
    losses."""
    with torch.no_grad():
        fake = eval_rollout(gen, mel, x0, lens, n_steps)[..., : audio.shape[-1]]
    (real_mp, _), (real_mr, _) = disc(audio)
    (fake_mp, _), (fake_mr, _) = disc(fake)
    s = gan["loss_scales"]
    return s["disc_mp"] * hinge_d(real_mp, fake_mp) + s["disc_mr"] * hinge_d(real_mr, fake_mr)


def g_loss(rollout: TrainRollout, disc: Discriminators, gan: dict, sr: int, audio, lens, mel,
           x0) -> torch.Tensor:
    """The generator objective on these rows: the real signal judged
    without a graph, the train-form rollout cut to the crop and judged, the
    scaled hinge, feature-matching and mel-reconstruction losses."""
    with torch.no_grad():
        (_, real_fmp), (_, real_fmr) = disc(audio)
    fake = rollout(mel, x0, lens)[..., : audio.shape[-1]]
    (fake_mp, fake_fmp), (fake_mr, fake_fmr) = disc(fake)
    s = gan["loss_scales"]
    return (s["gen_mp"] * hinge_g(fake_mp) + s["gen_mr"] * hinge_g(fake_mr)
            + s["fmap_mp"] * feature_matching(real_fmp, fake_fmp)
            + s["fmap_mr"] * feature_matching(real_fmr, fake_fmr)
            + s["mel_recon"] * mel_recon(audio, fake, gan, sr))


def change_norms(module: nn.Module, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each parameter's change from `start`, its norm taken in float64 (a
    float32 norm of the discriminators' 5.2M-element kernels is off by
    ~1e-4 on the CPU)."""
    return {n: float((p.detach().double() - start[n].double()).norm())
            for n, p in module.named_parameters()}


class GANSteps:
    """The reference's D and G steps of the fine-tuning recipe from the
    given weights: each step's objective over blocks of `rows` rows,
    backward, ScaledAdam with the side's Eden2 rate (`optimizer`'s lr_g /
    lr_d, lr_batches_g / lr_batches_d, warmup_batches, warmup_start) at that
    side's own update count."""

    def __init__(self, cfg: dict, g_weights: Dict[str, torch.Tensor],
                 d_weights: Dict[str, torch.Tensor], optimizer: dict, n_steps: int, device,
                 rows: int = 8):
        self.cfg, self.gan, self.opt_cfg = cfg, cfg["gan"], optimizer
        self.n_steps, self.rows = n_steps, rows
        self.gen = ref.build(cfg, g_weights, device)
        disc = Discriminators(self.gan)
        disc.load_state_dict(d_weights, strict=True)
        self.disc = disc.to(device)
        self.moved = {"g": self.gen, "d": self.disc}
        self.opts = {side: ScaledAdam(m.named_parameters(),
                                      clipping_scale=optimizer["clipping_scale"])
                     for side, m in self.moved.items()}
        self.n_limiters = len(self.gen.limiters())

    def step(self, side: str, audio, lens, x0, gates=None) -> dict:
        """One step of `side` ("d" or "g") on (B, L) `audio` with x0 (B,
        frames * hop) and, for "g", the (n_steps, n_limiters) gates. Returns
        its loss, each moved parameter's gradient norm and its change."""
        gen, disc, cfg = self.gen, self.disc, self.cfg
        module, opt = self.moved[side], self.opts[side]
        start = {n: p.detach().clone() for n, p in module.named_parameters()}
        module.zero_grad(set_to_none=True)
        if side == "g":
            rollout = TrainRollout(gen, gates, self.n_steps)
            limited = {f"{path}.{attr}" for path, attr, _, _ in rollout.limited}
            inputs = [p for n, p in gen.named_parameters() if n not in limited] + rollout.leaves()
        else:
            inputs = list(disc.parameters())
        b, loss = audio.shape[0], 0.0
        for i in range(0, b, self.rows):
            r = slice(i, i + self.rows)
            with torch.no_grad():
                mel = ref.log_mel(audio[r], cfg)
            if side == "g":
                part = g_loss(rollout, disc, self.gan, cfg["sampling_rate"], audio[r], lens[r],
                              mel, x0[r])
            else:
                part = d_loss(gen, disc, self.gan, audio[r], lens[r], mel, x0[r], self.n_steps)
            part = part * (audio[r].shape[0] / b)
            part.backward(inputs=inputs)
            loss += float(part.detach())
        if side == "g":
            rollout.finish()
        grads = {n: float(p.grad.double().norm()) for n, p in module.named_parameters()}
        o = self.opt_cfg
        opt.step(eden2_lr(o[f"lr_{side}"], opt.step_count, o[f"lr_batches_{side}"],
                          o["warmup_batches"], o["warmup_start"]))
        module.zero_grad(set_to_none=True)
        return {"losses": [loss], "grad_norms": grads, "change_norms": change_norms(module, start)}


def follow_gan(cfg: dict, g_weights: Dict[str, torch.Tensor], d_weights: Dict[str, torch.Tensor],
               recipe: dict, corpus: List[str], sides: str, device, tf32: bool = False,
               rows: int = 8) -> Dict[str, dict]:
    """The reference's steps of the fine-tuning recipe from the given
    weights, one batch a step, `sides` ("d" or "g" each) in order: each
    step's batch read again from the corpus, its draws again from the
    step's seed (x0, then in a G step the gates). Returns the first D
    step's and the first G step's `GANSteps.step` ("d", "g")."""
    hop = cfg["mel_hop_length"]
    steps = GANSteps(cfg, g_weights, d_weights, recipe, recipe["n_timesteps"], device, rows)
    out: Dict[str, dict] = {}
    with matmul_precision(tf32):
        for k, side in enumerate(sides):
            epoch, pos = divmod(k, recipe["batches_per_epoch"])
            audio, lens = data.global_batch(corpus, cfg["sampling_rate"], recipe["loader_seed"],
                                            epoch + 1, pos, recipe["local_batch"], recipe["world"],
                                            recipe["duration"], recipe["max_load_times"])
            audio = torch.as_tensor(audio, device=device)
            lens = torch.as_tensor(lens, device=device)
            b, length = audio.shape
            draw = torch.Generator(device=device).manual_seed(step_seed(recipe["draw_seed"], k))
            x0 = torch.randn((b, (1 + length // hop) * hop), generator=draw,
                             device=device) * cfg["init_noise_scale"]
            gates = None
            if side == "g":
                gates = (torch.rand(recipe["n_timesteps"], steps.n_limiters, generator=draw,
                                    device=device) < 0.6).float()
            result = steps.step(side, audio, lens, x0, gates)
            out.setdefault(side, result)
    return out
