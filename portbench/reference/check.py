"""The comparisons that decide a run's `correct`: the reference worked out
again from what the benchmark handed the program (the configuration, the
weights, the conditioning, the seeds, the corpus), and the program's
outputs judged against it. Each function returns the numbers compared;
the limits are in `portbench/limits/<workload>.json`.

Serving: the gap between a returned waveform and the reference's, as a
share of the reference's norm (`wave_rel_err`), the widest over the sampled
requests. Training: each of the first steps' loss (`loss_rel_err`), each
parameter's gradient norm at the first step (`grad_norm_gap`) and each
parameter's change over the first steps (`change_norm_gap`), each a gap
between the program's norm and the reference's over the larger of that
parameter's reference norm and the median parameter's, the worst
parameter's.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

from portbench.reference import data, model as ref
from portbench.reference.optim import ScaledAdam, eden2_lr, step_seed


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """IEEE float32 matmuls and convolutions (the configurations' precision),
    or with `tf32` the card's TF32 (the control)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def infer_noise(cfg: dict, batch: int, frames: int, seed: int, device) -> torch.Tensor:
    """x0 of a serving call made with `seed`: N(0, init_noise_scale^2) of
    (batch, frames * hop), drawn from a generator on the device."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(batch, frames * cfg["mel_hop_length"], generator=gen, device=device,
                       dtype=torch.float32) * cfg["init_noise_scale"]


def rel_err(ours: np.ndarray, theirs: np.ndarray) -> float:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    return float(np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-30))


class Reference:
    """The reference generator with the run's weights, on the device."""

    def __init__(self, cfg: dict, weights: Dict[str, torch.Tensor], device, tf32: bool = False):
        self.cfg, self.device, self.tf32 = cfg, device, tf32
        self.model = ref.build(cfg, weights, device).eval()

    def synth(self, mel: np.ndarray, n_steps: int, seed: int, rows: int = 8) -> np.ndarray:
        """(B, n_mels, frames) mels -> (B, frames * hop) waveforms, as a
        serving call with `seed` returns them; in blocks of `rows`."""
        noise = infer_noise(self.cfg, mel.shape[0], mel.shape[-1], seed, self.device)
        out = []
        with matmul_precision(self.tf32):
            for i in range(0, mel.shape[0], rows):
                m = torch.as_tensor(mel[i:i + rows], device=self.device)
                out.append(self.model.infer(m, noise[i:i + rows], n_steps).cpu().numpy())
        return np.concatenate(out)

    def stream(self, mel: np.ndarray, n_steps: int, seed: int, chunk: int, halo: int) -> np.ndarray:
        """A (n_mels, frames) stream in chunks of `chunk` frames, each
        synthesised with `halo` frames of context on either side, the last
        frame repeated to fill chunk + 2 * halo, and the context cut off."""
        hop, frames, out = self.cfg["mel_hop_length"], mel.shape[-1], []
        for start in range(0, frames, chunk):
            end = min(start + chunk, frames)
            lo, hi = max(0, start - halo), min(frames, end + halo)
            seg = mel[:, lo:hi]
            seg = np.concatenate([seg, np.repeat(seg[:, -1:], chunk + 2 * halo - seg.shape[1], 1)], 1)
            wav = self.synth(seg[None], n_steps, seed)[0]
            out.append(wav[(start - lo) * hop:(end - lo) * hop])
        return np.concatenate(out)


def norm_gaps(ours: Dict[str, float], theirs: Dict[str, float],
              names: Iterable[str]) -> Dict[str, float]:
    """|ours - theirs| / max(theirs, the median of theirs over all names),
    for each of `names`."""
    median = statistics.median(theirs[n] for n in theirs)
    return {n: abs(ours[n] - theirs[n]) / max(theirs[n], median, 1e-30) for n in names}


def worst(gaps: Dict[str, float], k: int = 3) -> list:
    """The `k` largest gaps, (name, gap), largest first."""
    return sorted(gaps.items(), key=lambda kv: -kv[1])[:k]


def follow_training(cfg: dict, weights: Dict[str, torch.Tensor], recipe: dict, corpus: List[str],
                    steps: int, device, tf32: bool = False, rows: int = 32) -> dict:
    """The reference's first `steps` optimizer steps of the FM recipe from
    `weights`: each step's global batch read again from the corpus
    (`recipe`'s loader seed, batch and world), its draws again from the
    step's seed, the loss summed over blocks of `rows` rows, backward, the
    limiters, ScaledAdam. Returns each step's loss, each parameter's first
    gradient norm and its change over the steps."""
    model = ref.build(cfg, weights, device).train()
    opt = ScaledAdam(model.named_parameters(), clipping_scale=recipe["clipping_scale"])
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    n_lim, nb = len(model.limiters()), len(cfg["n_ffts"])
    sr = cfg["sampling_rate"]
    losses, grad_norms = [], None
    with matmul_precision(tf32):
        for s in range(steps):
            epoch, pos = divmod(s, recipe["batches_per_epoch"])
            audio, lens = data.global_batch(corpus, sr, recipe["loader_seed"], epoch + 1, pos,
                                            recipe["local_batch"], recipe["world"],
                                            recipe["duration"], recipe["max_load_times"])
            audio, lens = torch.as_tensor(audio, device=device), torch.as_tensor(lens, device=device)
            b, length = audio.shape
            gen = torch.Generator(device=device).manual_seed(step_seed(recipe["draw_seed"], s))
            x0 = torch.randn((b, length), generator=gen, device=device) * cfg["init_noise_scale"]
            t = torch.rand(b, generator=gen, device=device)
            gates = (torch.rand(n_lim, generator=gen, device=device) < 0.6).float()
            weight = None
            if cfg["branch_dropout"] > 0.0 and nb > 1:
                idx = torch.randint(0, nb, (b,), generator=gen, device=device)
                drop = torch.rand(b, 1, generator=gen, device=device) < cfg["branch_dropout"]
                keep = torch.ones(b, nb, device=device)
                keep[torch.arange(b, device=device), idx] = 0.0
                weight = torch.where(drop, keep * (nb / (nb - 1)), torch.ones_like(keep))
            frames = 1 + length // cfg["loss_hop_length"]
            count = (torch.clamp(1 + lens // cfg["loss_hop_length"], max=frames).sum()
                     * cfg["loss_n_filters"]).float()
            model.zero_grad(set_to_none=True)
            loss = 0.0
            for i in range(0, b, rows):
                r = slice(i, i + rows)
                with torch.no_grad():
                    mel = ref.log_mel(audio[r], cfg)
                part, _ = model.loss_sum(audio[r], lens[r], mel, x0[r], t[r],
                                         None if weight is None else weight[r])
                part = part / count
                part.backward()
                loss += float(part.detach())
            ref.apply_limiters(model, gates)
            if s == 0:
                grad_norms = {n: float(p.grad.norm()) for n, p in model.named_parameters()}
            opt.step(eden2_lr(recipe["base_lr"], s, recipe["lr_batches"],
                              recipe["warmup_batches"], recipe["warmup_start"]))
            losses.append(loss)
    change = {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def training_numbers(ours: dict, theirs: dict, steps: int, detail: bool = False):
    """The compared numbers of a training cell: the worst step's relative
    loss gap over the first `steps`, the worst parameter's first-gradient
    norm gap, and the worst parameter's change gap. Parameters whose
    reference gradient is under a thousandth of the median parameter's move
    by round-off alone under Adam and are left out of the change."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(ours["losses"][:steps], theirs["losses"][:steps]))
    g = theirs["grad_norms"]
    median = statistics.median(g.values())
    moved = [n for n in g if g[n] >= 1e-3 * median]
    grads = norm_gaps(ours["grad_norms"], g, g)
    change = norm_gaps(ours["change_norms"], theirs["change_norms"], moved)
    numbers = {"loss_rel_err": loss, "grad_norm_gap": max(grads.values()),
               "change_norm_gap": max(change.values())}
    if detail:  # the worst parameters, and how many the change leaves out
        return numbers, {"grad": worst(grads), "change": worst(change),
                         "left_out": sorted(set(g) - set(moved))}
    return numbers


def first_grad_norms(optimizer, beta2: float = 0.98) -> Dict[str, float]:
    """Each parameter's gradient norm at the first step, as ScaledAdam got
    it, worked out from its state after that step: the second moment is
    then (1 - beta2) g^2 (the first step is never clipped)."""
    out = {}
    for g in optimizer.groups:
        for name, eas in zip(g.names, g.exp_avg_sq.unbind(0)):
            out[name] = float((eas.double().sum() / (1.0 - beta2)).sqrt())
    return out


def change_norms(params: Sequence, start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float((p.detach() - start[n]).norm()) for n, p in params}
