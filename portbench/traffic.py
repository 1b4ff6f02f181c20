"""The general traffic generator: every mix is a file of parameters,
`portbench/traffic/<name>.json`, read here. It makes the requests' lengths
and order, their audio and conditioning, and the training corpus, all from
the run's seed. Every seed gives the same set of lengths, in another order
and with other content, so the work of a run does not swing with the draw.

`voiced` is copied from `chip_smoke.py`, and `synth_utterance` from
`flow2gan_tpu_torch/bin/make_synthetic_corpus.py`, each with its array work
in torch, so that the requests and a corpus of a few hundred utterances are
made on the card in seconds.
"""

from __future__ import annotations

import json
import math
import wave
from pathlib import Path
from typing import Iterator, List, Sequence

import numpy as np
import torch

from portbench.reference.model import log_mel

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str) -> dict:
    return json.loads((TRAFFIC_DIR / f"{name}.json").read_text())


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """An independent generator for each use of the run's seed."""
    return np.random.default_rng([seed % 2**63, *stream])


def mid_quantiles(lo: float, hi: float, n: int, log: bool) -> List[float]:
    """The n mid-quantiles ((i + 1/2) / n) of the uniform, or log-uniform,
    distribution on [lo, hi]."""
    qs = [(i + 0.5) / n for i in range(n)]
    if log:
        return [lo * (hi / lo) ** q for q in qs]
    return [lo + (hi - lo) * q for q in qs]


def lengths_frames(mix: dict, cfg: dict) -> List[int]:
    """The mix's request lengths in conditioning frames, shortest first."""
    secs = mid_quantiles(mix["min_s"], mix["max_s"], mix["lengths"], mix["log_uniform"])
    return [round(s * cfg["sampling_rate"] / cfg["mel_hop_length"]) for s in secs]


def order(seed: int, n: int) -> Iterator[int]:
    """Seeded permutations of range(n), back to back, without end: each
    cycle holds every length once."""
    rng = rng_for(seed, 1)
    while True:
        yield from (int(i) for i in rng.permutation(n))


def voiced(seed: int, batch: int, length: int, sr: int, device) -> torch.Tensor:
    """Voiced tones plus noise: a few harmonics of an f0 in 90-260 Hz with a
    slow vibrato, under a syllable-rate envelope, float32 (batch, length) on
    `device`. The per-row draws are the original's, in its order; the noise
    comes from a generator on the device."""
    rng = np.random.RandomState(seed % 2**32)
    draws = []
    for _ in range(batch):
        f0, vib = rng.uniform(90.0, 260.0), rng.uniform(3, 7)
        draws.append((f0, vib, rng.uniform(2, 5), rng.uniform(0, 6.3)))
    f0, vib, rate, phase0 = (torch.tensor(col, dtype=torch.float64, device=device)[:, None]
                             for col in zip(*draws))
    t = torch.arange(length, dtype=torch.float64, device=device)[None] / sr
    f = f0 * (1.0 + 0.03 * torch.sin(2 * math.pi * vib * t))
    phase = 2 * math.pi * torch.cumsum(f, 1) / sr
    x = sum(torch.sin(h * phase) / h for h in range(1, 6))
    x = x * (0.5 + 0.5 * torch.sin(2 * math.pi * rate * t + phase0) ** 2)
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = torch.randn(batch, length, generator=gen, device=device)
    return (0.15 * x).float() + 0.01 * noise


def mels(seed: int, stream: int, cfg: dict, batch: int, frames: int, device) -> np.ndarray:
    """(batch, n_mels, frames) log-mels of `voiced` audio drawn from (seed,
    stream), float32 on the host, computed with the reference's frontend."""
    audio = voiced(int(rng_for(seed, 2, stream).integers(2**62)), batch,
                   frames * cfg["mel_hop_length"], cfg["sampling_rate"], device)
    with torch.no_grad():
        mel = log_mel(audio, cfg)[..., :frames]
    return mel.cpu().numpy()


def synth_utterance(seed: int, sr: int, duration: float, device) -> np.ndarray:
    """One speech-like utterance of `duration` s at `sr`, float32, fully
    determined by `seed`: a random-walk f0 with an LFO, a harmonic stack
    under three formants, voiced/unvoiced gates, shaped noise and a
    syllabic envelope."""
    rng = np.random.RandomState(seed)
    n = int(duration * sr)
    hop = 256
    n_frames = n // hop + 2
    t_frames = np.arange(n_frames) * hop / sr

    f0_base = rng.uniform(90.0, 350.0)
    walk = np.cumsum(rng.randn(n_frames)) * rng.uniform(0.2, 0.8)
    walk = walk - np.linspace(walk[0], walk[-1], n_frames)
    lfo = rng.uniform(1.0, 4.0) * np.sin(
        2 * np.pi * rng.uniform(4.0, 7.0) * t_frames + rng.uniform(0, 2 * np.pi))
    f0_frames = np.clip(f0_base * (1.0 + 0.01 * walk) + lfo, 60.0, 420.0)

    gate = np.zeros(n_frames)
    n_spans = rng.randint(2, 6)
    edges = np.sort(rng.uniform(0.05, 0.95, 2 * n_spans)) * n_frames
    for a, b in edges.reshape(-1, 2):
        gate[int(a):int(b)] = 1.0
    k = max(3, int(0.03 * sr / hop) | 1)
    gate = np.convolve(gate, np.hanning(k) / np.hanning(k).sum(), mode="same")

    centers = torch.tensor(np.sort(rng.uniform(250.0, 3500.0, 3)), device=device)
    bws = torch.tensor(rng.uniform(80.0, 400.0, 3), device=device)
    gains = torch.tensor(rng.uniform(0.5, 1.0, 3), device=device)

    def formant_amp(freqs):
        a = torch.zeros_like(freqs)
        for c, b, g in zip(centers, bws, gains):
            a = a + g / (1.0 + ((freqs - c) / b) ** 2)
        return a * (1.0 + freqs / 500.0) ** -0.5

    t_samp = np.arange(n) / sr
    f0 = torch.tensor(np.interp(t_samp, t_frames, f0_frames), device=device)
    v = torch.tensor(np.interp(t_samp, t_frames, gate), device=device)

    phase = 2 * math.pi * torch.cumsum(f0, 0) / sr
    max_h = min(int(np.floor((sr / 2 - 200.0) / f0_frames.max())), 40)
    ks = torch.arange(1, max_h + 1, device=device, dtype=torch.float64)
    harm_f = ks[:, None] * f0[None, :]
    amps = formant_amp(harm_f)
    amps[harm_f > sr / 2 - 100.0] = 0.0
    voiced_part = (amps * torch.sin(ks[:, None] * phase[None, :])).sum(0) / max_h**0.5

    white = torch.tensor(rng.randn(n), device=device)
    freqs = torch.fft.rfftfreq(n, 1.0 / sr, device=device, dtype=torch.float64)
    shaped = torch.fft.irfft(torch.fft.rfft(white) * formant_amp(freqs), n)
    shaped = shaped / (shaped.abs().max() + 1e-9)

    t_dev = torch.tensor(t_samp, device=device)
    syl = 0.55 + 0.45 * torch.sin(
        2 * math.pi * rng.uniform(3.0, 7.0) * t_dev + rng.uniform(0, 2 * np.pi))
    audio = syl * (v * (voiced_part + 0.05 * shaped) + (1.0 - v) * 0.35 * shaped)
    audio = audio / (audio.abs().max() + 1e-9) * rng.uniform(0.5, 0.89)
    return audio.float().cpu().numpy()


def write_pcm16(path: Path, audio: np.ndarray, sr: int) -> None:
    pcm = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())


def write_corpus(root: Path, seed: int, mix: dict, sr: int, device) -> Sequence[str]:
    """`mix["utterances"]` utterances of `mix["utterance_s"]` seconds from
    the seed, as 16-bit WAVs under `root`, and a recordings manifest
    (`root/train.jsonl`) that lists each `mix["manifest_repeats"]` times
    (each entry gets its own crops). Returns the manifest's paths in order."""
    base = int(rng_for(seed, 3).integers(2**31))
    root.mkdir(parents=True, exist_ok=True)
    paths = []
    for i in range(mix["utterances"]):
        path = root / f"utt_{i:04d}.wav"
        write_pcm16(path, synth_utterance(base + i, sr, mix["utterance_s"], device), sr)
        paths.append(str(path))
    n = int(mix["utterance_s"] * sr)
    entries = [p for _ in range(mix["manifest_repeats"]) for p in paths]
    with open(root / "train.jsonl", "w") as f:
        for j, p in enumerate(entries):
            f.write(json.dumps({"id": f"utt_{j:05d}", "sampling_rate": sr, "num_samples": n,
                                "duration": n / sr,
                                "sources": [{"type": "file", "channels": [0], "source": p}]}) + "\n")
    return entries
