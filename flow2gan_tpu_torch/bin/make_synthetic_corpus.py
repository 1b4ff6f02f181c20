#!/usr/bin/env python3
"""Procedural speech-like corpus with disjoint train and test parameter
draws, for held-out evaluation without downloads; the port's counterpart of
the JAX repo's `scripts/make_synthetic_corpus.py`, with its flags, and for
the same flags the same WAV samples and manifests.

Each utterance is synthesised from its own seeded draw of:

  - an f0 contour (a random-walk pitch of 90-350 Hz with an LFO),
  - a harmonic stack shaped by 3 formant-like resonances,
  - voiced/unvoiced spans with smooth gates, formant-shaped noise in the
    unvoiced spans and breath noise in the voiced ones,
  - a syllabic (3-7 Hz) amplitude envelope,

so that MR-STFT, pitch, periodicity and V/UV metrics all have structure to
measure. Train, test and dev draw from disjoint seed ranges (seed + i,
seed + 100000 + i, seed + 200000 + i): a model scores well on test only by
generalising.

    python -m flow2gan_tpu_torch.bin.make_synthetic_corpus \
        --corpus-dir data/LibriTTS --data-dir data/manifests

Layout and manifests are those `recipes/run_libritts.sh` reads:
  <corpus-dir>/{train-clean-100,dev-clean,test-clean}/9999/000000/*.wav
  <data-dir>/libritts_recordings_{train_clean_100,test_clean,dev_clean}.jsonl.gz
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from flow2gan_tpu_torch.data.audio_io import write_wav
from flow2gan_tpu_torch.data.dataset import Recording, write_recording_manifest

# split -> (seed offset, manifest name, file prefix)
SPLITS = {
    "train-clean-100": (0, "train_clean_100", "syn"),
    "test-clean": (100_000, "test_clean", "test"),
    "dev-clean": (200_000, "dev_clean", "dev"),
}


def synth_utterance(seed: int, sr: int, duration: float) -> np.ndarray:
    """One speech-like utterance of `duration` s at `sr`, float32, fully
    determined by `seed`."""
    rng = np.random.RandomState(seed)
    n = int(duration * sr)
    hop = 256
    n_frames = n // hop + 2
    t_frames = np.arange(n_frames) * hop / sr

    # f0 contour: a per-utterance base, a detrended slow random walk, an LFO
    f0_base = rng.uniform(90.0, 350.0)
    walk = np.cumsum(rng.randn(n_frames)) * rng.uniform(0.2, 0.8)
    walk = walk - np.linspace(walk[0], walk[-1], n_frames)
    lfo = rng.uniform(1.0, 4.0) * np.sin(
        2 * np.pi * rng.uniform(4.0, 7.0) * t_frames + rng.uniform(0, 2 * np.pi))
    f0_frames = np.clip(f0_base * (1.0 + 0.01 * walk) + lfo, 60.0, 420.0)

    # voiced/unvoiced gate: 2-5 voiced spans, smoothed over ~30 ms
    gate = np.zeros(n_frames)
    n_spans = rng.randint(2, 6)
    edges = np.sort(rng.uniform(0.05, 0.95, 2 * n_spans)) * n_frames
    for a, b in edges.reshape(-1, 2):
        gate[int(a):int(b)] = 1.0
    k = max(3, int(0.03 * sr / hop) | 1)
    gate = np.convolve(gate, np.hanning(k) / np.hanning(k).sum(), mode="same")

    # formant envelope: 3 resonances and a gentle spectral tilt
    centers = np.sort(rng.uniform(250.0, 3500.0, 3))
    bws = rng.uniform(80.0, 400.0, 3)
    gains = rng.uniform(0.5, 1.0, 3)

    def formant_amp(freqs):
        a = np.zeros_like(freqs)
        for c, b, g in zip(centers, bws, gains):
            a = a + g / (1.0 + ((freqs - c) / b) ** 2)
        return a * (1.0 + freqs / 500.0) ** -0.5

    t_samp = np.arange(n) / sr
    f0 = np.interp(t_samp, t_frames, f0_frames)
    v = np.interp(t_samp, t_frames, gate)

    # harmonic stack, at most 40 harmonics, none within 100 Hz of Nyquist
    phase = 2 * np.pi * np.cumsum(f0) / sr
    max_h = min(int(np.floor((sr / 2 - 200.0) / f0_frames.max())), 40)
    ks = np.arange(1, max_h + 1)
    harm_f = ks[:, None] * f0[None, :]
    amps = formant_amp(harm_f)
    amps[harm_f > sr / 2 - 100.0] = 0.0
    voiced = (amps * np.sin(ks[:, None] * phase[None, :])).sum(axis=0)
    voiced /= max_h**0.5

    # formant-shaped broadband noise
    white = rng.randn(n).astype(np.float64)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    shaped = np.fft.irfft(np.fft.rfft(white) * formant_amp(freqs), n)
    shaped /= np.abs(shaped).max() + 1e-9

    syl = 0.55 + 0.45 * np.sin(
        2 * np.pi * rng.uniform(3.0, 7.0) * t_samp + rng.uniform(0, 2 * np.pi))

    audio = syl * (v * (voiced + 0.05 * shaped) + (1.0 - v) * 0.35 * shaped)
    audio = audio / (np.abs(audio).max() + 1e-9) * rng.uniform(0.5, 0.89)
    return audio.astype(np.float32)


def get_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--corpus-dir", type=Path, required=True)
    p.add_argument("--data-dir", type=Path, required=True, help="Manifest output dir")
    p.add_argument("--sampling-rate", type=int, default=24000)
    p.add_argument("--n-train", type=int, default=300)
    p.add_argument("--n-test", type=int, default=20)
    p.add_argument("--n-dev", type=int, default=4)
    p.add_argument("--duration", type=float, default=3.0)
    p.add_argument("--train-repeat", type=int, default=1,
                   help="Write each train utterance N times into the train manifest (longer "
                   "epochs; independent crops per epoch)")
    p.add_argument("--seed", type=int, default=0)
    return p


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    sr = args.sampling_rate
    counts = {"train-clean-100": args.n_train, "test-clean": args.n_test,
              "dev-clean": args.n_dev}
    args.data_dir.mkdir(parents=True, exist_ok=True)
    for split, (offset, manifest, prefix) in SPLITS.items():
        recs = []
        d = args.corpus_dir / split / "9999" / "000000"
        d.mkdir(parents=True, exist_ok=True)
        repeats = args.train_repeat if split == "train-clean-100" else 1
        for i in range(counts[split]):
            audio = synth_utterance(args.seed + offset + i, sr, args.duration)
            path = d / f"{prefix}_{i:04d}.wav"
            write_wav(path, audio, sr)
            rid = f"{prefix}_{i:04d}"
            recs += [Recording(id=rid if r == 0 else f"{rid}_rep{r}", path=str(path),
                               sampling_rate=sr, num_samples=len(audio))
                     for r in range(repeats)]
        write_recording_manifest(recs, args.data_dir / f"libritts_recordings_{manifest}.jsonl.gz")
    print(f"synthetic corpus: {args.n_train} train (x{args.train_repeat} in manifest), "
          f"{args.n_test} test, {args.n_dev} dev @ {sr} Hz -> {args.corpus_dir} "
          "(disjoint seed ranges)")


if __name__ == "__main__":
    main()
