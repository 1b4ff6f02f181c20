#!/usr/bin/env python3
"""Pitch RMSE (cents), periodicity RMSE and voiced/unvoiced F1 between a
directory of generated WAVs and the ground truth; the port's counterpart of
the JAX repo's `scripts/compute_pitch_periodicity.py`, with its flags and
output.

    python -m flow2gan_tpu_torch.bin.compute_pitch_periodicity \
        --ref-dir data/LibriTTS/test-clean \
        --gen-dir exp/gan_1step/test_clean_wavs/test-clean --output metrics_pitch.json

Both signals are resampled to 16 kHz and tracked at hop 256 between 50 and
550 Hz: by `torchcrepe` ("full", on the CPU) where it is installed, else by
the YIN tracker below (de Cheveigné and Kawahara, 2002), whose periodicity is
1 - the minimum of the cumulative mean normalised difference. A frame is
voiced where its periodicity exceeds 0.5. Pitch RMSE is taken on the frames
voiced in both, periodicity RMSE on all frames, F1 on the voiced decisions.
It fails (exit 2, nothing written) when no pair of files is found to score.
"""

from __future__ import annotations

import argparse
import logging
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

from flow2gan_tpu_torch.bin.compute_pesq_visqol import file_pairs, refuse_empty, write_results

FMIN, FMAX = 50.0, 550.0
HOP = 256
PERIODICITY_THRESHOLD = 0.5


def get_parser():
    p = argparse.ArgumentParser(description="Pitch / periodicity / V-UV F1")
    p.add_argument("--ref-dir", type=Path, required=True)
    p.add_argument("--gen-dir", type=Path, required=True)
    p.add_argument("--file-list", type=Path, default=None)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--output", type=Path, default=None)
    return p


def yin_track(audio: np.ndarray, sr: int, hop: int = HOP):
    """YIN pitch and periodicity per hop: (f0 in Hz, periodicity in [0, 1])."""
    tau_min = int(sr / FMAX)
    tau_max = int(sr / FMIN)
    frame = 2 * tau_max
    n_frames = max(0, (len(audio) - frame) // hop + 1)
    f0 = np.zeros(n_frames)
    period = np.zeros(n_frames)
    taus = np.arange(tau_max + 1)
    for i in range(n_frames):
        x = audio[i * hop:i * hop + frame].astype(np.float64)
        w = len(x)
        # d(tau) = sum_{j < w - tau} (x_j - x_{j+tau})^2
        #        = head energy + tail energy - 2 * autocorrelation
        spec = np.fft.rfft(x, 2 * w)
        ac = np.fft.irfft(spec * np.conj(spec))[:tau_max + 1]
        cumsq = np.concatenate([[0.0], np.cumsum(x**2)])
        head = cumsq[w - taus]
        tail = cumsq[w] - cumsq[taus]
        d = np.maximum(head + tail - 2.0 * ac, 0.0)
        # cumulative mean normalised difference
        cmnd = np.ones(tau_max + 1)
        denom = np.cumsum(d[1:])
        cmnd[1:] = d[1:] * np.arange(1, tau_max + 1) / np.maximum(denom, 1e-12)
        seg = cmnd[tau_min:tau_max + 1]
        # YIN's absolute threshold: the first dip below 0.1, walked to its
        # minimum, else the global minimum (avoids octave-down errors)
        below = np.flatnonzero(seg < 0.1)
        if below.size:
            j = below[0]
            while j + 1 < len(seg) and seg[j + 1] < seg[j]:
                j += 1
            tau = int(j) + tau_min
        else:
            tau = int(np.argmin(seg)) + tau_min
        # parabolic interpolation around the minimum
        if tau_min < tau < tau_max:
            a, b, c = cmnd[tau - 1], cmnd[tau], cmnd[tau + 1]
            denom2 = a - 2 * b + c
            if abs(denom2) > 1e-12:
                tau = tau + 0.5 * (a - c) / denom2
        f0[i] = sr / tau if tau > 0 else 0.0
        period[i] = float(np.clip(1.0 - seg.min(), 0.0, 1.0))
    return f0, period


def pitch_metrics(f0_r, per_r, f0_g, per_g) -> dict:
    """Pitch RMSE (cents, frames voiced in both), periodicity RMSE and V/UV
    F1 of one pair of tracks."""
    n = min(len(f0_r), len(f0_g))
    f0_r, per_r, f0_g, per_g = f0_r[:n], per_r[:n], f0_g[:n], per_g[:n]
    v_r = per_r > PERIODICITY_THRESHOLD
    v_g = per_g > PERIODICITY_THRESHOLD
    both = v_r & v_g & (f0_r > 0) & (f0_g > 0)
    out = {"pitch_rmse_cents": None}
    if both.sum() > 0:
        cents = 1200.0 * np.log2(f0_g[both] / f0_r[both])
        out["pitch_rmse_cents"] = float(np.sqrt(np.mean(cents**2)))
    out["periodicity_rmse"] = float(np.sqrt(np.mean((per_r - per_g) ** 2)))
    tp = float((v_r & v_g).sum())
    precision = tp / max(float(v_g.sum()), 1.0)
    recall = tp / max(float(v_r.sum()), 1.0)
    out["vuv_f1"] = 2 * precision * recall / max(precision + recall, 1e-9)
    return out


def compute_one(pair) -> dict:
    """The metrics of one (ref, gen) pair. Runs in a worker process, on the
    CPU."""
    from flow2gan_tpu_torch.data.audio_io import read_wav, resample

    ref_path, gen_path = pair
    ref, sr_r = read_wav(ref_path)
    gen, sr_g = read_wav(gen_path)
    sr = 16000
    ref = resample(ref.mean(0), sr_r, sr)
    gen = resample(gen.mean(0), sr_g, sr)
    n = min(len(ref), len(gen))
    ref, gen = ref[:n], gen[:n]

    try:
        import torch
        import torchcrepe

        def track(x):
            with torch.no_grad():
                f0, per = torchcrepe.predict(torch.from_numpy(x[None]).float(), sr, HOP, FMIN,
                                             FMAX, "full", return_periodicity=True,
                                             batch_size=512, device="cpu")
            return f0[0].numpy(), per[0].numpy()

    except ImportError:

        def track(x):
            return yin_track(x, sr)

    return {"file": str(gen_path), **pitch_metrics(*track(ref), *track(gen))}


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    pairs = file_pairs(args.ref_dir, args.gen_dir, args.file_list)
    refuse_empty(pairs, args)
    with ProcessPoolExecutor(max_workers=args.num_workers) as ex:
        results = list(ex.map(compute_one, pairs))
    summary = {}
    for key in ("pitch_rmse_cents", "periodicity_rmse", "vuv_f1"):
        vals = [r[key] for r in results if r.get(key) is not None]
        summary[key] = float(np.mean(vals)) if vals else None
    summary["n_files"] = len(results)
    write_results(summary, results, args.output)
    return summary


if __name__ == "__main__":
    main()
