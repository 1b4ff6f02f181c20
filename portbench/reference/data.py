"""The reference's own reading of a training batch from the corpus's WAV
files: the crops the training recipe's loader defines (a recording's
`duration`-second crop at a seeded random offset, retried while silent, a
random -1..-6 dB peak normalisation; the epoch's seeded shuffle, each
process's strided share, batches in order; silent items dropped and the
batch refilled by repeating the others), worked out again from the raw
files and the loader's seed, epoch and position."""

from __future__ import annotations

import wave
from typing import List, Sequence, Tuple

import numpy as np

MIN_RMS = 0.005


def read_pcm16(path: str) -> np.ndarray:
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: the corpus is mono 16-bit PCM")
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32768.0


def crop(samples: np.ndarray, sr: int, seed: int, epoch: int, index: int, duration: float,
         max_load_times: int) -> Tuple[np.ndarray, bool]:
    rng = np.random.RandomState(((seed + 31 * epoch) * 1_000_003 + index) % (2**32))
    rec_dur = len(samples) / sr
    dur = min(duration, rec_dur)
    for _ in range(max(1, max_load_times)):
        start = int(rng.uniform(0, rec_dur - dur) * sr)
        y = samples[start:start + int(dur * sr)]
        silent = float(np.sqrt(np.mean(y**2))) < MIN_RMS
        if not silent:
            break
    peak = np.abs(y).max()
    db = rng.uniform(-1, -6)
    if peak > 0:
        y = (y * (10.0 ** (db / 20.0) / peak)).astype(np.float32)
    return y, silent


def batch(paths: Sequence[str], sr: int, seed: int, epoch: int, position: int,
          batch_size: int, rank: int, world: int, duration: float,
          max_load_times: int) -> Tuple[np.ndarray, np.ndarray]:
    """Batch `position` of `rank`'s share in `epoch`: (audio (B, L) float32,
    lens (B,) int32), L = duration * sr."""
    idx = np.arange(len(paths))
    np.random.RandomState(seed + epoch).shuffle(idx)
    per = len(paths) // world
    mine = idx[: per * world][rank::world]
    rows = mine[position * batch_size:(position + 1) * batch_size]
    cache = {}
    items: List[Tuple[np.ndarray, bool]] = []
    for i in rows:
        path = paths[int(i)]
        if path not in cache:
            cache[path] = read_pcm16(path)
        items.append(crop(cache[path], sr, seed, epoch, int(i), duration, max_load_times))
    kept = [x for x in items if not x[1]] or items[:1]
    kept = kept + [kept[i % len(kept)] for i in range(len(items) - len(kept))]
    length = int(duration * sr)
    audio = np.zeros((len(kept), length), np.float32)
    lens = np.zeros(len(kept), np.int32)
    for j, (y, _) in enumerate(kept):
        audio[j, : min(len(y), length)] = y[:length]
        lens[j] = min(len(y), length)
    return audio, lens


def global_batch(paths, sr, seed, epoch, position, local_batch, world, duration,
                 max_load_times) -> Tuple[np.ndarray, np.ndarray]:
    """The global batch: every rank's batch `position`, in rank order."""
    parts = [batch(paths, sr, seed, epoch, position, local_batch, r, world, duration,
                   max_load_times) for r in range(world)]
    return np.concatenate([a for a, _ in parts]), np.concatenate([b for _, b in parts])
