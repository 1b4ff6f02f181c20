"""Host-side data pipeline: recording manifests -> fixed-shape numpy batches.
The port's own copy of `flow2gan_tpu/data/dataset.py`, as far as the
trainer uses it, on the pure-Python read path (the whole WAV is read, then
cropped):

- lhotse-style `recordings.jsonl[.gz]` manifests;
- `duration`-second crops: at random offsets in training, retried up to
  `max_load_times` while the crop's RMS is below 0.005 (silence), from the
  start in eval; mono mixdown, a random -1..-6 dB peak normalisation (-3 dB
  in eval), polyphase resampling;
- batches of the crop length; silent items are dropped and the batch
  refilled by repeating the others;
- a thread-pool loader, deterministic per (seed, epoch).

Whole-file loading (the inference CLIs) and per-process sharding wait for
their slices (ROADMAP.md, slices 4 and 6).
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import logging
import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Sequence, Union

import numpy as np

from flow2gan_tpu_torch.data.audio_io import peak_normalize_db, read_wav, resample

Pathlike = Union[str, Path]


@dataclasses.dataclass(frozen=True)
class Recording:
    id: str
    path: str
    sampling_rate: int
    num_samples: int

    @property
    def duration(self) -> float:
        return self.num_samples / self.sampling_rate


def read_recording_manifest(path: Pathlike) -> List[Recording]:
    """Parse a lhotse-style recordings.jsonl[.gz] manifest."""
    path = str(path)
    opener = gzip.open if path.endswith(".gz") else open
    recs = []
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            recs.append(Recording(id=d["id"], path=d["sources"][0]["source"],
                                  sampling_rate=int(d["sampling_rate"]),
                                  num_samples=int(d["num_samples"])))
    return recs


def write_recording_manifest(recs: Sequence[Recording], path: Pathlike) -> None:
    path = str(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wt") as f:
        for r in recs:
            f.write(json.dumps({
                "id": r.id,
                "sources": [{"type": "file", "channels": [0], "source": r.path}],
                "sampling_rate": r.sampling_rate,
                "num_samples": r.num_samples,
                "duration": r.duration,
            }) + "\n")


class RecordingDataset:
    """Map-style dataset of `duration`-second crops. Item i of epoch e ->
    (audio float32 (T,), silence, path), with its randomness from (seed, e,
    i)."""

    min_rms = 0.005

    def __init__(self, recordings: Sequence[Recording], duration: float,
                 sampling_rate: int = 24000, train: bool = False, max_load_times: int = 1,
                 seed: int = 0):
        self.recordings = list(recordings)
        self.duration = duration
        self.sampling_rate = sampling_rate
        self.train = train
        self.max_load_times = max_load_times
        self.seed = seed

    def __len__(self) -> int:
        return len(self.recordings)

    @staticmethod
    def _load_slice(rec: Recording, offset_sec: float, dur_sec: float):
        start = int(offset_sec * rec.sampling_rate)
        audio, sr = read_wav(rec.path)
        return audio[:, start : start + int(dur_sec * rec.sampling_rate)], sr

    def __getitem__(self, index: int, epoch: int = 0):
        rec = self.recordings[index]
        rng = np.random.RandomState(((self.seed + 31 * epoch) * 1_000_003 + index) % (2**32))

        def is_silence(x):
            return float(np.sqrt(np.mean(x**2))) < self.min_rms

        duration = min(self.duration, rec.duration)
        if not self.train:
            y, sr = self._load_slice(rec, 0.0, duration)
            silence = is_silence(y)
        else:
            for _ in range(max(1, self.max_load_times)):
                offset = rng.uniform(0, rec.duration - duration)
                y, sr = self._load_slice(rec, offset, duration)
                silence = is_silence(y)
                if not silence:
                    break

        if y.shape[0] > 1:
            y = y.mean(axis=0, keepdims=True)
        y = peak_normalize_db(y, rng.uniform(-1, -6) if self.train else -3.0)
        if sr != self.sampling_rate:
            y = resample(y, sr, self.sampling_rate)
        return y[0].astype(np.float32), silence, rec.path


def pad_collate(items, length: int) -> Dict[str, np.ndarray]:
    """Collate (audio, silence, name) items into a batch zero-padded to
    `length`. Silent items are dropped and the others repeated to refill the
    batch, so the step sees one batch shape."""
    orig_n = len(items)
    kept = [x for x in items if not x[1]]
    if not kept:
        logging.warning("No non-silent audio in the batch, using the first item as fallback.")
        kept = list(items[0:1])
    kept = kept + [kept[i % len(kept)] for i in range(orig_n - len(kept))]

    lens = np.asarray([len(x[0]) for x in kept], np.int32)
    audios = np.zeros((len(kept), length), np.float32)
    for i, (a, _, _) in enumerate(kept):
        audios[i, : min(len(a), length)] = a[:length]
    return {"audio": audios, "audio_lens": np.minimum(lens, length),
            "file_names": [x[2] for x in kept]}


class DataLoader:
    """Thread-pool prefetching loader over a `RecordingDataset`, its batches
    padded to the crop length. Deterministic per (seed, epoch): call
    `set_epoch` each epoch."""

    prefetch = 4  # batches waiting beyond the workers' own

    def __init__(self, dataset: RecordingDataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.length = int(dataset.duration * dataset.sampling_rate)
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        return idx

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        batches = [indices[i : i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        epoch = self.epoch

        def load_batch(idx_list):
            items = [self.dataset.__getitem__(int(i), epoch=epoch) for i in idx_list]
            return pad_collate(items, self.length)

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # a bounded window of decodes in flight, not the whole epoch
            window = self.num_workers + self.prefetch
            with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
                inflight: deque = deque()
                it = iter(batches)
                try:
                    while True:
                        while len(inflight) < window:
                            nxt = next(it, None)
                            if nxt is None:
                                break
                            inflight.append(ex.submit(load_batch, nxt))
                        if not inflight or stop.is_set():
                            for fut in inflight:
                                fut.cancel()
                            break
                        try:
                            out_q.put(inflight.popleft().result())
                        except Exception as e:  # the consumer raises it
                            out_q.put(e)
                finally:
                    out_q.put(None)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # let a producer blocked on a full queue see the stop
            while thread.is_alive():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.05)


def build_data_loader(
    recordings: Sequence[Recording],
    duration: float,
    sampling_rate: int = 24000,
    batch_size: int = 256,
    num_workers: int = 8,
    train: bool = False,
    max_load_times: int = 1,
    seed: int = 0,
    drop_last: bool = False,
) -> DataLoader:
    """A loader of `duration`-second crops, shuffled and at random offsets
    for training, padded to the crop length."""
    dataset = RecordingDataset(recordings, duration, sampling_rate=sampling_rate, train=train,
                               max_load_times=max_load_times, seed=seed)
    return DataLoader(dataset, batch_size=batch_size, shuffle=train, num_workers=num_workers,
                      drop_last=drop_last, seed=seed)
