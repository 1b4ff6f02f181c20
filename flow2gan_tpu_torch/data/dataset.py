"""Host-side data pipeline: recording manifests -> numpy batches. The port's
own copy of `flow2gan_tpu/data/dataset.py`:

- lhotse-style `recordings.jsonl[.gz]` manifests, or a directory scan
  (`scan_dir_to_recordings`);
- `duration`-second crops, read by the native reader (`native_audio`, only
  the crop is decoded; the whole file is read in Python where the library is
  unavailable): at random offsets in training, retried up to
  `max_load_times` while the crop's RMS is below 0.005 (silence), from the
  start in eval; or whole files with `duration=None` (the inference CLIs);
- mono mixdown, with `apply_effects` a random -1..-6 dB peak normalisation
  (-3 dB in eval), polyphase resampling; names relative to `root_path`;
- batches of the crop length, or for whole files of the longest item
  rounded up to `_bucket_length`; silent items are dropped and the batch
  refilled by repeating the others;
- a thread-pool loader, deterministic per (seed, epoch), over this
  process's strided, equal-size shard of the recordings (each process of a
  multi-process run loads its share of the global batch); a training
  loader keeps its position in the epoch (`state_dict`) for a mid-epoch
  resume.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import logging
import os
import queue
import struct
import wave
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.data import native_audio
from flow2gan_tpu_torch.data.audio_io import peak_normalize_db, read_wav, resample
from flow2gan_tpu_torch.parallel import dist

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


def scan_dir_to_recordings(root: Pathlike, pattern: str = "**/*.wav") -> List[Recording]:
    """Recordings of the files under `root` that match `pattern`, from their
    WAV headers (a float WAV, which `wave` cannot parse, is read whole)."""
    recs = []
    for p in sorted(Path(root).glob(pattern)):
        try:
            with wave.open(str(p), "rb") as w:
                sr, n = w.getframerate(), w.getnframes()
        except (wave.Error, EOFError, struct.error):
            audio, sr = read_wav(p)
            n = audio.shape[-1]
        recs.append(Recording(id=p.stem, path=str(p), sampling_rate=sr, num_samples=n))
    return recs


class RecordingDataset:
    """Map-style dataset of `duration`-second crops, or of whole files when
    `duration` is None. Item i of epoch e -> (audio float32 (T,), silence,
    name), with its randomness from (seed, e, i); the name is the path,
    relative to `root_path` when one is given."""

    min_rms = 0.005

    def __init__(self, recordings: Sequence[Recording], sampling_rate: int = 24000,
                 root_path: Optional[str] = None, train: bool = False,
                 duration: Optional[float] = None, apply_effects: bool = True,
                 max_load_times: int = 1, seed: int = 0):
        self.recordings = list(recordings)
        self.sampling_rate = sampling_rate
        self.root_path = root_path
        self.train = train
        self.duration = duration
        self.apply_effects = apply_effects
        self.max_load_times = max_load_times
        self.seed = seed

    def __len__(self) -> int:
        return len(self.recordings)

    @staticmethod
    def _load_slice(rec: Recording, offset_sec: float, dur_sec: float):
        start = int(offset_sec * rec.sampling_rate)
        n = int(dur_sec * rec.sampling_rate)
        crop = native_audio.read_crop_mono(rec.path, start, n)  # decodes only the crop
        if crop is not None:
            return crop[None, :], rec.sampling_rate
        audio, sr = read_wav(rec.path)
        return audio[:, start : start + n], sr

    def __getitem__(self, index: int, epoch: int = 0):
        rec = self.recordings[index]
        rng = np.random.RandomState(((self.seed + 31 * epoch) * 1_000_003 + index) % (2**32))
        name = rec.path if self.root_path is None else os.path.relpath(rec.path, self.root_path)

        def is_silence(x):
            return float(np.sqrt(np.mean(x**2))) < self.min_rms

        if self.duration is None:
            y, sr = read_wav(rec.path)
            silence = is_silence(y)
        elif not self.train:
            y, sr = self._load_slice(rec, 0.0, min(self.duration, rec.duration))
            silence = is_silence(y)
        else:
            duration = min(self.duration, rec.duration)
            for _ in range(max(1, self.max_load_times)):
                offset = rng.uniform(0, rec.duration - duration)
                y, sr = self._load_slice(rec, offset, duration)
                silence = is_silence(y)
                if not silence:
                    break

        if y.shape[0] > 1:
            y = y.mean(axis=0, keepdims=True)
        if self.apply_effects:
            y = peak_normalize_db(y, rng.uniform(-1, -6) if self.train else -3.0)
        if sr != self.sampling_rate:
            y = resample(y, sr, self.sampling_rate)
        return y[0].astype(np.float32), silence, name


def _bucket_length(n: int, quantum: int = 4096) -> int:
    """`n` rounded up to a multiple of `quantum`, so that whole-file batches
    come in few shapes."""
    return -(-n // quantum) * quantum


def pad_collate(items, length: Optional[int]) -> Dict[str, np.ndarray]:
    """Collate (audio, silence, name) items into a batch zero-padded to
    `length`, or with `length=None` to the longest item's `_bucket_length`.
    Silent items are dropped and the others repeated to refill the batch, so
    the step sees one batch shape."""
    orig_n = len(items)
    kept = [x for x in items if not x[1]]
    if not kept:
        logging.warning("No non-silent audio in the batch, using the first item as fallback.")
        kept = list(items[0:1])
    kept = kept + [kept[i % len(kept)] for i in range(orig_n - len(kept))]

    lens = np.asarray([len(x[0]) for x in kept], np.int32)
    if length is None:
        length = _bucket_length(int(lens.max()))
    audios = np.zeros((len(kept), length), np.float32)
    for i, (a, _, _) in enumerate(kept):
        audios[i, : min(len(a), length)] = a[:length]
    return {"audio": audios, "audio_lens": np.minimum(lens, length),
            "file_names": [x[2] for x in kept]}


class DataLoader:
    """Thread-pool prefetching loader over a `RecordingDataset`, its batches
    padded to the crop length (whole files: see `pad_collate`).
    Deterministic per (seed, epoch): call `set_epoch` each epoch.

    Process `process_index` of `process_count` (default: this rank of the
    process group) loads the strided shard idx[index::count] of the
    epoch's order, cut to equal sizes; a dataset smaller than the process
    count is loaded whole by every process. A `resumable` loader counts the
    batches it has handed out this epoch: `state_dict()` is (epoch,
    consumed), and after `load_state_dict` the next pass skips the batches
    already consumed. A pass that runs to its end resets the count, so a
    loader iterated again without `set_epoch` replays the epoch.
    """

    prefetch = 4  # batches waiting beyond the workers' own

    def __init__(self, dataset: RecordingDataset, batch_size: int, shuffle: bool = False,
                 num_workers: int = 8, drop_last: bool = False, seed: int = 0,
                 process_index: Optional[int] = None, process_count: Optional[int] = None,
                 resumable: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.length = (None if dataset.duration is None
                       else int(dataset.duration * dataset.sampling_rate))
        self.seed = seed
        self.epoch = 0
        if process_index is None or process_count is None:
            process_index, process_count = dist.shard()
        self.process_index = process_index
        self.process_count = process_count
        self.resumable = resumable
        self._consumed = 0  # batches handed out this epoch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._consumed = 0

    def state_dict(self) -> Dict[str, int]:
        """The position in the epoch: the batch order is fixed by (seed,
        epoch), so the epoch and the count of batches consumed suffice."""
        return {"epoch": self.epoch, "consumed": self._consumed}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self.epoch = int(state["epoch"])
        self._consumed = int(state["consumed"])

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(idx)
        per = n // self.process_count
        if per == 0:
            return idx
        return idx[: per * self.process_count][self.process_index :: self.process_count]

    def __len__(self) -> int:
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        batches = [indices[i : i + self.batch_size] for i in range(0, len(indices), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]
        if self.resumable and self._consumed:
            batches = batches[self._consumed :]
        if not batches:
            self._consumed = 0
            return
        epoch = self.epoch

        def load_batch(idx_list):
            with tracing.span("loader.assemble"):
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
                with tracing.span("loader.wait"):
                    item = out_q.get()
                if item is None:
                    # the end of the epoch's stream (an early break by the
                    # consumer skips this and keeps the position)
                    self._consumed = 0
                    break
                if isinstance(item, Exception):
                    raise item
                # counted before it is handed out: the trainer checkpoints
                # between batches, and this one is then consumed
                self._consumed += 1
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
    root_path: Optional[str] = None,
    sampling_rate: int = 24000,
    batch_size: int = 256,
    num_workers: int = 8,
    train: bool = False,
    duration: Optional[float] = None,
    apply_effects: bool = True,
    max_load_times: int = 1,
    seed: int = 0,
    drop_last: bool = False,
) -> DataLoader:
    """A loader of `duration`-second crops, shuffled and at random offsets
    for training, padded to the crop length; or of whole files
    (`duration=None`) in manifest order. This process's shard; only a
    training loader is resumable (eval loaders are iterated again and again
    without `set_epoch`)."""
    dataset = RecordingDataset(recordings, sampling_rate=sampling_rate, root_path=root_path,
                               train=train, duration=duration, apply_effects=apply_effects,
                               max_load_times=max_load_times, seed=seed)
    return DataLoader(dataset, batch_size=batch_size, shuffle=train, num_workers=num_workers,
                      drop_last=drop_last, seed=seed, resumable=train)
