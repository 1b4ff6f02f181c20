#!/usr/bin/env python3
"""Cut a handful of WAV files into a LibriTTS-shaped rehearsal corpus; the
port's counterpart of the JAX repo's `scripts/make_rehearsal_corpus.py`,
with its flags, but `--source-dir` is required.

    python -m flow2gan_tpu_torch.bin.make_rehearsal_corpus --source-dir wavs \
        --corpus-dir data/LibriTTS --data-dir data/manifests

It writes the layout `recipes/run_libritts.sh` reads:

  <corpus-dir>/train-clean-100/<spk>/<chap>/seg_%04d.wav   dense crops
  <corpus-dir>/test-clean/<spk>/<chap>/test_%04d.wav       held-out*
  <corpus-dir>/dev-clean/<spk>/<chap>/dev_0000.wav

and lhotse-style manifests, plus `test_clean_files.txt`. *The test crops
partition the longest source, which the train crops cover densely: the
corpus measures how well a model reconstructs audio it trained on, not how
it generalises (`make_synthetic_corpus` is for that).

--train-repeat N writes each train crop N times into the train manifest
(distinct ids, same file), so that an epoch is N times longer; each entry
draws its own crop offset every epoch.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from flow2gan_tpu_torch.data.audio_io import read_wav, resample, write_wav
from flow2gan_tpu_torch.data.dataset import Recording, write_recording_manifest


def get_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source-dir", type=Path, required=True,
                   help="Directory of source WAVs (all at one rate after --resample-to)")
    p.add_argument("--corpus-dir", type=Path, required=True)
    p.add_argument("--data-dir", type=Path, required=True, help="manifest output dir")
    p.add_argument("--spk", type=str, default="1089")
    p.add_argument("--chap", type=str, default="134686")
    p.add_argument("--crop-sec", type=float, default=2.0)
    p.add_argument("--stride-sec", type=float, default=0.1)
    p.add_argument("--train-repeat", type=int, default=1)
    p.add_argument("--n-test", type=int, default=6,
                   help="contiguous test crops cut from the longest source")
    p.add_argument("--resample-to", type=int, default=None,
                   help="resample all source audio to this rate before cropping (e.g. 44100)")
    return p


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    wavs = sorted(args.source_dir.glob("*.wav"))
    if not wavs:
        raise SystemExit(f"no wavs under {args.source_dir}")
    loaded = []
    for w in wavs:
        audio, sr = read_wav(w)  # (C, T)
        mono = audio.mean(axis=0) if audio.ndim == 2 else audio
        if args.resample_to is not None and sr != args.resample_to:
            mono = resample(mono, sr, args.resample_to)
            sr = args.resample_to
        loaded.append((w, mono.astype(np.float32), sr))
    loaded.sort(key=lambda t: -t[1].shape[-1])
    _, long_audio, sr = loaded[0]
    if any(s != sr for _, _, s in loaded):
        raise SystemExit("mixed sample rates: pass --resample-to")

    crop = int(args.crop_sec * sr)
    stride = int(args.stride_sec * sr)
    sub = Path(args.spk) / args.chap

    def put(split, name, audio):
        out = args.corpus_dir / split / sub / f"{name}.wav"
        out.parent.mkdir(parents=True, exist_ok=True)
        write_wav(out, audio, sr)
        return Recording(id=name, path=str(out), sampling_rate=sr, num_samples=audio.shape[-1])

    # train: dense overlapping crops of the longest source
    train = [put("train-clean-100", f"seg_{i:04d}", long_audio[start:start + crop])
             for i, start in enumerate(range(0, long_audio.shape[-1] - crop + 1, stride))]
    # test: a partition of the longest source, then the other sources whole;
    # dev: the shortest source
    test = []
    for i in range(args.n_test):
        seg = long_audio[i * crop:(i + 1) * crop]
        if seg.shape[-1] < crop // 2:
            break
        test.append(put("test-clean", f"test_{i:04d}", seg))
    for _, audio, _ in loaded[1:]:
        test.append(put("test-clean", f"test_{len(test):04d}", audio))
    dev_audio = loaded[-1][1] if len(loaded) > 1 else long_audio[:crop]
    dev = [put("dev-clean", "dev_0000", dev_audio)]

    args.data_dir.mkdir(parents=True, exist_ok=True)
    train_m = [rec if r == 0 else Recording(id=f"{rec.id}#r{r}", path=rec.path,
                                            sampling_rate=rec.sampling_rate,
                                            num_samples=rec.num_samples)
               for r in range(args.train_repeat) for rec in train]
    write_recording_manifest(train_m, args.data_dir / "libritts_recordings_train_clean_100.jsonl.gz")
    write_recording_manifest(test, args.data_dir / "libritts_recordings_test_clean.jsonl.gz")
    write_recording_manifest(dev, args.data_dir / "libritts_recordings_dev_clean.jsonl.gz")
    (args.data_dir / "test_clean_files.txt").write_text(
        "\n".join(str(Path(r.path).relative_to(args.corpus_dir / "test-clean")) for r in test)
        + "\n")
    print(f"corpus: {len(train)} train crops (x{args.train_repeat} in manifest), {len(test)} "
          f"test, {len(dev)} dev @ {sr} Hz -> {args.corpus_dir}")


if __name__ == "__main__":
    main()
