#!/usr/bin/env python3
"""Fit the k-means pseudo-codec codebook of a token-conditioned config with
the port; the counterpart of the JAX package's `scripts/train_tokenizer.py`,
with its flags and defaults, and `--device`.

Reads a recordings manifest, computes log-mel frames with the named config's
frontend on `--device` (default cuda; the tests pass cpu), Lloyd-fits
`vocab_size` centroids on the CPU (`ops/tokenizer.py kmeans_fit`) and writes
the self-describing `.npz` codebook that `bin/pretrain.py`, `bin/finetune.py`,
`bin/infer.py` and `bin/infer_dir.py` take as `--tokenizer`, and that the
JAX package loads as well.

    python -m flow2gan_tpu_torch.bin.train_tokenizer --model-name token_24k_base \
        --recordings data/train.jsonl.gz --output exp/tokenizer_1024.npz

Each recording is zero-padded to whole seconds and its mel cut back to the
frames that the padding cannot reach, as the JAX script does (there, so that
its jitted mel compiles once per length bucket), so both fit the same frames.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np
import torch

from flow2gan_tpu_torch.data.audio_io import read_wav, resample
from flow2gan_tpu_torch.data.dataset import read_recording_manifest
from flow2gan_tpu_torch.models import get_generator_config
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram
from flow2gan_tpu_torch.ops.tokenizer import MelKMeansTokenizer, kmeans_fit
from flow2gan_tpu_torch.utils import disable_tf32


def get_parser():
    p = argparse.ArgumentParser(description="Fit the k-means pseudo-codec codebook "
                                "for token-conditioned training (the PyTorch port)",
                                formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--model-name", default="token_24k_base",
                   help="Generator config whose mel frontend + vocab_size the codebook is fit for")
    p.add_argument("--recordings", required=True, help="recordings.jsonl[.gz] manifest to fit on")
    p.add_argument("--root-path", default=None,
                   help="If manifest paths are relative, resolve under this")
    p.add_argument("--output", required=True, help="Output .npz codebook path")
    p.add_argument("--vocab-size", type=int, default=None,
                   help="Codebook size (default: the config's vocab_size)")
    p.add_argument("--max-recordings", type=int, default=2000,
                   help="Cap on recordings read (uniformly strided)")
    p.add_argument("--max-frames", type=int, default=2_000_000,
                   help="Cap on mel frames fed to k-means (random subsample)")
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="Where the mels are computed: cuda (the card), or cpu for the tests")
    return p


def mel_frames(args, cfg, device: torch.device) -> np.ndarray:
    """(N, n_mels) float32 log-mel frames of the manifest's recordings (at
    most --max-recordings, strided), read until 2 x --max-frames."""
    mel_fn = LogMelSpectrogram(sampling_rate=cfg.sampling_rate, n_fft=cfg.mel_n_fft,
                               hop_length=cfg.mel_hop_length, n_mels=cfg.n_mels).to(device)
    recs = read_recording_manifest(args.recordings)
    if len(recs) > args.max_recordings:
        stride = len(recs) / args.max_recordings
        recs = [recs[int(i * stride)] for i in range(args.max_recordings)]
    logging.info(f"reading mels of {len(recs)} recordings")
    frames, n_frames = [], 0
    for rec in recs:
        path = rec.path
        if args.root_path and not Path(path).exists():
            path = str(Path(args.root_path) / path)
        audio, sr = read_wav(path)
        audio = audio[:1]
        if sr != cfg.sampling_rate:
            audio = resample(audio, sr, cfg.sampling_rate)
        # zero-pad to whole seconds, then keep only the frames the pad
        # cannot reach
        n_samp = audio.shape[-1]
        pad = -(-n_samp // cfg.sampling_rate) * cfg.sampling_rate - n_samp
        if pad:
            audio = np.pad(audio, ((0, 0), (0, pad)))
        t_keep = max(1, n_samp // cfg.mel_hop_length + 1 - cfg.mel_n_fft // cfg.mel_hop_length)
        with torch.inference_mode():
            mel = mel_fn(torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(device))
        frames.append(mel[0, :, :t_keep].T.cpu().numpy())
        n_frames += frames[-1].shape[0]
        if n_frames >= args.max_frames * 2:
            break
    return np.concatenate(frames, axis=0)


def main(argv=None) -> Path:
    args = get_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
        disable_tf32()
    cfg = get_generator_config(args.model_name)
    k = args.vocab_size or int(cfg.get("vocab_size", 1024))
    X = mel_frames(args, cfg, device)
    if X.shape[0] > args.max_frames:
        X = X[np.random.RandomState(args.seed).choice(X.shape[0], args.max_frames, replace=False)]
    logging.info(f"k-means (k={k}) on {X.shape[0]} frames x {X.shape[1]} mels")

    C = kmeans_fit(X, k, iters=args.iters, seed=args.seed)
    tok = MelKMeansTokenizer(C, cfg.sampling_rate, cfg.mel_n_fft, cfg.mel_hop_length, cfg.n_mels)
    out = Path(args.output)
    out.parent.mkdir(parents=True, exist_ok=True)
    tok.save(out)
    # codebook usage on the fit data, a sanity signal
    used = len(np.unique(np.argmin(-2.0 * X[:100000] @ C.T + np.sum(C * C, axis=1), axis=1)))
    logging.info(f"saved {out}: K={k}, {used}/{k} centroids used on the fit sample")
    return out


if __name__ == "__main__":
    main()
