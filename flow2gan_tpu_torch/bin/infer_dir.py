#!/usr/bin/env python3
"""Directory inference with the port: every .wav (audio mode), .npy/.pt
mel (mel mode) or integer .npy token file (token mode, `--tokens true`) in a
directory, whole or streamed in chunks; the counterpart of
`flow2gan_tpu/bin/infer_dir.py`. A token config takes wavs with
`--tokenizer <codebook.npz>` (tokenized first) or token files.

    python -m flow2gan_tpu_torch.bin.infer_dir --checkpoint model.pt \
        --input-dir wavs --output-dir out --chunk-size 100

The chunked mode keeps the reference's receptive-field halo (3 frames per
layer of the k=7 convs on each side) and pads every chunk to one frame count
by repeating its last frame (mel column or token id), as the JAX package
does so that its jitted synthesis compiles once. The fixed shape keeps every
chunk's noise and edge padding, and so the output, the same as the JAX
package's; and since every chunk repeats the previous chunk's call, on the
card one CUDA graph serves the whole stream from its second chunk on
(`api.GraphRule`).
`--device` defaults to cuda; the tests pass cpu.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path
from typing import Callable, List

import numpy as np
import torch

from flow2gan_tpu_torch.api import VocoderModel, get_model
from flow2gan_tpu_torch.data.audio_io import read_wav, resample, write_wav
from flow2gan_tpu_torch.utils import setup_logger, str2bool

# (1, n_mels, frames) mels or (1, frames) token ids -> (1, frames * hop)
Synth = Callable[[np.ndarray], np.ndarray]


def get_parser():
    parser = argparse.ArgumentParser(
        description="Directory inference (the PyTorch port), wav or mel inputs, "
        "optional streaming chunked mode",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--model-name", type=str, default=None,
                        help="Config name (default: the released model's, else mel_24k_base)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="The port's .pt, a trainer checkpoint or a reference-named .pt")
    parser.add_argument("--hf-model-name", type=str, default=None,
                        help="A released model's name; needs its file as --checkpoint")
    parser.add_argument("--input-dir", type=Path, required=True)
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--mel", type=str2bool, default=False,
                        help="Inputs are mel files (.npy / .pt) instead of wavs")
    parser.add_argument("--tokens", type=str2bool, default=False,
                        help="Inputs are integer token files (.npy) for token_* configs")
    parser.add_argument("--tokenizer", type=str, default=None,
                        help="k-means codebook .npz: token_* configs with wav inputs "
                        "(audio is tokenized first)")
    parser.add_argument("--n-timesteps", type=int, default=None,
                        help="Euler steps (default: the released model's, else 1)")
    parser.add_argument("--chunk-size", type=int, default=0,
                        help="Streaming: mel frames per chunk (0 = whole file)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card), or cpu for the tests")
    return parser


def load_mel_file(path: Path) -> np.ndarray:
    """A (n_mels, frames) float32 mel from a .npy or .pt file, (1, n_mels,
    frames) allowed."""
    if path.suffix == ".npy":
        mel = np.load(path)
    elif path.suffix == ".pt":
        mel = torch.load(path, map_location="cpu", weights_only=True).numpy()
    else:
        raise ValueError(f"unsupported mel file {path}")
    if mel.ndim == 3:
        mel = mel[0]
    return mel.astype(np.float32)


def load_token_file(path: Path, vocab_size: int) -> np.ndarray:
    """(frames,) int64 token ids from a .npy file, (1, frames) allowed;
    ValueError for anything but integer ids in [0, vocab_size)."""
    ids = np.load(path)
    if ids.ndim == 2 and ids.shape[0] == 1:
        ids = ids[0]
    if ids.ndim != 1 or ids.dtype.kind not in "iu":
        raise ValueError(f"{path}: token files hold integer ids, (frames,) or (1, frames); "
                         f"got {ids.dtype} {ids.shape}")
    if ids.size and not (ids.min() >= 0 and ids.max() < vocab_size):
        raise ValueError(f"{path}: token ids must lie in [0, {vocab_size}); got ids in "
                         f"[{ids.min()}, {ids.max()}]")
    return ids.astype(np.int64)


def make_synth(model: VocoderModel, n_timesteps: int, seed: int) -> Synth:
    """Conditioning (B, ..., frames) -> waveforms (B, frames * hop) as numpy,
    every call with the noise of `seed`, as the JAX package's synth uses one
    key."""
    def synth(cond: np.ndarray) -> np.ndarray:
        return model.infer(cond, n_timesteps=n_timesteps, seed=seed).cpu().numpy()

    return synth


def streaming_infer(synth: Synth, cond: np.ndarray, chunk_size: int, num_layers: int,
                    hop: int) -> np.ndarray:
    """(n_mels, frames) mels or (frames,) token ids -> (frames * hop,) in
    chunks of `chunk_size` frames, each synthesised with a halo of 3 *
    num_layers frames on either side and padded at the right, by repeating
    its last frame, to chunk_size + 2 * halo frames; the halos are cut from
    the output."""
    side = 3 * num_layers
    frames = cond.shape[-1]
    padded_chunk = chunk_size + 2 * side
    outs = []
    start = 0
    while start < frames:
        end = min(start + chunk_size, frames)
        lo, hi = max(0, start - side), min(frames, end + side)
        seg = cond[..., lo:hi]
        if seg.shape[-1] < padded_chunk:
            pad = [(0, 0)] * (seg.ndim - 1) + [(0, padded_chunk - seg.shape[-1])]
            seg = np.pad(seg, pad, mode="edge")
        wav = synth(seg[None])[0]
        left = start - lo
        outs.append(wav[left * hop : (left + end - start) * hop])
        start = end
    return np.concatenate(outs)


def main(argv=None) -> List[Path]:
    """Synthesise every input file of the directory; returns the written paths."""
    args = get_parser().parse_args(argv)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    setup_logger(f"{args.output_dir}/log/log-infer-dir")
    logging.info(vars(args))

    vm = get_model(model_name=args.model_name, checkpoint=args.checkpoint, device=args.device,
                   hf_model_name=args.hf_model_name, tokenizer=args.tokenizer)
    cfg = vm.config
    if vm.is_token and not (args.tokens or args.tokenizer):
        raise ValueError("token_* config: pass --tokens true (int .npy inputs) or "
                         "--tokenizer <codebook.npz> (wav inputs)")
    if args.tokens and not vm.is_token:
        raise ValueError(f"--tokens true needs a token_* config, not {args.model_name}")
    synth = make_synth(vm, args.n_timesteps or vm.n_timesteps, args.seed)
    if args.tokens:
        files = sorted(args.input_dir.glob("*.npy"))
    elif args.mel:
        files = sorted([*args.input_dir.glob("*.npy"), *args.input_dir.glob("*.pt")])
    else:
        files = sorted(args.input_dir.glob("*.wav"))
    if not files:
        raise FileNotFoundError(f"no input files in {args.input_dir}")

    written, total_audio, total_time = [], 0.0, 0.0
    for f in files:
        if args.tokens:
            cond = load_token_file(f, cfg.vocab_size)
        elif args.mel:
            cond = load_mel_file(f)
        else:
            audio, sr = read_wav(f)
            if audio.shape[0] > 1:
                audio = audio.mean(axis=0, keepdims=True)
            audio = resample(audio, sr, cfg.sampling_rate)
            cond = vm.cond(audio)[0].cpu().numpy()
        t0 = time.perf_counter()
        if args.chunk_size > 0:
            wav = streaming_infer(synth, cond, args.chunk_size, num_layers=max(cfg.num_layers),
                                  hop=cfg.mel_hop_length)
        else:
            wav = synth(cond[None])[0]
        dt = time.perf_counter() - t0
        out = args.output_dir / (f.stem + ".wav")
        write_wav(out, wav, cfg.sampling_rate)
        written.append(out)
        total_audio += len(wav) / cfg.sampling_rate
        total_time += dt
        logging.info(f"{f.name}: {len(wav) / cfg.sampling_rate:.2f}s audio in {dt:.2f}s -> {out}")
    logging.info(f"Done: {total_audio:.1f}s audio in {total_time:.1f}s "
                 f"({total_audio / max(total_time, 1e-9):.1f}x real-time)")
    return written


if __name__ == "__main__":
    main()
