#!/usr/bin/env python3
"""Quick start: a waveform -> its log-mel -> a waveform, with a released or
local checkpoint (or, without one, random weights from a seed); the port's
counterpart of the JAX repo's `test_from_wav.py`. The WAV file is required.

    python -m flow2gan_tpu_torch.bin.from_wav --wav-file in.wav \
        --checkpoint exp/gan_4step/generator.pt --n-timesteps 4 --output output.wav

The input is mixed down to mono and resampled to the config's rate.
`--device` defaults to cuda.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from flow2gan_tpu_torch.api import get_model
from flow2gan_tpu_torch.data.audio_io import read_wav, resample, write_wav


def get_parser():
    p = argparse.ArgumentParser(description="wav -> mel -> wav (the PyTorch port)")
    p.add_argument("--wav-file", type=Path, required=True)
    p.add_argument("--model-name", type=str, default="mel_24k_base")
    p.add_argument("--hf-model-name", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--n-timesteps", type=int, default=4)
    p.add_argument("--output", type=Path, default=Path("output.wav"))
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card), or cpu")
    return p


def main(argv=None) -> Path:
    args = get_parser().parse_args(argv)
    model = get_model(model_name=args.model_name, hf_model_name=args.hf_model_name,
                      checkpoint=args.checkpoint, device=args.device)
    sr = model.config.sampling_rate
    audio, in_sr = read_wav(args.wav_file)
    audio = resample(audio.mean(axis=0, keepdims=True), in_sr, sr)
    wav = model.reconstruct(audio, n_timesteps=args.n_timesteps).cpu().numpy()
    write_wav(args.output, wav[0], sr)
    print(f"Wrote {args.output} ({wav.shape[1] / sr:.2f}s)")
    return args.output


if __name__ == "__main__":
    main()
