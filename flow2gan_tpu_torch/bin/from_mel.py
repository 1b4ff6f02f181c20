#!/usr/bin/env python3
"""Quick start: a mel spectrogram file -> a waveform, with a released or
local checkpoint (or, without one, random weights from a seed, which only
shows that the path runs); the port's counterpart of the JAX repo's
`test_from_mel.py`. The mel file is required.

    python -m flow2gan_tpu_torch.bin.from_mel --mel-file mel.pt \
        --checkpoint exp/gan_4step/generator.pt --n-timesteps 4 --output output.wav

The mel is a `.pt` tensor or a `.npy` array, (n_mels, frames) or
(1, n_mels, frames), in the config's log-mel. `--device` defaults to cuda.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from flow2gan_tpu_torch.api import get_model
from flow2gan_tpu_torch.data.audio_io import write_wav


def get_parser():
    p = argparse.ArgumentParser(description="mel file -> waveform (the PyTorch port)")
    p.add_argument("--mel-file", type=Path, required=True, help=".pt tensor or .npy array")
    p.add_argument("--model-name", type=str, default="mel_24k_base")
    p.add_argument("--hf-model-name", type=str, default=None)
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--n-timesteps", type=int, default=4)
    p.add_argument("--output", type=Path, default=Path("output.wav"))
    p.add_argument("--device", type=str, default="cuda", help="cuda (the card), or cpu")
    return p


def load_mel(path: Path) -> np.ndarray:
    """(1, n_mels, frames) float32 from a `.pt` tensor or a `.npy` array."""
    if path.suffix == ".pt":
        mel = torch.load(path, map_location="cpu", weights_only=True).numpy()
    else:
        mel = np.load(path)
    mel = np.asarray(mel, np.float32)
    return mel[None] if mel.ndim == 2 else mel


def main(argv=None) -> Path:
    args = get_parser().parse_args(argv)
    model = get_model(model_name=args.model_name, hf_model_name=args.hf_model_name,
                      checkpoint=args.checkpoint, device=args.device)
    wav = model.infer(load_mel(args.mel_file), n_timesteps=args.n_timesteps).cpu().numpy()
    write_wav(args.output, wav[0], model.config.sampling_rate)
    print(f"Wrote {args.output} ({wav.shape[1] / model.config.sampling_rate:.2f}s)")
    return args.output


if __name__ == "__main__":
    main()
