#!/usr/bin/env python3
"""Fréchet Speech Distance between a directory of generated WAVs and the
ground truth, on wav2vec2 hidden states mean-pooled per utterance at 16 kHz;
the port's counterpart of the JAX repo's `scripts/compute_fsd.py`.

    python -m flow2gan_tpu_torch.bin.compute_fsd --ref-dir data/LibriTTS/test-clean \
        --gen-dir exp/gan_1step/test_clean_wavs/test-clean \
        --model-path models/wav2vec2-base --output metrics_fsd.json

The distance is that between Gaussians fitted to the two sets of embeddings,
with sqrtm's stabilisation. The embedding model needs the `transformers`
package and a local copy of a wav2vec2 model as `--model-path`: this script
downloads nothing, so without either it exits non-zero and writes nothing
(the recipe keeps FSD optional for that reason).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import logging
import os
from pathlib import Path

import numpy as np


def get_parser():
    p = argparse.ArgumentParser(description="Fréchet Speech Distance")
    p.add_argument("--ref-dir", type=Path, required=True)
    p.add_argument("--gen-dir", type=Path, required=True)
    p.add_argument("--file-list", type=Path, default=None,
                   help="Optional list of relative wav paths")
    p.add_argument("--model-path", type=Path, default=None,
                   help="Local directory of a wav2vec2 model (e.g. wav2vec2-base)")
    p.add_argument("--cache", type=Path, default=None,
                   help="Cache the reference embeddings in this .npz")
    p.add_argument("--output", type=Path, default=None)
    return p


def load_files(dir_: Path, file_list) -> list:
    if file_list:
        return [dir_ / line.strip() for line in open(file_list) if line.strip()]
    return sorted(dir_.rglob("*.wav"))


def embed_files(files, model, fe) -> np.ndarray:
    """(len(files), hidden) mean-pooled last hidden states, on the CPU."""
    import torch

    from flow2gan_tpu_torch.data.audio_io import read_wav, resample

    embs = []
    with torch.no_grad():
        for f in files:
            audio, sr = read_wav(f)
            audio = resample(audio.mean(axis=0), sr, 16000)
            inputs = fe(audio, sampling_rate=16000, return_tensors="pt")
            out = model(inputs.input_values)
            embs.append(out.last_hidden_state.mean(dim=1)[0].numpy())
    return np.stack(embs)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1 - mu2||^2 + tr(S1 + S2 - 2 sqrt(S1 S2)), with an eps ridge
    where the product's square root is not finite."""
    from scipy import linalg

    diff = mu1 - mu2
    covmean, _ = linalg.sqrtm(sigma1.dot(sigma2), disp=False)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    if args.model_path is None or not args.model_path.is_dir():
        raise SystemExit(f"FSD needs a local wav2vec2 model directory as --model-path "
                         f"(got {args.model_path}); nothing is downloaded")
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    try:
        from transformers import Wav2Vec2FeatureExtractor, Wav2Vec2Model
    except ImportError as e:
        raise SystemExit(f"transformers required for FSD: {e}")
    try:
        fe = Wav2Vec2FeatureExtractor.from_pretrained(args.model_path, local_files_only=True)
        model = Wav2Vec2Model.from_pretrained(args.model_path, local_files_only=True)
    except Exception as e:
        raise SystemExit(f"Could not load wav2vec2 from {args.model_path}: {e}")
    model.eval()

    ref_files = load_files(args.ref_dir, args.file_list)
    gen_files = load_files(args.gen_dir, args.file_list)
    logging.info(f"{len(ref_files)} ref / {len(gen_files)} gen files")
    if len(ref_files) < 2 or len(gen_files) < 2:
        raise SystemExit("FSD needs at least 2 files on each side for a covariance")

    ref_key = hashlib.sha256("\n".join(str(f) for f in ref_files).encode()).hexdigest()[:16]
    cache = dict(np.load(args.cache, allow_pickle=False)) if args.cache and args.cache.exists() else {}
    if "ref" in cache and str(cache.get("ref_key")) == ref_key:
        ref_emb = cache["ref"]
    else:
        if "ref" in cache:
            logging.warning("embedding cache is for a different ref set; recomputing")
        ref_emb = embed_files(ref_files, model, fe)
    gen_emb = embed_files(gen_files, model, fe)
    if args.cache:
        np.savez(args.cache, ref=ref_emb, ref_key=np.asarray(ref_key))

    fsd = frechet_distance(ref_emb.mean(0), np.cov(ref_emb, rowvar=False),
                           gen_emb.mean(0), np.cov(gen_emb, rowvar=False))
    result = {"fsd": fsd, "n_ref": len(ref_files), "n_gen": len(gen_files)}
    print(json.dumps(result))
    if args.output:
        args.output.write_text(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
