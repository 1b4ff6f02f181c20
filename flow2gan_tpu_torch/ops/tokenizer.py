"""Discrete pseudo-codec tokenizer: log-mel frames vector-quantized to a
k-means codebook; the counterpart of `flow2gan_tpu/ops/tokenizer.py`.

The token source of the token-conditioned generator (`TokenAudioGenerator`):
the model's own mel frontend, each frame replaced by its nearest centroid.
The codebook is fit offline (`bin/train_tokenizer.py`, `kmeans_fit` on the
CPU) and frozen; tokenizing is one matmul and an argmin on the model's
device, inside the training step as the mel frontend it replaces.

Artifact format, shared with the JAX package (a file written by either
loads in the other): `.npz` with `centroids` (K, n_mels) float32 and the mel
frontend's constants (`sampling_rate`, `n_fft`, `hop_length`, `n_mels`),
checked against the model config at load.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch import nn

from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram


class MelKMeansTokenizer(nn.Module):
    """audio (B, L) -> int64 tokens (B, frames).

    One token per mel frame: the log-mel column's nearest centroid by
    Euclidean distance. ||x||^2 is the same for every centroid, so the
    argmin needs only -2 x.C^T + ||C||^2, one (B*T, n_mels) x (n_mels, K)
    float32 matmul (IEEE on the card: TF32 off, `utils.disable_tf32`).
    """

    def __init__(self, centroids: np.ndarray, sampling_rate: int, n_fft: int, hop_length: int,
                 n_mels: int):
        super().__init__()
        centroids = np.asarray(centroids, np.float32)
        if centroids.ndim != 2 or centroids.shape[1] != n_mels:
            raise ValueError(f"centroids must be (K, n_mels={n_mels}), got {centroids.shape}")
        c = torch.from_numpy(centroids.copy())
        self.register_buffer("centroids", c, persistent=False)
        self.register_buffer("c_sq", (c * c).sum(dim=1), persistent=False)
        self.vocab_size = centroids.shape[0]
        self.sampling_rate = sampling_rate
        self.n_fft = n_fft
        self.hop_length = hop_length
        self.n_mels = n_mels
        self.mel_fn = LogMelSpectrogram(sampling_rate=sampling_rate, n_fft=n_fft,
                                        hop_length=hop_length, n_mels=n_mels)

    def forward(self, audio: torch.Tensor) -> torch.Tensor:
        return self.quantize(self.mel_fn(audio))

    def scores(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, T) log-mel -> (B, T, K) squared distances to the
        centroids, less each frame's own ||x||^2."""
        frames = mel.transpose(-1, -2).float()
        return -2.0 * frames @ self.centroids.T + self.c_sq

    def quantize(self, mel: torch.Tensor) -> torch.Tensor:
        """(B, n_mels, T) log-mel -> (B, T) int64 token ids."""
        return self.scores(mel).argmin(dim=-1)

    def save(self, path) -> None:
        np.savez(path, centroids=self.centroids.cpu().numpy(), sampling_rate=self.sampling_rate,
                 n_fft=self.n_fft, hop_length=self.hop_length, n_mels=self.n_mels)

    def check_config(self, config, name="the tokenizer") -> None:
        """Raise ValueError where the codebook's frontend or size differs from
        a generator config's (its mel_* keys and vocab_size)."""
        checks = {"sampling_rate": self.sampling_rate, "mel_n_fft": self.n_fft,
                  "mel_hop_length": self.hop_length, "n_mels": self.n_mels,
                  "vocab_size": self.vocab_size}
        for key, got in checks.items():
            want = dict(config).get(key)
            if want is not None and int(want) != int(got):
                raise ValueError(f"{name} has {key}={got}, model config expects {want}")

    @classmethod
    def from_file(cls, path, expect_config: Optional[dict] = None) -> "MelKMeansTokenizer":
        """Load an .npz codebook; with `expect_config` (a generator config),
        raise ValueError on any frontend or vocabulary mismatch."""
        with np.load(Path(path)) as z:
            tok = cls(centroids=z["centroids"], sampling_rate=int(z["sampling_rate"]),
                      n_fft=int(z["n_fft"]), hop_length=int(z["hop_length"]),
                      n_mels=int(z["n_mels"]))
        if expect_config is not None:
            tok.check_config(expect_config, f"tokenizer {path}")
        return tok


def kmeans_fit(
    frames: np.ndarray,
    k: int,
    iters: int = 30,
    seed: int = 0,
    chunk: int = 65536,
) -> np.ndarray:
    """Deterministic Lloyd k-means on (N, D) float32 frames -> (k, D) centroids.

    Plain numpy (offline, CPU): random distinct-point init, chunked
    assignment, empty clusters reseeded to the currently-worst-fit points.
    """
    X = np.asarray(frames, np.float32)
    n = X.shape[0]
    if n < k:
        raise ValueError(f"need at least k={k} frames, got {n}")
    rng = np.random.RandomState(seed)
    C = X[rng.choice(n, size=k, replace=False)].copy()

    def assign(C):
        c_sq = np.sum(C * C, axis=1)
        labels = np.empty(n, np.int64)
        dists = np.empty(n, np.float32)
        for s in range(0, n, chunk):
            x = X[s : s + chunk]
            d = -2.0 * x @ C.T + c_sq  # + ||x||^2, constant per row
            li = np.argmin(d, axis=1)
            labels[s : s + chunk] = li
            dists[s : s + chunk] = d[np.arange(len(x)), li] + np.sum(x * x, axis=1)
        return labels, dists

    for _ in range(iters):
        labels, dists = assign(C)
        counts = np.bincount(labels, minlength=k)
        sums = np.zeros_like(C)
        np.add.at(sums, labels, X)
        nonempty = counts > 0
        C[nonempty] = sums[nonempty] / counts[nonempty, None]
        n_empty = int((~nonempty).sum())
        if n_empty:
            # reseed dead centroids on the worst-fit frames
            worst = np.argsort(-dists)[:n_empty]
            C[~nonempty] = X[worst]
    return C


def is_token_config(config) -> bool:
    return dict(config).get("conditioning", "mel") == "tokens"


def load_token_frontend(config, tokenizer_path, model_name: str = "?"
                        ) -> Optional[MelKMeansTokenizer]:
    """The conditioning frontend of a token config, or None for a mel one.

    The one entry of every CLI and trainer, so that they check alike: a
    token-conditioned model driven without a codebook raises, and the
    codebook is checked against the config on load.
    """
    if not is_token_config(config):
        return None
    if not tokenizer_path:
        raise ValueError(f"model {model_name} is token-conditioned; pass --tokenizer "
                         "<codebook.npz> (fit one with bin/train_tokenizer.py)")
    tok = MelKMeansTokenizer.from_file(tokenizer_path, expect_config=config)
    logging.info(f"Token conditioning: K={tok.vocab_size} codebook from {tokenizer_path}")
    return tok


def conditioning_frontend(config, tokenizer_path, model_name: str = "?") -> nn.Module:
    """audio -> the model's conditioning: the tokenizer of a token config
    (`load_token_frontend`, so a missing codebook raises), else the log-mel."""
    return (load_token_frontend(config, tokenizer_path, model_name)
            or LogMelSpectrogram(sampling_rate=config.sampling_rate, n_fft=config.mel_n_fft,
                                 hop_length=config.mel_hop_length, n_mels=config.n_mels))
