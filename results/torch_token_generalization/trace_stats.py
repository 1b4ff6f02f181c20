#!/usr/bin/env python3
"""Host-side numbers of the trace in README.md, from the repository root.

    # the FM rows' steps paired over the held-out files: mean, standard error
    python3 results/torch_token_generalization/trace_stats.py paired \
        results/torch_token_generalization results/r5_token_gen

    # codebooks on the same frames: inertia, ids used, near-ties, distance
    python3 results/torch_token_generalization/trace_stats.py codebooks \
        --train <manifests_gan>/libritts_recordings_train_clean_100.jsonl.gz \
        --test <manifests_fm>/libritts_recordings_test_clean.jsonl.gz \
        card=results/torch_token_generalization/tokenizer_1024.npz port_cpu=a.npz jax_cpu=b.npz

`codebooks` reads the frames as `bin/train_tokenizer.py` does (its
`mel_frames`, on the CPU), and scores each codebook in float64: the mean
squared distance of each frame to its nearest centroid, the ids that are
nearest to some frame, and the frames whose best two distances lie within
1e-5 of the frame's max |score| (score: distance less ||x||^2), the tie rule
of the token tests.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
from pathlib import Path

import numpy as np

METRICS = ("pitch_rmse_cents", "periodicity_rmse", "vuv_f1")


def per_file(directory: Path, row: str, key: str) -> dict:
    data = json.loads((directory / f"{row}_metrics_pitch.json").read_text())
    return {Path(f["file"]).name: f[key] for f in data["files"]}


def paired(args) -> None:
    for key in METRICS:
        for directory in args.dirs:
            rows = {n: per_file(directory, f"fm_{n}step", key) for n in (1, 2, 4)}
            for a, b in ((1, 2), (2, 4), (1, 4)):
                diffs = [rows[b][k] - rows[a][k] for k in rows[a]]
                mean = statistics.mean(diffs)
                se = statistics.stdev(diffs) / math.sqrt(len(diffs))
                worse = sum((d < 0) if key == "vuv_f1" else (d > 0) for d in diffs)
                print(json.dumps({"metric": key, "run": str(directory), "step": f"fm_{a}->fm_{b}",
                                  "mean": mean, "se": se, "t": mean / se,
                                  "files_worse": worse, "files": len(diffs)}))


def codebook_stats(frames: np.ndarray, centroids: np.ndarray) -> dict:
    c = centroids.astype(np.float64)
    c_sq = (c * c).sum(1)
    nearest, labels, ties = [], [], 0
    for s in range(0, len(frames), 32768):
        x = frames[s:s + 32768].astype(np.float64)
        scores = -2.0 * x @ c.T + c_sq
        best = np.partition(scores, 1, axis=1)[:, :2]
        ties += int((best[:, 1] - best[:, 0] <= 1e-5 * np.abs(scores).max(axis=1)).sum())
        nearest.append(best[:, 0] + (x * x).sum(1))
        labels.append(scores.argmin(1))
    return {"inertia": float(np.concatenate(nearest).mean()),
            "ids_used": int(len(np.unique(np.concatenate(labels)))),
            "near_ties": ties, "frames": len(frames)}


def codebooks(args) -> None:
    import torch

    from flow2gan_tpu_torch.bin import train_tokenizer
    from flow2gan_tpu_torch.models import get_generator_config

    cfg = get_generator_config("token_24k_base")

    def frames_of(manifest: str) -> np.ndarray:
        options = train_tokenizer.get_parser().parse_args(
            ["--model-name", "token_24k_base", "--recordings", manifest, "--output", "unused",
             "--device", "cpu"])
        return train_tokenizer.mel_frames(options, cfg, torch.device("cpu"))

    frames = {"train": frames_of(args.train), "test": frames_of(args.test)}
    books = dict(spec.split("=", 1) for spec in args.codebooks)
    centroids = {name: np.load(path)["centroids"] for name, path in books.items()}
    for name, c in centroids.items():
        print(json.dumps({"codebook": name, **{split: codebook_stats(x, c)
                                               for split, x in frames.items()}}))
    names = sorted(centroids)
    for i, a in enumerate(names):
        for b in names[i + 1:]:
            print(json.dumps({"pair": [a, b], "max_abs_diff":
                              float(np.abs(centroids[a] - centroids[b]).max())}))


def main(argv=None) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="command", required=True)
    p_paired = sub.add_parser("paired")
    p_paired.add_argument("dirs", type=Path, nargs="+")
    p_books = sub.add_parser("codebooks")
    p_books.add_argument("--train", required=True)
    p_books.add_argument("--test", required=True)
    p_books.add_argument("codebooks", nargs="+", help="name=path.npz")
    args = p.parse_args(argv)
    {"paired": paired, "codebooks": codebooks}[args.command](args)


if __name__ == "__main__":
    main()
