#!/usr/bin/env python3
"""Scan LibriTTS split directories into `recordings.jsonl.gz` manifests; the
port's counterpart of the JAX repo's `scripts/prepare_recordings_libritts.py`.
The manifests are lhotse-compatible and the same rows as that script's.

    python -m flow2gan_tpu_torch.bin.prepare_recordings_libritts \
        --corpus-dir data/LibriTTS --output-dir data/manifests

A split directory that does not exist is skipped with a warning.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from flow2gan_tpu_torch.data.dataset import scan_dir_to_recordings, write_recording_manifest


def get_parser():
    p = argparse.ArgumentParser(description="Scan LibriTTS splits into recording manifests")
    p.add_argument("--corpus-dir", type=Path, required=True,
                   help="LibriTTS root (contains train-clean-100/ etc.)")
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--splits", type=str,
                   default="train-clean-100,train-clean-360,dev-clean,test-clean")
    return p


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    for split in args.splits.split(","):
        split_dir = args.corpus_dir / split
        if not split_dir.exists():
            logging.warning(f"skip missing split {split_dir}")
            continue
        recs = scan_dir_to_recordings(split_dir)
        out = args.output_dir / f"libritts_recordings_{split.replace('-', '_')}.jsonl.gz"
        write_recording_manifest(recs, out)
        logging.info(f"{split}: {len(recs)} recordings -> {out}")


if __name__ == "__main__":
    main()
