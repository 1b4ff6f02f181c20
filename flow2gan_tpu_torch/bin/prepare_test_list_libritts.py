#!/usr/bin/env python3
"""Write the list of a split's WAV files, relative to the corpus root, for
evaluation; the port's counterpart of the JAX repo's
`scripts/prepare_test_list_libritts.py`.

    python -m flow2gan_tpu_torch.bin.prepare_test_list_libritts \
        --corpus-dir data/LibriTTS --split test-clean --output data/test_clean_files.txt
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path


def get_parser():
    p = argparse.ArgumentParser(description="Write a split's relative WAV file list")
    p.add_argument("--corpus-dir", type=Path, required=True)
    p.add_argument("--split", type=str, default="test-clean")
    p.add_argument("--output", type=Path, required=True)
    p.add_argument("--max-files", type=int, default=0)
    return p


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    files = sorted((args.corpus_dir / args.split).rglob("*.wav"))
    if args.max_files:
        files = files[:args.max_files]
    args.output.parent.mkdir(parents=True, exist_ok=True)
    args.output.write_text("".join(f"{wav.relative_to(args.corpus_dir)}\n" for wav in files))
    logging.info(f"{len(files)} files -> {args.output}")


if __name__ == "__main__":
    main()
