#!/usr/bin/env python3
"""Average a trainer's epoch checkpoints into one generator `.pt` (a
`state_dict`) that `api.get_model(checkpoint=...)` loads; the counterpart of
`flow2gan_tpu/bin/save_averaged_model.py`.

    python -m flow2gan_tpu_torch.bin.save_averaged_model --exp-dir exp/fm \
        --epoch 40 --avg 40

By default the average is over the window (epoch-{epoch-avg}, epoch-{epoch}]
of the float64 running average; with --use-averaged-model false it is the
plain mean of epochs epoch-avg+1 .. epoch. `--load-gan true` reads the GAN
trainer's checkpoints (`bin/finetune.py`) and keeps their generator: the
running average is the generator's already, and the plain mean takes each
checkpoint's "generator" entry.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import torch

from flow2gan_tpu_torch.training import checkpoint as ckpt
from flow2gan_tpu_torch.utils import setup_logger, str2bool


def get_parser():
    parser = argparse.ArgumentParser(
        description="Average checkpoints and save a deployment model",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--exp-dir", type=Path, required=True)
    parser.add_argument("--epoch", type=int, required=True, help="Last epoch to include")
    parser.add_argument("--avg", type=int, required=True, help="Number of epochs to average")
    parser.add_argument("--use-averaged-model", type=str2bool, default=True,
                        help="Running-average differencing (reference default)")
    parser.add_argument("--load-gan", type=str2bool, default=False,
                        help="The checkpoints are the GAN trainer's: keep their generator")
    parser.add_argument("--output", type=Path, default=None,
                        help="Output path (default exp-dir/averaged.pt)")
    return parser


def main(argv=None) -> Path:
    args = get_parser().parse_args(argv)
    out = args.output or (args.exp_dir / "averaged.pt")
    setup_logger(f"{args.exp_dir}/log/log-average")
    logging.info(vars(args))
    if args.use_averaged_model:
        start = args.exp_dir / f"epoch-{args.epoch - args.avg}.pt"
        end = args.exp_dir / f"epoch-{args.epoch}.pt"
        if not start.exists():
            raise SystemExit(f"Windowed averaging over ({start}, {end}] needs the start "
                             "checkpoint, which does not exist. Use a smaller --avg, or "
                             f"--use-averaged-model false for a plain average of the last "
                             f"{args.avg} epochs.")
        logging.info(f"Windowed running average over ({start}, {end}]")
        state = ckpt.average_checkpoints_with_averaged_model(start, end)
    else:
        files = [args.exp_dir / f"epoch-{e}.pt" for e in range(args.epoch - args.avg + 1,
                                                                 args.epoch + 1)]
        logging.info(f"Plain average over {len(files)} checkpoints")
        state = ckpt.average_checkpoints(files, load_gan=args.load_gan)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, out)
    logging.info(f"Saved averaged model to {out}")
    return out


if __name__ == "__main__":
    main()
