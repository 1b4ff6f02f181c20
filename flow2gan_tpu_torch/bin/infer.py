#!/usr/bin/env python3
"""Batch inference over a recordings manifest (wav -> mel -> wav
reconstruction, or wav -> tokens -> wav for a token config with
--tokenizer) with the port; the counterpart of `flow2gan_tpu/bin/infer.py`.

    python -m flow2gan_tpu_torch.bin.infer --exp-dir exp/fm --epoch 40 --avg 40 \
        --recordings data/test.jsonl.gz --root-path data --output-dir out

The weights (`resolve_params`) come from --checkpoint (the port's `.pt`, a
trainer checkpoint, or a released checkpoint in the reference's naming), from
--epoch N (exp-dir/epoch-N.pt), or from --epoch N --avg K: the window
(epoch-{N-K}, epoch-N] of the trainer's running averages, or with
--use-averaged-model false the plain mean of epochs N-K+1..N. With
--load-gan true they are the GAN trainer's checkpoints, and their generator
is taken.
--hf-model-name names a released model: it picks the config and the step
count and needs its file as --checkpoint (the port downloads nothing).
Outputs keep the manifest's paths, relative to --root-path, under
--output-dir. `--device` defaults to cuda; the tests pass cpu.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path
from typing import Dict, List

import torch

from flow2gan_tpu_torch.api import VocoderModel
from flow2gan_tpu_torch.compat.from_reference import load_torch_file, to_port_state_dict
from flow2gan_tpu_torch.data.audio_io import write_wav
from flow2gan_tpu_torch.data.dataset import build_data_loader, read_recording_manifest
from flow2gan_tpu_torch.models import build_generator, get_generator_config
from flow2gan_tpu_torch.models.config import HF_MODEL_NAMES, HF_REPO, generator_config_for_hf_model
from flow2gan_tpu_torch.ops.tokenizer import load_token_frontend
from flow2gan_tpu_torch.training import checkpoint as ckpt
from flow2gan_tpu_torch.utils import disable_tf32, setup_logger, str2bool


def get_parser():
    parser = argparse.ArgumentParser(
        description="Batch inference over a recordings manifest (the PyTorch port)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--exp-dir", type=Path, default=Path("exp/fm"))
    parser.add_argument("--model-name", type=str, default=None,
                        help="Config name (default: the released model's, else mel_24k_base)")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="The port's .pt, a trainer checkpoint or a reference-named .pt")
    parser.add_argument("--hf-model-name", type=str, default=None,
                        help="A released model's name; needs its file as --checkpoint")
    parser.add_argument("--epoch", type=int, default=None, help="Use exp-dir/epoch-N.pt")
    parser.add_argument("--avg", type=int, default=None, help="Average over the last K epochs")
    parser.add_argument("--use-averaged-model", type=str2bool, default=True,
                        help="With --avg: use running-average differencing")
    parser.add_argument("--load-gan", type=str2bool, default=False,
                        help="The checkpoint is the GAN trainer's: take its generator")
    parser.add_argument("--recordings", type=str, required=True,
                        help="recordings.jsonl[.gz] manifest to reconstruct")
    parser.add_argument("--root-path", type=str, default=None,
                        help="Base for relative output paths")
    parser.add_argument("--output-dir", type=Path, required=True)
    parser.add_argument("--n-timesteps", type=int, default=None,
                        help="Euler steps (default: the released model's, else 1)")
    parser.add_argument("--tokenizer", type=str, default=None,
                        help="k-means codebook .npz for token_* configs (bin/train_tokenizer.py): "
                        "reconstruction runs audio -> tokens -> audio")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card), or cpu for the tests")
    return parser


def resolve_params(args, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The state dict the flags name, in the port's naming."""
    if args.checkpoint:
        return to_port_state_dict(load_torch_file(args.checkpoint, args.load_gan), model)
    if args.hf_model_name:
        raise FileNotFoundError(
            f"--hf-model-name {args.hf_model_name} needs its checkpoint: the port downloads "
            f"nothing, so fetch {args.hf_model_name}.pt from {HF_REPO} and pass --checkpoint")
    exp_dir = Path(args.exp_dir)
    if args.epoch is not None and args.avg:
        if args.use_averaged_model:
            start = exp_dir / f"epoch-{args.epoch - args.avg}.pt"
            end = exp_dir / f"epoch-{args.epoch}.pt"
            logging.info(f"Windowed average over ({start}, {end}]")
            return ckpt.average_checkpoints_with_averaged_model(start, end)
        files = [exp_dir / f"epoch-{e}.pt" for e in range(args.epoch - args.avg + 1, args.epoch + 1)]
        logging.info(f"Plain average of {len(files)} checkpoints")
        return ckpt.average_checkpoints(files, load_gan=args.load_gan)
    if args.epoch is not None:
        return to_port_state_dict(
            load_torch_file(exp_dir / f"epoch-{args.epoch}.pt", args.load_gan), model)
    raise ValueError("Provide --checkpoint, --hf-model-name, or --epoch")


def output_path(output_dir: Path, name: str) -> Path:
    """Where the output of manifest entry `name` goes. A manifest without
    --root-path holds absolute paths, and `output_dir / "/abs"` would be the
    source itself: such a path keeps its structure inside output_dir."""
    rel = Path(name)
    if rel.is_absolute():
        rel = Path(*rel.parts[1:])
    return output_dir / rel


def main(argv=None) -> List[Path]:
    """Reconstruct every recording of the manifest; returns the written paths."""
    args = get_parser().parse_args(argv)
    if args.hf_model_name is not None and args.hf_model_name not in HF_MODEL_NAMES:
        raise ValueError(f"Unknown released model {args.hf_model_name!r}; available: "
                         f"{sorted(HF_MODEL_NAMES)}")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
        disable_tf32()
    args.output_dir.mkdir(parents=True, exist_ok=True)
    setup_logger(f"{args.output_dir}/log/log-infer")
    logging.info(vars(args))

    model_name = args.model_name or (generator_config_for_hf_model(args.hf_model_name)
                                     if args.hf_model_name else "mel_24k_base")
    n_timesteps = args.n_timesteps or HF_MODEL_NAMES.get(args.hf_model_name, 1)
    cfg = get_generator_config(model_name)
    tokenizer = load_token_frontend(cfg, args.tokenizer, model_name)
    model = build_generator(cfg)
    model.load_state_dict(resolve_params(args, model), strict=True)
    vm = VocoderModel(model.to(device), cfg, device, n_timesteps, tokenizer)

    loader = build_data_loader(read_recording_manifest(args.recordings), root_path=args.root_path,
                               sampling_rate=cfg.sampling_rate, batch_size=args.batch_size,
                               num_workers=args.num_workers, train=False, apply_effects=False)
    written, total_audio_s = [], 0.0
    t0 = time.perf_counter()
    for batch in loader:
        wav = vm.infer(vm.cond(batch["audio"]), seed=args.seed).cpu().numpy()
        for i, name in enumerate(batch["file_names"]):
            n = int(batch["audio_lens"][i])
            out = output_path(args.output_dir, name)
            out.parent.mkdir(parents=True, exist_ok=True)
            write_wav(out, wav[i, :n], cfg.sampling_rate)
            written.append(out)
            total_audio_s += n / cfg.sampling_rate
        logging.info(f"Wrote {len(batch['file_names'])} files")
    dt = time.perf_counter() - t0
    logging.info(f"Done: {total_audio_s:.1f}s of audio in {dt:.1f}s "
                 f"({total_audio_s / max(dt, 1e-9):.1f}x real-time incl. IO)")
    return written


if __name__ == "__main__":
    main()
