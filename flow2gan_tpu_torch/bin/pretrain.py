#!/usr/bin/env python3
"""Flow-matching pretraining (stage 1) of the port, on one card.

The counterpart of `flow2gan_tpu/bin/pretrain.py`, with its flag names and
defaults for what is ported, and `--device` (default cuda; the tests pass
cpu). Each step runs the fused iSTFT kernel forward and its adjoint kernel
backward on every branch. `--use-bf16 true` runs the ConvNeXt stacks in
bfloat16 (`compute_dtype`); parameters, the iSTFT and the loss stay float32.
Checkpoints: epoch-0.pt (the initial model), then
epoch-N.pt at the end of each epoch and checkpoint-<batch>.pt every
--save-every-n batches (the last --keep-last-k kept), each with the float64
running average that `bin/save_averaged_model.py` averages over.

    python -m flow2gan_tpu_torch.bin.pretrain --exp-dir exp/fm \
        --model-name mel_24k_base --train-recordings data/train.jsonl.gz \
        --valid-recordings data/valid.jsonl.gz --batch-size 64

A flag that is not ported yet raises and names the item of ROADMAP.md that
ports it; it is never ignored.
"""

from __future__ import annotations

import argparse
import logging
import os
import random
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from flow2gan_tpu_torch.api import init_weights
from flow2gan_tpu_torch.data.dataset import build_data_loader, read_recording_manifest
from flow2gan_tpu_torch.models import build_generator, get_generator_config
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram
from flow2gan_tpu_torch.training import checkpoint as ckpt
from flow2gan_tpu_torch.training.hooks import NonfiniteLossGuard
from flow2gan_tpu_torch.training.optim import ScaledAdam, eden2_lr
from flow2gan_tpu_torch.training.train_step import fm_eval_loss, fm_train_step, step_generator
from flow2gan_tpu_torch.utils import MetricsTracker, disable_tf32, setup_logger, str2bool

# the ROADMAP.md items (queue 1, by title) that port what the trainers do not
# run yet
SHARED_OPTIONS = "ROADMAP.md, 'The trainers' shared options'"
OBSERVABILITY = "ROADMAP.md, 'Observability'"
TOKEN_FAMILY = "ROADMAP.md, 'The token family'"
DDP = "ROADMAP.md, 'DDP'"

# flags of the JAX trainer that the port does not run yet: (attribute, its
# default, the ROADMAP.md item that ports it)
_LATER = (
    ("tokenizer", None, TOKEN_FAMILY),
    ("train_dls_weights", None, SHARED_OPTIONS),
    ("test_recordings", None, OBSERVABILITY + " (TensorBoard sample dumps)"),
    ("save_infer_steps", "2,4,8", OBSERVABILITY + " (TensorBoard sample dumps)"),
    ("print_diagnostics", False, OBSERVABILITY),
    ("inf_check", False, OBSERVABILITY),
    ("tensorboard", False, OBSERVABILITY),
    ("profile_dir", None, OBSERVABILITY),
    ("freeze_modules", None, SHARED_OPTIONS),
    ("lr_scale_rules", None, SHARED_OPTIONS),
    ("resume_from", None, SHARED_OPTIONS),
)


def get_parser():
    parser = argparse.ArgumentParser(
        description="Flow-matching pretraining of the PyTorch port",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--exp-dir", type=Path, default=Path("exp/fm"))
    parser.add_argument("--model-name", type=str, default="mel_24k_base")
    parser.add_argument("--tokenizer", type=str, default=None, help="not ported yet")
    parser.add_argument("--num-epochs", type=int, default=200)
    parser.add_argument("--start-epoch", type=int, default=1,
                        help="Resume from epoch-{start-epoch-1}.pt when > 1")
    parser.add_argument("--base-lr", type=float, default=0.035)
    parser.add_argument("--lr-batches", type=float, default=7500)
    parser.add_argument("--warmup-batches", type=float, default=500,
                        help="Eden2 linear-warmup length in batches")
    parser.add_argument("--warmup-start", type=float, default=0.1,
                        help="Eden2 warmup starting fraction (the reference trainer's 0.1)")
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--duration", type=float, default=1.5,
                        help="Training crop length in seconds")
    parser.add_argument("--max-load-times", type=int, default=3)
    parser.add_argument("--train-recordings", type=str, required=False,
                        help="CSV of recordings.jsonl[.gz] manifests")
    parser.add_argument("--train-dls-weights", type=str, default=None, help="not ported yet")
    parser.add_argument("--valid-recordings", type=str, required=False)
    parser.add_argument("--test-recordings", type=str, default=None, help="not ported yet")
    parser.add_argument("--save-infer-steps", type=str, default="2,4,8", help="not ported yet")
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--print-diagnostics", type=str2bool, default=False, help="not ported yet")
    parser.add_argument("--inf-check", type=str2bool, default=False, help="not ported yet")
    parser.add_argument("--save-every-n", type=int, default=4000,
                        help="Save checkpoint-{global_batch}.pt every N batches")
    parser.add_argument("--keep-last-k", type=int, default=30)
    parser.add_argument("--average-period", type=int, default=200)
    parser.add_argument("--log-interval", type=int, default=50)
    parser.add_argument("--valid-interval", type=int, default=2000)
    parser.add_argument("--use-bf16", type=str2bool, default=False,
                        help="bf16 activations in the model compute path")
    parser.add_argument("--tensorboard", type=str2bool, default=False, help="not ported yet")
    parser.add_argument("--profile-dir", type=str, default=None, help="not ported yet")
    parser.add_argument("--freeze-modules", type=str, default=None, help="not ported yet")
    parser.add_argument("--lr-scale-rules", type=str, default=None, help="not ported yet")
    parser.add_argument("--resume-from", type=str, default=None, help="not ported yet")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the card), or cpu for the tests")
    return parser


def check_ported(args, later=_LATER) -> None:
    """Raise on a flag the port does not run yet, naming its ROADMAP.md item;
    `later` lists them as (attribute, default, item)."""
    for attr, default, item in later:
        if getattr(args, attr) != default:
            flag = "--" + attr.replace("_", "-")
            raise NotImplementedError(f"{flag} is not ported yet: {item}")
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError(f"multi-process training is not ported yet: {DDP}")


def _manifests(csv: str):
    if not csv:
        raise SystemExit("--train-recordings is required: a comma-separated list of "
                         "recordings.jsonl[.gz] manifests")
    return [read_recording_manifest(path) for path in csv.split(",")]


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {"audio": torch.from_numpy(batch["audio"]).to(device),
            "audio_lens": torch.from_numpy(batch["audio_lens"]).to(device)}


def run(args) -> List[dict]:
    """Train; returns one record per step: batch index, loss, lr,
    clip_scale and the step's wall ms (to the loss's arrival on the host)."""
    check_ported(args)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to train on the CPU")
        disable_tf32()
    exp_dir = Path(args.exp_dir)
    exp_dir.mkdir(parents=True, exist_ok=True)
    setup_logger(f"{exp_dir}/log/log-train")
    logging.info(f"Training started: {vars(args)}")
    random.seed(args.seed)
    np.random.seed(args.seed)

    cfg = get_generator_config(args.model_name)
    if args.use_bf16:
        cfg["compute_dtype"] = "bfloat16"
    model = init_weights(build_generator(cfg), torch.Generator().manual_seed(args.seed)).to(device)
    mel_fn = LogMelSpectrogram(sampling_rate=cfg.sampling_rate, n_fft=cfg.mel_n_fft,
                               hop_length=cfg.mel_hop_length, n_mels=cfg.n_mels).to(device)
    logging.info(f"Number of model parameters: {sum(p.numel() for p in model.parameters())}")

    loader_kw = dict(sampling_rate=cfg.sampling_rate, num_workers=args.num_workers,
                     duration=args.duration)
    train_dls = [build_data_loader(recs, batch_size=args.batch_size, train=True,
                                   max_load_times=args.max_load_times, seed=args.seed,
                                   drop_last=True, **loader_kw)
                 for recs in _manifests(args.train_recordings)]
    valid_dls = [build_data_loader(recs, batch_size=min(args.batch_size, 32), train=False,
                                   **loader_kw)
                 for recs in (_manifests(args.valid_recordings) if args.valid_recordings else [])]

    optimizer = ScaledAdam(model.named_parameters(), clipping_scale=2.0)
    model_avg = {k: v.detach().double().clone() for k, v in model.state_dict().items()}
    batch_idx_train = 0
    if args.start_epoch > 1:
        resume = exp_dir / f"epoch-{args.start_epoch - 1}.pt"
        if not resume.exists():
            raise FileNotFoundError(f"--start-epoch {args.start_epoch} resumes from {resume}, "
                                    "which does not exist")
        logging.info(f"Resuming from {resume}")
        loaded = ckpt.load_checkpoint(resume)
        model.load_state_dict(loaded["model"])
        optimizer.load_state_dict(loaded["optimizer"])
        model_avg = {k: v.to(device) for k, v in loaded["model_avg"].items()}
        batch_idx_train = int(loaded["batch_idx_train"])

    def save(filename, **extra):
        ckpt.save_checkpoint(filename, model=model.state_dict(), model_avg=model_avg,
                             optimizer_state=optimizer.state_dict(),
                             train_params={"batch_idx_train": batch_idx_train,
                                           "model_name": args.model_name, **extra})

    epoch0 = exp_dir / "epoch-0.pt"
    if args.start_epoch == 1 and not epoch0.exists():
        # so that a window (epoch-0, epoch-N] is defined for every N
        save(epoch0)

    guard = NonfiniteLossGuard()
    history = []
    for epoch in range(args.start_epoch, args.num_epochs + 1):
        for dl in train_dls:
            dl.set_epoch(epoch)
        rng_py = random.Random(args.seed + epoch)
        iters = [iter(dl) for dl in train_dls]
        tot_losses = [MetricsTracker() for _ in train_dls]
        batch_idx = 0
        while True:
            dl_idx = rng_py.choices(range(len(iters)), k=1)[0]
            try:
                batch = next(iters[dl_idx])
            except StopIteration:
                logging.info(f"Reach end of dataloader {dl_idx}")
                break
            batch_idx += 1
            batch_idx_train += 1
            start = time.perf_counter()
            # lr and draws from the count of batches before this one
            metrics = fm_train_step(
                model, optimizer, mel_fn, _to_device(batch, device),
                eden2_lr(args.base_lr, batch_idx_train - 1, args.lr_batches,
                         warmup_batches=args.warmup_batches, warmup_start=args.warmup_start),
                step_generator(args.seed + 1, batch_idx_train - 1, device))
            loss_val = float(metrics["loss"])
            clip_val = float(metrics["clip_scale"])
            history.append({"batch_idx_train": batch_idx_train, "loss": loss_val,
                            "lr": metrics["lr"], "clip_scale": clip_val,
                            "ms": (time.perf_counter() - start) * 1e3})
            n = batch["audio"].shape[0]
            info = MetricsTracker()
            info["samples"] = n
            info["loss"] = loss_val * n
            tot_losses[dl_idx] = tot_losses[dl_idx] + info
            guard.check(loss_val, clip_val, batch_idx_train,
                        lambda suffix: save(exp_dir / f"bad-model{suffix}.pt"))

            if batch_idx_train % args.average_period == 0:
                model_avg = ckpt.update_averaged_model(model_avg, model.state_dict(),
                                                       args.average_period, batch_idx_train)
            if batch_idx_train % args.save_every_n == 0:
                save(exp_dir / f"checkpoint-{batch_idx_train}.pt")
                ckpt.remove_checkpoints(exp_dir, topk=args.keep_last_k)
            if batch_idx_train % args.log_interval == 0:
                logging.info(f"Epoch {epoch}, batch {batch_idx} (dl {dl_idx}), global "
                             f"{batch_idx_train}, loss {loss_val:.4f}, avg {tot_losses[dl_idx]}, "
                             f"lr {history[-1]['lr']:.2e}, clip {clip_val:.3f}")
            if args.valid_interval > 0 and batch_idx_train % args.valid_interval == 0 and valid_dls:
                valid = MetricsTracker()
                gen = torch.Generator(device=device).manual_seed(args.seed + 1)
                for dl in valid_dls:
                    for vb in dl:
                        n = vb["audio"].shape[0]
                        valid["loss"] += float(fm_eval_loss(model, mel_fn, _to_device(vb, device),
                                                            gen)) * n
                        valid["samples"] += n
                logging.info(f"Epoch {epoch}, validation: {valid}")
                if device.type == "cuda":
                    logging.info(f"Peak device memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")

        save(exp_dir / f"epoch-{epoch}.pt", base_lr=args.base_lr)
    logging.info("Done!")
    return history


def main(argv=None):
    run(get_parser().parse_args(argv))


if __name__ == "__main__":
    main()
