#!/usr/bin/env python3
"""Flow-matching pretraining (stage 1) of the port, on one card or as N
processes of data parallelism.

The counterpart of `flow2gan_tpu/bin/pretrain.py`, with its flag names and
defaults for what is ported, and `--device` (default cuda; the tests pass
cpu). Each step runs the fused iSTFT kernel forward and its adjoint kernel
backward on every branch. `--use-bf16 true` runs the ConvNeXt stacks in
bfloat16 (`compute_dtype`); parameters, the iSTFT and the loss stay float32.
A token config (`token_24k_base`) is conditioned on the ids of the k-means
codebook that `--tokenizer` names (fit by `bin/train_tokenizer.py`).
Checkpoints: epoch-0.pt (the initial model), then
epoch-N.pt at the end of each epoch and checkpoint-<batch>.pt every
--save-every-n batches (the last --keep-last-k kept), each with the float64
running average that `bin/save_averaged_model.py` averages over. A batch
checkpoint also holds the sampler's position: `--resume-from
checkpoint-<batch>.pt` continues mid-epoch where it was written.
`--freeze-modules` and `--lr-scale-rules` take parameter-path prefixes in
the JAX package's syntax (`cond_encoder`, `estimators_0/blocks_0=0.1`);
`--train-dls-weights` weights the choice among the training manifests.

    python -m flow2gan_tpu_torch.bin.pretrain --exp-dir exp/fm \
        --model-name mel_24k_base --train-recordings data/train.jsonl.gz \
        --valid-recordings data/valid.jsonl.gz --batch-size 64

Data parallelism: one process per card, `--batch-size` global (each rank
loads its 1/N, from its strided shard of the recordings; `--num-workers`
per rank), the gradients summed over the ranks after backward
(`parallel/dist.py`), so N ranks equal one process on the global batch.
Only rank 0 writes checkpoints and logs.

    python -m torch.distributed.run --nproc-per-node 2 \
        -m flow2gan_tpu_torch.bin.pretrain --batch-size 256 ...

A flag that is not ported yet raises and names the item of ROADMAP.md that
ports it; it is never ignored.
"""

from __future__ import annotations

import argparse
import logging
import random
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from flow2gan_tpu_torch.api import init_weights
from flow2gan_tpu_torch.data.dataset import build_data_loader, read_recording_manifest
from flow2gan_tpu_torch.models import build_generator, get_generator_config
from flow2gan_tpu_torch.ops.tokenizer import conditioning_frontend
from flow2gan_tpu_torch.parallel import dist
from flow2gan_tpu_torch.training import checkpoint as ckpt
from flow2gan_tpu_torch.training.hooks import NonfiniteLossGuard
from flow2gan_tpu_torch.training.optim import (
    ScaledAdam,
    eden2_lr,
    make_lr_scales,
    parse_lr_scale_rules,
)
from flow2gan_tpu_torch.training.train_step import fm_eval_loss, fm_train_step, step_generator
from flow2gan_tpu_torch.utils import MetricsTracker, disable_tf32, setup_logger, str2bool

# the ROADMAP.md item (queue 1, by title) that ports what the trainers do not
# run yet
OBSERVABILITY = "ROADMAP.md, 'Observability'"

# flags of the JAX trainer that the port does not run yet: (attribute, its
# default, the ROADMAP.md item that ports it)
_LATER = (
    ("test_recordings", None, OBSERVABILITY + " (TensorBoard sample dumps)"),
    ("save_infer_steps", "2,4,8", OBSERVABILITY + " (TensorBoard sample dumps)"),
    ("print_diagnostics", False, OBSERVABILITY),
    ("inf_check", False, OBSERVABILITY),
    ("tensorboard", False, OBSERVABILITY),
    ("profile_dir", None, OBSERVABILITY),
)


def get_parser():
    parser = argparse.ArgumentParser(
        description="Flow-matching pretraining of the PyTorch port",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--exp-dir", type=Path, default=Path("exp/fm"))
    parser.add_argument("--model-name", type=str, default="mel_24k_base")
    parser.add_argument("--tokenizer", type=str, default=None,
                        help="k-means codebook .npz for token_* configs (bin/train_tokenizer.py): "
                        "the frozen pseudo-codec that conditions TokenAudioGenerator")
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
    parser.add_argument("--train-dls-weights", type=str, default=None,
                        help="CSV of sampling weights, one per --train-recordings manifest")
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
    parser.add_argument("--freeze-modules", type=str, default=None,
                        help="CSV of parameter-path prefixes to freeze (lr 0), e.g. "
                        "'cond_encoder,estimators_0'")
    parser.add_argument("--lr-scale-rules", type=str, default=None,
                        help="CSV of prefix=scale lr multipliers, composed along the path, "
                        "e.g. 'cond_encoder=0.5,estimators_0/blocks_0=0.1'")
    parser.add_argument("--resume-from", type=str, default=None,
                        help="Continue mid-epoch from a checkpoint-<batch>.pt: the model, "
                        "optimizer, running average, batch count and sampler position")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (card LOCAL_RANK per rank), cuda:<i> (every rank on card i), "
                        "or cpu for the tests")
    return parser


def check_ported(args, later=_LATER) -> None:
    """Raise on a flag the port does not run yet, naming its ROADMAP.md item;
    `later` lists them as (attribute, default, item)."""
    for attr, default, item in later:
        if getattr(args, attr) != default:
            flag = "--" + attr.replace("_", "-")
            raise NotImplementedError(f"{flag} is not ported yet: {item}")


def local_batch_size(batch_size: int, world: int) -> int:
    """Each rank's share of the global `--batch-size`."""
    if batch_size % world:
        raise ValueError(f"--batch-size {batch_size} is the global batch and must divide "
                         f"by the world size {world}")
    return batch_size // world


def start_run(args, name: str) -> torch.device:
    """The trainers' common start: check the global batch against the world
    size, join the process group (a no-op in one process), turn TF32 off on
    the card, set up the log (rank 0's file) and seed the host RNGs.
    Returns this rank's device."""
    local_batch_size(args.batch_size, dist.env_world_size())
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to train on the CPU")
    device = dist.init_distributed(device)
    if device.type == "cuda":
        disable_tf32()
    exp_dir = Path(args.exp_dir)
    if dist.is_main():
        exp_dir.mkdir(parents=True, exist_ok=True)
    setup_logger(f"{exp_dir}/log/log-train", rank=dist.rank(), world_size=dist.world_size())
    logging.info(dist.describe(device))
    logging.info(f"{name} started: {vars(args)}")
    random.seed(args.seed)
    np.random.seed(args.seed)
    return device


def _manifests(csv: str):
    if not csv:
        raise SystemExit("--train-recordings is required: a comma-separated list of "
                         "recordings.jsonl[.gz] manifests")
    return [read_recording_manifest(path) for path in csv.split(",")]


def build_loaders(args, sampling_rate: int, valid_batch_cap: int):
    """This rank's training loaders (one per manifest, each its shard of
    the recordings at the local batch), its validation loaders, and the
    weights of the choice among the training loaders."""
    local_batch = local_batch_size(args.batch_size, dist.world_size())
    loader_kw = dict(sampling_rate=sampling_rate, num_workers=args.num_workers,
                     duration=args.duration)
    train_dls = [build_data_loader(recs, batch_size=local_batch, train=True,
                                   max_load_times=args.max_load_times, seed=args.seed,
                                   drop_last=True, **loader_kw)
                 for recs in _manifests(args.train_recordings)]
    valid_dls = [build_data_loader(recs, batch_size=min(local_batch, valid_batch_cap),
                                   train=False, **loader_kw)
                 for recs in (_manifests(args.valid_recordings) if args.valid_recordings else [])]
    weights = [1.0] * len(train_dls)
    if args.train_dls_weights:
        weights = [float(w) for w in args.train_dls_weights.split(",")]
        if len(weights) != len(train_dls):
            raise ValueError(f"--train-dls-weights gives {len(weights)} weights for "
                             f"{len(train_dls)} --train-recordings manifests")
    return train_dls, valid_dls, weights


def lr_scales(args, named_params) -> Optional[Dict[str, float]]:
    """Each parameter's lr multiplier from --lr-scale-rules and
    --freeze-modules, or None when both are empty."""
    rules = parse_lr_scale_rules(args.lr_scale_rules, args.freeze_modules)
    if not rules:
        return None
    scales = make_lr_scales(named_params, rules)
    logging.info(f"lr scale rules {rules}: {sum(v == 0.0 for v in scales.values())} "
                 f"parameter tensors frozen, {sum(v not in (0.0, 1.0) for v in scales.values())} "
                 "scaled")
    return scales


def resume_checkpoint(args, exp_dir: Path) -> Optional[dict]:
    """The checkpoint a run continues from: --resume-from, else
    epoch-{start-epoch - 1}.pt when --start-epoch > 1, else None. Every rank
    reads it."""
    if args.resume_from:
        logging.info(f"Mid-epoch resume from {args.resume_from}")
        return ckpt.load_checkpoint(args.resume_from)
    if args.start_epoch > 1:
        resume = exp_dir / f"epoch-{args.start_epoch - 1}.pt"
        if not resume.exists():
            raise FileNotFoundError(f"--start-epoch {args.start_epoch} resumes from {resume}, "
                                    "which does not exist")
        logging.info(f"Resuming from {resume}")
        return ckpt.load_checkpoint(resume)
    return None


def epoch_sampler(args, epoch: int, train_dls, resume_sampler: Optional[dict]) -> random.Random:
    """Set the loaders up for `epoch`: at the position a resumed checkpoint
    holds, else at the epoch's start; returns the loader-picking RNG."""
    if resume_sampler is not None:
        return ckpt.restore_sampler_state(resume_sampler, train_dls)[1]
    for dl in train_dls:
        dl.set_epoch(epoch)
    return random.Random(args.seed + epoch)


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {"audio": torch.from_numpy(batch["audio"]).to(device),
            "audio_lens": torch.from_numpy(batch["audio_lens"]).to(device)}


def run(args) -> List[dict]:
    """Train; returns one record per step: batch index, the training
    loader it drew from, loss, lr, clip_scale and the step's wall ms (to the
    loss's arrival on the host)."""
    check_ported(args)
    owns_group = not torch.distributed.is_initialized()
    device = start_run(args, "Training")
    try:
        return _train(args, device)
    finally:
        if owns_group:
            dist.destroy()


def _train(args, device: torch.device) -> List[dict]:
    exp_dir = Path(args.exp_dir)
    main = dist.is_main()
    cfg = get_generator_config(args.model_name)
    if args.use_bf16:
        cfg["compute_dtype"] = "bfloat16"
    # the model's conditioning: the log-mel, or for a token config the
    # frozen k-means pseudo-codec over the same frontend
    cond_fn = conditioning_frontend(cfg, args.tokenizer, args.model_name).to(device)
    model = init_weights(build_generator(cfg), torch.Generator().manual_seed(args.seed)).to(device)
    logging.info(f"Number of model parameters: {sum(p.numel() for p in model.parameters())}")
    train_dls, valid_dls, dls_weights = build_loaders(args, cfg.sampling_rate, 32)

    optimizer = ScaledAdam(model.named_parameters(), clipping_scale=2.0,
                           lr_scales=lr_scales(args, model.named_parameters()))
    # the running average lives on rank 0, which alone writes checkpoints
    model_avg = ({k: v.detach().double().clone() for k, v in model.state_dict().items()}
                 if main else None)
    batch_idx_train = 0
    resume_sampler = None
    loaded = resume_checkpoint(args, exp_dir)
    if loaded is not None:
        model.load_state_dict(loaded["model"])
        optimizer.load_state_dict(loaded["optimizer"])
        if main:
            model_avg = {k: v.to(device) for k, v in loaded["model_avg"].items()}
        batch_idx_train = int(loaded["batch_idx_train"])
        if args.resume_from and loaded.get("sampler") is not None:
            resume_sampler = loaded["sampler"]
            args.start_epoch = int(resume_sampler["epoch"])
            logging.info(f"Sampler restored: epoch {args.start_epoch}, consumed "
                         f"{[d['consumed'] for d in resume_sampler['dl_states']]}")
        del loaded
    dist.assert_replicas_equal(list(model.parameters()))

    def save(filename, sampler_state=None, **extra):
        ckpt.save_checkpoint(filename, model=model.state_dict(), model_avg=model_avg,
                             optimizer_state=optimizer.state_dict(),
                             train_params={"batch_idx_train": batch_idx_train,
                                           "model_name": args.model_name, **extra},
                             sampler_state=sampler_state)

    def save_bad_model(suffix):
        if main:
            save(exp_dir / f"bad-model{suffix}.pt")

    epoch0 = exp_dir / "epoch-0.pt"
    if main and args.start_epoch == 1 and not epoch0.exists():
        # so that a window (epoch-0, epoch-N] is defined for every N
        save(epoch0)

    guard = NonfiniteLossGuard()
    history = []
    for epoch in range(args.start_epoch, args.num_epochs + 1):
        rng_py = epoch_sampler(args, epoch, train_dls, resume_sampler)
        resume_sampler = None
        iters = [iter(dl) for dl in train_dls]
        tot_losses = [MetricsTracker() for _ in train_dls]
        batch_idx = 0
        while True:
            dl_idx = rng_py.choices(range(len(iters)), weights=dls_weights, k=1)[0]
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
                model, optimizer, cond_fn, _to_device(batch, device),
                eden2_lr(args.base_lr, batch_idx_train - 1, args.lr_batches,
                         warmup_batches=args.warmup_batches, warmup_start=args.warmup_start),
                step_generator(args.seed + 1, batch_idx_train - 1, device))
            loss_val = float(metrics["loss"])
            clip_val = float(metrics["clip_scale"])
            history.append({"batch_idx_train": batch_idx_train, "dl": dl_idx, "loss": loss_val,
                            "lr": metrics["lr"], "clip_scale": clip_val,
                            "ms": (time.perf_counter() - start) * 1e3})
            n = batch["audio"].shape[0]
            info = MetricsTracker()
            info["samples"] = n
            info["loss"] = loss_val * n
            tot_losses[dl_idx] = tot_losses[dl_idx] + info
            # the loss is the global batch's: every rank decides alike
            guard.check(loss_val, clip_val, batch_idx_train, save_bad_model)

            if main and batch_idx_train % args.average_period == 0:
                model_avg = ckpt.update_averaged_model(model_avg, model.state_dict(),
                                                       args.average_period, batch_idx_train)
            if main and batch_idx_train % args.save_every_n == 0:
                save(exp_dir / f"checkpoint-{batch_idx_train}.pt",
                     sampler_state=ckpt.sampler_state_snapshot(epoch, train_dls, rng_py))
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
                        valid["loss"] += float(fm_eval_loss(model, cond_fn, _to_device(vb, device),
                                                            gen)) * n
                        valid["samples"] += n
                valid.reduce(device)
                logging.info(f"Epoch {epoch}, validation: {valid}")
                if device.type == "cuda":
                    logging.info(f"Peak device memory {torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")

        if main:
            save(exp_dir / f"epoch-{epoch}.pt", base_lr=args.base_lr)
    logging.info("Done!")
    return history


def main(argv=None):
    run(get_parser().parse_args(argv))


if __name__ == "__main__":
    main()
