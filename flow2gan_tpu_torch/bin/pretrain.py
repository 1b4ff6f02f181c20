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
Every checkpoint holds `env_info` (`training/env.py`) and the best
validation loss so far (`best_valid_loss`, `best_valid_epoch`). Each step's
record (batch index, loss, lr, clip scale, wall ms) goes to
`<exp-dir>/steps.jsonl` as the step ends (`open_step_records`), from which
the recipe's step medians are read.

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

Observability, as in the JAX package:

- `--tensorboard` (on by default): the loss, lr and validation scalars,
  and at each validation the test samples (`--test-recordings`, else the
  first validation batch) as audio and spectrogram images, ground truth once
  and then at each of `--save-infer-steps`, in `<exp-dir>/tensorboard`
  (`utils_tb.py`, the port's own event writer; rank 0 writes);
- `--profile-dir`: a torch.profiler trace of global batches 10-15, written
  there as a Chrome trace, with the program's spans (`tracing`: the FM
  step's phases, the branches, ScaledAdam, each all-reduce, the loader)
  over the kernels;
- `--inf-check`: on a step clipped to zero, the parameters that dominate
  its gradient norm; on a non-finite loss, the non-finite parameters and
  the modules whose outputs were not finite, replayed on the batch;
- `--print-diagnostics`: the activation, parameter and gradient tables and
  the PReLU histograms (`training/diagnostics.py`) over 5 batches, then
  exit.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.api import init_weights
from flow2gan_tpu_torch.data.dataset import build_data_loader, read_recording_manifest
from flow2gan_tpu_torch.models import build_generator, get_generator_config
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram
from flow2gan_tpu_torch.ops.tokenizer import conditioning_frontend
from flow2gan_tpu_torch.parallel import dist
from flow2gan_tpu_torch.training import checkpoint as ckpt
from flow2gan_tpu_torch.training.diagnostics import (
    DiagnosticsCollector,
    collect_scalar_diagnostics,
    print_scalar_diagnostics,
)
from flow2gan_tpu_torch.training.env import get_env_info
from flow2gan_tpu_torch.training.hooks import NonfiniteLossGuard, find_nonfinite_module_outputs
from flow2gan_tpu_torch.training.optim import (
    ScaledAdam,
    dominant_parameters,
    eden2_lr,
    make_lr_scales,
    parse_lr_scale_rules,
)
from flow2gan_tpu_torch.training.train_step import fm_eval_loss, fm_train_step, step_generator
from flow2gan_tpu_torch.utils import (
    MetricsTracker,
    disable_tf32,
    plot_feature,
    setup_logger,
    str2bool,
)
from flow2gan_tpu_torch.utils_tb import SummaryWriter

DIAGNOSTIC_BATCHES = 5  # --print-diagnostics prints after this many, then exits
PROFILED_BATCHES = (10, 15)  # --profile-dir traces these global batches, both included


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
    parser.add_argument("--test-recordings", type=str, default=None,
                        help="recordings.jsonl[.gz] manifest of whole test files dumped to "
                        "TensorBoard at each validation (its first batch, up to 8); else the "
                        "first validation batch")
    parser.add_argument("--save-infer-steps", type=str, default="2,4,8",
                        help="Euler step counts of the TensorBoard test-sample dumps, CSV")
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--print-diagnostics", type=str2bool, default=False,
                        help="Collect the activation, parameter and gradient tables and the "
                        "PReLU histograms over 5 batches, print them and exit")
    parser.add_argument("--inf-check", type=str2bool, default=False,
                        help="Name the dominant gradients of a step clipped to zero, and the "
                        "non-finite parameters and module outputs of a non-finite loss")
    parser.add_argument("--save-every-n", type=int, default=4000,
                        help="Save checkpoint-{global_batch}.pt every N batches")
    parser.add_argument("--keep-last-k", type=int, default=30)
    parser.add_argument("--average-period", type=int, default=200)
    parser.add_argument("--log-interval", type=int, default=50)
    parser.add_argument("--valid-interval", type=int, default=2000)
    parser.add_argument("--use-bf16", type=str2bool, default=False,
                        help="bf16 activations in the model compute path")
    parser.add_argument("--tensorboard", type=str2bool, default=True)
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a torch.profiler trace of batches 10-15 into this directory "
                        "(a Chrome trace), the program's spans (the FM step's phases, the "
                        "branches, ScaledAdam, each all-reduce, the loader) over the kernels")
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
        return ckpt.load_checkpoint(args.resume_from)  # raises on a JAX .ckpt
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


def open_step_records(args, exp_dir: Path):
    """`<exp_dir>/steps.jsonl`, line-buffered, to which each step's record is
    written as one JSON line when the step ends: emptied where the run
    starts afresh, appended to where it resumes (`--start-epoch` > 1 or
    `--resume-from`). Rank 0 alone writes; the others get None."""
    if not dist.is_main():
        return None
    fresh = args.start_epoch == 1 and not args.resume_from
    return open(Path(exp_dir) / "steps.jsonl", "w" if fresh else "a", buffering=1)


def add_step_record(history: List[dict], steps_file, record: dict) -> None:
    """Keep a step's record, and write it where `steps_file` is open."""
    history.append(record)
    if steps_file is not None:
        steps_file.write(json.dumps(record) + "\n")


def _to_device(batch, device) -> Dict[str, torch.Tensor]:
    return {"audio": torch.from_numpy(batch["audio"]).to(device),
            "audio_lens": torch.from_numpy(batch["audio_lens"]).to(device)}


def open_tensorboard(args) -> Optional[SummaryWriter]:
    """Rank 0's event writer in <exp-dir>/tensorboard under --tensorboard,
    else None."""
    if not (args.tensorboard and dist.is_main()):
        return None
    return SummaryWriter(Path(args.exp_dir) / "tensorboard")


def load_test_batch(args, sampling_rate: int, valid_dls) -> Optional[dict]:
    """The samples the TensorBoard dumps synthesise: the first batch (up to
    8) of --test-recordings' whole files, else the first validation batch,
    else None."""
    if args.test_recordings:
        loader = build_data_loader(read_recording_manifest(args.test_recordings),
                                   sampling_rate=sampling_rate, batch_size=8,
                                   num_workers=args.num_workers, train=False, duration=None,
                                   apply_effects=False)
        return next(iter(loader))
    return next(iter(valid_dls[0])) if valid_dls else None


@torch.no_grad()
def save_test_samples(tb_writer: SummaryWriter, model, mel_fn, cond_fn, test_batch: dict,
                      infer_steps: Sequence[int], step_idx: int, sampling_rate: int,
                      with_gt: bool) -> None:
    """Synthesise every test sample at each of `infer_steps` Euler steps
    (x0 from seed 0, clamped) and write each as audio and a spectrogram
    image, tags valid/test_audio_{i}_step_{k}; with `with_gt` the ground
    truth too, valid/test_audio_{i}_gt (once a run is enough: it does not
    change). `cond_fn` conditions the model; `mel_fn` renders the images."""
    device = next(model.parameters()).device
    lens = np.asarray(test_batch["audio_lens"])

    def dump(tag: str, wav: np.ndarray) -> None:
        tb_writer.add_audio(tag, wav, step_idx, sampling_rate)
        mel = mel_fn(torch.from_numpy(np.ascontiguousarray(wav[None])).to(device))[0]
        tb_writer.add_image(f"{tag}_spec", plot_feature(mel.float().cpu().numpy()), step_idx,
                            dataformats="HWC")

    audio = np.asarray(test_batch["audio"], np.float32)
    if with_gt:
        for i in range(audio.shape[0]):
            dump(f"valid/test_audio_{i}_gt", audio[i, :lens[i]])
    cond = cond_fn(torch.from_numpy(audio).to(device))
    for n_steps in infer_steps:
        wav = model.infer(cond, audio_lens=torch.from_numpy(lens).to(device), n_timesteps=n_steps,
                          clamp_pred=True,
                          generator=torch.Generator(device=device).manual_seed(0))
        wav = wav.float().cpu().numpy()
        for i in range(wav.shape[0]):
            dump(f"valid/test_audio_{i}_step_{n_steps}", wav[i, :lens[i]])


class ProfileWindow:
    """--profile-dir: a torch.profiler trace (host, and the card's kernels
    on the card) from the start of global batch 10 to the end of batch 15,
    exported into the directory as a Chrome trace. The window turns the
    program's tracing on, so that its spans mark the trace; where tracing
    was already on, it is left on and its spans and counters are kept."""

    def __init__(self, profile_dir: Optional[str], device: torch.device):
        self.dir = Path(profile_dir) if profile_dir else None
        self.device = device
        self.prof = None
        self.traced = False  # whether the window turned tracing on

    def before(self, batch_idx_train: int) -> None:
        if self.dir is not None and batch_idx_train == PROFILED_BATCHES[0]:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.traced = not tracing.enabled()
            tracing.enable()
            self.prof = torch.profiler.profile(activities=activities)
            self.prof.start()

    def after(self, batch_idx_train: int) -> None:
        if self.prof is not None and batch_idx_train == PROFILED_BATCHES[1]:
            self.close()

    def close(self) -> None:
        """Stop the trace and write it (also where the run ended inside the
        window)."""
        if self.prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        if self.traced:
            tracing.disable()
            tracing.drain()
            self.traced = False
        self.dir.mkdir(parents=True, exist_ok=True)
        first, last = PROFILED_BATCHES
        path = self.dir / f"trace-batches-{first}-{last}-rank{dist.rank()}.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        logging.info(f"Profiler trace written to {path}")


def log_dominant_grads(named_params, optimizer: ScaledAdam, label: str = "") -> None:
    """--inf-check on a step clipped to zero: the parameters whose gradients
    (kept in `.grad` by the step) dominate the clipping norm."""
    grads = [(n, p.grad) for n, p in named_params if p.grad is not None]
    for name, share, grad_rms in dominant_parameters(grads, optimizer.named_param_rms()):
        logging.warning(f"Dominant {label}grad: {name} share={share:.2%} rms={grad_rms:.3g}")


def diagnose_fm_batch(diag: DiagnosticsCollector, model, cond_fn, batch: Dict[str, torch.Tensor],
                      gen: torch.Generator, scalars: Optional[tuple] = None) -> None:
    """One --print-diagnostics batch: the module outputs of the eval-form FM
    loss, the parameters, and in one backward of the train-form loss the
    parameter and module-output gradients (and with `scalars`, the PReLU
    outputs and gradients, `DiagnosticsCollector.output_grads`). Each rank
    diagnoses its own rows."""
    audio, lens = batch["audio"], batch["audio_lens"]
    with torch.no_grad():
        cond = cond_fn(audio)
        with diag.outputs(model):
            model(cond, audio, lens, model.draw(audio, cond.shape[-1], gen, train=False))
    named = list(model.named_parameters())
    diag.collect_params(named)
    model.zero_grad()
    with diag.output_grads(model, scalars):
        model(cond, audio, lens, model.draw(audio, cond.shape[-1], gen, train=True)).backward()
    diag.collect_params(((n, p.grad) for n, p in named), suffix=".param_grad")
    model.zero_grad()


def print_diagnostics(diag: DiagnosticsCollector, scalars: tuple) -> None:
    stats: dict = {}
    collect_scalar_diagnostics(stats, *scalars)
    if dist.is_main():
        diag.print_diagnostics()
        print_scalar_diagnostics(stats)
    logging.info("Diagnostics done, exiting")


def run(args) -> List[dict]:
    """Train; returns one record per step: batch index, the training
    loader it drew from, loss, lr, clip_scale and the step's wall ms (to the
    loss's arrival on the host)."""
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
    env_info = get_env_info(device)
    logging.info(f"Environment: {env_info}")
    cfg = get_generator_config(args.model_name)
    if args.use_bf16:
        cfg["compute_dtype"] = "bfloat16"
    # the model's conditioning: the log-mel, or for a token config the
    # frozen k-means pseudo-codec over the same frontend
    cond_fn = conditioning_frontend(cfg, args.tokenizer, args.model_name).to(device)
    mel_fn = LogMelSpectrogram(sampling_rate=cfg.sampling_rate, n_fft=cfg.mel_n_fft,
                               hop_length=cfg.mel_hop_length, n_mels=cfg.n_mels).to(device)
    model = init_weights(build_generator(cfg), torch.Generator().manual_seed(args.seed)).to(device)
    logging.info(f"Number of model parameters: {sum(p.numel() for p in model.parameters())}")
    train_dls, valid_dls, dls_weights = build_loaders(args, cfg.sampling_rate, 32)
    tb_writer = open_tensorboard(args)
    test_batch = load_test_batch(args, cfg.sampling_rate, valid_dls) if tb_writer else None
    infer_steps = [int(x) for x in args.save_infer_steps.split(",") if x.strip()]

    optimizer = ScaledAdam(model.named_parameters(), clipping_scale=2.0,
                           lr_scales=lr_scales(args, model.named_parameters()))
    # the running average lives on rank 0, which alone writes checkpoints
    model_avg = ({k: v.detach().double().clone() for k, v in model.state_dict().items()}
                 if main else None)
    batch_idx_train = 0
    best = {"best_valid_loss": float("inf"), "best_valid_epoch": 0}
    resume_sampler = None
    loaded = resume_checkpoint(args, exp_dir)
    if loaded is not None:
        model.load_state_dict(loaded["model"])
        optimizer.load_state_dict(loaded["optimizer"])
        if main:
            model_avg = {k: v.to(device) for k, v in loaded["model_avg"].items()}
        batch_idx_train = int(loaded["batch_idx_train"])
        best = {k: loaded.get(k, v) for k, v in best.items()}
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
                                           "model_name": args.model_name, "env_info": env_info,
                                           **best, **extra},
                             sampler_state=sampler_state)

    def save_bad_model(suffix):
        if main:
            save(exp_dir / f"bad-model{suffix}.pt")

    epoch0 = exp_dir / "epoch-0.pt"
    if main and args.start_epoch == 1 and not epoch0.exists():
        # so that a window (epoch-0, epoch-N] is defined for every N
        save(epoch0)

    guard = NonfiniteLossGuard()
    diag = DiagnosticsCollector() if args.print_diagnostics else None
    profile = ProfileWindow(args.profile_dir, device)
    gt_dumped = False  # the test samples' ground truth is written once a run
    history = []
    steps_file = open_step_records(args, exp_dir)
    try:
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
                profile.before(batch_idx_train)
                dev_batch = _to_device(batch, device)
                # lr and draws from the count of batches before this one
                metrics = fm_train_step(
                    model, optimizer, cond_fn, dev_batch,
                    eden2_lr(args.base_lr, batch_idx_train - 1, args.lr_batches,
                             warmup_batches=args.warmup_batches, warmup_start=args.warmup_start),
                    step_generator(args.seed + 1, batch_idx_train - 1, device))
                loss_val = float(metrics["loss"])
                clip_val = float(metrics["clip_scale"])
                add_step_record(history, steps_file, {
                    "batch_idx_train": batch_idx_train, "dl": dl_idx, "loss": loss_val,
                    "lr": metrics["lr"], "clip_scale": clip_val,
                    "ms": (time.perf_counter() - start) * 1e3})
                profile.after(batch_idx_train)
                n = batch["audio"].shape[0]
                info = MetricsTracker()
                info["samples"] = n
                info["loss"] = loss_val * n
                tot_losses[dl_idx] = tot_losses[dl_idx] + info
                if clip_val == 0.0 and args.inf_check:
                    # the step left its (global) gradients in .grad
                    log_dominant_grads(model.named_parameters(), optimizer)
                if diag is not None:
                    last = batch_idx == DIAGNOSTIC_BATCHES
                    scalars = ({}, {}) if last else None
                    diagnose_fm_batch(diag, model, cond_fn, dev_batch,
                                      step_generator(args.seed + 1, batch_idx_train, device), scalars)
                    if last:
                        print_diagnostics(diag, scalars)
                        return history

                def replay():
                    # the offending batch again, every module output tapped
                    gen = step_generator(args.seed + 1, batch_idx_train - 1, device)
                    audio, lens = dev_batch["audio"], dev_batch["audio_lens"]

                    def forward():
                        cond = cond_fn(audio)
                        model(cond, audio, lens, model.draw(audio, cond.shape[-1], gen, train=False))

                    return find_nonfinite_module_outputs(model, forward)

                # the loss is the global batch's: every rank decides alike
                guard.check(loss_val, clip_val, batch_idx_train, save_bad_model,
                            params_tree=model.state_dict() if args.inf_check else None,
                            intermediates_fn=replay if args.inf_check else None)

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
                    if tb_writer is not None:
                        tb_writer.add_scalar(f"train/current_loss_{dl_idx}", loss_val, batch_idx_train)
                        tb_writer.add_scalar("train/learning_rate", metrics["lr"], batch_idx_train)
                        tot_losses[dl_idx].write_summary(tb_writer, f"train/tot_loss_{dl_idx}_",
                                                         batch_idx_train)
                if args.valid_interval > 0 and batch_idx_train % args.valid_interval == 0 and valid_dls:
                    valid = MetricsTracker()
                    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
                    for dl in valid_dls:
                        for vb in dl:
                            n = vb["audio"].shape[0]
                            valid["loss"] += float(fm_eval_loss(model, cond_fn,
                                                                _to_device(vb, device), gen)) * n
                            valid["samples"] += n
                    valid.reduce(device)
                    valid_loss = valid["loss"] / valid["samples"] if valid["samples"] else float("inf")
                    if valid_loss < best["best_valid_loss"]:
                        best = {"best_valid_loss": valid_loss, "best_valid_epoch": epoch}
                    logging.info(f"Epoch {epoch}, validation: {valid} (best "
                                 f"{best['best_valid_loss']:.4g} @ epoch {best['best_valid_epoch']})")
                    if device.type == "cuda":
                        logging.info(f"Peak device memory "
                                     f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
                    if tb_writer is not None:
                        valid.write_summary(tb_writer, "train/valid_", batch_idx_train)
                        if test_batch is not None:
                            save_test_samples(tb_writer, model, mel_fn, cond_fn, test_batch,
                                              infer_steps, batch_idx_train, cfg.sampling_rate,
                                              with_gt=not gt_dumped)
                            gt_dumped = True

            if main:
                save(exp_dir / f"epoch-{epoch}.pt", base_lr=args.base_lr)
    finally:
        profile.close()
        if tb_writer is not None:
            tb_writer.close()
        if steps_file is not None:
            steps_file.close()
    logging.info("Done!")
    return history


def main(argv=None):
    run(get_parser().parse_args(argv))


if __name__ == "__main__":
    main()
