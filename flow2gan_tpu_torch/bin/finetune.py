#!/usr/bin/env python3
"""GAN fine-tuning (stage 2) of the port, on one card or as N processes of
data parallelism.

The counterpart of `flow2gan_tpu/bin/finetune.py`, with its flag names and
defaults for what is ported, and `--device` (default cuda; the tests pass
cpu). The generator starts from `--generator-model-path`: the FM trainer's
epoch checkpoint or averaged `.pt`, or a checkpoint in the reference's
naming. A token config is conditioned on the ids of the `--tokenizer`
codebook; the mel reconstruction loss stays on mels. Branch dropout is
off. The discriminators (MPD + MRD) start from flax's default init. The
first `--gen-start-batch-idx` batches train the discriminators alone; then
D and G steps strictly alternate, each with its own ScaledAdam and Eden2 lr. Every D step rolls the generator out in eval
form (3n fused-iSTFT launches); every G step differentiates the train-form
n-step rollout (3n forward and 3n adjoint launches). `--remat-rollout true`
recomputes each Euler step in backward.

    python -m flow2gan_tpu_torch.bin.finetune --exp-dir exp/gan_4step \\
        --model-name mel_24k_base --generator-model-path exp/fm/averaged.pt \\
        --n-timesteps 4 --train-recordings data/train.jsonl.gz --batch-size 64

Checkpoints: epoch-0.pt (the initial state), epoch-N.pt at the end of each
epoch and checkpoint-<batch>.pt every --save-every-n batches (the last
--keep-last-k kept). Each holds both models and both optimizers, the
generator's float64 running average and the D/G alternation state, so
--start-epoch resumes exactly; a batch checkpoint also holds the sampler's
position, from which --resume-from continues mid-epoch.
`bin/save_averaged_model.py --load-gan true` exports the generator. Each
step's record (side D or G, loss, lr, clip scale, wall ms) goes to
`<exp-dir>/steps.jsonl` as the step ends, as in `bin/pretrain.py`.
`--freeze-modules` and `--lr-scale-rules` apply to the generator only.

Data parallelism as in `bin/pretrain.py`: `--batch-size` is global, each
rank rolls out and judges its rows of it, and each step sums its own side's
gradients over the ranks:

    python -m torch.distributed.run --nproc-per-node 2 \\
        -m flow2gan_tpu_torch.bin.finetune --batch-size 64 ...

Observability as in `bin/pretrain.py`, for the side that stepped:
`--tensorboard` (on by default; every metric of the batch at the log
interval and the one after it, the validation, and the test samples at
`--n-timesteps`), `--profile-dir` (batches 10-15, with the program's spans
over the kernels), `--inf-check` (the dominant gradients of whichever side
was clipped to zero, the D or the G step keeping its gradients for it, and
the non-finite generator outputs of an eval-form rollout) and
`--print-diagnostics` (the generator's tables over 5 batches through the G
objective's train-form rollout, without `--remat-rollout`, whose recompute
would run the hooks again; then exit).
Every checkpoint holds `env_info`.
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path
from typing import List, Optional

import torch

from flow2gan_tpu_torch.api import init_weights
from flow2gan_tpu_torch.bin.pretrain import (
    DIAGNOSTIC_BATCHES,
    ProfileWindow,
    _to_device,
    add_step_record,
    build_loaders,
    epoch_sampler,
    load_test_batch,
    log_dominant_grads,
    lr_scales,
    open_step_records,
    open_tensorboard,
    print_diagnostics,
    resume_checkpoint,
    save_test_samples,
    start_run,
)
from flow2gan_tpu_torch.compat.from_reference import load_weights
from flow2gan_tpu_torch.models import build_generator, get_gan_config, get_generator_config
from flow2gan_tpu_torch.models.discriminators import Discriminators, init_discriminators
from flow2gan_tpu_torch.models.gan import make_mel_recon_fns
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram
from flow2gan_tpu_torch.ops.stft import num_frames
from flow2gan_tpu_torch.ops.tokenizer import conditioning_frontend
from flow2gan_tpu_torch.parallel import dist
from flow2gan_tpu_torch.training import checkpoint as ckpt
from flow2gan_tpu_torch.training.diagnostics import DiagnosticsCollector
from flow2gan_tpu_torch.training.env import get_env_info
from flow2gan_tpu_torch.training.gan_step import GANLossScales, make_gan_loss_fns, make_gan_steps
from flow2gan_tpu_torch.training.hooks import NonfiniteLossGuard, find_nonfinite_module_outputs
from flow2gan_tpu_torch.training.optim import ScaledAdam, eden2_lr
from flow2gan_tpu_torch.training.train_step import step_generator
from flow2gan_tpu_torch.utils import MetricsTracker, str2bool
_G_METRICS = ("loss_g", "gen_loss_mp", "gen_loss_mr", "feat_map_loss_mp", "feat_map_loss_mr",
              "mel_recon_loss")
_D_METRICS = ("loss_d", "disc_loss_mp", "disc_loss_mr")


def get_parser():
    parser = argparse.ArgumentParser(
        description="GAN fine-tuning of the PyTorch port",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    parser.add_argument("--exp-dir", type=Path, default=Path("exp/gan"))
    parser.add_argument("--model-name", type=str, default="mel_24k_base")
    parser.add_argument("--gan-name", type=str, default="gan_multi_scale_mel_recon")
    parser.add_argument("--generator-model-path", type=str, default=None,
                        help="The FM trainer's checkpoint or averaged .pt, or a reference-named .pt")
    parser.add_argument("--tokenizer", type=str, default=None,
                        help="k-means codebook .npz for token_* configs (bin/train_tokenizer.py)")
    parser.add_argument("--n-timesteps", type=int, default=1)
    parser.add_argument("--num-epochs", type=int, default=20)
    parser.add_argument("--start-epoch", type=int, default=1,
                        help="Resume from epoch-{start-epoch-1}.pt when > 1")
    parser.add_argument("--lr-g", type=float, default=0.002)
    parser.add_argument("--lr-d", type=float, default=0.02)
    parser.add_argument("--lr-batches-g", type=float, default=20000)
    parser.add_argument("--lr-batches-d", type=float, default=5000)
    parser.add_argument("--warmup-batches", type=float, default=500,
                        help="Eden2 linear-warmup length in batches")
    parser.add_argument("--warmup-start", type=float, default=0.1,
                        help="Eden2 warmup starting fraction (the reference trainer's 0.1)")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--duration", type=float, default=1.5)
    parser.add_argument("--max-load-times", type=int, default=3)
    parser.add_argument("--train-recordings", type=str, required=False,
                        help="CSV of recordings.jsonl[.gz] manifests")
    parser.add_argument("--train-dls-weights", type=str, default=None,
                        help="CSV of sampling weights, one per --train-recordings manifest")
    parser.add_argument("--valid-recordings", type=str, required=False)
    parser.add_argument("--test-recordings", type=str, required=False,
                        help="recordings.jsonl[.gz] manifest of whole test files dumped to "
                        "TensorBoard at --n-timesteps at each validation; else the first "
                        "validation batch")
    parser.add_argument("--num-workers", type=int, default=8)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--disc-loss-mp-scale", type=float, default=1.0)
    parser.add_argument("--disc-loss-mr-scale", type=float, default=0.1)
    parser.add_argument("--gen-loss-mp-scale", type=float, default=1.0)
    parser.add_argument("--gen-loss-mr-scale", type=float, default=0.1)
    parser.add_argument("--feat-map-loss-mp-scale", type=float, default=1.0)
    parser.add_argument("--feat-map-loss-mr-scale", type=float, default=0.1)
    parser.add_argument("--mel-recon-loss-scale", type=float, default=45.0)
    parser.add_argument("--gen-start-batch-idx", type=int, default=1000,
                        help="D-only warmup length before alternation starts")
    parser.add_argument("--average-period", type=int, default=200)
    parser.add_argument("--log-interval", type=int, default=50)
    parser.add_argument("--valid-interval", type=int, default=1000)
    parser.add_argument("--save-every-n", type=int, default=4000)
    parser.add_argument("--keep-last-k", type=int, default=30)
    parser.add_argument("--tensorboard", type=str2bool, default=True)
    parser.add_argument("--inf-check", type=str2bool, default=False,
                        help="On a D or G update clipped to zero, rank that side's parameters by "
                        "gradient-norm share; on a non-finite loss, name the generator modules "
                        "whose outputs went non-finite")
    parser.add_argument("--print-diagnostics", type=str2bool, default=False,
                        help="Collect the generator's activation, parameter and gradient tables "
                        "and PReLU histograms through the G objective for 5 batches, print, exit")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="Write a torch.profiler trace of batches 10-15 into this directory "
                        "(a Chrome trace), the program's spans (the Euler steps, the branches, "
                        "ScaledAdam, each all-reduce, the loader) over the kernels")
    parser.add_argument("--remat-rollout", type=str2bool, default=False,
                        help="Recompute each Euler step of the G step's rollout in backward")
    parser.add_argument("--freeze-modules", type=str, default=None,
                        help="CSV of generator parameter-path prefixes to freeze (lr 0)")
    parser.add_argument("--lr-scale-rules", type=str, default=None,
                        help="CSV of prefix=scale lr multipliers of the generator's parameters")
    parser.add_argument("--resume-from", type=str, default=None,
                        help="Continue mid-epoch from a checkpoint-<batch>.pt: both models and "
                        "optimizers, the running average, the D/G alternation and the sampler")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (card LOCAL_RANK per rank), cuda:<i> (every rank on card i), "
                        "or cpu for the tests")
    return parser


def run(args) -> List[dict]:
    """Fine-tune; returns one record per batch: batch index, the training
    loader it drew from, side ("D" or "G"), loss, lr, clip_scale and the
    step's wall ms (to the loss's arrival on the host)."""
    owns_group = not torch.distributed.is_initialized()
    device = start_run(args, "GAN fine-tuning")
    try:
        return _finetune(args, device)
    finally:
        if owns_group:
            dist.destroy()


def diagnose_gan_batch(diag: DiagnosticsCollector, generator, g_loss_fn, cond_fn, batch,
                       draws, n_timesteps: int, gen: torch.Generator,
                       scalars: Optional[tuple] = None) -> None:
    """One --print-diagnostics batch of the fine-tuner: the generator's
    module outputs in an eval-form rollout, its parameters, and in one
    backward of the G objective through the train-form rollout (`draws`)
    its parameter and module-output gradients (with `scalars`, the PReLU
    outputs and gradients, one per Euler step's call)."""
    with torch.no_grad(), diag.outputs(generator):
        generator.infer(cond_fn(batch["audio"]), n_timesteps=n_timesteps, generator=gen)
    named = list(generator.named_parameters())
    diag.collect_params(named)
    generator.zero_grad()
    with diag.output_grads(generator, scalars):
        g_loss_fn(batch, draws)[0].backward(inputs=[p for _, p in named])
    diag.collect_params(((n, p.grad) for n, p in named), suffix=".param_grad")
    generator.zero_grad()


def _finetune(args, device: torch.device) -> List[dict]:
    exp_dir = Path(args.exp_dir)
    main = dist.is_main()
    env_info = get_env_info(device)
    logging.info(f"Environment: {env_info}")
    cfg = get_generator_config(args.model_name)
    cfg["branch_dropout"] = 0.0  # off in the GAN stage, as in the reference
    gan_cfg = get_gan_config(args.gan_name)
    # the rollout's conditioning: the log-mel, or for a token config the
    # tokenizer over the same frontend; the mel reconstruction loss keeps mels
    cond_fn = conditioning_frontend(cfg, args.tokenizer, args.model_name).to(device)
    mel_fn = LogMelSpectrogram(sampling_rate=cfg.sampling_rate, n_fft=cfg.mel_n_fft,
                               hop_length=cfg.mel_hop_length, n_mels=cfg.n_mels).to(device)
    generator = init_weights(build_generator(cfg), torch.Generator().manual_seed(args.seed))
    if args.generator_model_path:
        logging.info(f"Loading generator from {args.generator_model_path}")
        load_weights(generator, args.generator_model_path)
    generator.to(device)
    discriminators = init_discriminators(
        Discriminators(), torch.Generator().manual_seed(args.seed)).to(device)
    mel_recon_fns = make_mel_recon_fns(cfg.sampling_rate, gan_cfg.mel_recon_n_ffts,
                                       gan_cfg.mel_recon_n_mels).to(device)
    optimizer_g = ScaledAdam(generator.named_parameters(), clipping_scale=2.0,
                             lr_scales=lr_scales(args, generator.named_parameters()))
    optimizer_d = ScaledAdam(discriminators.named_parameters(), clipping_scale=2.0)
    scales = GANLossScales(
        disc_mp=args.disc_loss_mp_scale, disc_mr=args.disc_loss_mr_scale,
        gen_mp=args.gen_loss_mp_scale, gen_mr=args.gen_loss_mr_scale,
        fmap_mp=args.feat_map_loss_mp_scale, fmap_mr=args.feat_map_loss_mr_scale,
        mel_recon=args.mel_recon_loss_scale)
    d_step, g_step, eval_step = make_gan_steps(
        generator, discriminators, cond_fn, mel_recon_fns, optimizer_g, optimizer_d,
        lr_g_fn=lambda b: eden2_lr(args.lr_g, b, args.lr_batches_g,
                                   warmup_batches=args.warmup_batches,
                                   warmup_start=args.warmup_start),
        lr_d_fn=lambda b: eden2_lr(args.lr_d, b, args.lr_batches_d,
                                   warmup_batches=args.warmup_batches,
                                   warmup_start=args.warmup_start),
        n_timesteps=args.n_timesteps, scales=scales, remat_rollout=args.remat_rollout,
        keep_grads=args.inf_check)
    logging.info(f"Parameters: generator {sum(p.numel() for p in generator.parameters())}, "
                 f"discriminators {sum(p.numel() for p in discriminators.parameters())}")

    model_avg = ({k: v.detach().double().clone() for k, v in generator.state_dict().items()}
                 if main else None)
    batch_idx_train, train_disc = 0, True
    resume_sampler = None
    loaded = resume_checkpoint(args, exp_dir)
    if loaded is not None:
        generator.load_state_dict(loaded["model"]["generator"])
        discriminators.load_state_dict(loaded["model"]["discriminator"])
        optimizer_g.load_state_dict(loaded["optimizer"]["g"])
        optimizer_d.load_state_dict(loaded["optimizer"]["d"])
        if main:
            model_avg = {k: v.to(device) for k, v in loaded["model_avg"].items()}
        batch_idx_train = int(loaded["batch_idx_train"])
        train_disc = bool(loaded["train_disc"])
        if args.resume_from and loaded.get("sampler") is not None:
            resume_sampler = loaded["sampler"]
            args.start_epoch = int(resume_sampler["epoch"])
            logging.info(f"Sampler restored at epoch {args.start_epoch}")
        del loaded
    dist.assert_replicas_equal([*generator.parameters(), *discriminators.parameters()])
    train_dls, valid_dls, dls_weights = build_loaders(args, cfg.sampling_rate, 16)
    tb_writer = open_tensorboard(args)
    test_batch = load_test_batch(args, cfg.sampling_rate, valid_dls) if tb_writer else None

    def save(filename, sampler_state=None, **extra):
        ckpt.save_checkpoint(
            filename,
            model={"generator": generator.state_dict(),
                   "discriminator": discriminators.state_dict()},
            model_avg=model_avg,
            optimizer_state={"g": optimizer_g.state_dict(), "d": optimizer_d.state_dict()},
            train_params={"batch_idx_train": batch_idx_train, "train_disc": train_disc,
                          "model_name": args.model_name, "n_timesteps": args.n_timesteps,
                          "env_info": env_info, **extra},
            sampler_state=sampler_state)

    def save_bad_model(suffix):
        if main:
            save(exp_dir / f"bad-model{suffix}.pt")

    epoch0 = exp_dir / "epoch-0.pt"
    if main and args.start_epoch == 1 and not epoch0.exists():
        # so that a window (epoch-0, epoch-N] is defined for every N
        save(epoch0)

    shard = dist.shard()

    def draws(audio, train: bool, gen: torch.Generator):
        n_frames = num_frames(audio.shape[-1], cfg.mel_hop_length)
        return generator.draw_rollout(audio.shape[0], n_frames, args.n_timesteps, gen, train,
                                      shard=shard)

    guard = NonfiniteLossGuard()
    diag, diag_g_loss = None, None
    if args.print_diagnostics:
        diag = DiagnosticsCollector()
        diag_g_loss = make_gan_loss_fns(generator, discriminators, cond_fn, mel_recon_fns,
                                        args.n_timesteps, scales)[1]
    profile = ProfileWindow(args.profile_dir, device)
    gt_dumped = False  # the test samples' ground truth is written once a run
    history = []
    steps_file = open_step_records(args, exp_dir)
    try:
        for epoch in range(args.start_epoch, args.num_epochs + 1):
            rng_py = epoch_sampler(args, epoch, train_dls, resume_sampler)
            resume_sampler = None
            iters = [iter(dl) for dl in train_dls]
            tot_g, tot_d = MetricsTracker(), MetricsTracker()
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
                # the draws from the count of batches before this one
                gen = step_generator(args.seed + 1, batch_idx_train - 1, device)
                side = "D" if train_disc else "G"
                if train_disc:
                    metrics = d_step(dev_batch, draws(dev_batch["audio"], False, gen))
                    keys, lr_key = _D_METRICS, "lr_d"
                    if batch_idx_train >= args.gen_start_batch_idx:
                        train_disc = False
                else:
                    metrics = g_step(dev_batch, draws(dev_batch["audio"], True, gen))
                    keys, lr_key = _G_METRICS, "lr_g"
                    train_disc = True
                values = torch.stack([metrics[k] for k in keys]).tolist()
                loss_val, clip_val, lr = values[0], float(metrics["clip_scale"]), metrics[lr_key]
                add_step_record(history, steps_file, {
                    "batch_idx_train": batch_idx_train, "dl": dl_idx, "side": side,
                    "loss": loss_val, "lr": lr, "clip_scale": clip_val,
                    "ms": (time.perf_counter() - start) * 1e3})
                n = batch["audio"].shape[0]
                info = MetricsTracker()
                info["samples"] = n
                for k, v in zip(keys, values):
                    info[k] = v * n
                if side == "D":
                    tot_d = tot_d + info
                else:
                    tot_g = tot_g + info
                profile.after(batch_idx_train)
                if clip_val == 0.0 and args.inf_check:
                    # the step left its side's (global) gradients in .grad
                    moved = discriminators if side == "D" else generator
                    log_dominant_grads(moved.named_parameters(),
                                       optimizer_d if side == "D" else optimizer_g, f"{side} ")
                if diag is not None:
                    last = batch_idx == DIAGNOSTIC_BATCHES
                    scalars = ({}, {}) if last else None
                    dgen = step_generator(args.seed + 1, batch_idx_train, device)
                    diagnose_gan_batch(diag, generator, diag_g_loss, cond_fn, dev_batch,
                                       draws(dev_batch["audio"], True, dgen), args.n_timesteps,
                                       dgen, scalars)
                    if last:
                        print_diagnostics(diag, scalars)
                        return history

                def replay():
                    # an eval-form rollout of the offending batch, every
                    # generator output tapped
                    rgen = step_generator(args.seed + 1, batch_idx_train - 1, device)
                    return find_nonfinite_module_outputs(generator, lambda: generator.infer(
                        cond_fn(dev_batch["audio"]), n_timesteps=args.n_timesteps, generator=rgen))

                guard.check(loss_val, clip_val, batch_idx_train, save_bad_model,
                            intermediates_fn=replay if args.inf_check else None)

                if main and batch_idx_train % args.average_period == 0:
                    model_avg = ckpt.update_averaged_model(model_avg, generator.state_dict(),
                                                           args.average_period, batch_idx_train)
                if main and batch_idx_train % args.save_every_n == 0:
                    save(exp_dir / f"checkpoint-{batch_idx_train}.pt",
                         sampler_state=ckpt.sampler_state_snapshot(epoch, train_dls, rng_py))
                    ckpt.remove_checkpoints(exp_dir, topk=args.keep_last_k)
                # the batch at the interval and the one after it, so both sides show
                if batch_idx_train % args.log_interval in (0, 1):
                    logging.info(f"Epoch {epoch}, batch {batch_idx}, global {batch_idx_train}, "
                                 f"{side} loss {loss_val:.4f}, lr {lr:.2e}, clip {clip_val:.3f}; "
                                 f"G avg: {tot_g}; D avg: {tot_d}")
                    if tb_writer is not None:
                        for k, v in [*zip(keys, values), (lr_key, lr), ("clip_scale", clip_val)]:
                            tb_writer.add_scalar(f"train/{k}", v, batch_idx_train)
                if args.valid_interval > 0 and batch_idx_train % args.valid_interval == 0 and valid_dls:
                    valid = MetricsTracker()
                    vgen = torch.Generator(device=device).manual_seed(args.seed + 1)
                    for dl in valid_dls:
                        for vb in dl:
                            vb = _to_device(vb, device)
                            m = eval_step(vb, draws(vb["audio"], False, vgen))
                            n = vb["audio"].shape[0]
                            valid["samples"] += n
                            for k in ("loss_g", "mel_recon_loss"):
                                valid[k] += float(m[k]) * n
                    valid.reduce(device)
                    logging.info(f"Epoch {epoch}, validation: {valid}")
                    if device.type == "cuda":
                        logging.info(f"Peak device memory "
                                     f"{torch.cuda.max_memory_allocated(device) / 1e9:.2f} GB")
                    if tb_writer is not None:
                        valid.write_summary(tb_writer, "train/valid_", batch_idx_train)
                        if test_batch is not None:
                            save_test_samples(tb_writer, generator, mel_fn, cond_fn, test_batch,
                                              [args.n_timesteps], batch_idx_train,
                                              cfg.sampling_rate, with_gt=not gt_dumped)
                            gt_dumped = True

            if main:
                save(exp_dir / f"epoch-{epoch}.pt")
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
