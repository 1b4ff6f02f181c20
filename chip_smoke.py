"""Smoke run of the PyTorch port (`flow2gan_tpu_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card (sm_90a) and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. the card (`nvidia-smi` name and power limit) and the torch / CUDA versions;
2. the build of `flow2gan_tpu_torch/csrc/fused_istft.cu` with nvcc: its time
   and ptxas' register report;
3. the fused iSTFT kernel against its plain PyTorch version on the card at
   the six branch shapes of mel_24k_base and mel_44k_128band_512x_base
   (batch 16) and at edge shapes (among them spectra with nonzero imaginary
   parts at DC and Nyquist, mel_24k_tiny's (64, 32) branch and a 60 s clip),
   with its time, the plain version's, the time of `torch.istft` (a
   yardstick the port never calls), the bound, and the timing floor (what
   the same timing reads for a one-element `add_`);
4. the adjoint kernel (the iSTFT's backward) against its plain version at
   the same shapes and at the three branch shapes of a training step (batch
   16 x 1.5 s), with exactly zero imaginary parts at DC and Nyquist, the
   dot-product identity <istft(s), g> = <s, adjoint(g)> on the card, its
   time, the plain adjoint's, that of `torch.stft` (the yardstick: the same
   transform of the padded, enveloped gradient, up to the bin weights), the
   bound, its share of it and the plan; at the training shapes the kernel
   and the plain adjoint each against a float64 adjoint (numpy), the
   kernel's error at most twice the plain one's; then both kernels, with
   the same checks and times, at the reference's per-card batches: a
   training step's shapes at its FM batch of 256, a GAN rollout step's at
   its fine-tuning batch of 64;
5. the main path: `get_model("mel_24k_base")` and `infer` on a (16, 100, 94)
   mel at 1, 2 and 4 Euler steps, with the launch count of the kernel over
   that run, then the per-call time and x-real-time over timed calls, and
   mel_44k_128band_512x_base once at 1 step;
6. card against CPU: the same weights and x0 through `infer_from_noise`;
7. `reconstruct` from a waveform;
8. the device-time breakdown of one 1-step call (torch.profiler);
9. gradients, card against CPU: the FM loss of full mel_24k_base at batch
   2 x 1 s and every parameter's gradient, with the same weights and draws,
   and the launches of both kernels in that step;
10. the trainer: a synthetic 24 kHz corpus written under build/, the port's
   `bin/pretrain.py` run in-process on mel_24k_base (batch 16 x 1.5 s, 32
   steps), with its launch counts, loss curve, step times, audio trained per
   second and peak memory; the checkpoints reloaded; `save_averaged_model`
   and a 1-step call served from the averaged weights; the device-time
   breakdown of one training step by family;
11. bf16 serving: mel_24k_base with `compute_dtype="bfloat16"` on the seed
   weights of phase 5, at 1, 2 and 4 steps (launches, then ms per call and
   x-real-time beside the float32 model's in the same phase), card bf16
   against card float32, card bf16 against CPU bf16 (the limit: 1/4 of the
   CPU's bf16 distance from float32, plus twice how far the CPU's bf16
   result moves when x0 moves by one float32 ulp), and one 1-step call's
   device time by family, float32 and bf16 GEMMs apart;
12. 44.1 kHz card against CPU: mel_44k_128band_512x_base, float32, 1 step;
13. bf16 training: `bin/pretrain.py --use-bf16` for 8 steps on half the
   corpus (loss curve, step times, audio per second, peak memory, launches
   of both kernels);
14. the CLIs: `bin/infer --epoch 2 --avg 1` over phase 10's checkpoints and
   a manifest of corpus files, `bin/infer_dir` on a directory of them, whole
   and in 50-frame chunks; lengths, finiteness, chunked against whole, and
   the native WAV reader in use;
15. the GAN stage (stage 2), all on mel_24k_base with the full
   discriminators (periods 2-11, windows 2048/1024/512):
   a. both kernels against their plain versions at the rollout shapes of a
      fine-tuning batch (16 x 1.5 s: 141 mel frames, 36096 samples);
   b. the discriminators, card against CPU (batch 2 x 1 s, same weights):
      every score and feature map;
   c. the D and G objectives at 1 step, card against CPU (batch 2 x 1 s,
      same weights and draws): loss and the own side's gradients, and the
      launches (forward, adjoint): (3, 0) for D, (3, 3) for G;
   d. the fine-tuner: `bin/finetune.py` at 4 Euler steps, batch 16 x 1.5 s,
      from phase 10's averaged model on its corpus, a D-only warm-up of 4
      batches then D/G alternation, 32 batches with validation; the launches
      of every D, G and validation step, finite losses, both sides moved;
      D-step and G-step times, audio per second of G step, peak memory;
   e. one D step and one G step profiled by kernel family, the
      discriminators' own device time measured alone, and the busy share;
   f. one 4-step G step with `--remat-rollout` and without: loss and
      gradients, peak memory and forward launches of each;
   g. `save_averaged_model --load-gan` on the fine-tuner's checkpoints and
      `bin/infer --load-gan` over corpus files at 4 steps;
16. data parallelism (`parallel/dist.py`), 2 ranks as spawned processes, at
   full mel_24k_base width with the full discriminators; one rank per card
   over NCCL where there are 2 cards, else both ranks on card 0 over gloo
   (the backend is printed); both kernels against their plain versions at
   the per-rank shapes (batch 8) with the other kernel checks above:
   a. one FM step as 2 ranks of 8 rows against one process on the global
      batch of 16 x 1.5 s (the second rank's valid lengths shorter), with
      the same weights and draws: loss, and every summed gradient within the
      FM card limits; the ranks' parameters bitwise equal after the step;
      with one card, the step again in a one-rank NCCL group, so that NCCL's
      init and all-reduce run on the card;
   b. a 4-step GAN D step and G step, the same way, within the D and G
      limits of 15c (each tensor 1e-2 of its norm plus four floors, the
      whole 2.5e-4 plus two), the floor here being how far one process's
      gradient moves when it computes the global batch as two halves and
      sums them, as the ranks do;
   c. `bin/pretrain.py` as 2 processes (global batch 16, 6 steps): step ms
      and audio per second at the global batch, peak memory per rank, the
      all-reduces' ms per step (CUDA events: the gradient buckets and the
      small ones apart), each rank's device time in its last step
      (profiled; NCCL's kernels, which spin while they wait, apart) and
      busy share, both kernels' launches per rank, and that
      only rank 0 wrote checkpoints and a log;
17. resume: `bin/pretrain.py` (4 steps) and `bin/finetune.py` (4 Euler
   steps, batches D, D, G, D, `--freeze-modules cond_encoder`) run
   straight twice and once with `--resume-from checkpoint-2.pt`: the
   resumed run within 4 times the straight runs' own spread, the D/G
   alternation and the sampler continued, the frozen tensors bitwise
   unchanged;
18. the token family at full width (token_24k_base: mel_24k_base's
   generator with a 1024 x 256 token embedding in front of the cond
   encoder):
   a. `bin/train_tokenizer.py` (vocab 1024, mels on the card) on phase 10's
      corpus, and its tokens on the card against the CPU tokenizer: equal
      but on near-ties (best two scores within 1e-5 of max|score|), which
      are under 1% of the frames and counted;
   b. `get_model("token_24k_base", tokenizer=...)` on a (16, 94) array of
      ids at 1, 2 and 4 steps: launches (3 per Euler step), then ms per
      call and x-real-time in turns with mel_24k_base's, one 1-step call
      of each by device time; card against CPU through infer_from_noise;
      `reconstruct` from a waveform;
   c. the FM loss and gradients card against CPU at batch 2 x 1 s: phase
      9's limits, but each tensor's 1e-2 plus four times how far the CPU's
      gradient of it moves when the parameters and x0 move by one float32
      ulp (as 15c holds the G side; the embedding's gradient is among the
      tensors), and (3, 3) launches;
   d. `bin/pretrain.py --tokenizer` for 8 steps at batch 16 x 1.5 s: every
      step's launches, losses, step ms, audio per second, peak memory; one
      step's device time by family;
   e. `bin/finetune.py --tokenizer` at 4 Euler steps from d's average, 8
      batches: every step's launches (D 12; G 12 and 12), losses;
   f. `bin/infer --tokenizer`, and `bin/infer_dir` with `--tokenizer` on
      wavs and `--tokens true` on their ids, whole and chunked;
19. observability, on mel_24k_base from phase 10's corpus and averaged
   model:
   a. `bin/pretrain.py` with `--tensorboard`, `--test-recordings` (4
      files) at `--save-infer-steps 1,2,4`, `--profile-dir` and
      `--inf-check`, 16 steps at batch 16 x 1.5 s, validating at batches
      8 and 16: every step's launches and the run's; the event file read
      back (framing, CRCs, the scalar, audio and image tags); the Chrome
      trace's kernel events of batches 10-15 against the launches counted
      there (18 and 18), the trace then deleted; `env_info` with the card's
      name and `best_valid_loss` in every checkpoint; the median ms of the
      steps that write nothing beside phase 10's;
   b. `--inf-check` with the third batch's first row NaN: that step
      clipped to zero, the dominant gradients and the first non-finite
      module output named, no failed replay, training going on;
   c. `--print-diagnostics` at batch 4 x 1 s: 5 batches, the tables of
      each kind counted, the wall time, the launches;
   d. `bin/finetune.py` at 4 Euler steps with the full discriminators, 16
      batches with `--tensorboard`, `--test-recordings`, `--profile-dir`
      and `--inf-check` (every step's launches, the event file, the trace
      against the counted launches), then `--print-diagnostics` at batch 4;
20. the `kernels` JSON line (each kernel's launches on every path, the
   data-parallel ones per rank), then the card line and the result line.
"""

from __future__ import annotations

import copy
import json
import math
import os
import re
import shutil
import socket
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed
import torch.multiprocessing

from flow2gan_tpu_torch import get_model, utils_tb
from flow2gan_tpu_torch.api import VocoderModel, init_weights
from flow2gan_tpu_torch.bin import (
    finetune,
    infer,
    infer_dir,
    pretrain,
    save_averaged_model,
    train_tokenizer,
)
from flow2gan_tpu_torch.compat.from_reference import load_weights
from flow2gan_tpu_torch.data import native_audio
from flow2gan_tpu_torch.data.audio_io import read_wav, write_wav
from flow2gan_tpu_torch.data.dataset import (
    Recording,
    read_recording_manifest,
    write_recording_manifest,
)
from flow2gan_tpu_torch.models import FMDraws, RolloutDraws, build_generator, get_generator_config
from flow2gan_tpu_torch.models.discriminators import Discriminators, init_discriminators
from flow2gan_tpu_torch.models.gan import discriminator_loss, feature_matching_loss, generator_loss
from flow2gan_tpu_torch.models.gan import make_mel_recon_fns
from flow2gan_tpu_torch.models.generator import branch_dropout_weight
from flow2gan_tpu_torch.ops import cuda_build
from flow2gan_tpu_torch.ops import fused_istft as fused
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram
from flow2gan_tpu_torch.ops.stft import envelope, hann_window_np
from flow2gan_tpu_torch.ops.tokenizer import MelKMeansTokenizer
from flow2gan_tpu_torch.parallel import dist
from flow2gan_tpu_torch.parallel.dist import Shard
from flow2gan_tpu_torch.training import checkpoint as ckpt
from flow2gan_tpu_torch.training.gan_step import make_gan_loss_fns, make_gan_steps
from flow2gan_tpu_torch.training.optim import ScaledAdam
from flow2gan_tpu_torch.training.train_step import fm_train_step, step_generator
from flow2gan_tpu_torch.utils import disable_tf32

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 FMA rate outside the
# tensor cores (the kernel accumulates in IEEE float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
ISTFT_TOL = 1e-5  # kernel vs plain, relative to max|plain|
CARD_VS_CPU_TOL = 1e-4  # whole model, relative to max|CPU|
# Gradients, card vs CPU (float32, TF32 off). Card and CPU round every op
# differently, and single tensors whose gradients nearly cancel (BiasNorm
# biases and log_scale) move far more than the whole: on the CPU, one float32
# ulp on an input moves the whole gradient by 1.3e-5 of its norm and such a
# tensor by up to 2.3e-3 of its own. Measured on an H100 80GB HBM3: 7.4e-8
# (loss), 6.3e-5 (whole gradient), 2.9e-3 (worst tensor); the same check
# with TF32 on read 1.0e-5, 1.0e-3 and 6.2e-2. The limits lie between the two.
LOSS_TOL = 1e-6  # relative
GRAD_TOL = 2.5e-4  # |grad_card - grad_cpu| / |grad_cpu| over all parameters
GRAD_TENSOR_TOL = 1e-2  # the same for each parameter tensor
GRAD_F64_RATIO = 2.0  # a tensor over 1e-2 needs card vs float64 <= 1e-2 and <= this times CPU's
ROOT = Path(__file__).resolve().parent / "build"
TRACE_DIR = ROOT / "traces"  # read, then deleted
TIMED_SAMPLES = 25
TIMED_CALLS = 20
SLEEP_CYCLES = 2_000_000  # about 1 ms of GPU spin ahead of each timed sample

# (n_fft, hop, batch, t_f, length): the iSTFT shapes of one Euler step of
# mel_24k_base (94 mel frames) and mel_44k_128band_512x_base (87 mel frames)
MAIN_SHAPES = [
    (512, 256, 16, 95, 24064),
    (256, 128, 16, 189, 24064),
    (128, 64, 16, 377, 24064),
    (1024, 512, 16, 88, 44544),
    (512, 256, 16, 175, 44544),
    (256, 128, 16, 349, 44544),
]
# (n_fft, hop, batch, t_f, length, real_edges): real_edges False gives the
# DC and Nyquist bins nonzero imaginary parts, which the iSTFT ignores
EDGE_SHAPES = [
    (512, 256, 3, 95, 24064, True),  # odd batch
    (256, 128, 16, 189, 25000, True),  # length above the default: zero pad
    (128, 64, 5, 377, 20000, True),  # length below the default: trim
    (512, 256, 4, 2, 256, True),  # T_f <= k
    (1024, 256, 2, 3, 512, True),  # k = 4, T_f <= k
    (128, 64, 1, 1, 64, True),  # one frame: the output is all pad
    (512, 256, 16, 95, 24064, False),  # a main shape, imaginary parts at DC and Nyquist
    (64, 32, 16, 189, 6016, False),  # mel_24k_tiny's (64, 32) branch
    (512, 256, 1, 5626, 1440000, False),  # a 60 s clip at 24 kHz, batch 1
    (1024, 256, 4, 40, 9984, False),  # k = 4, T_f above k
    (1024, 64, 2, 40, 2560, False),  # k = 16: tiles take their frames in chunks
]
# (n_fft, hop, batch, t_f, length): the branches of one mel_24k_base training
# step, batch 16 x 1.5 s crops
TRAIN_SHAPES = [
    (512, 256, 16, 141, 36000),
    (256, 128, 16, 282, 36000),
    (128, 64, 16, 563, 36000),
]
# (n_fft, hop, batch, t_f, length): the branches of one GAN rollout step at
# batch 16 x 1.5 s: 141 mel frames, so the generator's 141 * 256 samples
GAN_SHAPES = [
    (512, 256, 16, 142, 36096),
    (256, 128, 16, 283, 36096),
    (128, 64, 16, 565, 36096),
]
# (n_fft, hop, batch, t_f, length): the same branches at the reference's
# per-card batches, where both kernels are timed too: 256 (FM pretraining, 2
# cards x 256) and 64 (GAN fine-tuning, one card)
REFERENCE_BATCH_SHAPES = ([(n, h, 256, t, length) for n, h, _, t, length in TRAIN_SHAPES]
                          + [(n, h, 64, t, length) for n, h, _, t, length in GAN_SHAPES])
ADJOINT_F64_RATIO = 2.0  # kernel vs float64 at most this times the plain adjoint's error
GAN_STEPS = 4  # Euler steps of the fine-tuned model
GAN_BATCHES = 32  # 2 epochs of phase 10's corpus at batch 16
GAN_WARMUP = 4  # D-only batches before D/G alternation
DISC_VS_CPU_TOL = 1e-4  # each score and feature map, relative to max|CPU|
REMAT_TOL = 1e-6  # remat against plain: loss and whole gradient, relative
# the data-parallel phases: 2 ranks of 8 against one process of 16, 1.5 s
# crops, the second rank's rows shorter in part (its loss count differs)
DIST_WORLD = 2
DIST_BATCH = 16
DIST_LENGTH = 36000
DIST_LENS = [DIST_LENGTH] * 12 + [33000, 30000, 27000, 24000]
# (n_fft, hop, batch, t_f, length): each rank's iSTFT shapes in those phases
RANK_SHAPES = [(n, h, DIST_BATCH // DIST_WORLD, t, length)
               for n, h, _, t, length in TRAIN_SHAPES + GAN_SHAPES]
TRAIN_STEPS = 32  # 2 epochs of a 256-recording corpus at batch 16
TRAIN_ARGS = ["--model-name", "mel_24k_base", "--batch-size", "16", "--duration", "1.5",
              "--num-epochs", "2", "--num-workers", "4", "--seed", "0", "--save-every-n", "16",
              "--keep-last-k", "1", "--average-period", "4", "--log-interval", "8",
              "--valid-interval", "16", "--device", "cuda", "--tensorboard", "false"]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, samples: int = TIMED_SAMPLES) -> list:
    """Device times of fn() in ms, one per sample. Each sample queues fn
    behind a GPU spin so that the host's launch overhead stays out of the
    measured span."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(samples):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def istft_bound_ms(n_fft, batch, t_f, length):
    """(bytes_ms, ops_ms, matmul_ops_ms) of the iSTFT on this card, at the
    data-sheet rates. The bound is the larger of the first two.

    bytes: the spectrogram read once and the waveform written once (the
    kernel's twiddle and window tables are constants of n_fft, not inputs
    of the function). ops: the fewest the function needs, an
    inverse real FFT per frame (2.5 N log2 N FLOP), the window multiply and
    the overlap-add (2 N per frame) and the envelope divide (one per output
    sample). matmul_ops: the 2 * B * T_f * 2F * N FLOP of the matmul form
    that the first version of the kernel computed, which is no bound: an FFT
    does the same work in far fewer.
    """
    n_freq = n_fft // 2 + 1
    frames = batch * t_f
    bytes_ = frames * n_freq * 8 + batch * length * 4
    flop = frames * (2.5 * n_fft * math.log2(n_fft) + 2 * n_fft) + batch * length
    matmul_flop = 2 * frames * 2 * n_freq * n_fft
    return tuple(x * 1e3 for x in (
        bytes_ / HBM_BYTES_PER_S, flop / FP32_FLOP_PER_S, matmul_flop / FP32_FLOP_PER_S))


def check_istft_shape(n_fft, hop, batch, t_f, length, real_edges: bool, timed: bool) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(n_fft + t_f + batch)
    n_freq = n_fft // 2 + 1
    imag = torch.randn(batch, t_f, n_freq, generator=gen, device="cuda")
    # the spectrum of a real signal has no imaginary part at DC and Nyquist;
    # the port's iSTFT ignores it there, cuFFT's inverse (torch.istft) does
    # not, so the timed rows zero it
    if real_edges:
        imag[..., 0] = imag[..., -1] = 0.0
    spec = torch.complex(torch.randn(batch, t_f, n_freq, generator=gen, device="cuda"), imag)
    ref = fused.istft_plain(spec, n_fft, hop, length=length)
    out = fused.istft_kernel(spec, n_fft, hop, length=length)
    torch.cuda.synchronize()
    if out.shape != (batch, length) or not torch.isfinite(out).all():
        raise AssertionError(f"kernel output {tuple(out.shape)} not finite or not {(batch, length)}")
    abs_err = (out - ref).abs().max().item()
    rel_err = abs_err / max(ref.abs().max().item(), 1e-30)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fused.tile_plan(batch, t_f, n_fft, hop, length, sm_count)
    row = dict(n_fft=n_fft, hop=hop, batch=batch, t_f=t_f, length=length,
               real_edges=real_edges, max_abs_err=abs_err, max_rel_err=rel_err,
               rows_per_tile=plan.rows_per_tile, blocks=batch * plan.tiles,
               smem_bytes=plan.smem_bytes)
    if rel_err > ISTFT_TOL:
        raise AssertionError(f"fused iSTFT disagrees with its plain version: {row}")
    if timed:
        window = torch.from_numpy(hann_window_np(n_fft)).cuda()
        spec_ft = spec.transpose(1, 2).contiguous()  # torch.istft's (B, F, T) layout

        def library():
            return torch.istft(spec_ft, n_fft, hop, window=window, center=True, length=length)

        lib_err = (library() - ref).abs().max().item() / ref.abs().max().item()
        fns = {
            "ms": lambda: fused.istft_kernel(spec, n_fft, hop, length=length),
            "plain_ms": lambda: fused.istft_plain(spec, n_fft, hop, length=length),
            "library_ms": library,
        }
        times = {key: [] for key in fns}
        # two interleaved rounds, so drift on the card falls on all three alike
        for key in [*fns, *reversed(fns)]:
            times[key] += device_ms(fns[key])
        bytes_ms, ops_ms, matmul_ops_ms = istft_bound_ms(n_fft, batch, t_f, length)
        row.update({key: statistics.median(v) for key, v in times.items()})
        row.update(samples=len(times["ms"]), library_max_rel_err=lib_err,
                   bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms,
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bound_share=max(bytes_ms, ops_ms) / row["ms"], matmul_ops_ms=matmul_ops_ms)
    return row


def adjoint_bound_ms(n_fft, batch, t_f, length):
    """(bytes_ms, ops_ms) of the iSTFT's adjoint: the waveform's gradient read
    once and the spectrogram's written once; a forward real FFT per frame
    (2.5 N log2 N FLOP), the window multiply (N per frame) and the envelope
    divide (one per sample)."""
    bytes_ = batch * length * 4 + batch * t_f * (n_fft // 2 + 1) * 8
    flop = batch * t_f * (2.5 * n_fft * math.log2(n_fft) + n_fft) + batch * length
    return bytes_ / HBM_BYTES_PER_S * 1e3, flop / FP32_FLOP_PER_S * 1e3


def check_adjoint_shape(n_fft, hop, batch, t_f, length, timed: bool) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(7 * n_fft + t_f + batch)
    grad = torch.randn(batch, length, generator=gen, device="cuda")
    ref = fused.istft_adjoint_plain(grad, t_f, n_fft, hop)
    out = fused.istft_adjoint_kernel(grad, t_f, n_fft, hop)
    torch.cuda.synchronize()
    if out.shape != ref.shape or not torch.isfinite(torch.view_as_real(out)).all():
        raise AssertionError(f"adjoint output {tuple(out.shape)} not finite or not {tuple(ref.shape)}")
    abs_err = (torch.view_as_real(out) - torch.view_as_real(ref)).abs().max().item()
    scale = torch.view_as_real(ref).abs().max().item()
    rel_err = abs_err / max(scale, 1e-30)
    # the forward kernel drops the imaginary parts at DC and Nyquist, so
    # their gradient is exactly zero
    edge_imag = out[..., [0, -1]].imag.abs().max().item()
    # <istft(s), g> = <s, adjoint(g)> with both kernels
    spec = torch.complex(torch.randn(batch, t_f, n_fft // 2 + 1, generator=gen, device="cuda"),
                         torch.randn(batch, t_f, n_fft // 2 + 1, generator=gen, device="cuda"))
    y = fused.istft_kernel(spec, n_fft, hop, length=length).double()
    lhs = (y * grad.double()).sum().item()
    rhs = (torch.view_as_real(spec).double() * torch.view_as_real(out).double()).sum().item()
    dot_err = abs(lhs - rhs) / max((y * grad.double()).abs().sum().item(), 1e-30)
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fused.adjoint_plan(batch, t_f, n_fft, hop, sm_count)
    row = dict(n_fft=n_fft, hop=hop, batch=batch, t_f=t_f, length=length, max_abs_err=abs_err,
               max_rel_err=rel_err, dc_nyquist_max_imag=edge_imag, dot_identity_rel_err=dot_err,
               frames_per_tile=plan.frames_per_tile, items=plan.items, blocks=plan.blocks,
               stages=plan.stages, smem_bytes=plan.smem_bytes)
    if not (rel_err <= ISTFT_TOL and edge_imag == 0.0 and dot_err <= ISTFT_TOL):
        raise AssertionError(f"adjoint kernel disagrees with its plain version: {row}")
    if timed:
        # the yardstick: torch.stft of the enveloped gradient on the centred
        # grid, which is the adjoint up to the bin weights (1 at DC and
        # Nyquist, 2 elsewhere, over n_fft)
        out_len = min(length, (t_f - 1) * hop)
        padded = torch.nn.functional.pad(
            grad[:, :out_len] / envelope(t_f, n_fft, hop, grad.device)[:out_len],
            (n_fft // 2, n_fft // 2 + (t_f - 1) * hop - out_len))
        window = torch.from_numpy(hann_window_np(n_fft)).cuda()
        weights = torch.full((n_fft // 2 + 1, 1), 2.0 / n_fft, device="cuda")
        weights[0] = weights[-1] = 1.0 / n_fft

        def library():
            return torch.stft(padded, n_fft, hop, window=window, center=False, return_complex=True)

        lib = (library() * weights).transpose(1, 2)
        lib_err = ((torch.view_as_real(lib) - torch.view_as_real(ref)).abs().max().item()
                   / max(scale, 1e-30))
        fns = {
            "ms": lambda: fused.istft_adjoint_kernel(grad, t_f, n_fft, hop),
            "plain_ms": lambda: fused.istft_adjoint_plain(grad, t_f, n_fft, hop),
            "library_ms": library,
        }
        times = {key: [] for key in fns}
        for key in [*fns, *reversed(fns)]:
            times[key] += device_ms(fns[key])
        bytes_ms, ops_ms = adjoint_bound_ms(n_fft, batch, t_f, length)
        row.update({key: statistics.median(v) for key, v in times.items()})
        row.update(samples=len(times["ms"]), library_max_rel_err=lib_err,
                   bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms,
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   bound_share=max(bytes_ms, ops_ms) / row["ms"])
    return row


def adjoint_float64(grad: np.ndarray, t_f: int, n_fft: int, hop: int) -> np.ndarray:
    """The iSTFT's adjoint in float64 with numpy (window and envelope in
    float64 too): G[f, k] = c_k / N rfft(w * s[f hop - N/2 ...])[k], s =
    g / env on [0, out_len), c_k = 1 at DC and Nyquist, else 2."""
    window = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    padded_len = (t_f - 1) * hop + n_fft
    env = np.zeros(padded_len)
    for f in range(t_f):
        env[f * hop : f * hop + n_fft] += window ** 2
    out_len = min(grad.shape[-1], (t_f - 1) * hop)
    sig = np.zeros((grad.shape[0], padded_len))
    sig[:, n_fft // 2 : n_fft // 2 + out_len] = (grad[:, :out_len]
                                                 / env[n_fft // 2 : n_fft // 2 + out_len])
    frames = np.lib.stride_tricks.sliding_window_view(sig, n_fft, axis=-1)[:, ::hop][:, :t_f]
    spec = np.fft.rfft(frames * window, axis=-1) / n_fft
    spec[..., 1:-1] *= 2
    return spec


def check_adjoint_float64(n_fft, hop, batch, t_f, length) -> dict:
    """The kernel and the plain float32 adjoint, each against float64: a
    precision loss in the kernel's passes or twiddles shows here."""
    gen = torch.Generator(device="cuda").manual_seed(11 * n_fft + t_f + batch)
    grad = torch.randn(batch, length, generator=gen, device="cuda")
    ref = adjoint_float64(grad.cpu().double().numpy(), t_f, n_fft, hop)
    scale = max(np.abs(ref.real).max(), np.abs(ref.imag).max())
    errs = {}
    for name, out in [("kernel", fused.istft_adjoint_kernel(grad, t_f, n_fft, hop)),
                      ("plain", fused.istft_adjoint_plain(grad, t_f, n_fft, hop))]:
        diff = out.cpu().numpy().astype(np.complex128) - ref
        errs[name] = max(np.abs(diff.real).max(), np.abs(diff.imag).max()) / scale
    row = dict(n_fft=n_fft, hop=hop, batch=batch, t_f=t_f, length=length,
               kernel_vs_f64=errs["kernel"], plain_vs_f64=errs["plain"],
               limit=ADJOINT_F64_RATIO * errs["plain"])
    if not errs["kernel"] <= ADJOINT_F64_RATIO * errs["plain"]:
        raise AssertionError(f"adjoint kernel less precise than twice the plain adjoint: {row}")
    return row


def time_calls(fn, calls: int = TIMED_CALLS):
    """Host wall time per call in ms, each call ended by a device sync."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main_path(card: str, model, mel):
    """Serve mel_24k_base at 1/2/4 steps; returns the kernel's launches over
    one call at each step count, the median ms of a 1-step call, and the
    launches of one 1-step mel_44k_128band_512x_base call."""
    fused.launches = fused.adjoint_launches = 0
    for n in (1, 2, 4):
        before = fused.launches
        wav = model.infer(mel, n_timesteps=n)
        torch.cuda.synchronize()
        if wav.shape != (16, 24064) or not torch.isfinite(wav).all():
            raise AssertionError(f"{n}-step output {tuple(wav.shape)} not finite (16, 24064)")
        if fused.launches - before != 3 * n:
            raise AssertionError(f"{n}-step call launched the kernel {fused.launches - before} "
                                 f"times, expected {3 * n}")
    launches = fused.launches
    if fused.adjoint_launches:
        raise AssertionError(f"serving launched the adjoint {fused.adjoint_launches} times")
    print(f"main path: mel_24k_base infer at 1/2/4 steps, batch 16, fused_istft launches {launches}")

    audio_s = 16 * 24064 / 24000
    median_ms = {}
    for n in (1, 2, 4):
        ms = time_calls(lambda: model.infer(mel, n_timesteps=n))
        med = median_ms[n] = statistics.median(ms)
        print("main path timing " + json.dumps({
            "config": "mel_24k_base", "n_timesteps": n, "batch": 16, "mel_frames": 94,
            "audio_s": audio_s, "calls": len(ms), "ms_median": med, "ms_min": min(ms),
            "ms_max": max(ms), "x_real_time_median": audio_s / med * 1e3,
            "x_real_time_min": audio_s / max(ms) * 1e3, "x_real_time_max": audio_s / min(ms) * 1e3,
            "card": card,
        }))

    model44 = get_model("mel_44k_128band_512x_base", device="cuda", seed=0)
    mel44 = torch.from_numpy(np.random.RandomState(1).randn(16, 128, 87).astype(np.float32))
    fused.launches = 0
    wav = model44.infer(mel44, n_timesteps=1)
    torch.cuda.synchronize()
    launches44 = fused.launches
    if wav.shape != (16, 44544) or not torch.isfinite(wav).all() or launches44 != 3:
        raise AssertionError(f"44.1 kHz 1-step call: {tuple(wav.shape)}, {launches44} launches")
    ms = time_calls(lambda: model44.infer(mel44, n_timesteps=1), calls=5)
    print("44.1 kHz: mel_44k_128band_512x_base 1 step, batch 16 " + json.dumps(
        {"ms_median": statistics.median(ms), "x_real_time_median":
         16 * 44544 / 44100 / statistics.median(ms) * 1e3, "card": card}))
    return launches, median_ms[1], launches44


def card_vs_cpu():
    gpu = get_model("mel_24k_base", device="cuda", seed=0).module
    cpu = get_model("mel_24k_base", device="cpu", seed=0).module
    rng = np.random.RandomState(2)
    cond = rng.randn(2, 100, 94).astype(np.float32)
    noise = (0.1 * rng.randn(2, 24064)).astype(np.float32)
    for n in (1, 2, 4):
        with torch.inference_mode():
            before = fused.launches
            a = gpu.infer_from_noise(torch.from_numpy(noise).cuda(), torch.from_numpy(cond).cuda(),
                                     n_timesteps=n).cpu()
            if fused.launches - before != 3 * n:
                raise AssertionError("card run did not go through the kernel")
            b = cpu.infer_from_noise(torch.from_numpy(noise), torch.from_numpy(cond), n_timesteps=n)
        abs_err = (a - b).abs().max().item()
        rel = abs_err / b.abs().max().item()
        print(f"card vs CPU {n} step(s), batch 2: max_abs_err={abs_err:.3e} max_rel_err={rel:.3e}")
        if not rel <= CARD_VS_CPU_TOL:
            raise AssertionError(f"card and CPU disagree at {n} steps: {rel}")


_GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
_DTYPES = {"float": "fp32", "c10::BFloat16": "bf16", "c10::Half": "fp16"}
# kernel names of GEMMs (cuBLAS, cuBLASLt and CUTLASS kernels, split-K reductions)
_GEMM_NAMES = re.compile(r"gemm|nvjet|xmma|cutlass|splitkreduce", re.IGNORECASE)


def gemm_ms_by_dtype(prof, trace: Path) -> dict:
    """Device ms, kernels and ops of the GEMMs in a profile, by the input
    dtype of the matmul op that launched each kernel (the trace links a
    kernel to its op by "External id"; the op's "Input type" comes with
    record_shapes). One op may launch two kernels (split-K)."""
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    ops = {e["args"]["External id"]: e["args"].get("Input type", ["?"])[0]
           for e in events if e.get("cat") == "cpu_op" and e.get("name") in _GEMM_OPS
           and "External id" in e.get("args", {})}
    out, seen = {}, {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ext = e.get("args", {}).get("External id")
        if ext in ops:
            key = _DTYPES.get(ops[ext], ops[ext])
            row = out.setdefault(key, {"ms": 0.0, "kernels": 0, "ops": 0})
            row["ms"] += e["dur"] / 1e3
            row["kernels"] += 1
            seen.setdefault(key, set()).add(ext)
    for key, exts in seen.items():
        out[key]["ops"] = len(exts)
    return out


def _dev_us(e):  # the attribute's name differs across torch versions
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)


NCCL_FAMILY = "nccl collectives (with their waits)"


def _family(name: str) -> str:
    for key in ("fused_istft_adjoint", "fused_istft", "conv_depthwise"):
        if key in name:
            return key
    if name.startswith("nccl"):
        # a collective's kernel spins on the card until every rank arrives
        return NCCL_FAMILY
    return "gemm" if _GEMM_NAMES.search(name) else "elementwise, reductions, copies"


# cuDNN's convolution kernels (forward, data and weight gradients): the
# discriminators' Conv2d, and the generator's k=3 input conv
_CONV_NAMES = re.compile(r"fprop|dgrad|wgrad|convolve|conv2d|implicit", re.IGNORECASE)


def _gan_family(name: str) -> str:
    if "conv_depthwise" not in name and "fused_istft" not in name and _CONV_NAMES.search(name):
        return "conv (cuDNN)"
    return _family(name)


def profile_one_call(card: str, model, mel, wall_ms: float, label: str) -> dict:
    """Device time of one 1-step call by kernel family, the GEMMs split by
    input dtype, and the device's busy share against the unprofiled median
    call time; returns the GEMM split."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        model.infer(mel, n_timesteps=1)
        torch.cuda.synchronize()

    kernels = [(_dev_us(e), e.key, e.count) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0]
    total_ms = sum(k[0] for k in kernels) / 1e3
    families = {}
    for us, name, _ in kernels:
        families[_family(name)] = families.get(_family(name), 0.0) + us / 1e3
    gemms = gemm_ms_by_dtype(prof, TRACE_DIR / f"1step_{label}.json")
    print(f"profile 1 step {label} " + json.dumps({
        "device_ms": total_ms, "call_ms_median_unprofiled": wall_ms,
        "device_busy_share": total_ms / wall_ms if total_ms else "not measured",
        "device_events": sum(k[2] for k in kernels),
        "by_family_ms": families, "gemm_by_input_dtype": gemms,
        "top": [{"name": name[:100], "ms": us / 1e3, "count": count}
                for us, name, count in sorted(kernels, reverse=True)[:12]],
        "card": card,
    }))
    return gemms


def voiced(rng: np.random.RandomState, batch: int, length: int, sr: int = 24000) -> np.ndarray:
    """Voiced tones plus noise: a few harmonics of an f0 in 90-260 Hz with a
    slow vibrato, under a syllable-rate envelope, float32 (batch, length)."""
    t = np.arange(length) / sr
    out = np.empty((batch, length), np.float32)
    for i in range(batch):
        f0 = rng.uniform(90.0, 260.0) * (1.0 + 0.03 * np.sin(2 * np.pi * rng.uniform(3, 7) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        x = sum(np.sin(h * phase) / h for h in range(1, 6))
        x *= 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(2, 5) * t + rng.uniform(0, 6.3)) ** 2
        out[i] = 0.15 * x + 0.01 * rng.randn(length)
    return out


def _rel_per_tensor(a: dict, b: dict) -> dict:
    return {k: ((a[k] - b[k]).norm() / (b[k].norm() + 1e-300)).item() for k in b}


def _rel_all(a: dict, b: dict) -> float:
    return (math.sqrt(sum((a[k] - b[k]).norm().item() ** 2 for k in b))
            / math.sqrt(sum(b[k].norm().item() ** 2 for k in b)))


def grads_card_vs_cpu(card: str, model_name: str = "mel_24k_base", seed: int = 5,
                      float64: bool = False) -> tuple:
    """The FM loss and every parameter gradient of a full-width config
    (mel_24k_base, or token_24k_base on random token ids) at batch 2 x 1 s,
    card against CPU, with the same weights, t, x0, gates and branch
    weights drawn from `seed`; the step goes through both kernels three
    times each. Returns the launches (forward, adjoint).

    With `float64` the CPU also runs the step in float64 (the same weights
    and inputs, widened), the exact gradient as far as float32 can tell,
    and a tensor whose card-vs-CPU error passes GRAD_TENSOR_TOL still
    passes if the card holds that limit against the exact gradient and is
    as near it as the CPU: its error against float64 at most
    GRAD_TENSOR_TOL and at most GRAD_F64_RATIO times the CPU's. A gradient
    that nearly cancels (a BiasNorm's log_scale) can put the CPU's float32
    far from the exact one. The loss and the whole gradient keep their
    limits."""
    cfg = get_generator_config(model_name)
    cpu = init_weights(build_generator(cfg), torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    rng = np.random.RandomState(seed)
    batch, frames = 2, 94
    length = frames * 256
    cond = (rng.randint(0, cfg.vocab_size, (batch, frames)) if model_name.startswith("token")
            else rng.randn(batch, 100, frames).astype(np.float32))
    inputs = {"cond": cond, "audio": voiced(rng, batch, length),
              "lens": np.asarray([length, length - 3000])}
    x0 = (0.1 * rng.randn(batch, length)).astype(np.float32)
    t = rng.rand(batch).astype(np.float32)
    gates = (rng.rand(cpu.num_limiters) < 0.6).astype(np.float32)
    weight = branch_dropout_weight(torch.tensor([1, 0]), torch.tensor([[True], [False]]), 3)

    def run(model, device, dtype=torch.float32):
        model.zero_grad(set_to_none=True)
        draws = FMDraws(torch.from_numpy(x0).to(device, dtype), torch.from_numpy(t).to(device, dtype),
                        gates=torch.from_numpy(gates).to(device, dtype),
                        branch_weight=weight.to(device, dtype))
        args = [torch.from_numpy(inputs[k]).to(device) for k in ("cond", "audio", "lens")]
        args = [a.to(dtype) if a.is_floating_point() else a for a in args]
        loss = model(*args, draws)
        loss.backward()
        return loss.item(), {k: p.grad.double().cpu() for k, p in model.named_parameters()}

    fused.launches = fused.adjoint_launches = 0
    loss_gpu, g_gpu = run(gpu, "cuda")
    launches = (fused.launches, fused.adjoint_launches)
    if launches != (3, 3):
        raise AssertionError(f"a training step launched (forward, adjoint) {launches}, expected (3, 3)")
    loss_cpu, g_cpu = run(cpu, "cpu")
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    per = _rel_per_tensor(g_gpu, g_cpu)
    total = _rel_all(g_gpu, g_cpu)
    passes = {k: per[k] <= GRAD_TENSOR_TOL for k in per}
    err_sq = {k: (g_gpu[k] - g_cpu[k]).norm().item() ** 2 for k in g_cpu}
    largest = max(err_sq, key=err_sq.get)
    worst = max(per, key=per.get)
    report = {
        "config": model_name, "seed": seed, "batch": batch, "length": length, "tensors": len(per),
        "loss_card": loss_gpu, "loss_cpu": loss_cpu, "loss_rel_err": loss_err,
        "grad_rel_err_all": total, "grad_rel_err_worst_tensor": per[worst], "worst_tensor": worst,
        "grad_rel_err_median_tensor": statistics.median(per.values()),
        "largest_error_tensor": largest, "its_share_of_the_error": err_sq[largest] / max(sum(err_sq.values()), 1e-300),
        "launches_forward_adjoint": launches, "card": card}
    if float64:
        exact = copy.deepcopy(cpu).double()
        loss64, g64 = run(exact, "cpu", torch.float64)
        del exact
        card64, cpu64 = _rel_per_tensor(g_gpu, g64), _rel_per_tensor(g_cpu, g64)
        passes = {k: passes[k] or card64[k] <= min(GRAD_TENSOR_TOL, GRAD_F64_RATIO * cpu64[k])
                  for k in per}
        over = sorted((k for k in per if per[k] > GRAD_TENSOR_TOL), key=lambda k: -per[k])
        far = sorted(per, key=lambda k: -card64[k])[:5]
        report.update({
            "loss_card_vs_f64": abs(loss_gpu - loss64) / abs(loss64),
            "loss_cpu_vs_f64": abs(loss_cpu - loss64) / abs(loss64),
            "grad_all_card_vs_f64": _rel_all(g_gpu, g64), "grad_all_cpu_vs_f64": _rel_all(g_cpu, g64),
            "median_tensor_card_vs_f64": statistics.median(card64.values()),
            "median_tensor_cpu_vs_f64": statistics.median(cpu64.values()),
            "f64_ratio_limit": GRAD_F64_RATIO,
            "tensors_over_grad_tensor_tol": {k: {"card_vs_cpu": per[k], "card_vs_f64": card64[k],
                                                 "cpu_vs_f64": cpu64[k]} for k in over},
            "farthest_from_f64_on_the_card": {k: {"card_vs_f64": card64[k], "cpu_vs_f64": cpu64[k]}
                                              for k in far}})
        if "token_embed.weight" in per:
            report["token_embed_card_vs_f64"] = card64["token_embed.weight"]
            report["token_embed_cpu_vs_f64"] = cpu64["token_embed.weight"]
    if "token_embed.weight" in per:
        report["token_embed_rel_err"] = per["token_embed.weight"]
    print("grads card vs CPU " + json.dumps(report))
    finite = all(torch.isfinite(g).all() for g in g_gpu.values())
    if not (finite and loss_err <= LOSS_TOL and total <= GRAD_TOL and all(passes.values())):
        raise AssertionError("card and CPU gradients disagree: "
                             f"{sorted(k for k in passes if not passes[k])}")
    return launches


def write_corpus(root: Path, n: int, seconds: float, seed: int) -> Path:
    """n PCM16 recordings of voiced tones plus noise at 24 kHz, and their
    manifest."""
    rng = np.random.RandomState(seed)
    (root / "wav").mkdir(parents=True, exist_ok=True)
    recs = []
    for i in range(n):
        path = root / "wav" / f"utt{i:04d}.wav"
        write_wav(path, voiced(rng, 1, int(seconds * 24000))[0], 24000)
        recs.append(Recording(f"utt{i:04d}", str(path), 24000, int(seconds * 24000)))
    manifest = root / "recordings.jsonl.gz"
    write_recording_manifest(recs, manifest)
    return manifest


def device_families(fn, trace: Path = None, family=None, kernels: list = None):
    """Device ms by kernel family (`family`, default `_family`) of what fn()
    runs (torch.profiler), and with `trace` also the GEMMs by input dtype;
    `kernels`, where given, receives each kernel name's launch count."""
    from torch.profiler import ProfilerActivity, profile

    family = family or _family
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=trace is not None) as prof:
        fn()
        torch.cuda.synchronize()
    families = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0:
            families[family(e.key)] = families.get(family(e.key), 0.0) + _dev_us(e) / 1e3
            if kernels is not None:
                kernels.append(e.count)
    return families, (gemm_ms_by_dtype(prof, trace) if trace is not None else None)


def profile_train_step(card: str, step_ms: float, compute_dtype=None, tokenizer=None) -> None:
    """The device time of one mel_24k_base training step (batch 16 x 1.5 s),
    or with `tokenizer` one token_24k_base step conditioned on its ids, by
    family, the GEMMs by input dtype, the optimizer's part measured alone,
    and the busy share against the trainer's median step."""
    model_name = "token_24k_base" if tokenizer is not None else "mel_24k_base"
    cfg = get_generator_config(model_name)
    cfg["compute_dtype"] = compute_dtype
    label = (compute_dtype or "float32") + ("_token" if tokenizer is not None else "")
    model = init_weights(build_generator(cfg), torch.Generator().manual_seed(1)).cuda()
    mel_fn = (tokenizer if tokenizer is not None else LogMelSpectrogram(
        sampling_rate=24000, n_fft=1024, hop_length=256, n_mels=100)).cuda()
    optimizer = ScaledAdam(model.named_parameters(), clipping_scale=2.0)
    audio = torch.from_numpy(voiced(np.random.RandomState(11), 16, 36000)).cuda()
    batch = {"audio": audio, "audio_lens": torch.full((16,), 36000, device="cuda")}

    def step(i):
        return fm_train_step(model, optimizer, mel_fn, batch, 1e-3, step_generator(0, i, "cuda"))

    for i in range(3):
        step(i)
    wall = []
    for i in range(3, 8):  # without the data loader's threads beside it
        begin = time.perf_counter()
        float(step(i)["loss"])
        wall.append((time.perf_counter() - begin) * 1e3)
    step_fams, gemms = device_families(lambda: step(8), TRACE_DIR / f"train_step_{label}.json")
    model(mel_fn(audio), audio, batch["audio_lens"],
          model.draw(audio, 141, step_generator(0, 9, "cuda"))).backward()
    opt_ms = sum(device_families(lambda: optimizer.step(1e-3))[0].values())
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    model(mel_fn(audio), audio, batch["audio_lens"],
          model.draw(audio, 141, step_generator(0, 10, "cuda"))).backward()
    torch.cuda.synchronize()
    start.record()
    optimizer.step(1e-3)
    stop.record()
    torch.cuda.synchronize()
    total = sum(step_fams.values())
    if not total:
        raise AssertionError("torch.profiler recorded no device time for a training step")
    # the optimizer's kernels are all elementwise, reductions, sorts and copies
    key = "elementwise, reductions, copies"
    step_fams[key] = step_fams.get(key, 0.0) - opt_ms
    step_fams["optimizer (ScaledAdam, measured alone)"] = opt_ms
    print(f"profile train step {label} " + json.dumps({
        "config": model_name, "compute_dtype": compute_dtype or "float32", "batch": 16,
        "seconds_per_item": 1.5,
        "device_ms": total, "gemm_by_input_dtype": gemms,
        "step_ms_median_unprofiled": step_ms, "device_busy_share": total / step_ms,
        "step_ms_median_without_loader": statistics.median(wall),
        "by_family_ms": step_fams, "optimizer_share_of_device_ms": opt_ms / total,
        "optimizer_span_ms_events": start.elapsed_time(stop),
        "optimizer_groups": len(optimizer.groups), "parameter_tensors":
            sum(len(g.params) for g in optimizer.groups), "card": card}))


def trainer(card: str, root: Path):
    """mel_24k_base trained through the port's bin/pretrain.py on a corpus
    written under `root`; returns the two kernels' launches over the run, the
    experiment directory and the averaged model's path."""
    shutil.rmtree(root, ignore_errors=True)
    train = write_corpus(root / "train", 16 * TRAIN_STEPS // 2, 2.0, seed=21)
    valid = write_corpus(root / "valid", 16, 2.0, seed=22)
    exp = root / "exp"
    args = pretrain.get_parser().parse_args(TRAIN_ARGS + [
        "--exp-dir", str(exp), "--train-recordings", str(train), "--valid-recordings", str(valid)])
    torch.cuda.reset_peak_memory_stats()
    fused.launches = fused.adjoint_launches = 0
    start = time.perf_counter()
    history = pretrain.run(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = {"forward": fused.launches, "adjoint": fused.adjoint_launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = len(history)
    valid_batches = 2  # --valid-interval 16 over 32 steps, one batch of 16 each
    if steps != TRAIN_STEPS or launches != {"forward": 3 * (steps + valid_batches),
                                            "adjoint": 3 * steps}:
        raise AssertionError(f"trainer ran {steps} steps with launches {launches}")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    ms = [h["ms"] for h in history[2:]]  # the first steps allocate and tune
    med = statistics.median(ms)
    print("trainer " + json.dumps({
        "config": "mel_24k_base", "batch": 16, "seconds_per_item": 1.5, "steps": steps,
        "loss_curve": losses, "clip_scale": [h["clip_scale"] for h in history],
        "first_step_ms": history[0]["ms"], "step_ms_median": med, "step_ms_min": min(ms),
        "step_ms_max": max(ms), "audio_s_per_wall_s": 16 * 1.5 / med * 1e3,
        "peak_memory_gb": peak_gb, "run_wall_s": wall_s, "launches": launches, "card": card}))

    # the checkpoints reload onto a fresh model and optimizer, and the
    # batch checkpoint at the last step equals the last epoch's
    last, batch_ckpt = ckpt.load_checkpoint(exp / "epoch-2.pt"), ckpt.load_checkpoint(
        exp / f"checkpoint-{steps}.pt")
    fresh = build_generator(get_generator_config("mel_24k_base"))
    fresh.load_state_dict(last["model"], strict=True)
    ScaledAdam(fresh.named_parameters(), clipping_scale=2.0).load_state_dict(last["optimizer"])
    if last["batch_idx_train"] != steps or last["optimizer"]["step"] != steps or any(
            not torch.equal(v, batch_ckpt["model"][k]) for k, v in last["model"].items()):
        raise AssertionError("the checkpoints do not reload to the trained state")
    out = save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "2"])
    served = get_model("mel_24k_base", checkpoint=out, device="cuda")
    mel = torch.from_numpy(np.random.RandomState(0).randn(16, 100, 94).astype(np.float32))
    before = fused.launches
    wav = served.infer(mel, n_timesteps=1)
    torch.cuda.synchronize()
    if wav.shape != (16, 24064) or not torch.isfinite(wav).all() or fused.launches - before != 3:
        raise AssertionError(f"the averaged model served {tuple(wav.shape)} with "
                             f"{fused.launches - before} launches")
    print(f"trainer checkpoints: epoch-2 and checkpoint-{steps} reload; averaged model "
          f"{out.name} serves a 1-step call of {tuple(wav.shape)}, finite, 3 launches")
    profile_train_step(card, med)
    return launches, exp, out, med


def bf16_vocoder(device: str) -> VocoderModel:
    """mel_24k_base in bf16, built as the JAX package builds it (a config with
    compute_dtype, then build_generator) on get_model's seed-0 weights."""
    cfg = get_generator_config("mel_24k_base")
    cfg["compute_dtype"] = "bfloat16"
    module = init_weights(build_generator(cfg), torch.Generator().manual_seed(0))
    return VocoderModel(module.to(device), cfg, torch.device(device))


def rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).pow(2).mean().sqrt().item()


def bf16_card_vs_cpu(card: str) -> None:
    """Card bf16 against CPU bf16 through infer_from_noise at batch 2, with
    the same weights and x0. Card and CPU round their float32 parts (the
    STFT's DFT matmuls) in another order, which flips some bf16 casts, so the
    limit is that of the CPU tests: 1/4 of the CPU's bf16 distance from its
    float32 result, plus twice how far the CPU's bf16 result moves when x0
    moves by one float32 ulp."""
    gpu, cpu = bf16_vocoder("cuda").module, bf16_vocoder("cpu").module
    cpu32 = get_model("mel_24k_base", device="cpu", seed=0).module
    rng = np.random.RandomState(2)
    cond = torch.from_numpy(rng.randn(2, 100, 94).astype(np.float32))
    x0 = (0.1 * rng.randn(2, 24064)).astype(np.float32)
    with torch.inference_mode():
        fused.launches = 0
        card16 = gpu.infer_from_noise(torch.from_numpy(x0).cuda(), cond.cuda()).cpu()
        if fused.launches != 3:
            raise AssertionError("the card's bf16 run did not go through the kernel")
        cpu16 = cpu.infer_from_noise(torch.from_numpy(x0), cond)
        cpu32_out = cpu32.infer_from_noise(torch.from_numpy(x0), cond)
        floor = max(rms(cpu.infer_from_noise(torch.from_numpy(
            np.nextafter(x0, np.float32(to)).astype(np.float32)), cond), cpu16)
                    for to in (np.inf, -np.inf))
    err, noise = rms(card16, cpu16), rms(cpu16, cpu32_out)
    limit = noise / 4 + 2 * floor
    print("bf16 card vs CPU 1 step, batch 2 " + json.dumps({
        "rms_err": err, "max_abs_err": (card16 - cpu16).abs().max().item(),
        "cpu_bf16_vs_f32_rms": noise, "cpu_one_ulp_floor_rms": floor, "limit_rms": limit,
        "err_over_bf16_noise": err / noise, "card": card}))
    if not (torch.isfinite(card16).all() and err <= limit):
        raise AssertionError(f"card bf16 and CPU bf16 disagree: {err} > {limit}")


def bf16_serving(card: str, model32, mel) -> int:
    """mel_24k_base in bf16 at 1/2/4 steps: launches, times beside the
    float32 model's, card bf16 against card float32 and against the CPU, and
    one call's device time by family. Returns the launches over the three
    calls."""
    model16 = bf16_vocoder("cuda")
    fused.launches = fused.adjoint_launches = 0
    outs = {}
    for n in (1, 2, 4):
        before = fused.launches
        outs[n] = model16.infer(mel, n_timesteps=n)
        torch.cuda.synchronize()
        if outs[n].shape != (16, 24064) or not torch.isfinite(outs[n]).all():
            raise AssertionError(f"bf16 {n}-step output {tuple(outs[n].shape)} not finite (16, 24064)")
        if fused.launches - before != 3 * n:
            raise AssertionError(f"bf16 {n}-step call launched the kernel {fused.launches - before} "
                                 f"times, expected {3 * n}")
    launches = fused.launches
    if fused.adjoint_launches:
        raise AssertionError(f"bf16 serving launched the adjoint {fused.adjoint_launches} times")
    print(f"bf16 serving: mel_24k_base infer at 1/2/4 steps, batch 16, fused_istft launches {launches}")
    for n in (1, 2, 4):
        with torch.inference_mode():
            ref = model32.infer(mel, n_timesteps=n)
        print(f"bf16 vs f32 on the card, {n} step(s): " + json.dumps({
            "rms": rms(outs[n], ref), "max_abs": (outs[n] - ref).abs().max().item(),
            "f32_rms_level": ref.double().pow(2).mean().sqrt().item()}))

    audio_s = 16 * 24064 / 24000
    median16 = {}
    for n in (1, 2, 4):
        row = {"config": "mel_24k_base", "n_timesteps": n, "batch": 16, "mel_frames": 94,
               "audio_s": audio_s, "card": card}
        for name, m in (("f32", model32), ("bf16", model16), ("f32_again", model32),
                        ("bf16_again", model16)):
            ms = time_calls(lambda: m.infer(mel, n_timesteps=n))
            med = statistics.median(ms)
            row[name] = {"calls": len(ms), "ms_median": med, "ms_min": min(ms), "ms_max": max(ms),
                         "x_real_time_median": audio_s / med * 1e3,
                         "x_real_time_min": audio_s / max(ms) * 1e3,
                         "x_real_time_max": audio_s / min(ms) * 1e3}
        median16[n] = statistics.median([row["bf16"]["ms_median"], row["bf16_again"]["ms_median"]])
        print("bf16 serving timing " + json.dumps(row))
    bf16_card_vs_cpu(card)
    gemms = profile_one_call(card, model16, mel, median16[1], "bf16")
    # only the STFT's DFT matmuls (two per branch) may stay float32
    if gemms.get("bf16", {}).get("ops", 0) == 0 or gemms.get("fp32", {}).get("ops", 0) > 6:
        raise AssertionError(f"a bf16 call's GEMMs are not bf16 but the STFT's: {gemms}")
    return launches


def card_vs_cpu_44k(card: str) -> int:
    """mel_44k_128band_512x_base, float32, 1 step at batch 2, card against
    CPU with the same weights and x0; returns the card run's launches."""
    gpu = get_model("mel_44k_128band_512x_base", device="cuda", seed=0).module
    cpu = get_model("mel_44k_128band_512x_base", device="cpu", seed=0).module
    rng = np.random.RandomState(4)
    cond = torch.from_numpy(rng.randn(2, 128, 87).astype(np.float32))
    x0 = torch.from_numpy((0.1 * rng.randn(2, 87 * 512)).astype(np.float32))
    with torch.inference_mode():
        fused.launches = 0
        a = gpu.infer_from_noise(x0.cuda(), cond.cuda()).cpu()
        launches = fused.launches
        b = cpu.infer_from_noise(x0, cond)
    abs_err = (a - b).abs().max().item()
    rel = abs_err / b.abs().max().item()
    print(f"44.1 kHz card vs CPU 1 step, batch 2: max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} "
          f"launches {launches}")
    if launches != 3 or not rel <= CARD_VS_CPU_TOL:
        raise AssertionError(f"44.1 kHz: card and CPU disagree ({rel}) or {launches} launches")
    return launches


def bf16_trainer(card: str, root: Path) -> dict:
    """`bin/pretrain.py --use-bf16` for 8 steps on half the corpus of phase
    10; returns the two kernels' launches over the run."""
    recs = read_recording_manifest(root / "train" / "recordings.jsonl.gz")[:128]
    half = root / "train_half.jsonl.gz"
    write_recording_manifest(recs, half)
    exp = root / "exp_bf16"
    args = pretrain.get_parser().parse_args([
        "--model-name", "mel_24k_base", "--use-bf16", "true", "--batch-size", "16",
        "--duration", "1.5", "--num-epochs", "1", "--num-workers", "4", "--seed", "0",
        "--save-every-n", "1000", "--average-period", "4", "--log-interval", "4",
        "--valid-interval", "4", "--device", "cuda", "--exp-dir", str(exp),
        "--tensorboard", "false", "--train-recordings", str(half),
        "--valid-recordings", str(root / "valid" / "recordings.jsonl.gz")])
    torch.cuda.reset_peak_memory_stats()
    fused.launches = fused.adjoint_launches = 0
    start = time.perf_counter()
    history = pretrain.run(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = {"forward": fused.launches, "adjoint": fused.adjoint_launches}
    steps = len(history)
    if steps != 8 or launches != {"forward": 3 * (8 + 2), "adjoint": 3 * 8}:
        raise AssertionError(f"bf16 trainer ran {steps} steps with launches {launches}")
    losses = [h["loss"] for h in history]
    ms = [h["ms"] for h in history[2:]]
    med = statistics.median(ms)
    print("bf16 trainer " + json.dumps({
        "config": "mel_24k_base", "compute_dtype": "bfloat16", "batch": 16,
        "seconds_per_item": 1.5, "steps": steps, "loss_curve": losses,
        "clip_scale": [h["clip_scale"] for h in history], "first_step_ms": history[0]["ms"],
        "step_ms_median": med, "step_ms_min": min(ms), "step_ms_max": max(ms),
        "audio_s_per_wall_s": 16 * 1.5 / med * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "run_wall_s": wall_s,
        "launches": launches, "card": card}))
    if not all(math.isfinite(x) for x in losses) or not statistics.median(losses[-3:]) < losses[0]:
        raise AssertionError(f"the bf16 training loss is not finite or does not fall: {losses}")
    profile_train_step(card, med, "bfloat16")
    return launches


def clis(card: str, root: Path, exp: Path, averaged: Path) -> dict:
    """bin/infer over a manifest of corpus files with the windowed average
    of phase 10's epochs, and bin/infer_dir on a directory of them, whole and
    in 50-frame chunks; returns each run's launches."""
    recs = read_recording_manifest(root / "valid" / "recordings.jsonl.gz")[:6]
    cli = root / "cli"
    (cli / "wavs").mkdir(parents=True, exist_ok=True)
    write_recording_manifest(recs, cli / "recordings.jsonl.gz")
    launches = {}
    fused.launches = 0
    written = infer.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "1",
                          "--recordings", str(cli / "recordings.jsonl.gz"),
                          "--root-path", str(root / "valid"), "--output-dir", str(cli / "infer"),
                          "--batch-size", "4", "--num-workers", "2", "--device", "cuda"])
    launches["infer"] = fused.launches
    for rec, path in zip(recs, written):
        out, sr = read_wav(path)
        if sr != 24000 or out.shape != (1, rec.num_samples) or not np.isfinite(out).all():
            raise AssertionError(f"bin/infer wrote {path} at {sr} Hz, shape {out.shape}")
    if len(written) != len(recs) or launches["infer"] != 3 * 2:  # 6 files in batches of 4
        raise AssertionError(f"bin/infer wrote {len(written)} files with {launches['infer']} launches")
    for rec in recs[:4]:
        shutil.copy(rec.path, cli / "wavs")
    runs = {}
    for name, extra in (("infer_dir", []), ("infer_dir_chunked", ["--chunk-size", "50"])):
        fused.launches = 0
        runs[name] = infer_dir.main(["--checkpoint", str(averaged), "--input-dir", str(cli / "wavs"),
                                     "--output-dir", str(cli / name), "--device", "cuda", *extra])
        launches[name] = fused.launches
    frames = 48000 // 256 + 1  # 2 s files
    chunks = -(-frames // 50)
    if launches["infer_dir"] != 3 * 4 or launches["infer_dir_chunked"] != 3 * 4 * chunks:
        raise AssertionError(f"bin/infer_dir launches {launches}")
    diffs = []
    for whole, chunked in zip(runs["infer_dir"], runs["infer_dir_chunked"]):
        a, b = read_wav(whole)[0], read_wav(chunked)[0]
        if a.shape != b.shape or a.shape != (1, frames * 256) or not (
                np.isfinite(a).all() and np.isfinite(b).all()):
            raise AssertionError(f"bin/infer_dir wrote {a.shape} and {b.shape}")
        diffs.append({"file": whole.name, "max_abs": float(np.abs(a - b).max()),
                      "rms": float(np.sqrt(np.mean((a - b) ** 2))),
                      "whole_rms": float(np.sqrt(np.mean(a ** 2)))})
    if not (native_audio.available() and native_audio.reads > 0):
        raise AssertionError("the native WAV reader is not in use")
    print("CLIs " + json.dumps({"infer_files": len(written), "infer_dir_files": len(diffs),
                                "launches": launches, "chunks_per_file": chunks,
                                "chunked_vs_whole": diffs,
                                "native_wav_reader_crops": native_audio.reads, "card": card}))
    return launches


def disc_tensors(judgements) -> list:
    """The scores and feature maps of (MPD, MRD) judgements, in order."""
    out = []
    for scores, fmaps in judgements:
        for score, fmap in zip(scores, fmaps):
            out += [score, *fmap]
    return out


def discriminators_card_vs_cpu(card: str) -> None:
    """The full discriminators on a batch 2 x 1 s signal, card against CPU,
    with the same weights: every score and feature map."""
    cpu = init_discriminators(Discriminators(), torch.Generator().manual_seed(0))
    gpu = copy.deepcopy(cpu).cuda()
    x = torch.from_numpy(voiced(np.random.RandomState(31), 2, 24000))
    with torch.no_grad():
        a = [t.cpu() for t in disc_tensors(gpu.judge(x.cuda()))]
        b = disc_tensors(cpu.judge(x))
    errs = [((u - v).abs().max() / v.abs().max().clamp_min(1e-30)).item() for u, v in zip(a, b)]
    print("discriminators card vs CPU " + json.dumps({
        "batch": 2, "length": 24000, "tensors": len(errs), "max_rel_err": max(errs),
        "median_rel_err": statistics.median(errs),
        "parameters": sum(p.numel() for p in cpu.parameters()), "card": card}))
    if len(a) != 5 * 6 + 3 * 22 or not max(errs) <= DISC_VS_CPU_TOL:
        raise AssertionError(f"discriminators: card and CPU disagree ({max(errs)})")


def gan_models(device: str, generator_path=None):
    """mel_24k_base (branch dropout off; from `generator_path` or seed 0),
    the full discriminators (seed 0), the log-mel frontend and the
    multi-scale mel loss's frontends, on `device`."""
    cfg = get_generator_config("mel_24k_base")
    cfg["branch_dropout"] = 0.0
    gen = init_weights(build_generator(cfg), torch.Generator().manual_seed(0))
    if generator_path is not None:
        load_weights(gen, generator_path)
    disc = init_discriminators(Discriminators(), torch.Generator().manual_seed(0))
    mel = LogMelSpectrogram(sampling_rate=24000, n_fft=1024, hop_length=256, n_mels=100)
    return gen.to(device), disc.to(device), mel.to(device), make_mel_recon_fns(24000).to(device)


def hinge_parts(disc, audio, fakes) -> list:
    """The D objective's gradient in parts, on the CPU: its real half's
    (mean relu(1 - D(real)) over the discriminators, weighted 1 and 0.1),
    then its fake half's (mean relu(1 + D(fake))) for each waveform of
    `fakes`, as lists of tensors in `disc.named_parameters()` order."""
    params = [p for _, p in disc.named_parameters()]

    def half(judgement, sign):
        (mp, mr) = judgement
        return (sum(torch.relu(1 + sign * x).mean() for x in mp[0])
                + 0.1 * sum(torch.relu(1 + sign * x).mean() for x in mr[0]))

    parts = [torch.autograd.grad(half(disc.judge(audio), -1), params)]
    for fake in fakes:
        parts.append(torch.autograd.grad(half(disc.judge(fake), 1), params))
    return [[g.double() for g in part] for part in parts]


def gan_grads_card_vs_cpu(card: str) -> dict:
    """The D and G objectives of full mel_24k_base with the full
    discriminators at 1 Euler step, batch 2 x 1 s, card against CPU with the
    same weights and draws: the loss and every gradient of the objective's
    own side. Returns each objective's (forward, adjoint) launches.

    Each tensor's error is held to GRAD_TENSOR_TOL of its scale plus four
    times its floor, the whole gradient's to GRAD_TOL plus twice the whole
    floor. A floor moves one input; the card also rounds every op of the
    forward and backward passes in its own order, which moves a tensor
    whose gradient is a sum that nearly cancels (BiasNorm's scalar
    log_scale) by a few times more (PERF.md §6).
    G side: the scale is the gradient's norm, the floor how far the CPU's
    gradient moves when x0 moves by one float32 ulp, times how much further
    the card's rollout lies from the CPU's than the one-ulp rollout does
    (the card rounds every op of the solve, not only x0). D side: a fresh
    discriminator puts every score in the hinge's linear part, so the
    gradient is the fake half's minus the real half's (`hinge_parts`), and
    where they nearly cancel rounding shows at the halves' size: the scale
    is the larger of the gradient's norm and the halves' together, and the
    floor how far the CPU's gradient moves when its fake waveform is
    replaced by the card's (the generator's own card/CPU rounding)."""
    models = {dev: gan_models(dev) for dev in ("cpu", "cuda")}
    rng = np.random.RandomState(33)
    audio = voiced(rng, 2, 24000)
    lens = np.asarray([24000, 21000])
    x0 = (0.1 * rng.randn(2, 94 * 256)).astype(np.float32)
    gates = (rng.rand(1, models["cpu"][0].num_limiters) < 0.6).astype(np.float32)
    batch = {dev: {"audio": torch.from_numpy(audio).to(dev), "audio_lens": torch.from_numpy(lens).to(dev)}
             for dev in ("cpu", "cuda")}
    launches = {}

    def run(side, dev, x0_arr):
        gen, disc, mel, recon = models[dev]
        fns = dict(zip("dg", make_gan_loss_fns(gen, disc, mel, recon, n_timesteps=1)))
        own = disc if side == "d" else gen
        draws = RolloutDraws(torch.from_numpy(x0_arr).to(dev),
                             torch.from_numpy(gates).to(dev) if side == "g" else None)
        fused.launches = fused.adjoint_launches = 0
        loss, _ = fns[side](batch[dev], draws)
        loss.backward(inputs=list(own.parameters()))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches[side] = (fused.launches, fused.adjoint_launches)
        grads = [p.grad.double().cpu() for p in own.parameters()]
        own.zero_grad(set_to_none=True)
        return loss.item(), grads

    def fake(dev, x0_arr=x0):
        gen, _, mel, _ = models[dev]
        with torch.no_grad():
            out = gen.rollout(mel(batch[dev]["audio"]), RolloutDraws(torch.from_numpy(x0_arr).to(dev)),
                              batch[dev]["audio_lens"], 1)
        return out[..., :24000].cpu()

    def norm(tensors):
        return math.sqrt(sum(t.norm().item() ** 2 for t in tensors))

    for side in ("d", "g"):
        (loss_gpu, g_gpu), (loss_cpu, g_cpu) = run(side, "cuda", x0), run(side, "cpu", x0)
        names = [k for k, _ in (models["cpu"][1] if side == "d" else models["cpu"][0]).named_parameters()]
        if side == "d":
            g_real, g_fake, g_fake_card = hinge_parts(models["cpu"][1], batch["cpu"]["audio"],
                                                      [fake("cpu"), fake("cuda")])
            scale = [max(g.norm().item(), norm([a, b])) for g, a, b in zip(g_cpu, g_real, g_fake)]
            moved = [a - b for a, b in zip(g_fake_card, g_fake)]
        else:
            scale = [g.norm().item() for g in g_cpu]
            x0_ulp = np.nextafter(x0, np.float32(np.inf))
            f_cpu = fake("cpu")
            gain = ((fake("cuda") - f_cpu).norm() / (fake("cpu", x0_ulp) - f_cpu).norm()).item()
            moved = [(a - b) * gain for a, b in zip(run(side, "cpu", x0_ulp)[1], g_cpu)]
        err = [(a - b).norm().item() for a, b in zip(g_gpu, g_cpu)]
        floor = [m.norm().item() for m in moved]
        ratio = [e / (GRAD_TENSOR_TOL * sc + 4 * fl + 1e-300) for e, sc, fl in zip(err, scale, floor)]
        worst = max(range(len(names)), key=lambda i: ratio[i])
        loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
        total, total_scale, total_floor = norm([a - b for a, b in zip(g_gpu, g_cpu)]), norm(
            [torch.tensor(sc) for sc in scale]), norm(moved)
        print(f"GAN {side.upper()} objective card vs CPU " + json.dumps({
            "config": "mel_24k_base", "n_timesteps": 1, "batch": 2, "length": 24000,
            "tensors": len(names), "loss_card": loss_gpu, "loss_cpu": loss_cpu, "loss_rel_err": loss_err,
            "grad_rel_err_all": total / total_scale, "floor_all": total_floor / total_scale,
            "grad_rel_err_all_over_own_norm": total / norm(g_cpu),
            "worst_tensor": names[worst], "its_rel_err": err[worst] / scale[worst],
            "its_floor": floor[worst] / scale[worst],
            "its_norm_over_scale": g_cpu[worst].norm().item() / scale[worst],
            "worst_err_over_limit": ratio[worst],
            "median_tensor_rel_err": statistics.median(e / (sc + 1e-300) for e, sc in zip(err, scale)),
            "worst_tensor_over_own_norm": max(e / (g.norm().item() + 1e-300) for e, g in zip(err, g_cpu)),
            "scale": "own norm" if side == "g" else "max(own norm, hinge halves' norm)",
            "floor": (f"x0 moved one ulp, times {gain:.3g}" if side == "g"
                      else "the card's fake through the CPU's D"),
            "launches_forward_adjoint": launches[side], "card": card}))
        finite = all(torch.isfinite(g).all() for g in g_gpu)
        expected = (3, 0) if side == "d" else (3, 3)
        if launches[side] != expected:
            raise AssertionError(f"the {side.upper()} objective launched {launches[side]}, "
                                 f"expected {expected}")
        if not (finite and loss_err <= LOSS_TOL and ratio[worst] <= 1.0
                and total <= GRAD_TOL * total_scale + 2 * total_floor):
            raise AssertionError(f"card and CPU disagree on the {side.upper()} objective")
    return launches


def run_counting_steps(module, factory: str, args):
    """`module.run(args)` with each step that `module.<factory>` makes
    counting its kernel launches: `factory` is "make_gan_steps" (its D, G
    and eval steps) or "fm_train_step" (the step itself). Returns the run's
    history and one (step kind, forward launches, adjoint launches) per
    call."""
    calls = []
    original = getattr(module, factory)

    def wrap(kind, step):
        def run(*args, **kwargs):
            f, b = fused.launches, fused.adjoint_launches
            out = step(*args, **kwargs)
            calls.append((kind, fused.launches - f, fused.adjoint_launches - b))
            return out
        return run

    def counted(*a, **kw):
        return tuple(wrap(k, s) for k, s in zip(("D", "G", "eval"), original(*a, **kw)))

    setattr(module, factory, counted if factory == "make_gan_steps" else wrap("FM", original))
    try:
        return module.run(args), calls
    finally:
        setattr(module, factory, original)


def launches_by_kind(calls) -> dict:
    """Each step kind's launches (forward, adjoint), summed over the
    `calls` that `run_counting_steps` read."""
    out = {}
    for kind, f, b in calls:
        was = out.get(kind, (0, 0))
        out[kind] = (was[0] + f, was[1] + b)
    return out


def gan_finetune(card: str, root: Path, averaged: Path) -> dict:
    """`bin/finetune.py` on mel_24k_base at 4 Euler steps from the averaged FM
    model on phase 10's corpus; checks the launches of every step and
    returns them with the run's timings and its experiment directory."""
    exp = root / "exp_gan"
    args = finetune.get_parser().parse_args([
        "--model-name", "mel_24k_base", "--n-timesteps", str(GAN_STEPS), "--batch-size", "16",
        "--duration", "1.5", "--num-epochs", "2", "--num-workers", "4", "--seed", "0",
        "--gen-start-batch-idx", str(GAN_WARMUP), "--save-every-n", "1000", "--keep-last-k", "1",
        "--average-period", "4", "--log-interval", "8", "--valid-interval", "16",
        "--device", "cuda", "--exp-dir", str(exp), "--generator-model-path", str(averaged),
        "--tensorboard", "false", "--train-recordings", str(root / "train" / "recordings.jsonl.gz"),
        "--valid-recordings", str(root / "valid" / "recordings.jsonl.gz")])
    torch.cuda.reset_peak_memory_stats()
    fused.launches = fused.adjoint_launches = 0
    start = time.perf_counter()
    history, calls = run_counting_steps(finetune, "make_gan_steps", args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = 3 * GAN_STEPS
    sides = [h["side"] for h in history]
    expected = ["D"] * GAN_WARMUP + ["G", "D"] * ((GAN_BATCHES - GAN_WARMUP) // 2)
    per_kind = {kind: sorted({(f, b) for k, f, b in calls if k == kind}) for kind in ("D", "G", "eval")}
    counts = {kind: sum(k == kind for k, _, _ in calls) for kind in ("D", "G", "eval")}
    by_kind = launches_by_kind(calls)
    launches = {"forward": fused.launches, "adjoint": fused.adjoint_launches,
                "d_steps": by_kind["D"], "g_steps": by_kind["G"], "validation": by_kind["eval"]}
    if sides != expected or counts["eval"] != 2 or per_kind != {
            "D": [(n, 0)], "G": [(n, n)], "eval": [(n, 0)]}:
        raise AssertionError(f"fine-tuner: sides {sides}, launches per step {per_kind}, {counts}")
    if launches["forward"] != n * len(calls) or launches["adjoint"] != n * counts["G"]:
        raise AssertionError(f"fine-tuner launches {launches} beside its steps' {calls}")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite GAN loss: {losses}")
    first, last = (ckpt.load_checkpoint(exp / f"epoch-{e}.pt")["model"] for e in (0, 2))
    moved = {side: sum(not torch.equal(v, first[side][k]) for k, v in last[side].items())
             / len(last[side]) for side in ("generator", "discriminator")}
    if not (moved["generator"] > 0.9 and moved["discriminator"] > 0.9):
        raise AssertionError(f"fine-tuning did not move both sides: {moved}")
    ms = {side: [h["ms"] for h in history if h["side"] == side][2:] for side in ("D", "G")}
    med = {side: statistics.median(v) for side, v in ms.items()}
    print("GAN fine-tuner " + json.dumps({
        "config": "mel_24k_base", "n_timesteps": GAN_STEPS, "batch": 16, "seconds_per_item": 1.5,
        "batches": len(history), "sides": "".join(sides),
        "loss_d": [h["loss"] for h in history if h["side"] == "D"],
        "loss_g": [h["loss"] for h in history if h["side"] == "G"],
        "clip_scale": [h["clip_scale"] for h in history],
        "d_step_ms_median": med["D"], "d_step_ms_min": min(ms["D"]), "d_step_ms_max": max(ms["D"]),
        "g_step_ms_median": med["G"], "g_step_ms_min": min(ms["G"]), "g_step_ms_max": max(ms["G"]),
        "audio_s_per_g_step_s": 16 * 1.5 / med["G"] * 1e3,
        "first_d_step_ms": history[0]["ms"], "first_g_step_ms": history[GAN_WARMUP]["ms"],
        "peak_memory_gb": peak_gb, "run_wall_s": wall_s, "moved_share": moved,
        "launches": launches, "card": card}))
    return {"launches": launches, "d_ms": med["D"], "g_ms": med["G"], "exp": exp}


def gan_step_profiles(card: str, averaged: Path, d_ms: float, g_ms: float) -> dict:
    """One 4-step D step and one G step (batch 16 x 1.5 s) by kernel family,
    the discriminators' own device time in each, measured alone, and the
    busy share against the fine-tuner's median steps; then the G step with
    and without `--remat-rollout`. Returns the (forward, adjoint) launches
    of the plain and the remat G step."""
    gen, disc, mel, recon = gan_models("cuda", averaged)
    opt_g = ScaledAdam(gen.named_parameters(), clipping_scale=2.0)
    opt_d = ScaledAdam(disc.named_parameters(), clipping_scale=2.0)
    d_step, g_step, _ = make_gan_steps(gen, disc, mel, recon, opt_g, opt_d, lambda b: 1e-4,
                                       lambda b: 1e-3, n_timesteps=GAN_STEPS)
    audio = torch.from_numpy(voiced(np.random.RandomState(41), 16, 36000)).cuda()
    batch = {"audio": audio, "audio_lens": torch.full((16,), 36000, device="cuda")}

    def draws(train, i):
        return gen.draw_rollout(16, 141, GAN_STEPS, step_generator(0, i, "cuda"), train)

    for i in range(2):
        d_step(batch, draws(False, 2 * i))
        g_step(batch, draws(True, 2 * i + 1))
    counts = {"D": [], "G": []}
    fams = {"D": device_families(lambda: d_step(batch, draws(False, 10)), family=_gan_family,
                                 kernels=counts["D"])[0],
            "G": device_families(lambda: g_step(batch, draws(True, 11)), family=_gan_family,
                                 kernels=counts["G"])[0]}
    # the discriminators' part of each step, alone: D judges real and fake
    # and backward reaches its parameters; G judges real (no graph) and fake,
    # and backward reaches the fake waveform only
    with torch.no_grad():
        fake = gen.rollout(mel(audio), draws(False, 12), batch["audio_lens"], GAN_STEPS)[..., :36000]
    params_d = list(disc.parameters())

    def d_part():
        (rmp, rmr), (fmp, fmr) = disc.judge(audio), disc.judge(fake)
        loss = discriminator_loss(rmp[0], fmp[0]) + 0.1 * discriminator_loss(rmr[0], fmr[0])
        loss.backward(inputs=params_d)

    def g_part():
        leaf = fake.clone().requires_grad_()
        with torch.no_grad():
            real = disc.judge(audio)
        fj = disc.judge(leaf)
        loss = sum(generator_loss(f[0]) + feature_matching_loss(r[1], f[1]) for r, f in zip(real, fj))
        loss.backward(inputs=[leaf])

    disc_ms = {"D": statistics.median(device_ms(d_part, samples=5)),
               "G": statistics.median(device_ms(g_part, samples=5))}
    disc.zero_grad(set_to_none=True)
    wall = {"D": d_ms, "G": g_ms}
    for side in ("D", "G"):
        total = sum(fams[side].values())
        if not total:
            raise AssertionError("torch.profiler recorded no device time for a GAN step")
        print(f"profile GAN {side} step " + json.dumps({
            "config": "mel_24k_base", "n_timesteps": GAN_STEPS, "batch": 16, "seconds_per_item": 1.5,
            "device_ms": total, "device_kernels": sum(counts[side]), "by_family_ms": fams[side],
            "discriminators_alone_ms": disc_ms[side],
            "discriminators_share_of_device_ms": disc_ms[side] / total,
            "step_ms_median_fine_tuner": wall[side], "device_busy_share": total / wall[side],
            "card": card}))

    # --remat-rollout against plain, with the same weights and draws; plain
    # twice, to show what the card's own run-to-run order changes
    params_g = list(gen.parameters())
    g_draws = draws(True, 13)
    runs = {}
    for name, remat in (("plain", False), ("remat", True), ("plain_again", False)):
        _, g_fn = make_gan_loss_fns(gen, disc, mel, recon, n_timesteps=GAN_STEPS, remat_rollout=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        fused.launches = fused.adjoint_launches = 0
        loss, _ = g_fn(batch, g_draws)
        loss.backward(inputs=params_g)
        torch.cuda.synchronize()
        runs[name] = {"loss": loss.item(), "grads": [p.grad.detach().clone() for p in params_g],
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "base_gb": base_gb,
                      "launches": (fused.launches, fused.adjoint_launches)}
        gen.zero_grad(set_to_none=True)
        del loss

    def rel(a, b):
        num = math.sqrt(sum((x.double() - y.double()).norm().item() ** 2 for x, y in zip(a, b)))
        return num / math.sqrt(sum(y.double().norm().item() ** 2 for y in b))

    plain, remat = runs["plain"], runs["remat"]
    report = {
        "loss_rel_err": abs(remat["loss"] - plain["loss"]) / abs(plain["loss"]),
        "grad_rel_err_all": rel(remat["grads"], plain["grads"]),
        "plain_vs_plain_grad_rel_err_all": rel(runs["plain_again"]["grads"], plain["grads"]),
        **{f"{k}_{name}": runs[name][k] for name in ("plain", "remat")
           for k in ("peak_gb", "base_gb", "launches")}}
    print("GAN G step, --remat-rollout against plain " + json.dumps({
        "config": "mel_24k_base", "n_timesteps": GAN_STEPS, "batch": 16, **report, "card": card}))
    # the recompute runs each Euler step's forward again up to the last
    # tensor backward needs (torch.utils.checkpoint stops there): the third
    # branch's iSTFT saves nothing, so 2 of the 3 forward launches rerun
    n = 3 * GAN_STEPS
    if (plain["launches"] != (n, n) or remat["launches"] != (n + 2 * GAN_STEPS, n)
            or not (report["loss_rel_err"] <= REMAT_TOL and report["grad_rel_err_all"] <= REMAT_TOL)):
        raise AssertionError(f"remat disagrees with plain: {report}")
    return {"plain": plain["launches"], "remat": remat["launches"]}


def gan_clis(card: str, root: Path, exp: Path) -> int:
    """`save_averaged_model --load-gan` on the fine-tuner's checkpoints,
    served at 4 steps, and `bin/infer --load-gan` over the CLI phase's corpus
    files; returns bin/infer's launches."""
    out = save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "2",
                                    "--load-gan", "true"])
    served = get_model("mel_24k_base", checkpoint=out, device="cuda")
    wav = served.infer(np.random.RandomState(0).randn(4, 100, 94).astype(np.float32),
                       n_timesteps=GAN_STEPS)
    if wav.shape != (4, 24064) or not torch.isfinite(wav).all():
        raise AssertionError(f"the GAN average served {tuple(wav.shape)}")
    cli = root / "cli"
    recs = read_recording_manifest(cli / "recordings.jsonl.gz")
    fused.launches = 0
    written = infer.main(["--exp-dir", str(exp), "--epoch", "2", "--load-gan", "true",
                          "--n-timesteps", str(GAN_STEPS),
                          "--recordings", str(cli / "recordings.jsonl.gz"),
                          "--root-path", str(root / "valid"), "--output-dir", str(cli / "infer_gan"),
                          "--batch-size", "4", "--num-workers", "2", "--device", "cuda"])
    launches = fused.launches
    for rec, path in zip(recs, written):
        got, sr = read_wav(path)
        if sr != 24000 or got.shape != (1, rec.num_samples) or not np.isfinite(got).all():
            raise AssertionError(f"bin/infer --load-gan wrote {path} at {sr} Hz, shape {got.shape}")
    if len(written) != len(recs) or launches != 3 * GAN_STEPS * 2:  # 6 files in batches of 4
        raise AssertionError(f"bin/infer --load-gan wrote {len(written)} files with {launches} launches")
    print("GAN CLIs " + json.dumps({"averaged": out.name, "served_shape": list(wav.shape),
                                    "infer_files": len(written), "infer_launches": launches,
                                    "card": card}))
    return launches


# --------------------------------------------------- data parallelism (16)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_entry(rank: int, world: int, out_dir: str, fn_name: str, spec: dict) -> None:
    """One spawned rank: torchrun's environment, then `fn_name(spec)`, whose
    result it saves as rank<r>.pt. `spec["group"]` is "port" (the trainers'
    own `init_distributed` joins the group from the environment), "nccl1" (a
    one-rank NCCL group, joined here) or "trainer" (the trainer joins)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(spec["port"]))
    disable_tf32()
    if spec["group"] == "nccl1":
        torch.cuda.set_device(0)
        torch.distributed.init_process_group("nccl", rank=0, world_size=1)
    elif spec["group"] == "port":
        dist.init_distributed(spec["device"])
    try:
        torch.save(globals()[fn_name](spec), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy()


def spawn_ranks(world: int, fn_name: str, spec: dict, out: Path, tries: int = 3) -> list:
    """Run `fn_name(spec)` in `world` spawned processes; their results in
    rank order. The rendezvous port is free when it is picked, but another
    socket can take it before rank 0 listens on it (the ranks start seconds
    later): then the ranks are spawned again on a new port, at most `tries`
    times in all."""
    for attempt in range(tries):
        shutil.rmtree(out, ignore_errors=True)
        out.mkdir(parents=True)
        try:
            torch.multiprocessing.spawn(rank_entry, args=(world, str(out), fn_name,
                                                          {**spec, "port": free_port()}),
                                        nprocs=world)
            break
        except torch.multiprocessing.ProcessRaisedException as e:
            if "EADDRINUSE" not in str(e) or attempt == tries - 1:
                raise
            print(f"spawn_ranks: the rendezvous port was taken; spawning again ({e})".splitlines()[0])
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)]
    shutil.rmtree(out, ignore_errors=True)
    return results


def dist_batch(n: int, lens) -> dict:
    """The global batch of the data-parallel phases, in host memory: n
    voiced 1.5 s crops and their valid lengths `lens`."""
    return {"audio": torch.from_numpy(voiced(np.random.RandomState(51), n, DIST_LENGTH)),
            "audio_lens": torch.tensor(lens)}


def _grads_by_step(optimizer: ScaledAdam, into: dict, key: str):
    """Wrap `optimizer.step` to keep the gradients it applies (summed over
    the ranks by then) under `into[key]`, by parameter name, on the CPU."""
    step = optimizer.step

    def keep(lr):
        into[key] = {n: p.grad.detach().double().cpu() for g in optimizer.groups
                     for n, p in zip(g.names, g.params)}
        step(lr)

    optimizer.step = keep


def dist_steps(spec: dict) -> dict:
    """One FM step of full mel_24k_base, then (unless `spec["fm_only"]`) a
    4-step GAN D step and G step with the full discriminators, on this rank's
    rows of the global batch of 16 x 1.5 s (all of it in one process); the
    draws from step generators for the global batch. Returns the global
    losses, the summed gradients each step applied (rank 0 and one
    process), each step's launches of both kernels and the peak memory so
    far; raises on every rank unless the ranks' parameters are bitwise equal
    after each step. With `spec["floors"]` (one process) it also returns
    each GAN step's gradient computed as two halves of the batch."""
    shard = dist.shard()
    dev = torch.device("cuda", torch.cuda.current_device())
    batch = {k: shard.rows(v).to(dev) for k, v in dist_batch(DIST_BATCH, DIST_LENS).items()}
    grads = {}
    out = {"backend": (torch.distributed.get_backend() if torch.distributed.is_initialized()
                       else "none"), "device": str(dev)}

    cfg = get_generator_config("mel_24k_base")
    model = init_weights(build_generator(cfg), torch.Generator().manual_seed(0)).to(dev)
    mel = LogMelSpectrogram(sampling_rate=24000, n_fft=1024, hop_length=256, n_mels=100).to(dev)
    opt = ScaledAdam(model.named_parameters(), clipping_scale=2.0)
    dist.assert_replicas_equal(list(model.parameters()))
    _grads_by_step(opt, grads, "fm")
    fused.launches = fused.adjoint_launches = 0
    m = fm_train_step(model, opt, mel, batch, 1e-3, step_generator(0, 0, dev))
    torch.cuda.synchronize()
    out["fm"] = {"loss": float(m["loss"]), "launches": (fused.launches, fused.adjoint_launches)}
    dist.assert_replicas_equal(list(model.parameters()))  # raises on every rank if not
    del model, opt, m
    if spec.get("fm_only"):
        out["grads"] = grads if dist.is_main() else None
        return out

    gen, disc, mel, recon = gan_models(dev)
    opt_g = ScaledAdam(gen.named_parameters(), clipping_scale=2.0)
    opt_d = ScaledAdam(disc.named_parameters(), clipping_scale=2.0)
    d_step, g_step, _ = make_gan_steps(gen, disc, mel, recon, opt_g, opt_d, lambda b: 1e-4,
                                       lambda b: 1e-3, n_timesteps=GAN_STEPS)
    _grads_by_step(opt_d, grads, "d")
    _grads_by_step(opt_g, grads, "g")
    n_frames = DIST_LENGTH // 256 + 1
    d_draws = gen.draw_rollout(DIST_BATCH // shard.count, n_frames, GAN_STEPS,
                               step_generator(0, 1, dev), train=False, shard=shard)
    g_draws = gen.draw_rollout(DIST_BATCH // shard.count, n_frames, GAN_STEPS,
                               step_generator(0, 2, dev), train=True, shard=shard)
    loss_fns = dict(zip("dg", make_gan_loss_fns(gen, disc, mel, recon, n_timesteps=GAN_STEPS)))
    for side, step, draws, own in (("d", d_step, d_draws, opt_d), ("g", g_step, g_draws, opt_g)):
        if spec.get("floors"):
            # the floor: this step's gradient computed as the ranks compute
            # it, as two halves of the batch whose gradients are summed
            for r in range(DIST_WORLD):
                part = Shard(r, DIST_WORLD)
                half = {k: part.rows(v) for k, v in batch.items()}
                loss, _ = loss_fns[side](half, RolloutDraws(part.rows(draws.x0), draws.gates))
                (loss / DIST_WORLD).backward(inputs=[p for g in own.groups for p in g.params])
            out[f"split_{side}"] = {n: p.grad.detach().double().cpu() for g in own.groups
                                    for n, p in zip(g.names, g.params)}
            own.zero_grad()
        fused.launches = fused.adjoint_launches = 0
        m = step(batch, draws)
        torch.cuda.synchronize()
        out[side] = {"loss": float(m["loss_d" if side == "d" else "loss_g"]),
                     "launches": (fused.launches, fused.adjoint_launches),
                     "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        dist.assert_replicas_equal([*gen.parameters(), *disc.parameters()])
    out["grads"] = grads if dist.is_main() else None
    return out


def _norm(tensors) -> float:
    return math.sqrt(sum(t.norm().item() ** 2 for t in tensors))


def compare_steps(name: str, ours: dict, ref: dict, floors=None) -> dict:
    """A step of the ranks against one process, with 15c's limits: the loss
    within LOSS_TOL; each tensor's gradient within GRAD_TENSOR_TOL of its
    norm plus four times its floor, the whole within GRAD_TOL of the norm
    plus twice the floors' (no floors: 0). The report's "ok" says whether
    it holds."""
    names = sorted(ref["grads"][name])
    a = [ours["grads"][name][k] for k in names]
    b = [ref["grads"][name][k] for k in names]
    scales = [g.norm().item() for g in b]
    floors = [floors[k] for k in names] if floors else [0.0] * len(names)
    err = [(x - y).norm().item() for x, y in zip(a, b)]
    ratio = [e / (GRAD_TENSOR_TOL * s + 4 * f + 1e-300) for e, s, f in zip(err, scales, floors)]
    worst = max(range(len(names)), key=lambda i: ratio[i])
    total, total_scale, total_floor = (_norm([x - y for x, y in zip(a, b)]),
                                       math.hypot(*scales), math.hypot(*floors))
    loss_err = abs(ours[name]["loss"] - ref[name]["loss"]) / abs(ref[name]["loss"])
    return {"ok": bool(loss_err <= LOSS_TOL and ratio[worst] <= 1.0
                       and total <= GRAD_TOL * total_scale + 2 * total_floor
                       and all(torch.isfinite(x).all() for x in a)),
            "loss_ranks": ours[name]["loss"], "loss_one": ref[name]["loss"],
            "loss_rel_err": loss_err, "grad_rel_err_all": total / total_scale,
            "floor_all": total_floor / total_scale, "worst_tensor": names[worst],
            "its_rel_err": err[worst] / scales[worst], "its_floor": floors[worst] / scales[worst],
            "worst_err_over_limit": ratio[worst],
            "median_tensor_rel_err": statistics.median(e / (s + 1e-300) for e, s in zip(err, scales)),
            "tensors": len(a), "launches_per_rank": ours[name]["launches"],
            "launches_one": ref[name]["launches"]}


def data_parallel_steps(card: str) -> dict:
    """Phases 16a and 16b: the FM step, then the 4-step D and G steps, as 2
    ranks of 8 against one process of 16, with the same weights, batch and
    draws. One rank per card over NCCL where there are 2 cards; else both
    ranks on card 0 over gloo (every rank on the named card), and the FM
    step once more in a one-rank NCCL group, so that NCCL's init and
    all-reduce run on the card. Returns the per-rank launches."""
    per_card = torch.cuda.device_count() >= DIST_WORLD
    ref = dist_steps({"floors": True})
    torch.cuda.empty_cache()
    start = time.perf_counter()
    ranks = spawn_ranks(DIST_WORLD, "dist_steps", {"group": "port",
                                                   "device": "cuda" if per_card else "cuda:0"},
                        ROOT / "dist_steps")
    wall_s = time.perf_counter() - start
    backend = ranks[0]["backend"]
    if backend != ("nccl" if per_card else "gloo") or any(not r["device"].startswith("cuda")
                                                           for r in ranks):
        raise AssertionError(f"ranks ran on {[(r['backend'], r['device']) for r in ranks]}")
    # 15c's limits with this phase's floor: how far one process's gradient
    # moves when it computes the global batch as the ranks do, as two halves
    # (batch 8 runs other kernels, and the hinge's halves cancel in places)
    floors = {side: {k: (ref[f"split_{side}"][k] - g).norm().item()
                     for k, g in ref["grads"][side].items()} for side in ("d", "g")}
    reports = {side: compare_steps(side, ranks[0], ref, floors.get(side))
               for side in ("fm", "d", "g")}
    expected = {"fm": (3, 3), "d": (3 * GAN_STEPS, 0), "g": (3 * GAN_STEPS, 3 * GAN_STEPS)}
    print("data-parallel steps, 2 ranks against one process " + json.dumps({
        "config": "mel_24k_base", "global_batch": DIST_BATCH, "per_rank": DIST_BATCH // DIST_WORLD,
        "seconds_per_item": DIST_LENGTH / 24000, "valid_lens": DIST_LENS, "n_timesteps": GAN_STEPS,
        "backend": backend, "devices": [r["device"] for r in ranks],
        "ranks_bitwise_equal_after_each_step": True,
        "floor": "one process's gradient as two halves of the batch, summed",
        "peak_gb_per_rank": {s: [r[s]["peak_gb"] for r in ranks] for s in ("d", "g")},
        "spawned_run_wall_s": wall_s, **reports, "card": card}))
    for side, want in expected.items():
        got = [r[side]["launches"] for r in ranks]
        if got != [want] * DIST_WORLD or any(r[side]["loss"] != ranks[0][side]["loss"] for r in ranks):
            raise AssertionError(f"{side} step: per-rank launches {got} (want {want}) or "
                                 "losses differ between the ranks")
        if not reports[side]["ok"]:
            raise AssertionError(f"{side} step: the ranks disagree with one process")
    if not per_card:
        nccl = spawn_ranks(1, "dist_steps", {"group": "nccl1", "fm_only": True},
                           ROOT / "dist_nccl")[0]
        report = compare_steps("fm", nccl, ref)
        print("FM step in a one-rank NCCL group against one process " + json.dumps(
            {"backend": nccl["backend"], "device": nccl["device"], **report, "card": card}))
        if nccl["backend"] != "nccl" or nccl["fm"]["launches"] != (3, 3) or not report["ok"]:
            raise AssertionError(f"the one-rank NCCL group ran {nccl['backend']}, {report}")
    return {side: ranks[0][side]["launches"] for side in expected}


def dist_trainer_rank(spec: dict) -> dict:
    """`bin/pretrain.py` in this rank (it joins the group from torchrun's
    environment), with every checkpoint write and every all-reduce's span
    on the card recorded, step by step, and the last step's device time by
    family (torch.profiler)."""
    writes, spans, backends, marks, last = [], [], set(), [], {}
    save, all_reduce, step = ckpt.save_checkpoint, torch.distributed.all_reduce, pretrain.fm_train_step

    def recording(filename, *args, **kwargs):
        writes.append(Path(filename).name)
        return save(filename, *args, **kwargs)

    def timed(tensor, *args, **kwargs):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        work = all_reduce(tensor, *args, **kwargs)
        stop.record()
        spans.append((tensor.numel(), start, stop))
        backends.add(torch.distributed.get_backend())
        return work

    def marked(*args, **kwargs):
        marks.append(len(spans))
        if len(marks) < spec["steps"]:
            return step(*args, **kwargs)
        last["families"] = device_families(lambda: last.update(out=step(*args, **kwargs)))[0]
        return last["out"]

    ckpt.save_checkpoint, torch.distributed.all_reduce = recording, timed
    pretrain.fm_train_step = marked
    fused.launches = fused.adjoint_launches = 0
    history = pretrain.run(pretrain.get_parser().parse_args(spec["argv"]))
    torch.cuda.synchronize()
    ms = [(n, a.elapsed_time(b)) for n, a, b in spans]
    per_step = [ms[i:j] for i, j in zip(marks, marks[1:] + [len(ms)])]
    return {"writes": writes, "history": history,
            "launches": (fused.launches, fused.adjoint_launches),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "backend": ",".join(sorted(backends)),
            "all_reduce_by_step": [{"gradient_buckets_ms": sum(t for n, t in s if n >= 1 << 20),
                                    "small_ms": sum(t for n, t in s if n < 1 << 20),
                                    "calls": len(s)} for s in per_step],
            "last_step_device_ms_by_family": last["families"]}


def data_parallel_trainer(card: str, root: Path) -> dict:
    """Phase 16c: `bin/pretrain.py` as 2 processes (global batch 16, 8 per
    rank, 1 epoch of 96 recordings: 6 steps), as torchrun would start them;
    returns the per-rank launches."""
    recs = read_recording_manifest(root / "train" / "recordings.jsonl.gz")[:96]
    manifest = root / "dist_train.jsonl.gz"
    write_recording_manifest(recs, manifest)
    exp = root / "exp_dist"
    device = "cuda" if torch.cuda.device_count() >= DIST_WORLD else "cuda:0"
    argv = ["--model-name", "mel_24k_base", "--batch-size", str(DIST_BATCH), "--duration", "1.5",
            "--num-epochs", "1", "--num-workers", "4", "--seed", "0", "--save-every-n", "3",
            "--keep-last-k", "1", "--average-period", "2", "--log-interval", "2",
            "--valid-interval", "0", "--device", device, "--exp-dir", str(exp),
            "--tensorboard", "false", "--train-recordings", str(manifest)]
    steps = len(recs) // DIST_BATCH
    start = time.perf_counter()
    ranks = spawn_ranks(DIST_WORLD, "dist_trainer_rank",
                        {"group": "trainer", "argv": argv, "steps": steps},
                        root / "dist_trainer_out")
    wall_s = time.perf_counter() - start
    # medians over the steps after the first two, as the trainer phase's;
    # the last step ran under the profiler and is left out of the times
    ms = [statistics.median([h["ms"] for h in r["history"][2:-1]]) for r in ranks]
    per_step = [{k: statistics.median(s[k] for s in r["all_reduce_by_step"][2:-1])
                 for k in ("gradient_buckets_ms", "small_ms", "calls")} for r in ranks]
    # busy: the rank's own work; NCCL's kernels also count their waits
    device_ms = [sum(v for k, v in r["last_step_device_ms_by_family"].items()
                     if k != NCCL_FAMILY) for r in ranks]
    files = sorted(p.name for p in exp.rglob("*") if p.is_file())
    report = {"config": "mel_24k_base", "processes": DIST_WORLD, "backend": ranks[0]["backend"],
              "device": device, "global_batch": DIST_BATCH, "seconds_per_item": 1.5,
              "steps": steps, "loss_curve": [h["loss"] for h in ranks[0]["history"]],
              "step_ms_median_per_rank": ms,
              "audio_s_per_wall_s": DIST_BATCH * 1.5 / max(ms) * 1e3,
              "peak_memory_gb_per_rank": [r["peak_gb"] for r in ranks],
              "all_reduce_per_step_per_rank": per_step,
              "device_ms_per_step_per_rank": device_ms,
              "device_busy_share_per_rank": [d / m for d, m in zip(device_ms, ms)],
              "device_ms_by_family_per_rank": [r["last_step_device_ms_by_family"] for r in ranks],
              "launches_per_rank": [r["launches"] for r in ranks],
              "writes_per_rank": [r["writes"] for r in ranks], "files": files,
              "run_wall_s": wall_s, "card": card}
    print("data-parallel trainer " + json.dumps(report))
    logs = [f for f in files if f.startswith("log-train")]
    if ([len(r["history"]) for r in ranks] != [steps] * DIST_WORLD
            or any([h["loss"] for h in r["history"]] != report["loss_curve"] for r in ranks)
            or not all(math.isfinite(x) for x in report["loss_curve"])
            or [r["launches"] for r in ranks] != [(3 * steps, 3 * steps)] * DIST_WORLD
            or ranks[0]["writes"] != ["epoch-0.pt", "checkpoint-3.pt", "checkpoint-6.pt",
                                      "epoch-1.pt"]
            or any(r["writes"] for r in ranks[1:]) or len(logs) != 1):
        raise AssertionError(f"the data-parallel trainer: {report}")
    shutil.rmtree(exp, ignore_errors=True)
    return {"steps": steps, "launches": ranks[0]["launches"]}


# ------------------------------------------------------------- resume (17)


def _rel_dist(a: dict, b: dict) -> float:
    return _norm([a[k].double() - b[k].double() for k in b]) / _norm([v.double() for v in b.values()])


def resume_runs(root: Path, module, name: str, argv: list, resume_at: int) -> dict:
    """`module` run straight twice (the card's run-to-run spread) and once
    resumed with --resume-from checkpoint-<resume_at>.pt of the first;
    returns the three runs' histories and final "model" entries, and the
    checkpoint resumed from. Each run's directory (several GB of
    checkpoints) is deleted once read."""
    out = {}
    start = root / f"resume_{name}_from.pt"
    for run in ("straight", "again", "resumed"):
        exp = root / f"resume_{name}_{run}"
        shutil.rmtree(exp, ignore_errors=True)
        extra = ["--resume-from", str(start)] if run == "resumed" else []
        history = module.run(module.get_parser().parse_args(argv + ["--exp-dir", str(exp), *extra]))
        out[run] = {"history": history, "model": ckpt.load_checkpoint(exp / "epoch-1.pt")["model"]}
        if run == "straight":
            shutil.copy(exp / f"checkpoint-{resume_at}.pt", start)
        shutil.rmtree(exp, ignore_errors=True)
    out["from"] = {k: v for k, v in ckpt.load_checkpoint(start).items()
                   if k in ("sampler", "train_disc", "batch_idx_train")}
    start.unlink()
    return out


def resume_phase(card: str, root: Path, averaged: Path) -> None:
    """Phase 17: bin/pretrain.py for 4 steps (1 epoch of 64 recordings at
    batch 16), and bin/finetune.py at 4 Euler steps for 4 batches (D, D, G,
    D) with --freeze-modules cond_encoder, each resumed from its mid-epoch
    checkpoint-2.pt, against the straight run: within 4 times the card's
    run-to-run spread of two straight runs (the card's float sums are not
    bitwise repeatable). The frozen tensors stay bitwise unchanged."""
    recs = read_recording_manifest(root / "train" / "recordings.jsonl.gz")[:64]
    manifest = root / "resume_train.jsonl.gz"
    write_recording_manifest(recs, manifest)
    common = ["--model-name", "mel_24k_base", "--batch-size", "16", "--duration", "1.5",
              "--num-epochs", "1", "--num-workers", "4", "--seed", "0", "--save-every-n", "2",
              "--keep-last-k", "2", "--average-period", "2", "--log-interval", "2",
              "--valid-interval", "0", "--device", "cuda", "--tensorboard", "false",
              "--train-recordings", str(manifest)]
    runs = {"pretrain": resume_runs(root, pretrain, "fm", common, 2),
            "finetune": resume_runs(root, finetune, "gan", common + [
                "--n-timesteps", str(GAN_STEPS), "--gen-start-batch-idx", "2",
                "--generator-model-path", str(averaged), "--freeze-modules", "cond_encoder"], 2)}
    report = {}
    for name, r in runs.items():
        sides = ["generator", "discriminator"] if name == "finetune" else [None]
        for side in sides:
            pick = (lambda m: m[side]) if side else (lambda m: m)
            spread = _rel_dist(pick(r["again"]["model"]), pick(r["straight"]["model"]))
            resumed = _rel_dist(pick(r["resumed"]["model"]), pick(r["straight"]["model"]))
            key = name + (f"_{side}" if side else "")
            report[key] = {"resumed_vs_straight": resumed, "straight_vs_straight": spread,
                           "limit": 4 * spread}
            if not resumed <= 4 * spread:
                raise AssertionError(f"{key}: the resumed run lies {resumed} from the straight "
                                     f"run, beyond 4 x the run-to-run spread {spread}")
        tail = [(h.get("side"), h["dl"]) for h in r["straight"]["history"][2:]]
        if [(h.get("side"), h["dl"]) for h in r["resumed"]["history"]] != tail or \
                [h["batch_idx_train"] for h in r["resumed"]["history"]] != [3, 4]:
            raise AssertionError(f"{name}: the resumed run did not continue the straight one")
    ft = runs["finetune"]
    init = torch.load(averaged, weights_only=True)
    frozen = [k for k in init if k.startswith("cond_encoder.")]
    unchanged = all(torch.equal(r["model"]["generator"][k], init[k]) for r in
                    (ft["straight"], ft["again"], ft["resumed"]) for k in frozen)
    moved = sum(not torch.equal(ft["straight"]["model"]["generator"][k], v)
                for k, v in init.items() if k not in frozen) / (len(init) - len(frozen))
    sides = "".join(h["side"] for h in ft["straight"]["history"])
    print("resume " + json.dumps({
        "config": "mel_24k_base", "batch": 16, "steps": 4, "resumed_from": "checkpoint-2.pt",
        "sampler": ft["from"]["sampler"]["dl_states"], "train_disc_restored": ft["from"]["train_disc"],
        "gan_sides": sides, **report, "frozen_tensors": len(frozen),
        "frozen_bitwise_unchanged": unchanged, "other_generator_tensors_moved_share": moved,
        "card": card}))
    if not (unchanged and frozen and moved > 0.9 and sides == "DDGD"
            and ft["from"]["train_disc"] is False):
        raise AssertionError("--freeze-modules cond_encoder or the D/G alternation failed")


# ----------------------------------------------------------- the token family (18)

TIE_TOL = 1e-5  # frames whose best two token scores lie this close (of max|score|) may swap
TOKEN_STEPS = 8  # bin/pretrain.py on token_24k_base: one epoch of half the corpus at batch 16
TOKEN_GAN_SIDES = "DDGDGDGD"  # bin/finetune.py on it: 8 batches, 2 D-only


def tokens_agree(ours: torch.Tensor, ref: torch.Tensor, scores: torch.Tensor) -> dict:
    """Token ids equal but on near-ties, frames whose best two of the
    reference `scores` (B, T, K) lie within TIE_TOL of max|score|; those are
    fewer than 1% of the frames and counted."""
    two = scores.double().topk(2, dim=-1, largest=False).values
    tie = (two[..., 1] - two[..., 0]) <= TIE_TOL * scores.abs().max().item()
    differ = ours.cpu() != ref.cpu()
    out = {"frames": tie.numel(), "near_ties": int(tie.sum()), "ids_differ": int(differ.sum())}
    if (differ & ~tie).any() or tie.float().mean().item() >= 0.01:
        raise AssertionError(f"tokens disagree beyond the near-ties: {out}")
    return out


def token_codebook(card: str, root: Path) -> Path:
    """18a: `bin/train_tokenizer.py` (vocab 1024) on phase 10's corpus, its
    mels on the card, k-means on the CPU; then its tokens on the card against
    the CPU tokenizer's, with the tie rule. Returns the codebook's path."""
    out = root / "tokens" / "codebook.npz"
    start = time.perf_counter()
    train_tokenizer.main(["--model-name", "token_24k_base", "--recordings",
                          str(root / "train" / "recordings.jsonl.gz"), "--output", str(out),
                          "--max-frames", "16384", "--iters", "6", "--device", "cuda"])
    fit_s = time.perf_counter() - start
    cpu_tok = MelKMeansTokenizer.from_file(out, expect_config=get_generator_config("token_24k_base"))
    card_tok = copy.deepcopy(cpu_tok).cuda()
    audio = torch.from_numpy(voiced(np.random.RandomState(31), 16, 24000))
    with torch.inference_mode():
        ids_card = card_tok(audio.cuda())
        mel = cpu_tok.mel_fn(audio)
        ids_cpu, scores = cpu_tok.quantize(mel), cpu_tok.scores(mel)
    agree = tokens_agree(ids_card, ids_cpu, scores)
    print("token codebook " + json.dumps({
        "config": "token_24k_base", "vocab": cpu_tok.vocab_size, "fit_frames": 16384,
        "iters": 6, "fit_wall_s": fit_s, "ids_used_of_1024": len(ids_cpu.unique()),
        "card_vs_cpu_tokens": agree, "card": card}))
    return out


def token_serving(card: str, codebook: Path) -> dict:
    """18b: token_24k_base served through `get_model(tokenizer=...)` at batch
    16 x 94 frames of ids in host memory, 1/2/4 steps: the launches (3 per
    Euler step), ms per call and x-real-time in turns with mel_24k_base's,
    card against CPU through infer_from_noise, and `reconstruct`. Returns the
    launches of the serving calls and of `reconstruct`."""
    model = get_model("token_24k_base", device="cuda", seed=0, tokenizer=codebook)
    ids = np.random.RandomState(0).randint(0, 1024, (16, 94))
    fused.launches = fused.adjoint_launches = 0
    for n in (1, 2, 4):
        before = fused.launches
        wav = model.infer(ids, n_timesteps=n)
        torch.cuda.synchronize()
        if wav.shape != (16, 24064) or not torch.isfinite(wav).all():
            raise AssertionError(f"token {n}-step output {tuple(wav.shape)} not finite (16, 24064)")
        if fused.launches - before != 3 * n:
            raise AssertionError(f"token {n}-step call launched the kernel "
                                 f"{fused.launches - before} times, expected {3 * n}")
    launches = {"serving": (fused.launches, fused.adjoint_launches)}
    if fused.adjoint_launches:
        raise AssertionError(f"token serving launched the adjoint {fused.adjoint_launches} times")
    print(f"token serving: token_24k_base infer at 1/2/4 steps, batch 16, fused_istft launches "
          f"{launches['serving'][0]}")

    mel_model = get_model("mel_24k_base", device="cuda", seed=0)
    mel = torch.from_numpy(np.random.RandomState(0).randn(16, 100, 94).astype(np.float32))
    audio_s = 16 * 24064 / 24000
    one_step = {}
    for n in (1, 2, 4):
        row = {"n_timesteps": n, "batch": 16, "frames": 94, "audio_s": audio_s, "card": card}
        for name, fn in (("mel_24k_base", lambda: mel_model.infer(mel, n_timesteps=n)),
                         ("token_24k_base", lambda: model.infer(ids, n_timesteps=n)),
                         ("mel_24k_base_again", lambda: mel_model.infer(mel, n_timesteps=n)),
                         ("token_24k_base_again", lambda: model.infer(ids, n_timesteps=n))):
            ms = time_calls(fn)
            med = statistics.median(ms)
            row[name] = {"calls": len(ms), "ms_median": med, "ms_min": min(ms), "ms_max": max(ms),
                         "x_real_time_median": audio_s / med * 1e3}
            if n == 1:
                one_step.setdefault(name.removesuffix("_again"), []).append(med)
        print("token serving timing " + json.dumps(row))
    # one 1-step call of each, device time by family
    profile_one_call(card, mel_model, mel, statistics.mean(one_step["mel_24k_base"]), "f32_mel")
    profile_one_call(card, model, ids, statistics.mean(one_step["token_24k_base"]), "f32_token")
    del mel_model

    cpu = get_model("token_24k_base", device="cpu", seed=0).module
    rng = np.random.RandomState(2)
    cond = torch.from_numpy(rng.randint(0, 1024, (2, 94)))
    noise = torch.from_numpy((0.1 * rng.randn(2, 24064)).astype(np.float32))
    for n in (1, 2, 4):
        with torch.inference_mode():
            before = fused.launches
            a = model.module.infer_from_noise(noise.cuda(), cond.cuda(), n_timesteps=n).cpu()
            if fused.launches - before != 3 * n:
                raise AssertionError("the token card run did not go through the kernel")
            b = cpu.infer_from_noise(noise, cond, n_timesteps=n)
        rel = (a - b).abs().max().item() / b.abs().max().item()
        print(f"token card vs CPU {n} step(s), batch 2: max_rel_err={rel:.3e}")
        if not rel <= CARD_VS_CPU_TOL:
            raise AssertionError(f"token_24k_base: card and CPU disagree at {n} steps: {rel}")

    fused.launches = fused.adjoint_launches = 0
    wav = model.reconstruct(0.1 * torch.randn(4, 24000, generator=torch.Generator().manual_seed(3)),
                            n_timesteps=1)
    torch.cuda.synchronize()
    launches["reconstruct"] = (fused.launches, fused.adjoint_launches)
    if wav.shape != (4, 24064) or not torch.isfinite(wav).all() or launches["reconstruct"] != (3, 0):
        raise AssertionError(f"token reconstruct gave {tuple(wav.shape)}, launches "
                             f"{launches['reconstruct']}")
    print(f"token reconstruct: (4, 24000) waveform -> tokens -> {tuple(wav.shape)}, finite, "
          f"3 launches")
    return launches


def token_trainer(card: str, root: Path, codebook: Path) -> tuple:
    """18d: `bin/pretrain.py --model-name token_24k_base --tokenizer` for 8
    steps at batch 16 x 1.5 s on half of phase 10's corpus, every step's
    launches checked; then its average. Returns the launches over the run
    and the averaged model's path."""
    exp = root / "tokens" / "exp_fm"
    args = pretrain.get_parser().parse_args([
        "--model-name", "token_24k_base", "--tokenizer", str(codebook), "--batch-size", "16",
        "--duration", "1.5", "--num-epochs", "1", "--num-workers", "4", "--seed", "0",
        "--save-every-n", "1000", "--average-period", "4", "--log-interval", "4",
        "--valid-interval", "4", "--device", "cuda", "--exp-dir", str(exp),
        "--tensorboard", "false", "--train-recordings", str(root / "train_half.jsonl.gz"),
        "--valid-recordings", str(root / "valid" / "recordings.jsonl.gz")])
    torch.cuda.reset_peak_memory_stats()
    fused.launches = fused.adjoint_launches = 0
    start = time.perf_counter()
    history, calls = run_counting_steps(pretrain, "fm_train_step", args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = {"forward": fused.launches, "adjoint": fused.adjoint_launches}
    steps = len(history)
    if steps != TOKEN_STEPS or {c[1:] for c in calls} != {(3, 3)} or len(calls) != steps or \
            launches != {"forward": 3 * (steps + 2), "adjoint": 3 * steps}:
        raise AssertionError(f"token trainer: {steps} steps, per step {calls}, in all {launches}")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite token training loss: {losses}")
    ms = [h["ms"] for h in history[2:]]
    med = statistics.median(ms)
    print("token trainer " + json.dumps({
        "config": "token_24k_base", "batch": 16, "seconds_per_item": 1.5, "steps": steps,
        "launches_per_step": calls[0][1:], "loss_curve": losses,
        "clip_scale": [h["clip_scale"] for h in history], "first_step_ms": history[0]["ms"],
        "step_ms_median": med, "step_ms_min": min(ms), "step_ms_max": max(ms),
        "audio_s_per_wall_s": 16 * 1.5 / med * 1e3,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "run_wall_s": wall_s,
        "launches": launches, "card": card}))
    averaged = save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "1", "--avg", "1"])
    for path in exp.glob("*.pt"):
        if path != averaged:
            path.unlink()
    profile_train_step(card, med, tokenizer=MelKMeansTokenizer.from_file(codebook))
    return launches, averaged


def token_finetune(card: str, root: Path, codebook: Path, averaged: Path) -> dict:
    """18e: `bin/finetune.py --tokenizer` on token_24k_base at 4 Euler steps,
    batch 16 x 1.5 s, from 18d's average, 8 batches (2 D-only); every step's
    launches checked: D 12 forward, G 12 forward and 12 adjoint."""
    exp = root / "tokens" / "exp_gan"
    args = finetune.get_parser().parse_args([
        "--model-name", "token_24k_base", "--tokenizer", str(codebook),
        "--n-timesteps", str(GAN_STEPS), "--batch-size", "16", "--duration", "1.5",
        "--num-epochs", "1", "--num-workers", "4", "--seed", "0", "--gen-start-batch-idx", "2",
        "--save-every-n", "1000", "--keep-last-k", "1", "--average-period", "4",
        "--log-interval", "4", "--valid-interval", "0", "--device", "cuda",
        "--exp-dir", str(exp), "--generator-model-path", str(averaged), "--tensorboard", "false",
        "--train-recordings", str(root / "train_half.jsonl.gz")])
    torch.cuda.reset_peak_memory_stats()
    fused.launches = fused.adjoint_launches = 0
    history, calls = run_counting_steps(finetune, "make_gan_steps", args)
    torch.cuda.synchronize()
    n = 3 * GAN_STEPS
    sides = "".join(h["side"] for h in history)
    per_kind = {kind: sorted({(f, b) for k, f, b in calls if k == kind}) for kind in ("D", "G")}
    g_steps = sides.count("G")
    by_kind = launches_by_kind(calls)
    launches = {"forward": fused.launches, "adjoint": fused.adjoint_launches,
                "d_steps": by_kind["D"], "g_steps": by_kind["G"]}
    if sides != TOKEN_GAN_SIDES or per_kind != {"D": [(n, 0)], "G": [(n, n)]} or \
            launches["forward"] != n * len(calls) or launches["adjoint"] != n * g_steps:
        raise AssertionError(f"token fine-tuner: sides {sides}, per step {per_kind}, {launches}")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite token GAN loss: {losses}")
    ms = {side: [h["ms"] for h in history if h["side"] == side][1:] for side in ("D", "G")}
    print("token fine-tuner " + json.dumps({
        "config": "token_24k_base", "n_timesteps": GAN_STEPS, "batch": 16,
        "seconds_per_item": 1.5, "sides": sides,
        "loss_d": [h["loss"] for h in history if h["side"] == "D"],
        "loss_g": [h["loss"] for h in history if h["side"] == "G"],
        "d_step_ms_median": statistics.median(ms["D"]), "g_step_ms_median": statistics.median(ms["G"]),
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
        "card": card}))
    shutil.rmtree(exp, ignore_errors=True)
    return launches


def token_clis(card: str, root: Path, codebook: Path, averaged: Path) -> dict:
    """18f: `bin/infer --tokenizer` over phase 14's manifest, and
    `bin/infer_dir` on its wavs with `--tokenizer` and on their tokens
    (.npy, from the codebook on the card) with `--tokens true`, whole and in
    50-frame chunks; checked as phase 14 checks the mel CLIs, and each token
    run against the wav run that tokenized the same audio. Returns each
    run's launches (forward, adjoint)."""
    cli, out = root / "cli", root / "tokens" / "cli"
    recs = read_recording_manifest(cli / "recordings.jsonl.gz")
    common = ["--model-name", "token_24k_base", "--checkpoint", str(averaged), "--device", "cuda"]
    launches = {}
    fused.launches = fused.adjoint_launches = 0
    written = infer.main([*common, "--tokenizer", str(codebook),
                          "--recordings", str(cli / "recordings.jsonl.gz"),
                          "--root-path", str(root / "valid"), "--output-dir", str(out / "infer"),
                          "--batch-size", "4", "--num-workers", "2"])
    launches["infer"] = (fused.launches, fused.adjoint_launches)
    for rec, path in zip(recs, written):
        got, sr = read_wav(path)
        if sr != 24000 or got.shape != (1, rec.num_samples) or not np.isfinite(got).all():
            raise AssertionError(f"bin/infer --tokenizer wrote {path} at {sr} Hz, shape {got.shape}")
    if len(written) != len(recs) or launches["infer"] != (3 * 2, 0):  # 6 files in batches of 4
        raise AssertionError(f"bin/infer --tokenizer: {len(written)} files, {launches['infer']} launches")
    tok = MelKMeansTokenizer.from_file(codebook).cuda()
    (out / "ids").mkdir(parents=True, exist_ok=True)
    for wav in sorted((cli / "wavs").glob("*.wav")):
        with torch.inference_mode():
            ids = tok(torch.from_numpy(read_wav(wav)[0]).cuda())
        np.save(out / "ids" / (wav.stem + ".npy"), ids.cpu().numpy())
    runs = {}
    for name, flags in (("wav", ["--input-dir", str(cli / "wavs"), "--tokenizer", str(codebook)]),
                        ("tokens", ["--input-dir", str(out / "ids"), "--tokens", "true"])):
        for chunked, extra in ((False, []), (True, ["--chunk-size", "50"])):
            key = f"infer_dir_{name}" + ("_chunked" if chunked else "")
            fused.launches = fused.adjoint_launches = 0
            runs[key] = infer_dir.main([*common, *flags, "--output-dir", str(out / key), *extra])
            launches[key] = (fused.launches, fused.adjoint_launches)
    frames = 48000 // 256 + 1  # 2 s files
    chunks = -(-frames // 50)
    if any(launches[k] != (3 * 4 * (chunks if k.endswith("chunked") else 1), 0) for k in runs):
        raise AssertionError(f"token bin/infer_dir launches {launches}")
    diffs = []
    for name in ("wav", "tokens"):
        for whole, chunked, from_wav in zip(runs[f"infer_dir_{name}"],
                                            runs[f"infer_dir_{name}_chunked"],
                                            runs["infer_dir_wav"]):
            a, b, w = read_wav(whole)[0], read_wav(chunked)[0], read_wav(from_wav)[0]
            if not (a.shape == b.shape == (1, frames * 256) and np.isfinite(a).all()
                    and np.isfinite(b).all()):
                raise AssertionError(f"token bin/infer_dir wrote {a.shape} and {b.shape}")
            same = float(np.abs(a - w).max() / max(np.abs(w).max(), 1e-12))
            if same > CARD_VS_CPU_TOL:
                raise AssertionError(f"{whole.name}: the token file's output is {same} from the wav's")
            diffs.append({"mode": name, "file": whole.name,
                          "chunked_vs_whole_max_abs": float(np.abs(a - b).max()),
                          "chunked_vs_whole_rms": float(np.sqrt(np.mean((a - b) ** 2))),
                          "whole_rms": float(np.sqrt(np.mean(a ** 2))),
                          "vs_wav_mode_max_rel": same})
    print("token CLIs " + json.dumps({"infer_files": len(written), "infer_dir_files": 4,
                                      "launches": launches, "chunks_per_file": chunks,
                                      "outputs": diffs, "card": card}))
    return launches


def token_family(card: str, root: Path) -> dict:
    """Phase 18, the token family at full width: 18a-f. Returns each path's
    launches of both kernels."""
    codebook = token_codebook(card, root)
    serving = token_serving(card, codebook)
    fm_step = [grads_card_vs_cpu(card, "token_24k_base", seed, float64=True) for seed in (5, 6)]
    train_launches, averaged = token_trainer(card, root, codebook)
    gan = token_finetune(card, root, codebook, averaged)
    cli_launches = token_clis(card, root, codebook, averaged)
    shutil.rmtree(root / "tokens", ignore_errors=True)
    return {"serving": serving, "fm_step": fm_step, "train": train_launches, "gan": gan,
            "cli": cli_launches}


# ------------------------------------------------------- observability (19)

OBS_STEPS = 16  # one epoch of phase 10's corpus at batch 16
OBS_WINDOW = (10, 15)  # the global batches that --profile-dir traces


def _varint(buf: bytes, i: int):
    n = shift = 0
    while True:
        b = buf[i]
        n |= (b & 0x7F) << shift
        i, shift = i + 1, shift + 7
        if b < 0x80:
            return n, i


def _fields(buf: bytes):
    """(field number, value) of a protobuf message: ints, or bytes."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        wire = key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire in (1, 5):
            value, i = buf[i:i + (8 if wire == 1 else 4)], i + (8 if wire == 1 else 4)
        elif wire == 2:
            n, i = _varint(buf, i)
            value, i = buf[i:i + n], i + n
        else:
            raise AssertionError(f"protobuf wire type {wire}")
        yield key >> 3, value


def read_event_tags(path: Path) -> dict:
    """Each tag of a TensorBoard event file with the kinds of value written
    under it ("scalar", "image", "audio"): the TFRecord framing and both
    CRCs of every record checked, the first record the file version."""
    data, pos, tags, first = path.read_bytes(), 0, {}, True
    while pos < len(data):
        header = data[pos:pos + 8]
        n = struct.unpack("<Q", header)[0]
        body = data[pos + 12:pos + 12 + n]
        crcs = struct.unpack("<I", data[pos + 8:pos + 12]) + struct.unpack(
            "<I", data[pos + 12 + n:pos + 16 + n])
        if crcs != (utils_tb.masked_crc32c(header), utils_tb.masked_crc32c(body)):
            raise AssertionError(f"{path.name}: a record at byte {pos} fails its CRC")
        pos += 16 + n
        event = dict(_fields(body))
        if first and event.get(3) != b"brain.Event:2":
            raise AssertionError(f"{path.name} does not start with the file version")
        first = False
        for _, value in _fields(event.get(5, b"")):
            value = dict(_fields(value))
            kind = {2: "scalar", 4: "image", 6: "audio"}[next(k for k in value if k != 1)]
            tags.setdefault(value[1].decode(), set()).add(kind)
    return tags


def trace_launches(trace_dir: Path) -> tuple:
    """(forward, adjoint) kernel events in the one Chrome trace that
    --profile-dir wrote; the trace is deleted once read."""
    (path,) = trace_dir.glob("trace-*.json")
    events = json.loads(path.read_text())["traceEvents"]
    shutil.rmtree(trace_dir)
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    return (sum("fused_istft" in n and "fused_istft_adjoint" not in n for n in names),
            sum("fused_istft_adjoint" in n for n in names))


def trainer_log(exp: Path) -> list:
    """The messages of a trainer run's log file."""
    (path,) = (exp / "log").glob("log-train-*")
    return [line.split("] ", 1)[1] for line in path.read_text().splitlines() if "] " in line]


def check_env_info(card_name: str, *paths: Path) -> None:
    for path in paths:
        saved = ckpt.load_checkpoint(path)
        if saved["env_info"]["device-name"] != card_name or "best_valid_loss" not in saved:
            raise AssertionError(f"{path.name}: env_info {saved['env_info']}, keys {sorted(saved)}")


def window_launches(calls: list, kinds=("FM", "D", "G")) -> tuple:
    """(forward, adjoint) launches of the training steps of global batches
    OBS_WINDOW (the steps' calls are one per batch, in order; validation
    calls are left out)."""
    steps = [c for c in calls if c[0] in kinds]
    window = steps[OBS_WINDOW[0] - 1:OBS_WINDOW[1]]
    return sum(c[1] for c in window), sum(c[2] for c in window)


def observability_pretrain(card: str, root: Path, test: Path, base_step_ms: float) -> dict:
    """19a: bin/pretrain.py on mel_24k_base with --tensorboard, --test-recordings
    (4 files) at --save-infer-steps 1,2,4, --profile-dir and --inf-check for
    16 steps at batch 16 x 1.5 s, validating at batches 8 and 16 (outside
    the profiled window)."""
    exp, prof = root / "exp_obs", root / "obs_profile"
    args = pretrain.get_parser().parse_args([
        "--model-name", "mel_24k_base", "--batch-size", "16", "--duration", "1.5",
        "--num-epochs", "1", "--num-workers", "4", "--seed", "0", "--save-every-n", "8",
        "--keep-last-k", "1", "--average-period", "4", "--log-interval", "8",
        "--valid-interval", "8", "--device", "cuda", "--exp-dir", str(exp),
        "--train-recordings", str(root / "train" / "recordings.jsonl.gz"),
        "--valid-recordings", str(root / "valid" / "recordings.jsonl.gz"),
        "--test-recordings", str(test), "--save-infer-steps", "1,2,4",
        "--profile-dir", str(prof), "--inf-check", "true", "--tensorboard", "true"])
    fused.launches = fused.adjoint_launches = 0
    start = time.perf_counter()
    history, calls = run_counting_steps(pretrain, "fm_train_step", args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = (fused.launches, fused.adjoint_launches)
    # each validation: one batch of 16 (3 launches), then the 4 test files
    # synthesised at 1, 2 and 4 steps (3 launches a step)
    expected = (3 * OBS_STEPS + 2 * (3 + 3 * (1 + 2 + 4)), 3 * OBS_STEPS)
    if len(history) != OBS_STEPS or set(calls) != {("FM", 3, 3)} or launches != expected:
        raise AssertionError(f"19a: {len(history)} steps, {set(calls)}, launches {launches} "
                             f"against {expected}")
    window, traced = window_launches(calls), trace_launches(prof)
    if window != (18, 18) or traced != window:
        raise AssertionError(f"19a: the profiled window launched {window}, its trace holds {traced}")
    (events,) = (exp / "tensorboard").glob("events.out.tfevents.*")
    tags = read_event_tags(events)
    audio = {f"valid/test_audio_{i}_{k}" for i in range(4) for k in ("gt", "step_1", "step_2",
                                                                     "step_4")}
    want = {**{t: {"scalar"} for t in ("train/current_loss_0", "train/learning_rate",
                                       "train/tot_loss_0_loss", "train/valid_loss")},
            **{t: {"audio"} for t in audio}, **{f"{t}_spec": {"image"} for t in audio}}
    if tags != want:
        raise AssertionError(f"19a: event tags {sorted(tags)} against {sorted(want)}")
    check_env_info(torch.cuda.get_device_name(0), exp / "epoch-0.pt", exp / "epoch-1.pt",
                   exp / f"checkpoint-{OBS_STEPS}.pt")
    best = ckpt.load_checkpoint(exp / "epoch-1.pt")["best_valid_loss"]
    if not math.isfinite(best) or any(h["clip_scale"] != 1.0 for h in history):
        raise AssertionError(f"19a: best_valid_loss {best}, clip {[h['clip_scale'] for h in history]}")
    # the steps that write nothing: not the first two (allocation), not a
    # log, validation or checkpoint step (8, 16), not the profiled window
    quiet = [h["ms"] for h in history[2:] if h["batch_idx_train"] % 8
             and not OBS_WINDOW[0] <= h["batch_idx_train"] <= OBS_WINDOW[1]]
    shutil.rmtree(exp)
    out = {"steps": len(history), "launches": launches, "profiled_window": window,
           "trace_kernel_events": traced, "event_tags": len(tags), "best_valid_loss": best,
           "quiet_step_ms": quiet, "quiet_step_ms_median": statistics.median(quiet),
           "phase_10_step_ms_median": base_step_ms,
           "extra_ms_per_quiet_step": statistics.median(quiet) - base_step_ms,
           "run_wall_s": wall_s, "card": card}
    print("observability pretrain " + json.dumps(out))
    return out


def observability_inf_check(card: str, root: Path) -> tuple:
    """19b: 4 steps with --inf-check, the third batch's first row NaN: the
    step is clipped to zero, the warnings name the dominant gradients and
    the first module whose output was not finite, the replay does not
    fail, and training goes on."""
    recs = read_recording_manifest(root / "train" / "recordings.jsonl.gz")[:64]
    manifest = root / "obs_inf.jsonl.gz"
    write_recording_manifest(recs, manifest)
    exp = root / "exp_inf"
    args = pretrain.get_parser().parse_args([
        "--model-name", "mel_24k_base", "--batch-size", "16", "--duration", "1.5",
        "--num-epochs", "1", "--num-workers", "4", "--seed", "0", "--save-every-n", "1000",
        "--log-interval", "1", "--valid-interval", "0", "--device", "cuda", "--exp-dir", str(exp),
        "--tensorboard", "false", "--inf-check", "true", "--train-recordings", str(manifest)])
    step, seen = pretrain.fm_train_step, []

    def poisoned(model, optimizer, cond_fn, batch, *rest):
        seen.append(1)
        if len(seen) == 3:
            batch["audio"][0] = float("nan")
        return step(model, optimizer, cond_fn, batch, *rest)

    fused.launches = fused.adjoint_launches = 0
    pretrain.fm_train_step = poisoned
    try:
        history = pretrain.run(args)
    finally:
        pretrain.fm_train_step = step
    torch.cuda.synchronize()
    launches = (fused.launches, fused.adjoint_launches)
    log = trainer_log(exp)
    dominant = [m for m in log if m.startswith("Dominant grad: ")]
    modules = [m for m in log if m.startswith("The output of module ")]
    clips = [h["clip_scale"] for h in history]
    if (clips != [1.0, 1.0, 0.0, 1.0] or math.isfinite(history[2]["loss"])
            or not all(math.isfinite(h["loss"]) for h in history[3:])):
        raise AssertionError(f"19b: clip_scale {clips}, losses {[h['loss'] for h in history]}")
    first = "The output of module cond_encoder.in_proj is not finite"
    if not dominant or not modules or modules[0] != first or any("replay failed" in m for m in log):
        raise AssertionError(f"19b: warnings {dominant[:2]} {modules[:2]}")
    # 4 steps, and the replay's eval-form forward on the poisoned batch
    if launches != (3 * 4 + 3, 3 * 4):
        raise AssertionError(f"19b: launches {launches}")
    shutil.rmtree(exp)
    print("observability inf-check " + json.dumps({
        "clip_scale": clips, "dominant": dominant[:3], "first_module": modules[0],
        "modules_named": len(modules), "launches": launches, "card": card}))
    return launches


def diagnostics_tables(log: list) -> dict:
    """The number of tables of each kind that --print-diagnostics printed."""
    names = [m.split("]: ")[0][len("Diagnostics ["):] for m in log if m.startswith("Diagnostics [")]
    return {"forward": sum(not n.startswith("param/") and not n.endswith(".grad") for n in names),
            "output_grad": sum(n.endswith(".grad") for n in names),
            "param": sum(n.startswith("param/") and not n.endswith(".param_grad") for n in names),
            "param_grad": sum(n.endswith(".param_grad") for n in names),
            "scalar_histograms": sum(m.startswith("ScalarDiagnostics [") for m in log),
            "report_lines": sum(m.startswith("module=") for m in log)}


def observability_diagnostics(card: str, root: Path, module, argv: list, expected: tuple,
                              label: str) -> dict:
    """19c (and the fine-tuner's in 19d): --print-diagnostics at batch 4 x
    1 s: 5 batches, the tables, the PReLU histograms, exit; the tables of
    each kind counted, the pass's wall time and its launches."""
    exp = root / f"exp_diag_{label}"
    args = module.get_parser().parse_args(argv + [
        "--batch-size", "4", "--duration", "1.0", "--num-epochs", "1", "--num-workers", "4",
        "--seed", "0", "--save-every-n", "1000", "--log-interval", "1", "--valid-interval", "0",
        "--device", "cuda", "--exp-dir", str(exp), "--tensorboard", "false",
        "--print-diagnostics", "true",
        "--train-recordings", str(root / "train" / "recordings.jsonl.gz")])
    fused.launches = fused.adjoint_launches = 0
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    history = module.run(args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    launches = (fused.launches, fused.adjoint_launches)
    log = trainer_log(exp)
    tables = diagnostics_tables(log)
    if (len(history) != 5 or log[-1] != "Diagnostics done, exiting" or launches != expected
            or not all(tables.values()) or (exp / "epoch-1.pt").exists()):
        raise AssertionError(f"19 diagnostics {label}: {len(history)} batches, launches "
                             f"{launches} against {expected}, tables {tables}, last {log[-1:]}")
    shutil.rmtree(exp)
    out = {"trainer": label, "batches": len(history), "tables": tables, "run_wall_s": wall_s,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
           "card": card}
    print("observability diagnostics " + json.dumps(out))
    return out


def observability_finetune(card: str, root: Path, test: Path, averaged: Path) -> dict:
    """19d: bin/finetune.py at 4 Euler steps with the full discriminators
    for 16 batches (D-only to batch 2) with --tensorboard, --test-recordings,
    --profile-dir and --inf-check, every step's launches checked; then
    --print-diagnostics at batch 4."""
    exp, prof = root / "exp_obs_gan", root / "obs_gan_profile"
    args = finetune.get_parser().parse_args([
        "--model-name", "mel_24k_base", "--n-timesteps", str(GAN_STEPS), "--batch-size", "16",
        "--duration", "1.5", "--num-epochs", "1", "--num-workers", "4", "--seed", "0",
        "--gen-start-batch-idx", "2", "--save-every-n", "1000", "--keep-last-k", "1",
        "--average-period", "4", "--log-interval", "8", "--valid-interval", "8",
        "--device", "cuda", "--exp-dir", str(exp), "--generator-model-path", str(averaged),
        "--train-recordings", str(root / "train" / "recordings.jsonl.gz"),
        "--valid-recordings", str(root / "valid" / "recordings.jsonl.gz"),
        "--test-recordings", str(test), "--profile-dir", str(prof), "--inf-check", "true",
        "--tensorboard", "true"])
    fused.launches = fused.adjoint_launches = 0
    start = time.perf_counter()
    history, calls = run_counting_steps(finetune, "make_gan_steps", args)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - start
    n = 3 * GAN_STEPS
    per_kind = {kind: sorted({(f, b) for k, f, b in calls if k == kind}) for kind in ("D", "G", "eval")}
    counts = {kind: sum(k == kind for k, _, _ in calls) for kind in ("D", "G", "eval")}
    sides = "".join(h["side"] for h in history)
    # the test samples: 4 files at GAN_STEPS steps after each of 2 validations
    launches = (fused.launches, fused.adjoint_launches)
    expected = (n * len(calls) + 2 * n, n * counts["G"])
    if (sides != "DD" + "GD" * 7 or per_kind != {"D": [(n, 0)], "G": [(n, n)], "eval": [(n, 0)]}
            or counts["eval"] != 2 or launches != expected):
        raise AssertionError(f"19d: sides {sides}, per step {per_kind}, {counts}, launches "
                             f"{launches} against {expected}")
    window, traced = window_launches(calls), trace_launches(prof)
    if window != (6 * n, 3 * n) or traced != window:
        raise AssertionError(f"19d: the profiled window launched {window}, its trace holds {traced}")
    (events,) = (exp / "tensorboard").glob("events.out.tfevents.*")
    tags = read_event_tags(events)
    want_scalars = {f"train/{k}" for k in (*finetune._D_METRICS, *finetune._G_METRICS, "lr_d",
                                            "lr_g", "clip_scale", "valid_loss_g",
                                            "valid_mel_recon_loss")}
    audio = {f"valid/test_audio_{i}_{k}" for i in range(4) for k in ("gt", f"step_{GAN_STEPS}")}
    want = {**{t: {"scalar"} for t in want_scalars}, **{t: {"audio"} for t in audio},
            **{f"{t}_spec": {"image"} for t in audio}}
    if tags != want:
        raise AssertionError(f"19d: event tags {sorted(tags)} against {sorted(want)}")
    saved = ckpt.load_checkpoint(exp / "epoch-1.pt")["env_info"]
    if saved["device-name"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"19d: env_info {saved}")
    if not all(math.isfinite(h["loss"]) for h in history):
        raise AssertionError(f"19d: losses {[h['loss'] for h in history]}")
    shutil.rmtree(exp)
    by_kind = launches_by_kind(calls)
    out = {"batches": len(history), "sides": sides, "launches": launches,
           "d_steps": by_kind["D"], "g_steps": by_kind["G"], "validation": by_kind["eval"],
           "profiled_window": window, "trace_kernel_events": traced, "event_tags": len(tags),
           "clip_scale": [h["clip_scale"] for h in history], "run_wall_s": wall_s, "card": card}
    print("observability finetune " + json.dumps(out))
    # 5 diagnostics batches, D D G D G: each a step, an eval-form rollout
    # (n) and the G objective through the train-form rollout (n and n)
    diag = observability_diagnostics(
        card, root, finetune, ["--model-name", "mel_24k_base", "--n-timesteps", str(GAN_STEPS),
                               "--gen-start-batch-idx", "2", "--generator-model-path",
                               str(averaged)],
        (5 * 3 * n, 5 * n + 2 * n), "finetune")
    return {**out, "diagnostics": diag}


def observability(card: str, root: Path, averaged: Path, base_step_ms: float) -> dict:
    """Phase 19 on mel_24k_base, from phase 10's corpus and averaged model."""
    test = root / "obs_test.jsonl.gz"
    write_recording_manifest(read_recording_manifest(root / "valid" / "recordings.jsonl.gz")[:4],
                             test)
    pre = observability_pretrain(card, root, test, base_step_ms)
    inf = observability_inf_check(card, root)
    # 5 batches: each a step (3, 3), the eval-form loss (3) and the train-form
    # loss's forward and backward (3, 3)
    diag = observability_diagnostics(card, root, pretrain, ["--model-name", "mel_24k_base"],
                                     (5 * 9, 5 * 6), "pretrain")
    gan = observability_finetune(card, root, test, averaged)
    return {"pretrain": pre, "inf_check": inf, "diagnostics": diag, "finetune": gan}


def main() -> int:
    if sys.argv[1:]:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    # IEEE float32 for the plain iSTFT's matmuls from the first comparison
    # on; get_model would set the same
    disable_tf32()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    build = cuda_build.build("fused_istft")
    print(f"build: {build.path.name} in {build.seconds:.2f} s")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    print(f"bound_ms = max(spectrogram and waveform bytes / {HBM_BYTES_PER_S:.3g} B/s, FFT-form FLOP / "
          f"{FP32_FLOP_PER_S:.3g} FLOP/s): H100 SXM data sheet, HBM3 and FP32 on CUDA cores; "
          "matmul_ops_ms is the matmul form's FLOP at the same rate, not a bound")
    # what the timing harness reads for a kernel that does nearly nothing
    one = torch.zeros(1, device="cuda")
    floor_ms = statistics.median(device_ms(lambda: one.add_(1)))
    print(f"timing floor: a one-element add_ reads {floor_ms:.6f} ms")
    shapes = []
    for shape in MAIN_SHAPES:
        shapes.append(check_istft_shape(*shape, real_edges=True, timed=True))
        print("istft shape " + json.dumps(shapes[-1]))
    for shape in EDGE_SHAPES:
        print("istft edge " + json.dumps(check_istft_shape(*shape, timed=False)))
    adjoint_shapes = []
    for shape in MAIN_SHAPES + TRAIN_SHAPES:
        adjoint_shapes.append(check_adjoint_shape(*shape, timed=True))
        print("adjoint shape " + json.dumps(adjoint_shapes[-1]))
    for shape in TRAIN_SHAPES:
        print("adjoint vs float64 " + json.dumps(check_adjoint_float64(*shape)))
    for shape in EDGE_SHAPES:
        print("adjoint edge " + json.dumps(check_adjoint_shape(*shape[:5], timed=False)))
    reference_batches = {"istft": [], "adjoint": []}
    for shape in REFERENCE_BATCH_SHAPES:
        reference_batches["istft"].append(check_istft_shape(*shape, real_edges=True, timed=True))
        print("istft reference-batch shape " + json.dumps(reference_batches["istft"][-1]))
        reference_batches["adjoint"].append(check_adjoint_shape(*shape, timed=True))
        print("adjoint reference-batch shape " + json.dumps(reference_batches["adjoint"][-1]))
    for shape in GAN_SHAPES:
        print("istft GAN shape " + json.dumps(check_istft_shape(*shape, real_edges=True, timed=False)))
        print("adjoint GAN shape " + json.dumps(check_adjoint_shape(*shape, timed=False)))
    for shape in RANK_SHAPES:
        print("istft per-rank shape " + json.dumps(check_istft_shape(*shape, real_edges=True,
                                                                     timed=False)))
        print("adjoint per-rank shape " + json.dumps(check_adjoint_shape(*shape, timed=False)))

    model = get_model("mel_24k_base", device="cuda", seed=0)
    # the request's mel arrives in host memory, as a server receives it
    mel = torch.from_numpy(np.random.RandomState(0).randn(16, 100, 94).astype(np.float32))
    launches, wall_ms, launches44 = main_path(card, model, mel)
    card_vs_cpu()
    audio = 0.1 * torch.randn(4, 24000, generator=torch.Generator().manual_seed(3))
    wav = model.reconstruct(audio, n_timesteps=1)
    if wav.shape != (4, 24064) or not torch.isfinite(wav).all():
        raise AssertionError(f"reconstruct gave {tuple(wav.shape)}")
    print(f"reconstruct: (4, 24000) waveform -> {tuple(wav.shape)}, finite")
    profile_one_call(card, model, mel, wall_ms, "f32")
    bf16_launches = bf16_serving(card, model, mel)
    del model
    card44_launches = card_vs_cpu_44k(card)
    grads_card_vs_cpu(card)
    discriminators_card_vs_cpu(card)
    gan_grad_launches = gan_grads_card_vs_cpu(card)
    root = Path(__file__).resolve().parent / "build" / "smoke_train"
    train_launches, exp, averaged, train_step_ms = trainer(card, root)
    bf16_train_launches = bf16_trainer(card, root)
    cli_launches = clis(card, root, exp, averaged)
    for path in [*exp.glob("*.pt"), *(root / "exp_bf16").glob("*.pt")]:
        if path != averaged:
            path.unlink()  # several GB of FM checkpoints
    gan = gan_finetune(card, root, averaged)
    remat_launches = gan_step_profiles(card, averaged, gan["d_ms"], gan["g_ms"])
    gan_cli_launches = gan_clis(card, root, gan["exp"])
    shutil.rmtree(gan["exp"], ignore_errors=True)
    dp = data_parallel_steps(card)
    dp_train = data_parallel_trainer(card, root)
    resume_phase(card, root, averaged)
    tokens = token_family(card, root)
    obs = observability(card, root, averaged, train_step_ms)
    shutil.rmtree(root, ignore_errors=True)  # several GB of checkpoints
    dp_paths = {"fm_step_2_ranks_per_rank": 0, "gan_d_step_2_ranks_per_rank": 1,
                "gan_g_step_2_ranks_per_rank": 2,
                f"pretrain_2_ranks_{dp_train['steps']}_steps_per_rank": 3}
    dp_launches = [dp["fm"], dp["d"], dp["g"], dp_train["launches"]]
    # each token path's launches (forward, adjoint), as its run read them
    token_paths = {
        "token_serving_f32_1_2_4_steps": tokens["serving"]["serving"],
        "token_reconstruct_1_step": tokens["serving"]["reconstruct"],
        **{f"token_fm_step_card_vs_cpu_seed_{seed}": pair
           for seed, pair in zip((5, 6), tokens["fm_step"])},
        f"token_training_{TOKEN_STEPS}_steps": (tokens["train"]["forward"],
                                                tokens["train"]["adjoint"]),
        "token_finetune_4_steps_8_batches": (tokens["gan"]["forward"], tokens["gan"]["adjoint"]),
        "token_finetune_d_steps": tokens["gan"]["d_steps"],
        "token_finetune_g_steps": tokens["gan"]["g_steps"],
        **{f"token_cli_{k}": v for k, v in tokens["cli"].items()}}
    obs_paths = {
        f"observability_pretrain_{OBS_STEPS}_steps": obs["pretrain"]["launches"],
        "observability_pretrain_profiled_window_10_15": obs["pretrain"]["profiled_window"],
        "observability_inf_check_poisoned_4_steps": obs["inf_check"],
        "observability_diagnostics_pretrain_5_batches": obs["diagnostics"]["launches"],
        f"observability_finetune_{OBS_STEPS}_batches": obs["finetune"]["launches"],
        "observability_finetune_d_steps": obs["finetune"]["d_steps"],
        "observability_finetune_g_steps": obs["finetune"]["g_steps"],
        "observability_finetune_validation": obs["finetune"]["validation"],
        "observability_finetune_profiled_window_10_15": obs["finetune"]["profiled_window"],
        "observability_diagnostics_finetune_5_batches":
            obs["finetune"]["diagnostics"]["launches"]}

    step = shapes[:3]  # the three branches of one mel_24k_base Euler step
    train_step = adjoint_shapes[-3:]  # the three branches of one training step
    print(json.dumps({"kernels": [{
        "name": "fused_istft",
        "route": "cuda",
        "source": "flow2gan_tpu_torch/csrc/fused_istft.cu",
        "replaces": "flow2gan_tpu/ops/pallas_istft.py:240",
        "launches": launches,
        "launches_by_path": {
            "serving_f32_1_2_4_steps": launches, "serving_bf16_1_2_4_steps": bf16_launches,
            "serving_44k_1_step": launches44, "card_vs_cpu_44k_1_step": card44_launches,
            "training_f32_32_steps": train_launches["forward"],
            "training_bf16_8_steps": bf16_train_launches["forward"],
            **{f"cli_{k}": v for k, v in cli_launches.items()},
            "gan_d_objective_card_vs_cpu_1_step": gan_grad_launches["d"][0],
            "gan_g_objective_card_vs_cpu_1_step": gan_grad_launches["g"][0],
            "gan_finetune_4_steps_32_batches": gan["launches"]["forward"],
            "gan_finetune_d_steps": gan["launches"]["d_steps"][0],
            "gan_finetune_g_steps": gan["launches"]["g_steps"][0],
            "gan_finetune_validation": gan["launches"]["validation"][0],
            "gan_g_step_plain": remat_launches["plain"][0],
            "gan_g_step_remat_with_recompute": remat_launches["remat"][0],
            "cli_infer_load_gan_4_steps": gan_cli_launches,
            **{k: dp_launches[i][0] for k, i in dp_paths.items()},
            **{k: v[0] for k, v in token_paths.items()},
            **{k: v[0] for k, v in obs_paths.items()}},
        "max_abs_err": max(s["max_abs_err"] for s in shapes + reference_batches["istft"]),
        "max_rel_err": max(s["max_rel_err"] for s in shapes + reference_batches["istft"]),
        "ms": sum(s["ms"] for s in step),
        "plain_ms": sum(s["plain_ms"] for s in step),
        "bound_ms": sum(s["bound_ms"] for s in step),
        "bound_by": ("operations" if sum(s["ops_ms"] for s in step)
                     >= sum(s["bytes_ms"] for s in step) else "bytes"),
        "matmul_ops_ms": sum(s["matmul_ops_ms"] for s in step),
        "library_ms": sum(s["library_ms"] for s in step),
        "floor_ms": floor_ms,
        "per": "one mel_24k_base Euler step at batch 16: the sum over its three branch shapes",
        "shapes": shapes + reference_batches["istft"],
    }, {
        "name": "fused_istft_adjoint",
        "route": "cuda",
        "source": "flow2gan_tpu_torch/csrc/fused_istft.cu",
        "replaces": "flow2gan_tpu/ops/pallas_istft.py:222",
        "launches": train_launches["adjoint"],
        "launches_by_path": {"training_f32_32_steps": train_launches["adjoint"],
                             "training_bf16_8_steps": bf16_train_launches["adjoint"],
                             "gan_d_objective_card_vs_cpu_1_step": gan_grad_launches["d"][1],
                             "gan_g_objective_card_vs_cpu_1_step": gan_grad_launches["g"][1],
                             "gan_finetune_4_steps_32_batches": gan["launches"]["adjoint"],
                             "gan_finetune_d_steps": gan["launches"]["d_steps"][1],
                             "gan_finetune_g_steps": gan["launches"]["g_steps"][1],
                             "gan_finetune_validation": gan["launches"]["validation"][1],
                             "gan_g_step_plain": remat_launches["plain"][1],
                             "gan_g_step_remat": remat_launches["remat"][1],
                             **{k: dp_launches[i][1] for k, i in dp_paths.items()},
                             **{k: v[1] for k, v in token_paths.items()},
                             **{k: v[1] for k, v in obs_paths.items()}},
        "max_abs_err": max(s["max_abs_err"] for s in adjoint_shapes + reference_batches["adjoint"]),
        "max_rel_err": max(s["max_rel_err"] for s in adjoint_shapes + reference_batches["adjoint"]),
        "ms": sum(s["ms"] for s in train_step),
        "plain_ms": sum(s["plain_ms"] for s in train_step),
        "bound_ms": sum(s["bound_ms"] for s in train_step),
        "bound_by": ("operations" if sum(s["ops_ms"] for s in train_step)
                     >= sum(s["bytes_ms"] for s in train_step) else "bytes"),
        "library_ms": sum(s["library_ms"] for s in train_step),
        "floor_ms": floor_ms,
        "per": "one mel_24k_base training step at batch 16 x 1.5 s: the sum over its three branch shapes",
        "shapes": adjoint_shapes + reference_batches["adjoint"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
