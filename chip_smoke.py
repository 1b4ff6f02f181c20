"""Card check of the PyTorch port (`flow2gan_tpu_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card (sm_90a) and the
CUDA toolkit:

    python3 chip_smoke.py

It checks; `portbench/` measures. The only times it takes are each
hand-written kernel's alone (phases 3, 4, 23 and 24: its ms, its plain
version's, the library's where one exists, and the bound from
`portbench/yardstick.py`), since no benchmark cell times a kernel alone.

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line), and each followed by a line `phase <name> <seconds>`,
its wall time (phase 18 one such line for each of its parts):

1. the card (`nvidia-smi` name and power limit) and the torch / CUDA versions;
2. the build of `flow2gan_tpu_torch/csrc/fused_istft.cu` with nvcc and
   ptxas' register report;
3. the fused iSTFT kernel against its plain PyTorch version on the card at
   the six branch shapes of mel_24k_base and mel_44k_128band_512x_base
   (batch 16) and at edge shapes (among them spectra with nonzero imaginary
   parts at DC and Nyquist, mel_24k_tiny's (64, 32) branch and a 60 s clip);
   at the branch shapes its time, the plain version's, that of `torch.istft`
   (a yardstick the port never calls) and the bound, and the timing floor
   (what the same timing reads for a one-element `add_`);
4. the adjoint kernel (the iSTFT's backward) against its plain version at
   the same shapes and at the three branch shapes of a training step (batch
   16 x 1.5 s), with exactly zero imaginary parts at DC and Nyquist and the
   dot-product identity <istft(s), g> = <s, adjoint(g)> on the card; its
   time, the plain adjoint's, that of `torch.stft` (the same transform of
   the padded, enveloped gradient, up to the bin weights) and the bound; at
   the training shapes the kernel and the plain adjoint each against a
   float64 adjoint (numpy), the kernel's error at most twice the plain
   one's; then both kernels, checked and timed, at the reference's per-card
   batches (a training step's shapes at its FM batch of 256, a GAN rollout
   step's at its fine-tuning batch of 64), and checked at the GAN rollout
   and per-rank shapes;
5. the main path: `get_model("mel_24k_base")` and `infer` on a (16, 100, 94)
   mel at 1, 2 and 4 Euler steps (shape, finite, 3 launches of the kernel a
   step, no adjoint), and mel_44k_128band_512x_base once at 1 step;
6. card against CPU: the same weights and x0 through `infer_from_noise`;
7. `reconstruct` from a waveform;
8. (no longer run: a serving call's profile is `portbench/`'s traced run);
9. gradients, card against CPU: the FM loss of full mel_24k_base at batch
   2 x 1 s and every parameter's gradient, with the same weights and draws,
   and the launches of both kernels in that step; then, report only, the
   same step on the CPU in float64, and the card's and the CPU's float32
   gradients against it (whole and worst tensor, and the tensor that holds
   most of the card-vs-CPU gap);
10. the trainer: a synthetic 24 kHz corpus written under build/, the port's
   `bin/pretrain.py` run in-process on mel_24k_base (batch 16 x 1.5 s, 32
   steps): its launches, finite losses, peak memory; the checkpoints
   reloaded; `save_averaged_model` and a 1-step call served from the
   averaged weights;
11. bf16 serving: mel_24k_base with `compute_dtype="bfloat16"` on the seed
   weights of phase 5, at 1, 2 and 4 steps (launches), card bf16 against
   card float32 (report), card bf16 against CPU bf16 (the limit: 1/4 of the
   CPU's bf16 distance from float32, plus twice how far the CPU's bf16
   result moves when x0 moves by one float32 ulp), and one 1-step call's
   GEMMs by input dtype: some bf16, and no float32 but the STFT's six;
12. 44.1 kHz card against CPU: mel_44k_128band_512x_base, float32, 1 step;
13. bf16 training: `bin/pretrain.py --use-bf16` for 8 steps on half the
   corpus (launches of both kernels, finite and falling loss);
14. the CLIs: `bin/infer --epoch 2 --avg 1` over phase 10's checkpoints and
   a manifest of corpus files, `bin/infer_dir` on a directory of them, whole
   and in 50-frame chunks; lengths, finiteness, launches, chunked against
   whole, and the native WAV reader in use;
15. the GAN stage (stage 2), all on mel_24k_base with the full
   discriminators (periods 2-11, windows 2048/1024/512):
   a. both kernels against their plain versions at the rollout shapes of a
      fine-tuning batch (16 x 1.5 s: 141 mel frames, 36096 samples; in
      phase 4);
   b. the discriminators, card against CPU (batch 2 x 1 s, same weights):
      every score and feature map;
   c. the D and G objectives at 1 step, card against CPU (batch 2 x 1 s,
      same weights and draws): loss and the own side's gradients, and the
      launches (forward, adjoint): (3, 0) for D, (3, 3) for G;
   d. the fine-tuner: `bin/finetune.py` at 4 Euler steps, batch 16 x 1.5 s,
      from phase 10's averaged model on its corpus, a D-only warm-up of 4
      batches then D/G alternation, 32 batches with validation; the launches
      of every D, G and validation step, finite losses, both sides moved;
   e. (no longer run: the GAN steps' profiles are the GAN cell's);
   f. one 4-step G step with `--remat-rollout` and without: loss and
      gradients within 1e-6, and the forward launches of each (peak memory
      reported);
   g. `save_averaged_model --load-gan` on the fine-tuner's checkpoints and
      `bin/infer --load-gan` over corpus files at 4 steps;
16. data parallelism (`parallel/dist.py`), 2 ranks as spawned processes, at
   full mel_24k_base width with the full discriminators; one rank per card
   over NCCL where there are 2 cards, else both ranks on card 0 over gloo;
   both kernels against their plain versions at the per-rank shapes (batch
   8) in phase 4:
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
   c. `bin/pretrain.py` as 2 processes (global batch 16, 6 steps): equal
      finite losses on both ranks, both kernels' launches per rank, and
      that only rank 0 wrote checkpoints and a log;
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
      ids at 1, 2 and 4 steps: launches (3 per Euler step); card against
      CPU through infer_from_noise; `reconstruct` from a waveform;
   c. the FM loss and gradients card against CPU at batch 2 x 1 s: phase
      9's limits, but each tensor's 1e-2 plus four times how far the CPU's
      gradient of it moves when the parameters and x0 move by one float32
      ulp (as 15c holds the G side; the embedding's gradient is among the
      tensors), and (3, 3) launches;
   d. `bin/pretrain.py --tokenizer` for 8 steps at batch 16 x 1.5 s: every
      step's launches, finite losses;
   e. `bin/finetune.py --tokenizer` at 4 Euler steps from d's average, 8
      batches: every step's launches (D 12; G 12 and 12), finite losses;
      its two exports, as phase 20 checks them: the last weights equal
      epoch-1's generator bit for bit, the windowed average does not;
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
      name and `best_valid_loss` in every checkpoint;
   b. `--inf-check` with the third batch's first row NaN: that step
      clipped to zero, the dominant gradients and the first non-finite
      module output named, no failed replay, training going on;
   c. `--print-diagnostics` at batch 4 x 1 s: 5 batches, the tables of
      each kind counted, the launches;
   d. `bin/finetune.py` at 4 Euler steps with the full discriminators, 16
      batches with `--tensorboard`, `--test-recordings`, `--profile-dir`
      and `--inf-check` (every step's launches, the event file, the trace
      against the counted launches), then `--print-diagnostics` at batch 4;
20. the recipe, as a user runs it, at mel_24k_base on the card:
   `bin/make_synthetic_corpus` (16 train utterances x 2 s, 2 test, 1 dev),
   then `bash flow2gan_tpu_torch/recipes/run_libritts.sh` stages 1-6: the
   manifests, FM pretraining for one epoch at batch 8, the average,
   `--n-timesteps-list 1` GAN fine-tuning for one epoch at batch 4 after a
   2-batch D warm-up and its export, inference on the test split and both
   metric CLIs; every stage's exit code and artifacts (manifests,
   `epoch-*.pt`, `averaged.pt`, `generator.pt`, the WAVs, metric JSONs with
   n_files > 0 and finite values), `bin/collect_results`' `summary.json`;
   the GAN run exported again with `--use-averaged-model false` (the last
   weights, the second export of `recipes/drive_generalization.sh`): equal
   to epoch-1's generator bit for bit, and the windowed `generator.pt`
   not; the inference stage again in-process with the counters reset (its
   launches), then `bin/from_mel.py` and `bin/from_wav.py` on a test file,
   and `bash flow2gan_tpu_torch/recipes/infer_dir.sh` in its three modes
   (the test WAVs, that file's mel, the WAVs in streaming chunks) with the
   exported generator, each output checked;
21. the `kernels` JSON line (the fused iSTFT, its adjoint, phase 23's
   three ConvNeXt chain kernels and phase 24's four train-form kernels: each one's times at the shapes of one
   serving or training step and the shapes behind them, and its launches
   on the paths PERF.md's kernel table reads), then the card line and the
   result line;
22. (run after phase 12) `VocoderModel.infer`'s CUDA graphs: on a fresh model
   one eager call, one capture and four replays at other seeds, each output
   equal to the eager path's (`torch.equal`), for mel_44k_128band_512x_base
   at 1 step on the stream chunk (1, 128, 148), mel_24k_base at 1 and 4
   steps at batch 16, its bf16 build and token_24k_base; consecutive
   replays' outputs held apart; the profiler's `fused_istft` kernels in N
   replays 3 x steps x N, and `istft.launches` unchanged by them; the
   profiler's kernels in five replays against five eager calls, and a
   capture made under the profiler; a 30 s stream through `streaming_infer`
   against the eager stream, bit for bit, with the profiler's `fused_istft`
   kernels over it 3 x chunks; three keys captured in turn for three
   rounds, each output equal to eager, the allocator's reserved bytes not
   growing past the first round's (one capture stream and pool a model);
23. (run after phase 22) the ConvNeXt blocks' eval-form chain
   (`flow2gan_tpu_torch/csrc/convnext_chain.cu`): its build and ptxas'
   report; its three kernels against their plain versions at the main
   path's block shapes (bulk serving at batch 16, 101 and 872 mel frames:
   the three branches and the cond encoder; the stream's 148-frame chunk at
   batch 1), each with its ms, its plain version's and its byte bound at
   the yardstick's HBM rate, and at edges (a ragged mask, fewer frames than
   taps, one frame, a cond longer than needed, widths 48, 64 and 1024); one
   768-channel block's eval form against the eager chain, and the kernels
   one call runs (the chain's three beside the GEMMs: no bias pass); on a
   fresh model's first call 100 `convnext.fused_blocks` and no
   `convnext.eager_blocks` (mel_24k_base, 4 steps), 28 on the 44.1 kHz
   stream chunk, and 28 eager in bf16; each call against the eager chain;
   no depthwise conv kernel in a bulk call;
24. (run after phase 23) the ConvNeXt blocks' train form
   (`flow2gan_tpu_torch/csrc/convnext_chain_train.cu` through
   `ops/convnext_chain_train.py TrainChain`): its build and ptxas' report;
   its four kernels and the partials' float64 sums against their plain
   versions in float64 at the blocks
   of a training step at the FM cell's 256 rows (timed: each kernel's ms,
   its plain version's and its byte bound) and the GAN cell's 64 (1.5 s
   crops: the three branches and the cond encoder), and at edges (one
   frame, fewer frames than taps, widths 132, 1024 and 48, a longer cond);
   one 768-channel block's train form (gates on, limiters past their
   limits, a ragged mask) through the kernels and through the eager chain,
   each gradient against the block in float64, and the kernels one forward
   and backward runs (no depthwise conv); the counters over one
   `fm_train_step` (28 blocks through the Function, none eager) and one GAN
   D step (100 through the eval chain) and G step at 4 Euler steps with
   remat (100 through the Function and 96 recomputed, none eager).
"""

from __future__ import annotations

import collections
import contextlib
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

from flow2gan_tpu_torch import get_model, tracing, utils_tb
from flow2gan_tpu_torch.api import VocoderModel, init_weights
from flow2gan_tpu_torch.bin import (
    collect_results,
    finetune,
    from_mel,
    from_wav,
    infer,
    infer_dir,
    make_synthetic_corpus,
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
from flow2gan_tpu_torch.models.gan import make_mel_recon_fns
from flow2gan_tpu_torch.models import convnext
from flow2gan_tpu_torch.models.convnext import ConvNeXtBlock
from flow2gan_tpu_torch.models.generator import branch_dropout_weight
from flow2gan_tpu_torch.ops import convnext_chain as chain
from flow2gan_tpu_torch.ops import convnext_chain_train as train_chain
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
from flow2gan_tpu_torch.utils import disable_tf32, make_valid_mask
from portbench import yardstick

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
CHAIN_TOL = 1e-5  # the ConvNeXt chain's first kernel vs plain, relative to max|plain|
BLOCK_TOL = 1e-5  # a block's eval form, kernels vs eager chain, relative to max|eager|
# (label, batch, frames, channels, f, conditioned): the ConvNeXt blocks of
# the main path. Bulk serving, mel_24k_base at batch 16 and 101 and 872 mel
# frames: the three branches (cond at 1/f of their frame rate) and the cond
# encoder; the stream's 148-frame chunk of mel_44k_128band_512x_base at
# batch 1, the same
CHAIN_SHAPES = [
    *[(f"bulk_{m}_branch_{i}", 16, m * f + 1, ch, f, True)
      for m in (101, 872) for i, (ch, f) in enumerate(((768, 1), (512, 2), (384, 4)))],
    ("bulk_101_cond_encoder", 16, 101, 512, 1, False),
    ("bulk_872_cond_encoder", 16, 872, 512, 1, False),
    *[(f"stream_branch_{i}", 1, 148 * f + 1, ch, f, True)
      for i, (ch, f) in enumerate(((768, 1), (512, 2), (384, 4)))],
    ("stream_cond_encoder", 1, 148, 512, 1, False),
]
# (label, batch, frames, channels, f, conditioned, ragged): edges, untimed;
# ragged gives the rows masks of other lengths
CHAIN_EDGES = [
    ("ragged_mask", 5, 203, 512, 2, True, True),
    ("frames_below_taps", 3, 4, 768, 1, True, False),
    ("one_frame", 2, 1, 384, 4, True, True),
    ("odd_frames", 3, 1001, 384, 4, True, False),
    ("tiny_width_64", 2, 129, 64, 2, True, True),
    ("tiny_width_48", 2, 257, 48, 4, True, False),
    ("tiny_width_48_unconditioned", 2, 31, 48, 1, False, True),
    ("width_1024", 2, 97, 1024, 1, True, False),
]
# the train-form kernels against their plain versions in float64 on the
# card: each output's largest error over its largest value (the parameter
# sums add up to 144k rows in float32 a thread and a block, then float64),
# within this or within TRAIN_BLOCK_RATIO times the float32 plain version's
# own error, where a sum that nearly cancels (the log-scale's) puts that
# higher
TRAIN_CHAIN_TOL = 1e-5
# a block's train form through the kernels against float64 (the same block
# widened, eager autograd on the card), each gradient tensor's error over its
# norm: within this, or within TRAIN_BLOCK_RATIO times the eager float32
# chain's own error where a gradient that nearly cancels puts that higher
TRAIN_BLOCK_TOL = 2e-5
TRAIN_BLOCK_RATIO = 4.0
# (label, batch, frames, channels, f, conditioned, ragged): the ConvNeXt
# blocks of a training step at the cells' per-card batches, 1.5 s crops:
# FM at 256 rows (timed), the GAN at 64; the three branches and the cond
# encoder
TRAIN_CHAIN_SHAPES = [
    *[(f"{name}_branch_{i}", batch, frames, ch, f, True, batch == 64)
      for name, batch in (("fm", 256), ("gan", 64))
      for i, (frames, ch, f) in enumerate(((141, 768, 1), (282, 512, 2), (563, 384, 4)))],
    ("fm_cond_encoder", 256, 141, 512, 1, False, False),
    ("gan_cond_encoder", 64, 141, 512, 1, False, True),
]
TRAIN_CHAIN_EDGES = [
    ("one_frame", 3, 1, 384, 4, True, True),
    ("frames_below_taps", 2, 5, 768, 1, True, False),
    ("odd_width_132", 3, 97, 132, 2, True, True),
    ("width_1024", 2, 83, 1024, 1, True, False),
    ("tiny_width_48_unconditioned", 5, 31, 48, 1, False, True),
]
TRAIN_ARGS = ["--model-name", "mel_24k_base", "--batch-size", "16", "--duration", "1.5",
              "--num-epochs", "2", "--num-workers", "4", "--seed", "0", "--save-every-n", "16",
              "--keep-last-k", "1", "--average-period", "4", "--log-interval", "8",
              "--valid-interval", "16", "--device", "cuda", "--tensorboard", "false"]


class PhaseClock:
    """Prints `phase <name> <seconds>` as each phase ends: its wall time,
    from the end of the phase before (or the clock's start)."""

    def __init__(self):
        self.t = time.perf_counter()

    def done(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name} {now - self.t:.2f}")
        self.t = now


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def n_istft() -> int:
    """The fused iSTFT kernel's launches since the last `tracing.drain()`."""
    return tracing.counter("istft.launches")


def n_adjoint() -> int:
    """The adjoint kernel's launches since the last `tracing.drain()`."""
    return tracing.counter("istft.adjoint_launches")


@contextlib.contextmanager
def untraced():
    """The program's tracing off for a timing, then as it was."""
    was = tracing.enabled()
    tracing.disable()
    try:
        yield
    finally:
        if was:
            tracing.enable()


@untraced()
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


def bound_ms(kernel: str, n_fft, hop, batch, t_f, length) -> float:
    """The yardstick's least time in ms of `kernel` ("istft" or "adjoint")
    at one shape (`portbench/yardstick.py`: bytes against FFT-form
    operations at the data-sheet rates)."""
    bound_s = yardstick.istft_bound_s if kernel == "istft" else yardstick.adjoint_bound_s
    return 1e3 * bound_s(n_fft, batch, t_f, length)


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
    out = fused.fused_istft(spec, n_fft, hop, length=length)
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
            "ms": lambda: fused.fused_istft(spec, n_fft, hop, length=length),
            "plain_ms": lambda: fused.istft_plain(spec, n_fft, hop, length=length),
            "library_ms": library,
        }
        times = {key: [] for key in fns}
        # two interleaved rounds, so drift on the card falls on all three alike
        for key in [*fns, *reversed(fns)]:
            times[key] += device_ms(fns[key])
        row.update({key: statistics.median(v) for key, v in times.items()})
        bound = bound_ms("istft", n_fft, hop, batch, t_f, length)
        row.update(samples=len(times["ms"]), library_max_rel_err=lib_err, bound_ms=bound,
                   bound_share=bound / row["ms"])
    return row


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
    y = fused.fused_istft(spec, n_fft, hop, length=length).double()
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
        row.update({key: statistics.median(v) for key, v in times.items()})
        bound = bound_ms("adjoint", n_fft, hop, batch, t_f, length)
        row.update(samples=len(times["ms"]), library_max_rel_err=lib_err, bound_ms=bound,
                   bound_share=bound / row["ms"])
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


def eager_infer(vm: VocoderModel, cond, n: int, seed: int) -> torch.Tensor:
    """What `vm.infer(cond, n_timesteps=n, seed=seed)` computes eagerly, past
    its graph rule."""
    with torch.inference_mode():
        gen = torch.Generator(device=vm.device).manual_seed(seed)
        return vm.module.infer(vm._on_device(cond), n_timesteps=n, clamp_pred=True, generator=gen)


def main_path(model, mel) -> tuple:
    """Serve mel_24k_base at 1/2/4 steps and mel_44k_128band_512x_base at 1;
    returns the (forward, adjoint) launches of the three mel_24k_base calls."""
    tracing.drain()
    for n in (1, 2, 4):
        before = n_istft()
        wav = model.infer(mel, n_timesteps=n)
        torch.cuda.synchronize()
        if wav.shape != (16, 24064) or not torch.isfinite(wav).all():
            raise AssertionError(f"{n}-step output {tuple(wav.shape)} not finite (16, 24064)")
        if n_istft() - before != 3 * n:
            raise AssertionError(f"{n}-step call launched the kernel {n_istft() - before} "
                                 f"times, expected {3 * n}")
    launches = (n_istft(), n_adjoint())
    if n_adjoint():
        raise AssertionError(f"serving launched the adjoint {n_adjoint()} times")
    print(f"main path: mel_24k_base infer at 1/2/4 steps, batch 16, fused_istft launches "
          f"{launches[0]}")

    model44 = get_model("mel_44k_128band_512x_base", device="cuda", seed=0)
    mel44 = torch.from_numpy(np.random.RandomState(1).randn(16, 128, 87).astype(np.float32))
    tracing.drain()
    wav = model44.infer(mel44, n_timesteps=1)
    torch.cuda.synchronize()
    if wav.shape != (16, 44544) or not torch.isfinite(wav).all() or n_istft() != 3:
        raise AssertionError(f"44.1 kHz 1-step call: {tuple(wav.shape)}, {n_istft()} launches")
    print("44.1 kHz: mel_44k_128band_512x_base 1 step, batch 16, finite, 3 launches")
    return launches


def card_vs_cpu():
    gpu = get_model("mel_24k_base", device="cuda", seed=0).module
    cpu = get_model("mel_24k_base", device="cpu", seed=0).module
    rng = np.random.RandomState(2)
    cond = rng.randn(2, 100, 94).astype(np.float32)
    noise = (0.1 * rng.randn(2, 24064)).astype(np.float32)
    for n in (1, 2, 4):
        with torch.inference_mode():
            before = n_istft()
            a = gpu.infer_from_noise(torch.from_numpy(noise).cuda(), torch.from_numpy(cond).cuda(),
                                     n_timesteps=n).cpu()
            if n_istft() - before != 3 * n:
                raise AssertionError("card run did not go through the kernel")
            b = cpu.infer_from_noise(torch.from_numpy(noise), torch.from_numpy(cond), n_timesteps=n)
        abs_err = (a - b).abs().max().item()
        rel = abs_err / b.abs().max().item()
        print(f"card vs CPU {n} step(s), batch 2: max_abs_err={abs_err:.3e} max_rel_err={rel:.3e}")
        if not rel <= CARD_VS_CPU_TOL:
            raise AssertionError(f"card and CPU disagree at {n} steps: {rel}")


_GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")


def gemm_ops_by_dtype(fn) -> dict:
    """The matmul ops of fn() that ran a kernel on the card, counted by
    their first input's dtype as the profiler names it ("float",
    "c10::BFloat16"): the trace links a kernel to its op by "External id",
    and the op's "Input type" comes with record_shapes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    trace = TRACE_DIR / "gemms.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace))
    events = json.loads(trace.read_text())["traceEvents"]
    trace.unlink()
    ops = {e["args"]["External id"]: e["args"].get("Input type", ["?"])[0]
           for e in events if e.get("cat") == "cpu_op" and e.get("name") in _GEMM_OPS
           and "External id" in e.get("args", {})}
    ran = {e["args"]["External id"] for e in events
           if e.get("cat") == "kernel" and e.get("args", {}).get("External id") in ops}
    return dict(collections.Counter(ops[ext] for ext in ran))


def _dev_us(e):  # the attribute's name differs across torch versions
    return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)


def device_kernels(prof) -> list:
    """(device us, name, count) of each device operation's name in a
    profile, without the device-side copies of host annotations (the
    program's spans, with its tracing on)."""
    marks = {e.name() for e in prof.profiler.kineto_results.events()
             if e.is_user_annotation() and str(e.device_type()).endswith("CUDA")}
    return [(_dev_us(e), e.key, e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and _dev_us(e) > 0 and e.key not in marks]


@contextlib.contextmanager
def kernels_run():
    """A dict that gets, when the context closes, the device kernels the
    profiler saw run inside it, CUDA graph replays included: all of them
    (`kernels`), the count of each of the yardstick's families
    (`by_family`), and the fused iSTFT's (`forward`) and its adjoint's
    (`adjoint`)."""
    from torch.profiler import ProfilerActivity, profile

    runs = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield runs
        torch.cuda.synchronize()
    families = collections.Counter()
    for _, name, count in device_kernels(prof):
        families[yardstick.family(name)] += count
    runs.update(kernels=sum(families.values()), by_family=families,
                forward=families[yardstick.ISTFT], adjoint=families[yardstick.ADJOINT])


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
                      float64: str = None) -> None:
    """The FM loss and every parameter gradient of a full-width config
    (mel_24k_base, or token_24k_base on random token ids) at batch 2 x 1 s,
    card against CPU, with the same weights, t, x0, gates and branch
    weights drawn from `seed`; the step goes through both kernels three
    times each.

    With `float64` the CPU also runs the step in float64 (the same weights
    and inputs, widened), the exact gradient as far as float32 can tell,
    and the card's and the CPU's float32 gradients are reported against it
    on a line of their own. With `float64="check"` a tensor whose
    card-vs-CPU error misses GRAD_TENSOR_TOL still passes if the card holds
    that limit against the exact gradient and is as near it as the CPU: its
    error against float64 at most GRAD_TENSOR_TOL and at most
    GRAD_F64_RATIO times the CPU's. A gradient that nearly cancels (a
    BiasNorm's log_scale) can put the CPU's float32 far from the exact one.
    With `float64="report"` the limits are the float32 ones alone. The loss
    and the whole gradient keep their limits."""
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

    tracing.drain()
    loss_gpu, g_gpu = run(gpu, "cuda")
    launches = (n_istft(), n_adjoint())
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
    if float64 not in (None, "check", "report"):
        raise ValueError(f"float64 is None, 'check' or 'report', not {float64!r}")
    if float64:
        exact = copy.deepcopy(cpu).double()
        loss64, g64 = run(exact, "cpu", torch.float64)
        del exact
        card64, cpu64 = _rel_per_tensor(g_gpu, g64), _rel_per_tensor(g_cpu, g64)
        if float64 == "check":
            passes = {k: passes[k] or card64[k] <= min(GRAD_TENSOR_TOL, GRAD_F64_RATIO * cpu64[k])
                      for k in per}
        card_worst, cpu_worst = max(card64, key=card64.get), max(cpu64, key=cpu64.get)
        print("grads vs float64 " + json.dumps({
            "config": model_name, "seed": seed, "mode": float64,
            "whole_card_vs_f64": _rel_all(g_gpu, g64), "whole_cpu_vs_f64": _rel_all(g_cpu, g64),
            "worst_tensor_card_vs_f64": card64[card_worst], "its_name_card": card_worst,
            "worst_tensor_cpu_vs_f64": cpu64[cpu_worst], "its_name_cpu": cpu_worst,
            "largest_card_vs_cpu_error_tensor": largest,
            "its_card_vs_f64": card64[largest], "its_cpu_vs_f64": cpu64[largest], "card": card}))
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
    tracing.drain()
    history = pretrain.run(args)
    torch.cuda.synchronize()
    launches = {"forward": n_istft(), "adjoint": n_adjoint()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    steps = len(history)
    valid_batches = 2  # --valid-interval 16 over 32 steps, one batch of 16 each
    if steps != TRAIN_STEPS or launches != {"forward": 3 * (steps + valid_batches),
                                            "adjoint": 3 * steps}:
        raise AssertionError(f"trainer ran {steps} steps with launches {launches}")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    print("trainer " + json.dumps({
        "config": "mel_24k_base", "batch": 16, "seconds_per_item": 1.5, "steps": steps,
        "loss_curve": losses, "clip_scale": [h["clip_scale"] for h in history],
        "peak_memory_gb": peak_gb, "launches": launches, "card": card}))

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
    before = n_istft()
    wav = served.infer(mel, n_timesteps=1)
    torch.cuda.synchronize()
    if wav.shape != (16, 24064) or not torch.isfinite(wav).all() or n_istft() - before != 3:
        raise AssertionError(f"the averaged model served {tuple(wav.shape)} with "
                             f"{n_istft() - before} launches")
    print(f"trainer checkpoints: epoch-2 and checkpoint-{steps} reload; averaged model "
          f"{out.name} serves a 1-step call of {tuple(wav.shape)}, finite, 3 launches")
    return launches, exp, out


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
        tracing.drain()
        card16 = gpu.infer_from_noise(torch.from_numpy(x0).cuda(), cond.cuda()).cpu()
        if n_istft() != 3:
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


def bf16_serving(card: str, model32, mel) -> None:
    """mel_24k_base in bf16 at 1/2/4 steps: launches, card bf16 against card
    float32 and against the CPU, and one 1-step call's GEMMs by input dtype."""
    model16 = bf16_vocoder("cuda")
    tracing.drain()
    outs = {}
    for n in (1, 2, 4):
        before = n_istft()
        outs[n] = model16.infer(mel, n_timesteps=n)
        torch.cuda.synchronize()
        if outs[n].shape != (16, 24064) or not torch.isfinite(outs[n]).all():
            raise AssertionError(f"bf16 {n}-step output {tuple(outs[n].shape)} not finite (16, 24064)")
        if n_istft() - before != 3 * n:
            raise AssertionError(f"bf16 {n}-step call launched the kernel {n_istft() - before} "
                                 f"times, expected {3 * n}")
    if n_adjoint():
        raise AssertionError(f"bf16 serving launched the adjoint {n_adjoint()} times")
    print(f"bf16 serving: mel_24k_base infer at 1/2/4 steps, batch 16, fused_istft launches "
          f"{n_istft()}")
    for n in (1, 2, 4):
        with torch.inference_mode():
            ref = model32.infer(mel, n_timesteps=n)
        print(f"bf16 vs f32 on the card, {n} step(s): " + json.dumps({
            "rms": rms(outs[n], ref), "max_abs": (outs[n] - ref).abs().max().item(),
            "f32_rms_level": ref.double().pow(2).mean().sqrt().item()}))
    bf16_card_vs_cpu(card)
    gemms = gemm_ops_by_dtype(lambda: eager_infer(model16, mel, 1, 0))
    print(f"bf16 serving, one 1-step call's GEMM ops by input dtype: {json.dumps(gemms)}")
    # only the STFT's DFT matmuls (two per branch) may stay float32
    if gemms.get("c10::BFloat16", 0) == 0 or gemms.get("float", 0) > 6:
        raise AssertionError(f"a bf16 call's GEMMs are not bf16 but the STFT's: {gemms}")


def card_vs_cpu_44k() -> None:
    """mel_44k_128band_512x_base, float32, 1 step at batch 2, card against
    CPU with the same weights and x0."""
    gpu = get_model("mel_44k_128band_512x_base", device="cuda", seed=0).module
    cpu = get_model("mel_44k_128band_512x_base", device="cpu", seed=0).module
    rng = np.random.RandomState(4)
    cond = torch.from_numpy(rng.randn(2, 128, 87).astype(np.float32))
    x0 = torch.from_numpy((0.1 * rng.randn(2, 87 * 512)).astype(np.float32))
    with torch.inference_mode():
        tracing.drain()
        a = gpu.infer_from_noise(x0.cuda(), cond.cuda()).cpu()
        launches = n_istft()
        b = cpu.infer_from_noise(x0, cond)
    abs_err = (a - b).abs().max().item()
    rel = abs_err / b.abs().max().item()
    print(f"44.1 kHz card vs CPU 1 step, batch 2: max_abs_err={abs_err:.3e} max_rel_err={rel:.3e} "
          f"launches {launches}")
    if launches != 3 or not rel <= CARD_VS_CPU_TOL:
        raise AssertionError(f"44.1 kHz: card and CPU disagree ({rel}) or {launches} launches")


CHAIN_COUNTERS = ("fused_blocks", "eager_blocks", "norm_film_launches", "prelu_launches",
                  "residual_launches")


def chain_counts() -> dict:
    """The ConvNeXt chain's counters since the last `tracing.drain()`."""
    return {k: tracing.counter(f"convnext.{k}") for k in CHAIN_COUNTERS}


@contextlib.contextmanager
def eager_chain():
    """Every ConvNeXt block takes the eager chain, as before the kernels, in
    eval and train form."""
    taken, train_taken = convnext.takes_chain, convnext.takes_train_chain
    convnext.takes_chain = convnext.takes_train_chain = lambda *args: False
    try:
        yield
    finally:
        convnext.takes_chain, convnext.takes_train_chain = taken, train_taken


def chain_bytes(batch, frames, channels, f, conditioned, masked=False) -> dict:
    """The least bytes each chain kernel moves: every input read once and
    every output written once (the depthwise conv's halo rows not again)."""
    n = batch * frames * channels
    norm = 2 * n + channels * 10 + 1  # x in, y out; the 7 taps, three biases, the scale
    if conditioned:
        norm += batch * -(-frames // f) * channels + batch * channels
    if masked:
        norm += batch * frames
    return {"norm_film": 4 * norm, "prelu": 4 * (6 * n + 3 * channels),
            "residual": 4 * (3 * n + 2 * channels)}


def check_chain_shape(label, batch, frames, channels, f, conditioned, ragged=False,
                      extra_rows=0, timed=True) -> dict:
    """The three ConvNeXt chain kernels against their plain versions on the
    card at one shape: `convnext_norm_film` within CHAIN_TOL (the taps and
    the mean are summed in another order), `prelu_inplace` and
    `scaled_residual` (with a scale and a bias, a scale, neither) bit for
    bit; with `timed`
    each kernel's and plain version's ms and the byte bound."""
    gen = torch.Generator(device="cuda").manual_seed(batch * 7919 + frames * 31 + channels)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    mask = None
    if ragged:
        lens = torch.randint(1, frames + 1, (batch,), generator=gen, device="cuda")
        lens[0] = frames
        mask = make_valid_mask(lens, frames)[..., None]
    c = te = None
    if conditioned:
        c, te = rnd(batch, -(-frames // f) + extra_rows, channels), rnd(batch, channels, scale=0.3)
    x = rnd(batch, frames, channels)
    args = (x, mask, rnd(channels, 1, 7, scale=0.3), rnd(channels, scale=0.1),
            rnd(channels, scale=0.1), torch.tensor(0.4, device="cuda"), c, te, f)
    ref = chain.norm_film_plain(*args)
    out = chain.norm_film(*args)
    hidden, alpha = rnd(batch, frames, 3 * channels), 0.25 + rnd(3 * channels, scale=0.05)
    h, res, scale = rnd(batch, frames, channels), rnd(batch, frames, channels), 0.5 + rnd(
        channels, scale=0.1).abs()
    bias = rnd(channels, scale=0.1)
    prelu_equal = torch.equal(chain.prelu_(hidden.clone(), alpha), chain.prelu_plain(hidden, alpha))
    residual_equal = all(
        torch.equal(chain.scaled_residual_(h.clone(), res, s, b),
                    chain.scaled_residual_plain(h, res, s, b))
        for s, b in ((scale, bias), (scale, None), (None, None)))
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)
    rows, per_warp = chain.norm_film_plan(batch, frames, torch.cuda.get_device_properties(0)
                                          .multi_processor_count)
    row = dict(label=label, batch=batch, frames=frames, channels=channels, f=f,
               conditioned=conditioned, ragged=ragged, rows_per_tile=rows,
               rows_per_warp=per_warp, blocks=batch * -(-frames // rows),
               norm_film_max_rel_err=err, prelu_bitwise=prelu_equal,
               residual_bitwise=residual_equal)
    if (not out.is_contiguous() or not torch.isfinite(out).all() or not err <= CHAIN_TOL
            or not prelu_equal or not residual_equal):
        raise AssertionError(f"ConvNeXt chain kernels disagree with their plain versions: {row}")
    if timed:
        fns = {
            "norm_film": lambda: chain.norm_film(*args),
            "norm_film_plain": lambda: chain.norm_film_plain(*args),
            "prelu": lambda: chain.prelu_(hidden, alpha),
            "prelu_plain": lambda: chain.prelu_plain(hidden, alpha),
            "residual": lambda: chain.scaled_residual_(h, res, scale, bias),
            "residual_plain": lambda: chain.scaled_residual_plain(h, res, scale, bias),
        }
        times = {key: [] for key in fns}
        for key in [*fns, *reversed(fns)]:
            times[key] += device_ms(fns[key])
        row.update({f"{key}_ms": statistics.median(v) for key, v in times.items()})
        for key, nbytes in chain_bytes(batch, frames, channels, f, conditioned).items():
            bound = nbytes / yardstick.HBM_BYTES_PER_S * 1e3
            row.update({f"{key}_bound_ms": bound, f"{key}_bound_share": bound / row[f"{key}_ms"]})
    return row


def chain_block(card: str) -> dict:
    """One conditioned mel_24k_base branch-0 block (768 channels) at bulk's
    batch 16 x 873 frames: its eval form through the kernels against the
    eager chain (`eager_chain`) on the card; the kernels three eval-form
    calls run (the three chain kernels, once a call, and the GEMMs: no bias
    pass beside the GEMMs)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(19)
    block = ConvNeXtBlock(768, 2304, 7, conditioned=True, cond_channels=512,
                          time_embed_channels=512).cuda()
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.05)
        block.norm.log_scale.fill_(0.5)
        block.residual_scale.scale.uniform_(0.5, 1.0, generator=gen)
    x = torch.randn(16, 873, 768, generator=gen, device="cuda")
    cond = torch.randn(16, 873, 512, generator=gen, device="cuda")
    time_embed = torch.randn(16, 512, generator=gen, device="cuda")
    tracing.drain()
    with torch.no_grad():
        fused_out = block(x, cond, time_embed)
        with eager_chain():
            eager_out = block(x, cond, time_embed)
    torch.cuda.synchronize()
    counts = chain_counts()
    if counts != {"fused_blocks": 1, "eager_blocks": 1, "norm_film_launches": 1,
                  "prelu_launches": 1, "residual_launches": 1}:
        raise AssertionError(f"a block call through the chain and one eager counted {counts}")
    err = (fused_out - eager_out).abs().max().item() / eager_out.abs().max().item()
    # three calls: the profiler has missed the first kernels of a window
    calls = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.no_grad():
            for _ in range(calls):
                block(x, cond, time_embed)
        torch.cuda.synchronize()
    kernels = [(name, count) for _, name, count in device_kernels(prof)]
    gemm = [yardstick.family(name) == "gemm" for name, _ in kernels]
    others = [(name[:90], count) for (name, count), g in zip(kernels, gemm) if not g]
    row = {"max_rel_err": err, "calls_profiled": calls, "kernels": sum(c for _, c in kernels),
           "gemm_kernels": sum(c for (_, c), g in zip(kernels, gemm) if g),
           "other_kernels": others, "card": card}
    print("convnext chain block " + json.dumps(row))
    if not err <= BLOCK_TOL:
        raise AssertionError(f"a block's eval form through the kernels is off the eager chain: {row}")
    ours = ("convnext_norm_film", "prelu_inplace", "scaled_residual")
    if (not all(any(k in n for k in ours) for n, _ in others)
            or not all(any(k in n for n, _ in others) for k in ours)
            or any(c > calls for _, c in others)):
        raise AssertionError(f"a fused block ran other kernels than the chain's three beside "
                             f"its GEMMs (a bias pass?): {others}")
    return row


def chain_serving(card: str) -> dict:
    """The kernels on the serving paths: a fresh model's first (eager) call
    counts every block as fused (mel_24k_base at 4 steps: 4 cond-encoder
    blocks and 4 steps x 3 branches x 8, 100; the 44.1 kHz stream chunk at 1
    step, 28) and none eager, the bf16 build every block eager; the call
    against the eager chain on the same x0; no depthwise conv kernel left in
    a bulk call. Returns the two fused paths' counters by label."""
    model = get_model("mel_24k_base", device="cuda", seed=0)
    mel = torch.from_numpy(np.random.RandomState(5).randn(16, 100, 872).astype(np.float32))
    model44 = get_model("mel_44k_128band_512x_base", device="cuda", seed=0)
    chunk = torch.from_numpy(np.random.RandomState(6).randn(1, 128, 148).astype(np.float32))
    rows = {}
    for label, vm, cond, n, blocks in (("bulk_24k_872_frames_4_steps", model, mel, 4, 100),
                                       ("stream_44k_chunk_1_step", model44, chunk, 1, 28)):
        tracing.drain()
        vm.infer(cond, n_timesteps=n)  # a fresh model's first call runs eager
        torch.cuda.synchronize()
        counts = chain_counts()
        if counts != {"fused_blocks": blocks, "eager_blocks": 0, "norm_film_launches": blocks,
                      "prelu_launches": blocks, "residual_launches": blocks}:
            raise AssertionError(f"{label}: counted {counts}, expected {blocks} fused blocks")
        fused_out = eager_infer(vm, cond, n, 0)
        with eager_chain():
            eager_out = eager_infer(vm, cond, n, 0)
        err = (fused_out - eager_out).abs().max().item() / eager_out.abs().max().item()
        rel_l2 = ((fused_out - eager_out).norm() / eager_out.norm()).item()
        if not err <= CARD_VS_CPU_TOL:
            raise AssertionError(f"{label}: kernels against the eager chain {err}")
        rows[label] = {**counts, "max_rel_err_vs_eager_chain": err, "rel_l2_vs_eager_chain": rel_l2}
    tracing.drain()
    bf16 = bf16_vocoder("cuda")
    bf16.infer(torch.from_numpy(np.random.RandomState(7).randn(16, 100, 94).astype(np.float32)),
               n_timesteps=1)
    torch.cuda.synchronize()
    counts = chain_counts()
    if counts["fused_blocks"] or counts["eager_blocks"] != 28:
        raise AssertionError(f"bf16 serving counted {counts}, expected 28 eager blocks")
    del bf16

    with kernels_run() as runs:
        eager_infer(model, mel, 4, 0)
    if runs["by_family"]["conv_depthwise"]:
        raise AssertionError(f"a depthwise conv kernel ran on the fused path: {runs['by_family']}")
    print("convnext chain serving " + json.dumps({**rows, "bf16_1_step": counts,
                                                  "bulk_kernels_by_family": runs["by_family"],
                                                  "card": card}))
    return rows


def convnext_chain_phase(card: str) -> list:
    """Phase 23: the ConvNeXt chain kernels built, checked at every shape
    and timed at the main path's; a block and the serving paths through
    them. Returns the three kernels' entries of the `kernels` line."""
    build = cuda_build.build("convnext_chain")
    print(f"build: {build.path.name} in {build.seconds:.2f} s")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    tracing.drain()
    shapes = []
    for shape in CHAIN_SHAPES:
        shapes.append(check_chain_shape(*shape))
        print("convnext chain shape " + json.dumps(shapes[-1]))
    for label, batch, frames, channels, f, conditioned, ragged in CHAIN_EDGES:
        print("convnext chain edge " + json.dumps(check_chain_shape(
            label, batch, frames, channels, f, conditioned, ragged, extra_rows=2, timed=False)))
    chain_block(card)
    serving = chain_serving(card)
    step = [s for s in shapes if s["label"].startswith("bulk_872_branch")]
    entries = []
    for name, key, launches in (("convnext_norm_film", "norm_film", "norm_film_launches"),
                                ("prelu_inplace", "prelu", "prelu_launches"),
                                ("scaled_residual", "residual", "residual_launches")):
        entries.append({
            "name": name, "route": "cuda", "source": "flow2gan_tpu_torch/csrc/convnext_chain.cu",
            "replaces": "none (XLA fused the chain on the TPU: flow2gan_tpu/models/convnext.py:52-117)",
            "launches_by_path": {k: v[launches] for k, v in serving.items()},
            "ms": sum(s[f"{key}_ms"] for s in step),
            "plain_ms": sum(s[f"{key}_plain_ms"] for s in step),
            "bound_ms": sum(s[f"{key}_bound_ms"] for s in step), "bound_by": "bytes",
            "per": "one block of each branch of mel_24k_base at batch 16, 872 mel frames",
            "shapes": [{k: v for k, v in s.items() if k.startswith((key, "label"))}
                       for s in shapes],
        })
    return entries


TRAIN_COUNTERS = ("train_fused_blocks", "train_eager_blocks", "eager_blocks", "fused_blocks",
                  "prelu_fwd_launches", "prelu_bwd_launches", "norm_film_bwd_launches",
                  "dwconv_bwd_launches")


def train_counts() -> dict:
    """The train-form chain's counters since the last `tracing.drain()`."""
    return {k: tracing.counter(f"convnext.{k}") for k in TRAIN_COUNTERS}


def train_chain_bytes(batch, frames, channels, f, conditioned, ragged, chunks, segs) -> dict:
    """The least bytes each train-form kernel moves: every input read once
    and every output written once, partial sums included; the mask only
    where there is one."""
    n, hidden = batch * frames * channels, 3 * channels
    rows = -(-frames // f)
    cond = 2 * batch * rows * channels + batch * channels if conditioned else 0  # c in, dc out
    mask = batch * frames if ragged else 0
    parts = {"prelu": chunks * 2 * hidden, "norm": batch * segs * (channels + 4),
             "te": segs * batch * channels if conditioned else 0,
             "conv": -(-batch * segs // 8) * channels * 10}
    return {"prelu_fwd": 4 * (6 * n + hidden), "prelu_bwd": 4 * (12 * n + hidden + parts["prelu"]),
            "norm_film_bwd": 4 * (3 * n + mask + cond + 10 * channels
                                  + parts["norm"] + parts["te"]),
            "dwconv_bwd": 4 * (4 * n + mask + 9 * channels + parts["conv"])}


def _max_rel(ours, ref) -> float:
    return ((ours.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-300)).item()


def check_train_chain_shape(label, batch, frames, channels, f, conditioned, ragged=False,
                            extra_rows=0, timed=True) -> dict:
    """The four train-form kernels on the card at one shape against their
    plain versions in float64 (`convnext_prelu_fwd` and `convnext_prelu_bwd`'s
    dh1 and p against the float32 plain versions bit for bit), each output
    within TRAIN_CHAIN_TOL of the largest float64 value; the float32 plain
    versions' own errors beside them. With `timed`, each kernel's ms, its
    plain version's and the byte bound, and the partials' sums' ms."""
    gen = torch.Generator(device="cuda").manual_seed(batch * 7919 + frames * 31 + channels + 1)

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    hidden, sm = 3 * channels, torch.cuda.get_device_properties(0).multi_processor_count
    mask = None
    if ragged:
        lens = torch.randint(1, frames + 1, (batch,), generator=gen, device="cuda")
        lens[0] = frames
        mask = make_valid_mask(lens, frames)[..., None]
    c = te = None
    if conditioned:
        c, te = rnd(batch, -(-frames // f) + extra_rows, channels), rnd(batch, channels, scale=0.3)
    x, dy, g = rnd(batch, frames, channels), rnd(batch, frames, channels), rnd(batch, frames, channels)
    w, db, nb = rnd(channels, 1, 7, scale=0.3), rnd(channels, scale=0.1), rnd(channels, scale=0.1)
    ls = torch.tensor(0.4, device="cuda")
    alpha, scale = 0.25 + rnd(hidden, scale=0.05), 0.5 + rnd(channels, scale=0.1).abs()
    h1, dp = rnd(batch * frames, hidden), rnd(batch * frames, hidden)
    chunks = train_chain.prelu_bwd_plan(batch * frames, hidden, sm)[0]
    segs, seg_rows = train_chain.segment_plan(batch, frames, f, sm)

    def backward():
        sums = train_chain._Sums(batch, channels, hidden, 7, conditioned, chunks, segs, x.device)
        dh1 = dp.clone()
        p = train_chain._launch_prelu_bwd(dh1, h1, alpha, sums)
        dz, dc = train_chain._launch_norm_film_bwd(x, mask, w, db, nb, ls, c, te, f, dy, sums,
                                                   segs, seg_rows)
        dx = train_chain._launch_dwconv_bwd(dz, x, mask, w, g, scale, sums, segs, seg_rows)
        return dh1, p, dz, dc, dx, sums, sums.finish()

    p_fwd = train_chain.prelu_out(h1, alpha)
    dh1, p, dz, dc, dx, _, out = backward()
    torch.cuda.synchronize()
    plain_dh1, plain_p = train_chain.prelu_bwd_plain(dp, h1, alpha)[:2]
    prelu_bitwise = (torch.equal(p_fwd, chain.prelu_plain(h1, alpha)) and torch.equal(p, plain_p)
                     and torch.equal(dh1, plain_dh1))
    del plain_dh1, plain_p
    d64 = lambda t: None if t is None else t.double()  # noqa: E731
    ours = {"dalpha": out["prelu"][:hidden], "db1": out["prelu"][hidden:]}
    ref = dict(zip(("dalpha", "db1"), train_chain.prelu_bwd_plain(d64(dp), d64(h1),
                                                                     d64(alpha))[2:]))
    args64 = [d64(t) for t in (x, mask, w, db, nb, ls, c, te)]
    ref.update(zip(("dz", "dc", "dnorm_bias", "dlog_scale", "dte"),
                   train_chain.norm_film_bwd_plain(*args64, f, d64(dy))))
    ours.update(dz=dz, dc=dc, dnorm_bias=out["norm"][:channels], dlog_scale=out["norm"][channels],
                dte=out["te"].view(batch, channels) if conditioned else None)
    ref.update(zip(("dx", "ddw_weight", "ddw_bias", "dscale", "db2"), train_chain.dwconv_bwd_plain(
        d64(dz), d64(x), d64(mask), d64(w), d64(g), d64(scale))))
    conv = out["conv"]
    ours.update(dx=dx, ddw_weight=conv[:7 * channels].view(channels, 1, 7),
                ddw_bias=conv[7 * channels:8 * channels], dscale=conv[8 * channels:9 * channels],
                db2=conv[9 * channels:])
    errs = {k: _max_rel(v, ref[k]) for k, v in ours.items() if v is not None}
    # the float32 plain versions against float64, for scale
    plain32 = dict(zip(("dz", "dc", "dnorm_bias", "dlog_scale", "dte"),
                       train_chain.norm_film_bwd_plain(x, mask, w, db, nb, ls, c, te, f, dy)))
    plain32.update(zip(("dx", "ddw_weight", "ddw_bias", "dscale", "db2"),
                       train_chain.dwconv_bwd_plain(dz, x, mask, w, g, scale)))
    plain_errs = {k: _max_rel(v, ref[k]) for k, v in plain32.items() if v is not None}
    del ref, plain32, args64
    row = dict(label=label, batch=batch, frames=frames, channels=channels, f=f,
               conditioned=conditioned, ragged=ragged, prelu_chunks=chunks, segs=segs,
               seg_rows=seg_rows, prelu_bitwise=prelu_bitwise,
               max_rel_err=errs, plain_f32_max_rel_err=plain_errs)
    if not prelu_bitwise or not all(
            e <= max(TRAIN_CHAIN_TOL, TRAIN_BLOCK_RATIO * plain_errs.get(k, 0.0))
            for k, e in errs.items()) or not all(
            torch.isfinite(t).all() for t in (dz, dx, out["prelu"], out["norm"], conv)):
        raise AssertionError(f"the train-form kernels disagree with their plain versions: {row}")
    if timed:
        sums = train_chain._Sums(batch, channels, hidden, 7, conditioned, chunks, segs, x.device)
        dh1 = dp.clone()
        fns = {
            "prelu_fwd": lambda: train_chain.prelu_out(h1, alpha),
            "prelu_fwd_plain": lambda: chain.prelu_plain(h1, alpha),
            "prelu_bwd": lambda: train_chain._launch_prelu_bwd(dh1, h1, alpha, sums),
            "prelu_bwd_plain": lambda: train_chain.prelu_bwd_plain(dp, h1, alpha),
            "norm_film_bwd": lambda: train_chain._launch_norm_film_bwd(
                x, mask, w, db, nb, ls, c, te, f, dy, sums, segs, seg_rows),
            "norm_film_bwd_plain": lambda: train_chain.norm_film_bwd_plain(
                x, mask, w, db, nb, ls, c, te, f, dy),
            "dwconv_bwd": lambda: train_chain._launch_dwconv_bwd(dz, x, mask, w, g, scale, sums,
                                                                 segs, seg_rows),
            "dwconv_bwd_plain": lambda: train_chain.dwconv_bwd_plain(dz, x, mask, w, g, scale),
            "partial_sums": sums.finish,  # torch's reductions, no kernel of this file
        }
        times = {key: [] for key in fns}
        for key in [*fns, *reversed(fns)]:
            times[key] += device_ms(fns[key], samples=10)
        row.update({f"{key}_ms": statistics.median(v) for key, v in times.items()})
        for key, nbytes in train_chain_bytes(batch, frames, channels, f, conditioned, ragged,
                                             chunks, segs).items():
            bound = nbytes / yardstick.HBM_BYTES_PER_S * 1e3
            row.update({f"{key}_bound_ms": bound, f"{key}_bound_share": bound / row[f"{key}_ms"]})
    return row


def _block_grads(block, x, cond, time_embed, mask, gates, grad) -> tuple:
    block.zero_grad(set_to_none=True)
    leaves = [t.detach().clone().requires_grad_() for t in (x, cond, time_embed)]
    out = block(*leaves, mask, gates)
    (out * grad).sum().backward()
    grads = {"x": leaves[0].grad, "cond": leaves[1].grad, "time_embed": leaves[2].grad}
    grads.update({k: p.grad for k, p in block.named_parameters()})
    return out.detach(), {k: v.detach().double() for k, v in grads.items()}


def train_chain_block(card: str) -> dict:
    """One conditioned mel_24k_base branch-0 block (768 channels) at the GAN
    cell's 64 x 141 frames, a ragged mask, gates half on and its log-scale
    and residual scales past their limits: its train form through the
    Function against the eager chain's autograd on the card, each against
    the same block in float64 (eager, on the card); the counters of each
    path; the kernels one forward and backward runs (no depthwise conv)."""
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device="cuda").manual_seed(23)
    block = ConvNeXtBlock(768, 2304, 7, conditioned=True, cond_channels=512,
                          time_embed_channels=512).cuda()
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.05)
        block.norm.log_scale.fill_(1.6)
        block.residual_scale.scale.uniform_(0.3, 1.2, generator=gen)
    block.norm.gate_index, block.residual_scale.gate_index = 0, 1
    batch, frames = 64, 141
    x = torch.randn(batch, frames, 768, generator=gen, device="cuda")
    cond = torch.randn(batch, frames, 512, generator=gen, device="cuda")
    time_embed = torch.randn(batch, 512, generator=gen, device="cuda")
    lens = torch.randint(1, frames + 1, (batch,), generator=gen, device="cuda")
    mask = make_valid_mask(lens, frames)[..., None]
    grad = torch.randn(batch, frames, 768, generator=gen, device="cuda")
    gates = torch.tensor([1.0, 1.0], device="cuda")
    tracing.drain()
    fused = _block_grads(block, x, cond, time_embed, mask, gates, grad)
    torch.cuda.synchronize()
    counts = train_counts()
    expected = {"train_fused_blocks": 1, "prelu_fwd_launches": 1, "prelu_bwd_launches": 1,
                "norm_film_bwd_launches": 1, "dwconv_bwd_launches": 1}
    if counts != {k: expected.get(k, 0) for k in TRAIN_COUNTERS}:
        raise AssertionError(f"a train-form block counted {counts}")
    taken = convnext.takes_train_chain
    convnext.takes_train_chain = lambda *args: False
    try:
        eager = _block_grads(block, x, cond, time_embed, mask, gates, grad)
    finally:
        convnext.takes_train_chain = taken
    if train_counts()["train_eager_blocks"] != 1:
        raise AssertionError(f"the eager train form counted {train_counts()}")
    exact = _block_grads(copy.deepcopy(block).double(), x.double(), cond.double(),
                         time_embed.double(), mask.double(), gates.double(), grad.double())

    def err(a, b):
        return ((a.double() - b).norm() / b.norm().clamp_min(1e-300)).item()

    report = {"out_fused": err(fused[0], exact[0]), "out_eager": err(eager[0], exact[0])}
    worst, failed = {}, []
    for name, ref in exact[1].items():
        e_fused, e_eager = err(fused[1][name], ref), err(eager[1][name], ref)
        worst[name] = (e_fused, e_eager)
        if not e_fused <= max(TRAIN_BLOCK_TOL, TRAIN_BLOCK_RATIO * e_eager):
            failed.append(name)
    report["grads_fused_vs_eager_against_float64"] = worst
    calls = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            _block_grads(block, x, cond, time_embed, mask, gates, grad)
        torch.cuda.synchronize()
    kernels = [(name, count) for _, name, count in device_kernels(prof)]
    families = collections.Counter()
    for name, count in kernels:
        families[yardstick.family(name)] += count
    report["kernels_by_family_two_calls"] = dict(families)
    report["other_kernels_two_calls"] = [(n[:80], c) for n, c in kernels
                                         if yardstick.family(n) != "gemm"]
    print("convnext train chain block " + json.dumps({**report, "card": card}))
    if not report["out_fused"] <= TRAIN_BLOCK_TOL or failed:
        raise AssertionError(f"a block's train form is off float64 beyond the eager chain's own "
                             f"error: {failed} {report}")
    if families["conv_depthwise"]:
        raise AssertionError(f"a depthwise conv kernel ran in the fused train form: {families}")
    return report


def train_chain_steps(card: str) -> dict:
    """The counters over one `fm_train_step` of mel_24k_base at 16 x 1.5 s
    (28 blocks through the Function, none eager) and one GAN D and G step
    at 4 Euler steps with `remat_rollout` (D: 100 eval-form blocks through
    the chain; G: 100 through the Function and 96 recomputed, none eager)."""
    dev = torch.device("cuda")
    batch = {k: v.to(dev) for k, v in dist_batch(DIST_BATCH, DIST_LENS).items()}
    cfg = get_generator_config("mel_24k_base")
    model = init_weights(build_generator(cfg), torch.Generator().manual_seed(0)).to(dev)
    mel = LogMelSpectrogram(sampling_rate=24000, n_fft=1024, hop_length=256, n_mels=100).to(dev)
    opt = ScaledAdam(model.named_parameters(), clipping_scale=2.0)
    tracing.drain()
    m = fm_train_step(model, opt, mel, batch, 1e-3, step_generator(0, 0, dev))
    torch.cuda.synchronize()
    rows = {"fm_step": {**train_counts(), "loss": float(m["loss"])}}
    del model, opt, m
    gen, disc, mel, recon = gan_models("cuda")
    opt_g = ScaledAdam(gen.named_parameters(), clipping_scale=2.0)
    opt_d = ScaledAdam(disc.named_parameters(), clipping_scale=2.0)
    d_step, g_step, _ = make_gan_steps(gen, disc, mel, recon, opt_g, opt_d, lambda b: 1e-4,
                                       lambda b: 1e-3, n_timesteps=GAN_STEPS, remat_rollout=True)
    n_frames = DIST_LENGTH // 256 + 1
    for side, step, train in (("d", d_step, False), ("g", g_step, True)):
        draws = gen.draw_rollout(DIST_BATCH, n_frames, GAN_STEPS, step_generator(0, 3, dev),
                                 train=train)
        tracing.drain()
        step(batch, draws)
        torch.cuda.synchronize()
        rows[f"gan_{side}_step"] = {**train_counts(),
                                    "recomputed_steps": tracing.counter("solve.recomputed_steps")}
    print("convnext train chain steps " + json.dumps({**rows, "card": card}))
    blocks = 4 + 3 * 8 * GAN_STEPS  # the cond encoder, then 3 branches x 8 a step
    want = {
        "fm_step": {"train_fused_blocks": 28, "prelu_bwd_launches": 28},
        "gan_d_step": {"fused_blocks": blocks},
        "gan_g_step": {"train_fused_blocks": blocks + 3 * 8 * GAN_STEPS,
                       "prelu_bwd_launches": blocks, "recomputed_steps": GAN_STEPS},
    }
    for name, expected in want.items():
        got = rows[name]
        if any(got[k] != v for k, v in expected.items()) or got["train_eager_blocks"] or \
                got["eager_blocks"]:
            raise AssertionError(f"{name} counted {got}, expected {expected} and none eager")
    return rows


def convnext_train_chain_phase(card: str) -> list:
    """Phase 24: the train-form kernels built, checked at every shape and
    timed at the FM cell's; one block's train form and the training steps
    through them. Returns the four kernels' entries of the `kernels` line."""
    build = cuda_build.build("convnext_chain_train")
    print(f"build: {build.path.name} in {build.seconds:.2f} s")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    tracing.drain()
    shapes = []
    for label, batch, frames, channels, f, conditioned, ragged in TRAIN_CHAIN_SHAPES:
        shapes.append(check_train_chain_shape(label, batch, frames, channels, f, conditioned,
                                              ragged, timed=batch == 256))
        print("convnext train chain shape " + json.dumps(shapes[-1]))
    for label, batch, frames, channels, f, conditioned, ragged in TRAIN_CHAIN_EDGES:
        print("convnext train chain edge " + json.dumps(check_train_chain_shape(
            label, batch, frames, channels, f, conditioned, ragged, extra_rows=2, timed=False)))
    train_chain_block(card)
    steps = train_chain_steps(card)
    step = [s for s in shapes if s["label"].startswith("fm_")]
    entries = []
    for key in ("prelu_fwd", "prelu_bwd", "norm_film_bwd", "dwconv_bwd"):
        entries.append({
            "name": f"convnext_{key}", "route": "cuda",
            "source": "flow2gan_tpu_torch/csrc/convnext_chain_train.cu",
            "replaces": "none (XLA fused and differentiated the chain on the TPU: "
                        "flow2gan_tpu/models/convnext.py:52-117)",
            "launches_by_path": {k: v[f"{key}_launches"] for k, v in steps.items()},
            "ms": sum(s[f"{key}_ms"] for s in step),
            "plain_ms": sum(s[f"{key}_plain_ms"] for s in step),
            "bound_ms": sum(s[f"{key}_bound_ms"] for s in step), "bound_by": "bytes",
            "per": "one block of each branch and of the cond encoder of mel_24k_base at "
                   "batch 256 x 1.5 s",
            "shapes": [{k: v for k, v in s.items() if k.startswith((key, "label"))}
                       for s in shapes],
        })
    return entries


def graph_counts() -> dict:
    return {k: tracing.counter(f"infer.{k}") for k in ("eager_calls", "graph_captures",
                                                       "graph_replays")}


def check_graph_replays(label: str, vm: VocoderModel, cond, n: int, replays: int = 4) -> dict:
    """Calls with one key on a fresh model (eager, capture, then `replays`
    replays at other seeds) against the eager path, bit for bit; the held
    outputs of consecutive replays stay apart; a replay at another seed
    draws that seed's x0; the eager call and the capture's warm-up launch
    the fused iSTFT 3 x steps times each; the replays launch it from the
    host none, and the profiler sees the device run it 3 x steps x N times
    in N replays."""
    seeds = [11, 11] + [12 + k for k in range(replays)]
    refs = {s: eager_infer(vm, cond, n, s) for s in set(seeds)}
    tracing.drain()
    outs = []
    for s in seeds[:2]:
        outs.append(vm.infer(cond, n_timesteps=n, seed=s))
    per_call = n_istft() / 2
    before = n_istft()
    with kernels_run() as runs:
        for s in seeds[2:]:
            outs.append(vm.infer(cond, n_timesteps=n, seed=s))
    counted = n_istft() - before
    counts = graph_counts()
    if counts != {"eager_calls": 1, "graph_captures": 1, "graph_replays": replays}:
        raise AssertionError(f"{label}: calls ran {counts}, expected 1 eager, 1 capture and "
                             f"{replays} replays")
    if per_call != 3 * n or counted != 0 or runs["forward"] != replays * 3 * n:
        raise AssertionError(f"{label}: {per_call} launches an eager call; over {replays} "
                             f"replays {counted} counted, {runs['forward']} run on the device")
    bad = [s for s, out in zip(seeds, outs) if not torch.equal(out, refs[s])]
    if bad:
        raise AssertionError(f"{label}: replayed output differs from eager at seeds {bad}")
    if len({o.data_ptr() for o in outs}) != len(outs) or torch.equal(outs[2], outs[3]):
        raise AssertionError(f"{label}: held outputs of consecutive replays share storage or "
                             "values")
    row = {"calls": len(seeds), **counts, "launches_per_eager_call": per_call,
           "fused_istft_run_in_replays": runs["forward"], "bitwise_equal": True}
    print(f"graph replay {label} " + json.dumps(row))
    return row


def graph_profile(vm: VocoderModel, cond, n: int, calls: int = 5) -> dict:
    """Device kernels the profiler sees in `calls` replays and in as many
    eager calls, and a capture made while the profiler runs (a new key)
    against the eager path."""
    def kernels(fn):
        with kernels_run() as runs:
            fn()
        return runs["kernels"], runs["forward"]

    for _ in range(2):
        vm.infer(cond, n_timesteps=n)  # capture, if the previous key was another
    replayed = kernels(lambda: [vm.infer(cond, n_timesteps=n) for _ in range(calls)])
    eager = kernels(lambda: [eager_infer(vm, cond, n, 0) for _ in range(calls)])
    other = cond[..., :-8]
    with kernels_run():
        outs = [vm.infer(other, n_timesteps=n, seed=s) for s in (3, 3, 4)]
    if not all(torch.equal(o, eager_infer(vm, other, n, s)) for o, s in zip(outs, (3, 3, 4))):
        raise AssertionError("a graph captured under the profiler replays other values")
    if replayed[1] != calls * 3 * n or replayed[0] < eager[0] or replayed[0] > eager[0] + 3 * calls:
        raise AssertionError(f"the profiler saw (kernels, fused_istft) {replayed} in {calls} "
                             f"replays, {eager} in {calls} eager calls")
    return {"replayed_kernels": replayed[0], "replayed_fused_istft": replayed[1],
            "eager_kernels": eager[0], "eager_fused_istft": eager[1], "calls": calls}


def capture_cycles(vm: VocoderModel, frames=(60, 94, 128), rounds: int = 3) -> dict:
    """Keys in turn, each called twice (eager, then capture), for `rounds`
    rounds at batch 16 and 1 step: each output equal to the eager path's,
    the allocator's reserved bytes after each round, which later rounds
    must not grow past the first's by an eighth (every capture runs on the
    model's one capture stream into its one pool)."""
    rng = np.random.RandomState(23)
    mels = {f: rng.randn(16, 100, f).astype(np.float32) for f in frames}
    reserved = []
    before = graph_counts()["graph_captures"]
    for _ in range(rounds):
        for f, mel in mels.items():
            for kind in ("eager", "capture"):
                out = vm.infer(mel, n_timesteps=1, seed=f)
                if not torch.equal(out, eager_infer(vm, mel, 1, f)):
                    raise AssertionError(f"capture cycles: {kind} call at {f} frames differs")
        reserved.append(torch.cuda.memory_reserved(vm.device))
    captures = graph_counts()["graph_captures"] - before
    if captures != rounds * len(frames) or max(reserved[1:]) > reserved[0] * 9 / 8:
        raise AssertionError(f"capture cycles: {captures} captures, reserved bytes {reserved}")
    return {"captures": captures, "reserved_bytes_by_round": reserved}


def graph_replay(card: str) -> None:
    """22: `VocoderModel.infer`'s CUDA graphs on the card against the eager
    path, bit for bit (`check_graph_replays`): mel_44k_128band_512x_base at
    1 step on the stream shape, mel_24k_base at 1 and 4 steps at batch 16,
    in bf16, and token_24k_base; the profiler's kernels in replays; a 30 s
    stream through `streaming_infer` against the eager stream."""
    rng = np.random.RandomState(22)
    model44 = get_model("mel_44k_128band_512x_base", device="cuda", seed=0)
    chunk = rng.randn(1, 128, 148).astype(np.float32)
    rows = {"mel_44k_stream_chunk_1_step": check_graph_replays(
        "mel_44k_128band_512x_base (1, 128, 148) 1 step", model44, chunk, 1)}
    mel = rng.randn(16, 100, 94).astype(np.float32)
    for n in (1, 4):
        rows[f"mel_24k_base_b16_{n}_step"] = check_graph_replays(
            f"mel_24k_base (16, 100, 94) {n} step", get_model("mel_24k_base", device="cuda",
                                                              seed=0), mel, n)
    rows["mel_24k_base_bf16_b16_1_step"] = check_graph_replays(
        "mel_24k_base bf16 (16, 100, 94) 1 step", bf16_vocoder("cuda"), mel, 1)
    rows["token_24k_base_b16_1_step"] = check_graph_replays(
        "token_24k_base (16, 94) 1 step", get_model("token_24k_base", device="cuda", seed=0),
        rng.randint(0, 1024, (16, 94)), 1)
    rows["profile_mel_44k_chunk"] = graph_profile(model44, chunk, 1)
    rows["capture_cycles_mel_24k_base"] = capture_cycles(get_model("mel_24k_base", device="cuda",
                                                                   seed=0))

    stream = rng.randn(128, int(30 * 44100 / 512)).astype(np.float32)
    layers, hop = max(model44.config.num_layers), model44.config.mel_hop_length
    model44 = get_model("mel_44k_128band_512x_base", device="cuda", seed=0)
    tracing.drain()
    with kernels_run() as runs:
        ours = infer_dir.streaming_infer(infer_dir.make_synth(model44, 1, 5), stream, 100, layers,
                                         hop)
    launches, counted, counts = runs["forward"], n_istft(), graph_counts()
    theirs = infer_dir.streaming_infer(
        lambda seg: eager_infer(model44, seg, 1, 5).cpu().numpy(), stream, 100, layers, hop)
    chunks = -(-stream.shape[-1] // 100)
    # the host launches the kernel in the eager chunk and the capture's warm-up
    if not np.array_equal(ours, theirs) or launches != 3 * chunks or counted != 3 * 2 or counts != {
            "eager_calls": 1, "graph_captures": 1, "graph_replays": chunks - 2}:
        raise AssertionError(f"30 s stream: equal {np.array_equal(ours, theirs)}, {launches} "
                             f"run on the device, {counted} counted, {counts} over {chunks} "
                             "chunks")
    rows["stream_30s"] = {"chunks": chunks, **counts, "fused_istft_run": launches,
                          "fused_istft_counted": counted, "bitwise_equal": True}
    print("graph replay " + json.dumps({**rows, "card": card}))


def bf16_trainer(card: str, root: Path) -> None:
    """`bin/pretrain.py --use-bf16` for 8 steps on half the corpus of phase
    10."""
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
    tracing.drain()
    history = pretrain.run(args)
    torch.cuda.synchronize()
    launches = {"forward": n_istft(), "adjoint": n_adjoint()}
    steps = len(history)
    if steps != 8 or launches != {"forward": 3 * (8 + 2), "adjoint": 3 * 8}:
        raise AssertionError(f"bf16 trainer ran {steps} steps with launches {launches}")
    losses = [h["loss"] for h in history]
    print("bf16 trainer " + json.dumps({
        "config": "mel_24k_base", "compute_dtype": "bfloat16", "batch": 16,
        "seconds_per_item": 1.5, "steps": steps, "loss_curve": losses,
        "clip_scale": [h["clip_scale"] for h in history],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "card": card}))
    if not all(math.isfinite(x) for x in losses) or not statistics.median(losses[-3:]) < losses[0]:
        raise AssertionError(f"the bf16 training loss is not finite or does not fall: {losses}")


def clis(card: str, root: Path, exp: Path, averaged: Path) -> None:
    """bin/infer over a manifest of corpus files with the windowed average
    of phase 10's epochs, and bin/infer_dir on a directory of them, whole and
    in 50-frame chunks, each run's launches checked (bin/infer_dir's: the
    kernels the profiler saw run)."""
    recs = read_recording_manifest(root / "valid" / "recordings.jsonl.gz")[:6]
    cli = root / "cli"
    (cli / "wavs").mkdir(parents=True, exist_ok=True)
    write_recording_manifest(recs, cli / "recordings.jsonl.gz")
    launches = {}
    tracing.drain()
    written = infer.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "1",
                          "--recordings", str(cli / "recordings.jsonl.gz"),
                          "--root-path", str(root / "valid"), "--output-dir", str(cli / "infer"),
                          "--batch-size", "4", "--num-workers", "2", "--device", "cuda"])
    launches["infer"] = n_istft()
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
        # equal-length files and chunks repeat a key, which replays a CUDA graph
        with kernels_run() as ran:
            runs[name] = infer_dir.main(["--checkpoint", str(averaged), "--input-dir",
                                         str(cli / "wavs"), "--output-dir", str(cli / name),
                                         "--device", "cuda", *extra])
        launches[name] = ran["forward"]
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


def gan_grads_card_vs_cpu(card: str) -> None:
    """The D and G objectives of full mel_24k_base with the full
    discriminators at 1 Euler step, batch 2 x 1 s, card against CPU with the
    same weights and draws: the loss and every gradient of the objective's
    own side, and each objective's (forward, adjoint) launches.

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
        tracing.drain()
        loss, _ = fns[side](batch[dev], draws)
        loss.backward(inputs=list(own.parameters()))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches[side] = (n_istft(), n_adjoint())
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
            f, b = n_istft(), n_adjoint()
            out = step(*args, **kwargs)
            calls.append((kind, n_istft() - f, n_adjoint() - b))
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
    returns the run's (forward, adjoint) launches and its experiment
    directory."""
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
    tracing.drain()
    history, calls = run_counting_steps(finetune, "make_gan_steps", args)
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = 3 * GAN_STEPS
    sides = [h["side"] for h in history]
    expected = ["D"] * GAN_WARMUP + ["G", "D"] * ((GAN_BATCHES - GAN_WARMUP) // 2)
    per_kind = {kind: sorted({(f, b) for k, f, b in calls if k == kind}) for kind in ("D", "G", "eval")}
    counts = {kind: sum(k == kind for k, _, _ in calls) for kind in ("D", "G", "eval")}
    by_kind = launches_by_kind(calls)
    launches = {"forward": n_istft(), "adjoint": n_adjoint(),
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
    print("GAN fine-tuner " + json.dumps({
        "config": "mel_24k_base", "n_timesteps": GAN_STEPS, "batch": 16, "seconds_per_item": 1.5,
        "batches": len(history), "sides": "".join(sides),
        "loss_d": [h["loss"] for h in history if h["side"] == "D"],
        "loss_g": [h["loss"] for h in history if h["side"] == "G"],
        "clip_scale": [h["clip_scale"] for h in history],
        "peak_memory_gb": peak_gb, "moved_share": moved, "launches": launches, "card": card}))
    return (launches["forward"], launches["adjoint"]), exp


def gan_remat(card: str, averaged: Path) -> None:
    """One 4-step G step (batch 16 x 1.5 s) from the averaged FM model with
    `--remat-rollout` and without: loss and gradients within REMAT_TOL, the
    launches of each, and each one's peak memory."""
    gen, disc, mel, recon = gan_models("cuda", averaged)
    audio = torch.from_numpy(voiced(np.random.RandomState(41), 16, 36000)).cuda()
    batch = {"audio": audio, "audio_lens": torch.full((16,), 36000, device="cuda")}

    # --remat-rollout against plain, with the same weights and draws; plain
    # twice, to show what the card's own run-to-run order changes
    params_g = list(gen.parameters())
    g_draws = gen.draw_rollout(16, 141, GAN_STEPS, step_generator(0, 13, "cuda"), True)
    runs = {}
    for name, remat in (("plain", False), ("remat", True), ("plain_again", False)):
        _, g_fn = make_gan_loss_fns(gen, disc, mel, recon, n_timesteps=GAN_STEPS, remat_rollout=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base_gb = torch.cuda.memory_allocated() / 1e9
        tracing.drain()
        loss, _ = g_fn(batch, g_draws)
        loss.backward(inputs=params_g)
        torch.cuda.synchronize()
        runs[name] = {"loss": loss.item(), "grads": [p.grad.detach().clone() for p in params_g],
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "base_gb": base_gb,
                      "launches": (n_istft(), n_adjoint())}
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


def gan_clis(card: str, root: Path, exp: Path) -> None:
    """`save_averaged_model --load-gan` on the fine-tuner's checkpoints,
    served at 4 steps, and `bin/infer --load-gan` over the CLI phase's corpus
    files, with bin/infer's launches."""
    out = save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "2",
                                    "--load-gan", "true"])
    served = get_model("mel_24k_base", checkpoint=out, device="cuda")
    wav = served.infer(np.random.RandomState(0).randn(4, 100, 94).astype(np.float32),
                       n_timesteps=GAN_STEPS)
    if wav.shape != (4, 24064) or not torch.isfinite(wav).all():
        raise AssertionError(f"the GAN average served {tuple(wav.shape)}")
    cli = root / "cli"
    recs = read_recording_manifest(cli / "recordings.jsonl.gz")
    tracing.drain()
    written = infer.main(["--exp-dir", str(exp), "--epoch", "2", "--load-gan", "true",
                          "--n-timesteps", str(GAN_STEPS),
                          "--recordings", str(cli / "recordings.jsonl.gz"),
                          "--root-path", str(root / "valid"), "--output-dir", str(cli / "infer_gan"),
                          "--batch-size", "4", "--num-workers", "2", "--device", "cuda"])
    launches = n_istft()
    for rec, path in zip(recs, written):
        got, sr = read_wav(path)
        if sr != 24000 or got.shape != (1, rec.num_samples) or not np.isfinite(got).all():
            raise AssertionError(f"bin/infer --load-gan wrote {path} at {sr} Hz, shape {got.shape}")
    if len(written) != len(recs) or launches != 3 * GAN_STEPS * 2:  # 6 files in batches of 4
        raise AssertionError(f"bin/infer --load-gan wrote {len(written)} files with {launches} launches")
    print("GAN CLIs " + json.dumps({"averaged": out.name, "served_shape": list(wav.shape),
                                    "infer_files": len(written), "infer_launches": launches,
                                    "card": card}))


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
    tracing.enable()  # the kernels' launch counters
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
    tracing.drain()
    m = fm_train_step(model, opt, mel, batch, 1e-3, step_generator(0, 0, dev))
    torch.cuda.synchronize()
    out["fm"] = {"loss": float(m["loss"]), "launches": (n_istft(), n_adjoint())}
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
        tracing.drain()
        m = step(batch, draws)
        torch.cuda.synchronize()
        out[side] = {"loss": float(m["loss_d" if side == "d" else "loss_g"]),
                     "launches": (n_istft(), n_adjoint()),
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


def data_parallel_steps(card: str) -> None:
    """Phases 16a and 16b: the FM step, then the 4-step D and G steps, as 2
    ranks of 8 against one process of 16, with the same weights, batch and
    draws. One rank per card over NCCL where there are 2 cards; else both
    ranks on card 0 over gloo (every rank on the named card), and the FM
    step once more in a one-rank NCCL group, so that NCCL's init and
    all-reduce run on the card; the per-rank launches of each step."""
    per_card = torch.cuda.device_count() >= DIST_WORLD
    ref = dist_steps({"floors": True})
    torch.cuda.empty_cache()
    ranks = spawn_ranks(DIST_WORLD, "dist_steps", {"group": "port",
                                                   "device": "cuda" if per_card else "cuda:0"},
                        ROOT / "dist_steps")
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
        **reports, "card": card}))
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


def dist_trainer_rank(spec: dict) -> dict:
    """`bin/pretrain.py` in this rank (it joins the group from torchrun's
    environment), with every checkpoint write recorded."""
    writes, save = [], ckpt.save_checkpoint

    def recording(filename, *args, **kwargs):
        writes.append(Path(filename).name)
        return save(filename, *args, **kwargs)

    ckpt.save_checkpoint = recording
    tracing.drain()
    history = pretrain.run(pretrain.get_parser().parse_args(spec["argv"]))
    torch.cuda.synchronize()
    return {"writes": writes, "history": history, "launches": (n_istft(), n_adjoint()),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def data_parallel_trainer(card: str, root: Path) -> None:
    """Phase 16c: `bin/pretrain.py` as 2 processes (global batch 16, 8 per
    rank, 1 epoch of 96 recordings: 6 steps), as torchrun would start them:
    the ranks' losses, their launches, and only rank 0 writing."""
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
    ranks = spawn_ranks(DIST_WORLD, "dist_trainer_rank", {"group": "trainer", "argv": argv},
                        root / "dist_trainer_out")
    files = sorted(p.name for p in exp.rglob("*") if p.is_file())
    report = {"config": "mel_24k_base", "processes": DIST_WORLD, "device": device,
              "global_batch": DIST_BATCH, "seconds_per_item": 1.5,
              "steps": steps, "loss_curve": [h["loss"] for h in ranks[0]["history"]],
              "peak_memory_gb_per_rank": [r["peak_gb"] for r in ranks],
              "launches_per_rank": [r["launches"] for r in ranks],
              "writes_per_rank": [r["writes"] for r in ranks], "files": files, "card": card}
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
    train_tokenizer.main(["--model-name", "token_24k_base", "--recordings",
                          str(root / "train" / "recordings.jsonl.gz"), "--output", str(out),
                          "--max-frames", "16384", "--iters", "6", "--device", "cuda"])
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
        "iters": 6, "ids_used_of_1024": len(ids_cpu.unique()),
        "card_vs_cpu_tokens": agree, "card": card}))
    return out


def token_serving(card: str, codebook: Path) -> None:
    """18b: token_24k_base served through `get_model(tokenizer=...)` at batch
    16 x 94 frames of ids in host memory, 1/2/4 steps: the launches (3 per
    Euler step), card against CPU through infer_from_noise, and
    `reconstruct`."""
    model = get_model("token_24k_base", device="cuda", seed=0, tokenizer=codebook)
    ids = np.random.RandomState(0).randint(0, 1024, (16, 94))
    tracing.drain()
    for n in (1, 2, 4):
        before = n_istft()
        wav = model.infer(ids, n_timesteps=n)
        torch.cuda.synchronize()
        if wav.shape != (16, 24064) or not torch.isfinite(wav).all():
            raise AssertionError(f"token {n}-step output {tuple(wav.shape)} not finite (16, 24064)")
        if n_istft() - before != 3 * n:
            raise AssertionError(f"token {n}-step call launched the kernel "
                                 f"{n_istft() - before} times, expected {3 * n}")
    if n_adjoint():
        raise AssertionError(f"token serving launched the adjoint {n_adjoint()} times")
    print(f"token serving: token_24k_base infer at 1/2/4 steps, batch 16, fused_istft launches "
          f"{n_istft()}")

    cpu = get_model("token_24k_base", device="cpu", seed=0).module
    rng = np.random.RandomState(2)
    cond = torch.from_numpy(rng.randint(0, 1024, (2, 94)))
    noise = torch.from_numpy((0.1 * rng.randn(2, 24064)).astype(np.float32))
    for n in (1, 2, 4):
        with torch.inference_mode():
            before = n_istft()
            a = model.module.infer_from_noise(noise.cuda(), cond.cuda(), n_timesteps=n).cpu()
            if n_istft() - before != 3 * n:
                raise AssertionError("the token card run did not go through the kernel")
            b = cpu.infer_from_noise(noise, cond, n_timesteps=n)
        rel = (a - b).abs().max().item() / b.abs().max().item()
        print(f"token card vs CPU {n} step(s), batch 2: max_rel_err={rel:.3e}")
        if not rel <= CARD_VS_CPU_TOL:
            raise AssertionError(f"token_24k_base: card and CPU disagree at {n} steps: {rel}")

    tracing.drain()
    wav = model.reconstruct(0.1 * torch.randn(4, 24000, generator=torch.Generator().manual_seed(3)),
                            n_timesteps=1)
    torch.cuda.synchronize()
    launches = (n_istft(), n_adjoint())
    if wav.shape != (4, 24064) or not torch.isfinite(wav).all() or launches != (3, 0):
        raise AssertionError(f"token reconstruct gave {tuple(wav.shape)}, launches {launches}")
    print(f"token reconstruct: (4, 24000) waveform -> tokens -> {tuple(wav.shape)}, finite, "
          f"3 launches")


def token_trainer(card: str, root: Path, codebook: Path) -> Path:
    """18d: `bin/pretrain.py --model-name token_24k_base --tokenizer` for 8
    steps at batch 16 x 1.5 s on half of phase 10's corpus, every step's
    launches checked; then its average. Returns the averaged model's path."""
    exp = root / "tokens" / "exp_fm"
    args = pretrain.get_parser().parse_args([
        "--model-name", "token_24k_base", "--tokenizer", str(codebook), "--batch-size", "16",
        "--duration", "1.5", "--num-epochs", "1", "--num-workers", "4", "--seed", "0",
        "--save-every-n", "1000", "--average-period", "4", "--log-interval", "4",
        "--valid-interval", "4", "--device", "cuda", "--exp-dir", str(exp),
        "--tensorboard", "false", "--train-recordings", str(root / "train_half.jsonl.gz"),
        "--valid-recordings", str(root / "valid" / "recordings.jsonl.gz")])
    torch.cuda.reset_peak_memory_stats()
    tracing.drain()
    history, calls = run_counting_steps(pretrain, "fm_train_step", args)
    torch.cuda.synchronize()
    launches = {"forward": n_istft(), "adjoint": n_adjoint()}
    steps = len(history)
    if steps != TOKEN_STEPS or {c[1:] for c in calls} != {(3, 3)} or len(calls) != steps or \
            launches != {"forward": 3 * (steps + 2), "adjoint": 3 * steps}:
        raise AssertionError(f"token trainer: {steps} steps, per step {calls}, in all {launches}")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite token training loss: {losses}")
    print("token trainer " + json.dumps({
        "config": "token_24k_base", "batch": 16, "seconds_per_item": 1.5, "steps": steps,
        "launches_per_step": calls[0][1:], "loss_curve": losses,
        "clip_scale": [h["clip_scale"] for h in history],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches, "card": card}))
    averaged = save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "1", "--avg", "1"])
    for path in exp.glob("*.pt"):
        if path != averaged:
            path.unlink()
    return averaged


def token_finetune(card: str, root: Path, codebook: Path, averaged: Path) -> tuple:
    """18e: `bin/finetune.py --tokenizer` on token_24k_base at 4 Euler steps,
    batch 16 x 1.5 s, from 18d's average, 8 batches (2 D-only); every step's
    launches checked: D 12 forward, G 12 forward and 12 adjoint; the run
    exported both ways (`check_gan_exports`). Returns the run's (forward,
    adjoint) launches."""
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
    tracing.drain()
    history, calls = run_counting_steps(finetune, "make_gan_steps", args)
    torch.cuda.synchronize()
    n = 3 * GAN_STEPS
    sides = "".join(h["side"] for h in history)
    per_kind = {kind: sorted({(f, b) for k, f, b in calls if k == kind}) for kind in ("D", "G")}
    g_steps = sides.count("G")
    by_kind = launches_by_kind(calls)
    launches = {"forward": n_istft(), "adjoint": n_adjoint(),
                "d_steps": by_kind["D"], "g_steps": by_kind["G"]}
    if sides != TOKEN_GAN_SIDES or per_kind != {"D": [(n, 0)], "G": [(n, n)]} or \
            launches["forward"] != n * len(calls) or launches["adjoint"] != n * g_steps:
        raise AssertionError(f"token fine-tuner: sides {sides}, per step {per_kind}, {launches}")
    losses = [h["loss"] for h in history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite token GAN loss: {losses}")
    # the token drive's two exports: the windowed average over batches 4 and
    # 8, and the last weights
    windowed = save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "1", "--avg", "1",
                                         "--load-gan", "true", "--output", str(exp / "generator.pt")])
    check_gan_exports(exp, windowed, exp / "last" / "generator.pt")
    print("token fine-tuner " + json.dumps({
        "config": "token_24k_base", "n_timesteps": GAN_STEPS, "batch": 16,
        "seconds_per_item": 1.5, "sides": sides,
        "loss_d": [h["loss"] for h in history if h["side"] == "D"],
        "loss_g": [h["loss"] for h in history if h["side"] == "G"],
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
        "last_weights_export": "equals epoch-1's generator; the windowed export differs",
        "card": card}))
    shutil.rmtree(exp, ignore_errors=True)
    return launches["forward"], launches["adjoint"]


def check_gan_exports(run: Path, windowed: Path, last: Path) -> None:
    """A GAN run's two exports, as the held-out drives make them: the last
    weights (`save_averaged_model --use-averaged-model false` over epoch 1,
    written to `last`) equal epoch-1's generator bit for bit, and the
    windowed export `windowed` (the running average over (epoch-0,
    epoch-1]) does not."""
    last = torch.load(save_averaged_model.main([
        "--exp-dir", str(run), "--epoch", "1", "--avg", "1", "--use-averaged-model", "false",
        "--load-gan", "true", "--output", str(last)]), weights_only=True)
    epoch1 = ckpt.load_checkpoint(run / "epoch-1.pt")["model"]["generator"]
    windowed = torch.load(windowed, weights_only=True)
    if last.keys() != epoch1.keys() or not all(torch.equal(last[k], epoch1[k]) for k in epoch1):
        raise AssertionError(f"{run}: the last-weights export differs from epoch-1's generator")
    if windowed.keys() != last.keys() or all(torch.equal(windowed[k], last[k]) for k in last):
        raise AssertionError(f"{run}: the windowed export equals the last weights")


def token_clis(card: str, root: Path, codebook: Path, averaged: Path) -> None:
    """18f: `bin/infer --tokenizer` over phase 14's manifest, and
    `bin/infer_dir` on its wavs with `--tokenizer` and on their tokens
    (.npy, from the codebook on the card) with `--tokens true`, whole and in
    50-frame chunks; checked as phase 14 checks the mel CLIs, and each token
    run against the wav run that tokenized the same audio; each run's
    launches (forward, adjoint; bin/infer_dir's: the kernels the profiler
    saw run)."""
    cli, out = root / "cli", root / "tokens" / "cli"
    recs = read_recording_manifest(cli / "recordings.jsonl.gz")
    common = ["--model-name", "token_24k_base", "--checkpoint", str(averaged), "--device", "cuda"]
    launches = {}
    tracing.drain()
    written = infer.main([*common, "--tokenizer", str(codebook),
                          "--recordings", str(cli / "recordings.jsonl.gz"),
                          "--root-path", str(root / "valid"), "--output-dir", str(out / "infer"),
                          "--batch-size", "4", "--num-workers", "2"])
    launches["infer"] = (n_istft(), n_adjoint())
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
            # equal-length files and chunks repeat a key, which replays a CUDA graph
            with kernels_run() as ran:
                runs[key] = infer_dir.main([*common, *flags, "--output-dir", str(out / key),
                                            *extra])
            launches[key] = (ran["forward"], ran["adjoint"])
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


def token_family(card: str, root: Path, clock: PhaseClock) -> tuple:
    """Phase 18, the token family at full width: 18a-f, each followed by
    its phase line on `clock`. Returns the token fine-tuner's (forward,
    adjoint) launches."""
    codebook = token_codebook(card, root)
    clock.done("18a_token_codebook")
    token_serving(card, codebook)
    clock.done("18b_token_serving")
    for seed in (5, 6):
        grads_card_vs_cpu(card, "token_24k_base", seed, float64="check")
    clock.done("18c_token_grads_card_vs_cpu")
    averaged = token_trainer(card, root, codebook)
    clock.done("18d_token_trainer")
    gan = token_finetune(card, root, codebook, averaged)
    clock.done("18e_token_finetune")
    token_clis(card, root, codebook, averaged)
    shutil.rmtree(root / "tokens", ignore_errors=True)
    clock.done("18f_token_clis")
    return gan


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


def observability_pretrain(card: str, root: Path, test: Path) -> None:
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
    tracing.drain()
    history, calls = run_counting_steps(pretrain, "fm_train_step", args)
    torch.cuda.synchronize()
    launches = (n_istft(), n_adjoint())
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
    shutil.rmtree(exp)
    print("observability pretrain " + json.dumps({
        "steps": len(history), "launches": launches, "profiled_window": window,
        "trace_kernel_events": traced, "event_tags": len(tags), "best_valid_loss": best,
        "card": card}))


def observability_inf_check(card: str, root: Path) -> None:
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

    tracing.drain()
    pretrain.fm_train_step = poisoned
    try:
        history = pretrain.run(args)
    finally:
        pretrain.fm_train_step = step
    torch.cuda.synchronize()
    launches = (n_istft(), n_adjoint())
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
                              label: str) -> None:
    """19c (and the fine-tuner's in 19d): --print-diagnostics at batch 4 x
    1 s: 5 batches, the tables, the PReLU histograms, exit; the tables of
    each kind counted, and the pass's launches."""
    exp = root / f"exp_diag_{label}"
    args = module.get_parser().parse_args(argv + [
        "--batch-size", "4", "--duration", "1.0", "--num-epochs", "1", "--num-workers", "4",
        "--seed", "0", "--save-every-n", "1000", "--log-interval", "1", "--valid-interval", "0",
        "--device", "cuda", "--exp-dir", str(exp), "--tensorboard", "false",
        "--print-diagnostics", "true",
        "--train-recordings", str(root / "train" / "recordings.jsonl.gz")])
    tracing.drain()
    torch.cuda.reset_peak_memory_stats()
    history = module.run(args)
    torch.cuda.synchronize()
    launches = (n_istft(), n_adjoint())
    log = trainer_log(exp)
    tables = diagnostics_tables(log)
    if (len(history) != 5 or log[-1] != "Diagnostics done, exiting" or launches != expected
            or not all(tables.values()) or (exp / "epoch-1.pt").exists()):
        raise AssertionError(f"19 diagnostics {label}: {len(history)} batches, launches "
                             f"{launches} against {expected}, tables {tables}, last {log[-1:]}")
    shutil.rmtree(exp)
    print("observability diagnostics " + json.dumps({
        "trainer": label, "batches": len(history), "tables": tables,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
        "card": card}))


def observability_finetune(card: str, root: Path, test: Path, averaged: Path) -> None:
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
    tracing.drain()
    history, calls = run_counting_steps(finetune, "make_gan_steps", args)
    torch.cuda.synchronize()
    n = 3 * GAN_STEPS
    per_kind = {kind: sorted({(f, b) for k, f, b in calls if k == kind}) for kind in ("D", "G", "eval")}
    counts = {kind: sum(k == kind for k, _, _ in calls) for kind in ("D", "G", "eval")}
    sides = "".join(h["side"] for h in history)
    # the test samples: 4 files at GAN_STEPS steps after each of 2 validations
    launches = (n_istft(), n_adjoint())
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
    print("observability finetune " + json.dumps({
        "batches": len(history), "sides": sides, "launches": launches,
        "d_steps": by_kind["D"], "g_steps": by_kind["G"], "validation": by_kind["eval"],
        "profiled_window": window, "trace_kernel_events": traced, "event_tags": len(tags),
        "clip_scale": [h["clip_scale"] for h in history], "card": card}))
    # 5 diagnostics batches, D D G D G: each a step, an eval-form rollout
    # (n) and the G objective through the train-form rollout (n and n)
    observability_diagnostics(
        card, root, finetune, ["--model-name", "mel_24k_base", "--n-timesteps", str(GAN_STEPS),
                               "--gen-start-batch-idx", "2", "--generator-model-path",
                               str(averaged)],
        (5 * 3 * n, 5 * n + 2 * n), "finetune")


def observability(card: str, root: Path, averaged: Path) -> None:
    """Phase 19 on mel_24k_base, from phase 10's corpus and averaged model."""
    test = root / "obs_test.jsonl.gz"
    write_recording_manifest(read_recording_manifest(root / "valid" / "recordings.jsonl.gz")[:4],
                             test)
    observability_pretrain(card, root, test)
    observability_inf_check(card, root)
    # 5 batches: each a step (3, 3), the eval-form loss (3) and the train-form
    # loss's forward and backward (3, 3)
    observability_diagnostics(card, root, pretrain, ["--model-name", "mel_24k_base"],
                              (5 * 9, 5 * 6), "pretrain")
    observability_finetune(card, root, test, averaged)


# ------------------------------------------------------------ the recipe (20)

RECIPE = Path(__file__).resolve().parent / "flow2gan_tpu_torch" / "recipes" / "run_libritts.sh"
INFER_DIR = RECIPE.parent / "infer_dir.sh"
RECIPE_TIMEOUT_S = 600


def _finite_metrics(path: Path, keys) -> dict:
    summary = json.loads(path.read_text())["summary"]
    if summary["n_files"] <= 0 or not all(math.isfinite(summary[k]) for k in keys):
        raise AssertionError(f"{path}: {summary}")
    return summary


def recipe(card: str, root: Path) -> None:
    """Phase 20: the recipe on the card through `run_libritts.sh` stages 1-6
    at mel_24k_base, its artifacts checked, then its inference stage again
    in-process, `bin/from_mel.py` and `bin/from_wav.py`, each with the
    counters reset and its (forward, adjoint) launches checked, and
    `recipes/infer_dir.sh`."""
    corpus, data, exp = root / "LibriTTS", root / "manifests", root / "exp"
    make_synthetic_corpus.main(["--corpus-dir", str(corpus), "--data-dir", str(root / "synthetic"),
                                "--n-train", "16", "--n-test", "2", "--n-dev", "1",
                                "--duration", "2.0"])
    quiet = "--valid-interval 100000 --log-interval 1 --num-workers 4 --tensorboard false"
    cmd = ["bash", str(RECIPE), "--stage", "1", "--stop-stage", "6", "--corpus-dir", str(corpus),
           "--data-dir", str(data), "--exp-dir", str(exp), "--model-name", "mel_24k_base",
           "--train-splits", "train_clean_100", "--n-timesteps-list", "1",
           "--fm-epochs", "1", "--fm-batch", "8", "--fm-avg", "1",
           "--gan-epochs", "1", "--gan-batch", "4", "--gan-avg", "1", "--device", "cuda",
           "--fm-extra-args", quiet, "--gan-extra-args", f"--gen-start-batch-idx 2 {quiet}"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=RECIPE_TIMEOUT_S,
                          env={**os.environ, "PYTHON": sys.executable})
    stages = re.findall(r"Stage (\d)[b:]", proc.stdout)
    if proc.returncode != 0 or "Pipeline done." not in proc.stdout:
        raise AssertionError(f"run_libritts.sh exited {proc.returncode} after stages {stages}:\n"
                             f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    manifests = {split: len(read_recording_manifest(data / f"libritts_recordings_{split}.jsonl.gz"))
                 for split in ("train_clean_100", "dev_clean", "test_clean")}
    if manifests != {"train_clean_100": 16, "dev_clean": 1, "test_clean": 2}:
        raise AssertionError(f"stage 1 wrote manifests {manifests}")
    files = ["fm/epoch-0.pt", "fm/epoch-1.pt", "fm/averaged.pt", "gan_1step/epoch-0.pt",
             "gan_1step/epoch-1.pt", "gan_1step/generator.pt"]
    missing = [f for f in files if not (exp / f).is_file()]
    if missing or not (data / "test_clean_files.txt").is_file():
        raise AssertionError(f"the recipe left no {missing or 'test list'}")
    # every step ran on the card: FM 2 steps of 8, the GAN's 4 batches D, D, G, D
    fm_steps = [json.loads(x) for x in (exp / "fm/steps.jsonl").read_text().splitlines()]
    gan_steps = [json.loads(x) for x in (exp / "gan_1step/steps.jsonl").read_text().splitlines()]
    if (len(fm_steps) != 2 or [x["side"] for x in gan_steps] != ["D", "D", "G", "D"]
            or not all(math.isfinite(x["loss"]) for x in fm_steps + gan_steps)):
        raise AssertionError(f"recipe steps: FM {fm_steps}, GAN {gan_steps}")
    if not all("'device': 'cuda'" in (exp / d / "log").joinpath(f).read_text()
               for d in ("fm", "gan_1step") for f in os.listdir(exp / d / "log")
               if f.startswith("log-train")):
        raise AssertionError("a trainer of the recipe did not run on the card")
    wav_dir = exp / "gan_1step" / "test_clean_wavs" / "test-clean"
    wavs = sorted(wav_dir.rglob("*.wav"))
    if [w.name for w in wavs] != ["test_0000.wav", "test_0001.wav"]:
        raise AssertionError(f"stage 5 wrote {wavs}")
    pesq = _finite_metrics(exp / "gan_1step" / "metrics_pesq.json", ["mrstft"])
    pitch = _finite_metrics(exp / "gan_1step" / "metrics_pitch.json",
                            ["periodicity_rmse", "vuv_f1"])
    summary = collect_results.main(["--exp-dir", str(exp), "--output-dir", str(root / "results"),
                                    "--steps", "1"])
    if list(summary) != ["gan_1step"] or summary["gan_1step"]["pesq"]["n_files"] != 2:
        raise AssertionError(f"summary.json: {summary}")
    # the drive's second export: the last weights, where the windowed one
    # (average period 200 over 4 batches) is the FM generator it started from
    check_gan_exports(exp / "gan_1step", exp / "gan_1step" / "generator.pt",
                      root / "exp_last" / "gan_1step" / "generator.pt")

    launches = {}
    test_manifest = data / "libritts_recordings_test_clean.jsonl.gz"
    tracing.drain()
    written = infer.main(["--model-name", "mel_24k_base", "--checkpoint",
                          str(exp / "gan_1step/generator.pt"), "--recordings", str(test_manifest),
                          "--root-path", str(corpus), "--output-dir", str(root / "infer_again"),
                          "--n-timesteps", "1", "--device", "cuda"])
    launches["recipe_infer_stage_1_step"] = (n_istft(), n_adjoint())
    for path, again in zip(wavs, sorted(written)):
        ours, _ = read_wav(again)
        theirs, _ = read_wav(path)
        if ours.shape != theirs.shape or np.abs(ours - theirs).max() > 2.0 / 32768:
            raise AssertionError(f"the inference stage in-process differs from the recipe's: {path}")
    audio, _ = read_wav(wavs[0])
    mel = LogMelSpectrogram()(torch.from_numpy(audio)).numpy()
    np.save(root / "test_0000_mel.npy", mel)
    outs = {}
    for name, module, argv in [("from_mel", from_mel, ["--mel-file", str(root / "test_0000_mel.npy")]),
                               ("from_wav", from_wav, ["--wav-file", str(wavs[0])])]:
        tracing.drain()
        out = module.main([*argv, "--checkpoint", str(exp / "gan_1step/generator.pt"),
                           "--n-timesteps", "1", "--output", str(root / f"{name}.wav"),
                           "--device", "cuda"])
        launches[f"recipe_{name}_1_step"] = (n_istft(), n_adjoint())
        outs[name], sr = read_wav(out)
        if sr != 24000 or outs[name].shape != (1, mel.shape[-1] * 256) or not np.isfinite(outs[name]).all():
            raise AssertionError(f"bin/{name}.py wrote {outs[name].shape} at {sr} Hz")
    expected = {"recipe_infer_stage_1_step": (3, 0), "recipe_from_mel_1_step": (3, 0),
                "recipe_from_wav_1_step": (3, 0)}
    if launches != expected:
        raise AssertionError(f"recipe launches {launches}, expected {expected}")

    # infer_dir.sh as a user runs it: the test WAVs, the mel above, the WAVs in chunks
    wav_in = sorted((corpus / "test-clean").rglob("*.wav"))
    mel_in = root / "infer_dir_mels"
    mel_in.mkdir()
    shutil.copy(root / "test_0000_mel.npy", mel_in)
    out_dir = root / "infer_dir"
    proc = subprocess.run(["bash", str(INFER_DIR), "--wav-dir", str(wav_in[0].parent),
                           "--mel-dir", str(mel_in), "--checkpoint", str(exp / "gan_1step/generator.pt"),
                           "--out-dir", str(out_dir)], capture_output=True, text=True,
                          timeout=RECIPE_TIMEOUT_S, env={**os.environ, "PYTHON": sys.executable})
    if proc.returncode != 0:
        raise AssertionError(f"infer_dir.sh exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    lengths = {}
    for mode, names in [("out_wav", [w.name for w in wav_in]), ("out_mel", ["test_0000_mel.wav"]),
                        ("out_stream", [w.name for w in wav_in])]:
        outs = sorted((out_dir / mode).glob("*.wav"))
        if [o.name for o in outs] != names:
            raise AssertionError(f"infer_dir.sh wrote {outs} in {mode}, expected {names}")
        for o in outs:
            wav, sr = read_wav(o)
            if sr != 24000 or wav.size == 0 or not np.isfinite(wav).all():
                raise AssertionError(f"infer_dir.sh wrote {wav.shape} at {sr} Hz to {o}")
            lengths[(mode, o.name)] = wav.shape[-1]
        if not all("'device': 'cuda'" in f.read_text() for f in (out_dir / mode / "log").iterdir()):
            raise AssertionError(f"infer_dir.sh's {mode} call did not run on the card")
    if any(lengths[("out_stream", w.name)] != lengths[("out_wav", w.name)] for w in wav_in):
        raise AssertionError(f"streaming and whole-file lengths differ: {lengths}")
    print("recipe " + json.dumps({
        "stages": sorted(set(stages)),
        "manifests": manifests, "fm_steps": len(fm_steps),
        "gan_sides": "".join(x["side"] for x in gan_steps), "mrstft": pesq["mrstft"],
        "last_weights_export": "equals epoch-1's generator; the windowed export differs",
        "periodicity_rmse": pitch["periodicity_rmse"], "vuv_f1": pitch["vuv_f1"],
        "launches": launches, "card": card}))


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
    # the kernels' launch counters count while the program's tracing is on;
    # the kernel timings turn it off (`untraced`)
    tracing.enable()
    clock = PhaseClock()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    clock.done("1_card")
    build = cuda_build.build("fused_istft")
    print(f"build: {build.path.name} in {build.seconds:.2f} s")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    clock.done("2_build")

    print(f"bound_ms: portbench/yardstick.py's, the larger of the bytes at "
          f"{yardstick.HBM_BYTES_PER_S:.3g} B/s and the FFT-form FLOP at "
          f"{yardstick.FP32_FLOP_PER_S:.3g} FLOP/s")
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
    clock.done("3_istft_kernel")
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
    clock.done("4_adjoint_kernel_and_reference_batches")

    model = get_model("mel_24k_base", device="cuda", seed=0)
    # the request's mel arrives in host memory, as a server receives it
    mel = torch.from_numpy(np.random.RandomState(0).randn(16, 100, 94).astype(np.float32))
    serving = main_path(model, mel)
    clock.done("5_main_path")
    card_vs_cpu()
    clock.done("6_card_vs_cpu")
    audio = 0.1 * torch.randn(4, 24000, generator=torch.Generator().manual_seed(3))
    wav = model.reconstruct(audio, n_timesteps=1)
    if wav.shape != (4, 24064) or not torch.isfinite(wav).all():
        raise AssertionError(f"reconstruct gave {tuple(wav.shape)}")
    print(f"reconstruct: (4, 24000) waveform -> {tuple(wav.shape)}, finite")
    clock.done("7_reconstruct")
    bf16_serving(card, model, mel)
    del model
    clock.done("11_bf16_serving")
    card_vs_cpu_44k()
    clock.done("12_card_vs_cpu_44k")
    graph_replay(card)
    clock.done("22_graph_replay")
    chain_kernels = convnext_chain_phase(card)
    clock.done("23_convnext_chain")
    train_chain_kernels = convnext_train_chain_phase(card)
    clock.done("24_convnext_train_chain")
    grads_card_vs_cpu(card, float64="report")
    clock.done("9_grads_card_vs_cpu_and_float64")
    discriminators_card_vs_cpu(card)
    gan_grads_card_vs_cpu(card)
    clock.done("15abc_discriminators_and_gan_objectives_card_vs_cpu")
    root = Path(__file__).resolve().parent / "build" / "smoke_train"
    train_launches, exp, averaged = trainer(card, root)
    clock.done("10_trainer")
    bf16_trainer(card, root)
    clock.done("13_bf16_trainer")
    clis(card, root, exp, averaged)
    for path in [*exp.glob("*.pt"), *(root / "exp_bf16").glob("*.pt")]:
        if path != averaged:
            path.unlink()  # several GB of FM checkpoints
    clock.done("14_clis")
    gan_launches, gan_exp = gan_finetune(card, root, averaged)
    clock.done("15d_gan_finetune")
    gan_remat(card, averaged)
    clock.done("15f_gan_remat")
    gan_clis(card, root, gan_exp)
    shutil.rmtree(gan_exp, ignore_errors=True)
    clock.done("15g_gan_clis")
    data_parallel_steps(card)
    clock.done("16ab_data_parallel_steps")
    data_parallel_trainer(card, root)
    clock.done("16c_data_parallel_trainer")
    resume_phase(card, root, averaged)
    clock.done("17_resume")
    token_gan_launches = token_family(card, root, clock)
    observability(card, root, averaged)
    shutil.rmtree(root, ignore_errors=True)  # several GB of checkpoints
    clock.done("19_observability")
    recipe(card, root / "recipe")
    shutil.rmtree(root, ignore_errors=True)
    clock.done("20_recipe")

    # (forward, adjoint) launches on the paths of PERF.md's kernel table
    paths = {"serving_f32_1_2_4_steps": serving,
             f"training_f32_{TRAIN_STEPS}_steps": (train_launches["forward"],
                                                   train_launches["adjoint"]),
             f"gan_finetune_{GAN_STEPS}_steps_{GAN_BATCHES}_batches": gan_launches,
             f"token_finetune_{GAN_STEPS}_steps_8_batches": token_gan_launches}
    step = shapes[:3]  # the three branches of one mel_24k_base Euler step
    train_step = adjoint_shapes[-3:]  # the three branches of one training step
    print(json.dumps({"kernels": [{
        "name": "fused_istft",
        "route": "cuda",
        "source": "flow2gan_tpu_torch/csrc/fused_istft.cu",
        "replaces": "flow2gan_tpu/ops/pallas_istft.py:240",
        "launches_by_path": {k: v[0] for k, v in paths.items()},
        "max_abs_err": max(s["max_abs_err"] for s in shapes + reference_batches["istft"]),
        "max_rel_err": max(s["max_rel_err"] for s in shapes + reference_batches["istft"]),
        "ms": sum(s["ms"] for s in step),
        "plain_ms": sum(s["plain_ms"] for s in step),
        "bound_ms": sum(s["bound_ms"] for s in step),
        "library_ms": sum(s["library_ms"] for s in step),
        "floor_ms": floor_ms,
        "per": "one mel_24k_base Euler step at batch 16: the sum over its three branch shapes",
        "shapes": shapes + reference_batches["istft"],
    }, {
        "name": "fused_istft_adjoint",
        "route": "cuda",
        "source": "flow2gan_tpu_torch/csrc/fused_istft.cu",
        "replaces": "flow2gan_tpu/ops/pallas_istft.py:222",
        "launches_by_path": {k: v[1] for k, v in paths.items()},
        "max_abs_err": max(s["max_abs_err"] for s in adjoint_shapes + reference_batches["adjoint"]),
        "max_rel_err": max(s["max_rel_err"] for s in adjoint_shapes + reference_batches["adjoint"]),
        "ms": sum(s["ms"] for s in train_step),
        "plain_ms": sum(s["plain_ms"] for s in train_step),
        "bound_ms": sum(s["bound_ms"] for s in train_step),
        "library_ms": sum(s["library_ms"] for s in train_step),
        "floor_ms": floor_ms,
        "per": "one mel_24k_base training step at batch 16 x 1.5 s: the sum over its three branch shapes",
        "shapes": adjoint_shapes + reference_batches["adjoint"],
    }, *chain_kernels, *train_chain_kernels]}))
    clock.done("21_kernels_line")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
