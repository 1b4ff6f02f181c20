"""GAN fine-tuning (stage 2), the fine-tuner's loop as `bin/finetune.py`
runs it, on one card: the port's `DataLoader` over a corpus made from the
seed, the batch moved to the card, the rollout's draws from the step's
generator, `make_gan_steps`' D and G steps with two ScaledAdams and their
Eden2 rates, the loss fetched each step. The first `gen_start_batch_idx`
batches train the discriminators alone; then D and G steps alternate, one
batch each.

Set-up builds the steps' objects once and drives them through the first
`setup_steps` batches with the window's own calls and feed, so that the
window starts at a D step having run both kinds of step; the window closes
after a G step, so that it holds whole D/G pairs. Its rate is the crop
seconds of all its batches over its wall time. The reference follows the
steps up to the first G step after the window and is compared with the
first D step and the first G step: each one's loss and each parameter's
change over it, the D step's gradient norms, and the G step's residual
scales' gradient norms. In float32 the G gradient hangs on the log-mels of
the 2048- and 1024-point scales at their near-empty lowest bins: their
rounding moves a branch's whole gradient by a common factor, up to 2.4
times between two sound float32 computations, and single parameters'
norms by more, while within a branch the residual scales keep their
pattern. So the G gradient is judged by its residual scales
(`g_residual_scale_gap`): each against the reference once the program's
norm is divided by its branch's median ratio (PERF.md section 4 has the
card's readings); its worst parameter is printed. They are limited
parameters, where the G backward's own rule (each use's gradient flipped
by its gate, the gates the recompute must use again) acts. A factor on a
whole branch's gradient is not seen, and moves no step of ScaledAdam,
which takes each parameter's step from its gradient's sign and its own
scale. The change after ScaledAdam's first step is 0.1 lr rms sign(g) for
each element whatever the gradient's size, and the loss comes from the
forward alone: neither sees a G backward that is wrong.

A traced run traces `trace_steps` more batches after the window, with the
program's spans and counters on (`flow2gan_tpu_torch.tracing`, where the
program has them), and puts what it drained beside the trace's digest in
`obs`, with what the training cells' readers take (`steps`, the harness's
spans, the window's operations `flop`, each iSTFT launch's bound).

Faults of its own, besides `portbench/faults.py`'s (`--fault <name>`):
- `no_mrd_fmap`: the G step's MRD feature-matching term is dropped;
- `mrd_batch_peak`: the MRD scales each signal by the batch's peak, not by
  its own row's;
- `remat_gates`: the G step's backward recomputes every Euler step with
  the first step's gates (its forward is untouched);
- `no_limiter_flips`: the limiters never flip a gradient (only the G
  step's backward runs them).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

import torch
import torch.utils.checkpoint

from portbench import faults, harness, traffic, yardstick, yardstick_gan
from portbench.reference import check
from portbench.reference.gan import change_norms, disc_param_specs, follow_gan
from portbench.tracing import Spans, Trace
from portbench.weights_gan import make_disc_weights

FAULTS = ("no_mrd_fmap", "mrd_batch_peak", "remat_gates", "no_limiter_flips")


@contextlib.contextmanager
def planted(name: Optional[str]):
    if name not in FAULTS:
        with faults.planted(name):
            yield
        return
    from flow2gan_tpu_torch.models import discriminators, norms
    from flow2gan_tpu_torch.ops.stft import stft
    from flow2gan_tpu_torch.training import gan_step

    if name == "no_limiter_flips":
        owner, attr = norms.LimitParamValue, "backward"
        patched = staticmethod(lambda ctx, g: (g, None, None, None))
    elif name == "remat_gates":
        owner, attr = torch.utils.checkpoint, "checkpoint"
        checkpoint, first = torch.utils.checkpoint.checkpoint, {}

        def patched(fn, x, cond, t, dt, lens, gates, **kwargs):
            if t == 0.0:
                first["gates"] = gates
            calls = []

            def once_right(*args):
                calls.append(None)  # the second call is the recompute in backward
                return fn(*args) if len(calls) == 1 else fn(*args[:-1], first["gates"])

            return checkpoint(once_right, x, cond, t, dt, lens, gates, **kwargs)
    elif name == "no_mrd_fmap":
        owner, attr = gan_step, "feature_matching_loss"
        matching = gan_step.feature_matching_loss

        def patched(real, fake):
            loss = matching(real, fake)
            # an MRD judgement carries 21 feature maps a window, an MPD's 5 a period
            return loss * 0.0 if len(real[0]) > 5 else loss
    else:
        owner, attr = discriminators.DiscriminatorR, "spectrogram"

        def patched(self, x):
            x = x - x.mean(dim=-1, keepdim=True)
            x = 0.8 * x / (x.abs().amax() + 1e-9)
            spec = stft(x, self.window_length, self.hop_length)
            return torch.stack([spec.real, spec.imag], dim=1)
    saved = vars(owner)[attr]  # a class's staticmethod as it is
    setattr(owner, attr, patched)
    try:
        yield
    finally:
        setattr(owner, attr, saved)


def residual_scale_gaps(ours: dict, theirs: dict) -> dict:
    """Each residual scale's gradient-norm gap (`check.norm_gaps`) once the
    program's norm is divided by its branch's common scale: the median,
    over the residual scales of the module that holds its blocks, of the
    program's norm over the reference's (a branch of zeros, which has no
    scale, is taken as it is)."""
    names = [n for n in theirs if n.endswith("residual_scale.scale")]
    ratios: dict = {}
    for n in names:
        ratios.setdefault(n.split(".blocks.")[0], []).append(ours[n] / max(theirs[n], 1e-30))
    scale = {branch: statistics.median(r) or 1.0 for branch, r in ratios.items()}
    return check.norm_gaps({n: ours[n] / scale[n.split(".blocks.")[0]] for n in names},
                           theirs, names)


def side_of(k: int, gen_start: int) -> str:
    """The side of batch k (from 0): D for the first `gen_start`, then G
    and D in turn (`bin/finetune.py`'s `train_disc`)."""
    return "d" if k < gen_start or (k - gen_start) % 2 else "g"


def recipe(r: harness.Run) -> dict:
    mix = r.mix
    if mix["world"] != 1:
        raise ValueError("the GAN driver runs on one card")
    return dict(mix["optimizer"], world=1, local_batch=mix["batch"],
                batches_per_epoch=mix["utterances"] * mix["manifest_repeats"] // mix["batch"],
                duration=mix["crop_s"], max_load_times=mix["max_load_times"],
                loader_seed=r.seed_for(2) % 2**31, draw_seed=r.seed_for(3) % 2**31,
                n_timesteps=mix["n_timesteps"])


def disc_weights(r: harness.Run, device: torch.device):
    return make_disc_weights(disc_param_specs(r.cfg["gan"]), r.seed_for(5), device)


def _train(r: harness.Run, rec: dict, dev: torch.device, out: Path) -> dict:
    from flow2gan_tpu_torch import tracing
    from flow2gan_tpu_torch.data.dataset import build_data_loader, read_recording_manifest
    from flow2gan_tpu_torch.models.discriminators import Discriminators
    from flow2gan_tpu_torch.models.gan import make_mel_recon_fns
    from flow2gan_tpu_torch.ops.stft import num_frames
    from flow2gan_tpu_torch.ops.tokenizer import conditioning_frontend
    from flow2gan_tpu_torch.training import optim
    from flow2gan_tpu_torch.training.gan_step import GANLossScales, make_gan_steps
    from flow2gan_tpu_torch.training.train_step import step_generator

    mix, cfg = r.mix, r.cfg
    gan, n_steps, gen_start = cfg["gan"], mix["n_timesteps"], mix["gen_start_batch_idx"]
    generator, acfg = harness.build_generator(r, dev)
    disc = Discriminators(gan["mpd_periods"], gan["mrd_fft_sizes"]).to(dev)
    disc.load_state_dict(disc_weights(r, dev), strict=True)
    start = {"g": {n: p.detach().clone() for n, p in generator.named_parameters()},
             "d": {n: p.detach().clone() for n, p in disc.named_parameters()}}
    cond_fn = conditioning_frontend(acfg, None, r.config_name).to(dev)
    recon = make_mel_recon_fns(cfg["sampling_rate"], gan["mel_recon_n_ffts"],
                               gan["mel_recon_n_mels"]).to(dev)
    moved = {"d": disc, "g": generator}
    opts = {side: optim.ScaledAdam(m.named_parameters(), clipping_scale=rec["clipping_scale"])
            for side, m in moved.items()}

    def lr_fn(side):
        return lambda b: optim.eden2_lr(rec[f"lr_{side}"], b, rec[f"lr_batches_{side}"],
                                        warmup_batches=rec["warmup_batches"],
                                        warmup_start=rec["warmup_start"])

    d_step, g_step, _ = make_gan_steps(generator, disc, cond_fn, recon, opts["g"], opts["d"],
                                       lr_fn("g"), lr_fn("d"), n_timesteps=n_steps,
                                       scales=GANLossScales(**gan["loss_scales"]),
                                       remat_rollout=mix["remat_rollout"])
    steps = {"d": d_step, "g": g_step}
    harness.phase("program built")
    traffic.write_corpus(out / "corpus", r.seed, mix, cfg["sampling_rate"], dev)
    harness.phase("corpus made")
    loader = build_data_loader(read_recording_manifest(out / "corpus" / "train.jsonl"),
                               sampling_rate=cfg["sampling_rate"], batch_size=rec["local_batch"],
                               num_workers=mix["num_workers"], train=True,
                               duration=rec["duration"], max_load_times=rec["max_load_times"],
                               seed=rec["loader_seed"], drop_last=True)
    spans = Spans(traced=r.trace)

    def feed():
        epoch = 0
        while True:
            epoch += 1
            loader.set_epoch(epoch)
            yield from loader

    batches = feed()
    first = {}

    def step(k):
        side = side_of(k, gen_start)
        with spans("loader.next"):
            batch = next(batches)
        with spans(f"{side}_step"):
            dev_batch = {"audio": torch.from_numpy(batch["audio"]).to(dev),
                         "audio_lens": torch.from_numpy(batch["audio_lens"]).to(dev)}
            audio = dev_batch["audio"]
            draws = generator.draw_rollout(audio.shape[0], num_frames(audio.shape[-1],
                                                                      cfg["mel_hop_length"]),
                                           n_steps, step_generator(rec["draw_seed"], k, dev),
                                           train=side == "g")
            metrics = steps[side](dev_batch, draws)
        with spans("loss_fetch"):
            loss = float(metrics[f"loss_{side}"])
        if side not in first:
            first[side] = {"losses": [loss], "grad_norms": check.first_grad_norms(opts[side]),
                           "change_norms": change_norms(moved[side], start[side])}
        return side

    setup = mix["setup_steps"]
    times = []
    for k in range(setup):
        t = harness.clock()
        step(k)
        times.append(harness.clock() - t)
    del start
    if set(first) != {"d", "g"} or side_of(setup, gen_start) != "d":
        raise ValueError("set-up must take a D and a G step and end before a D step")
    harness.phase(f"first steps, {[round(t, 3) for t in times]} s")
    spans.seconds.clear()
    harness.sync(dev)
    window_start = time.time()
    t0 = harness.clock()
    k = setup
    while True:
        side = step(k)
        k += 1
        if side == "g" and harness.clock() - t0 >= r.seconds:
            break
    wall = harness.clock() - t0
    n_batches = k - setup
    obs = {}
    if r.trace:
        tracing.drain()
        tracing.enable()
        try:
            with Trace(dev) as trace:
                for j in range(k, k + mix["trace_steps"]):
                    step(j)
        finally:
            tracing.disable()
        drained = tracing.drain()
        obs = trace.digest()
        device_ms = defaultdict(list)
        for s in drained.spans:
            device_ms[s.name].append(s.device_ms)
        # each branch's iSTFT on the rollout's x0 once an Euler step, and its
        # adjoint once an Euler step in G; a G step's recompute runs them again
        # but the last branch's, which saves nothing for backward, so that
        # the checkpoint's recompute stops before it
        traced = [side_of(j, gen_start) for j in range(k, k + mix["trace_steps"])]
        steps_run = n_steps * len(traced)
        recomputed = n_steps * traced.count("g") if mix["remat_rollout"] else 0
        hop = cfg["mel_hop_length"]
        length = int(rec["duration"] * cfg["sampling_rate"])
        shapes = yardstick.branch_shapes(cfg, rec["local_batch"], num_frames(length, hop) * hop)
        obs.update(steps=mix["trace_steps"], spans=dict(spans.seconds),
                   program={"device_ms": dict(device_ms), "counters": drained.counters},
                   istft_bound_s=[yardstick.istft_bound_s(*s) for _ in range(steps_run)
                                  for s in shapes]
                   + [yardstick.istft_bound_s(*s) for _ in range(recomputed) for s in shapes[:-1]],
                   adjoint_bound_s=[yardstick.adjoint_bound_s(*s)
                                    for _ in range(n_steps * traced.count("g")) for s in shapes])
        counted = [drained.counters.get(f"gan.{side}_steps") for side in "dg"]
        if None not in counted:  # a program without the GAN counters: no operations
            obs["flop"] = (
                counted[0] * yardstick_gan.d_step_flop(cfg, rec["local_batch"], length, n_steps)
                + counted[1] * yardstick_gan.g_step_flop(cfg, rec["local_batch"], length, n_steps))
    return {"first": first, "n_batches": n_batches, "wall": wall,
            "memory": harness.memory_peak(dev), "obs": obs, "window_start": window_start}


def run(r: harness.Run) -> harness.Result:
    from flow2gan_tpu_torch.utils import disable_tf32

    mix, dev = r.mix, r.device
    rec = recipe(r)
    if dev.type == "cuda":
        disable_tf32()
    out = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    try:
        with planted(r.fault):
            ours = _train(r, rec, dev, Path(out))
        gc.collect()  # the program's models and optimizers, before the reference's
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        corpus = [json.loads(line)["sources"][0]["source"]
                  for line in (Path(out) / "corpus" / "train.jsonl").read_text().splitlines()]
        sides = "".join(side_of(k, mix["gen_start_batch_idx"])
                        for k in range(mix["gen_start_batch_idx"] + 1))

        def follow(tf32):
            return follow_gan(r.cfg, harness.weights(r, dev), disc_weights(r, dev), rec, corpus,
                              sides, dev, tf32=tf32, rows=mix["reference_rows"])

        theirs = follow(False)
        if r.control:
            ours["first"] = follow(True)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    numbers = {}
    for side in ("d", "g"):
        got, detail = check.training_numbers(ours["first"][side], theirs[side], 1, detail=True)
        print(f"worst {side} parameters {detail}", file=sys.stderr)
        numbers.update({f"{side}_{key}": v for key, v in got.items()})
    # the G gradient judged by its residual scales: see the module's docstring
    gaps = residual_scale_gaps(ours["first"]["g"]["grad_norms"], theirs["g"]["grad_norms"])
    numbers["g_residual_scale_gap"] = max(gaps.values())
    print(f"unjudged g_grad_norm_gap {numbers.pop('g_grad_norm_gap')!r}; worst residual scales"
          f" {check.worst(gaps)}", file=sys.stderr)
    audio = ours["n_batches"] * mix["batch"] * mix["crop_s"]
    e2e = {"train_audio_s_per_s": audio / ours["wall"], "peak_mem_gib": ours["memory"] / 2**30}
    return harness.Result(attempted=ours["n_batches"], failed=0, end_to_end=e2e, obs=ours["obs"],
                          checks=numbers, memory_peak_bytes=ours["memory"],
                          window_start=ours["window_start"])
