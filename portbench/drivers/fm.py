"""Flow-matching pretraining, the trainer's loop as `bin/pretrain.py` runs
it: the port's `DataLoader` over a corpus made from the seed, the batch
moved to the card, `fm_train_step` with the Eden2 rate and the step's
generator, the loss fetched each step. With `world` > 1 in the mix, one
process per card joins an NCCL group and takes its share of the global
batch (`parallel/dist.py`); the window's numbers are rank 0's, the peak
memory the largest rank's.

Set-up builds the step's objects once and drives them through the first
`check_steps` steps with the window's own calls and feed; the reference
follows those steps after the window. A step ends when the host has the
loss. The window's rate is the crop seconds of the global batches over its
wall time."""

from __future__ import annotations

import json
import os
import shutil
import socket
import sys
import tempfile
import time
from pathlib import Path

import torch

from portbench import faults, harness, traffic, yardstick
from portbench.reference.check import follow_training, training_numbers
from portbench.tracing import Spans, Trace


def first_grad_norms(optimizer, beta2: float = 0.98) -> dict:
    """Each parameter's gradient norm at the first step, as ScaledAdam got
    it, worked out from its state after that step: its second moment is
    then (1 - beta2) g^2 (the first step is never clipped)."""
    return {name: float((eas.double().sum() / (1.0 - beta2)).sqrt())
            for g in optimizer.groups for name, eas in zip(g.names, g.exp_avg_sq.unbind(0))}


def recipe(r: harness.Run) -> dict:
    mix = r.mix
    local = mix["batch"] // mix["world"]
    per_rank = mix["utterances"] * mix["manifest_repeats"] // mix["world"]
    return dict(mix["optimizer"], world=mix["world"], local_batch=local,
                batches_per_epoch=per_rank // local, duration=mix["crop_s"],
                max_load_times=mix["max_load_times"], loader_seed=r.seed_for(2) % 2**31,
                draw_seed=r.seed_for(3) % 2**31)


def rank_main(r: harness.Run, rank: int, port: int, out: str) -> dict:
    """One rank's set-up, first steps, window and readings."""
    from flow2gan_tpu_torch.data.dataset import build_data_loader, read_recording_manifest
    from flow2gan_tpu_torch.ops.tokenizer import conditioning_frontend
    from flow2gan_tpu_torch.training import optim, train_step
    from flow2gan_tpu_torch.utils import disable_tf32

    mix, rec = r.mix, recipe(r)
    world = mix["world"]
    dev = torch.device("cuda", rank) if r.device.type == "cuda" and world > 1 else r.device
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        disable_tf32()
    if world > 1:
        torch.distributed.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", init_method=f"tcp://localhost:{port}",
            rank=rank, world_size=world)
    try:
        with faults.planted(r.fault):
            return _train(r, rec, dev, rank, Path(out), build_data_loader,
                          read_recording_manifest, conditioning_frontend, optim, train_step)
    finally:
        if world > 1:
            torch.distributed.destroy_process_group()


def _barrier(world):
    if world > 1:
        torch.distributed.barrier()


def _train(r, rec, dev, rank, out, build_data_loader, read_manifest, frontend, optim, train_step):
    from flow2gan_tpu_torch.parallel import dist

    mix, cfg, world = r.mix, r.cfg, rec["world"]
    model, acfg = harness.build_generator(r, dev)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    dist.assert_replicas_equal(list(model.parameters()))
    cond_fn = frontend(acfg, None, r.config_name).to(dev)
    optimizer = optim.ScaledAdam(model.named_parameters(),
                                 clipping_scale=rec["clipping_scale"])
    harness.phase(f"rank {rank} program built")
    if rank == 0:
        traffic.write_corpus(out / "corpus", r.seed, mix, cfg["sampling_rate"], dev)
    _barrier(world)
    harness.phase(f"rank {rank} corpus made")
    loader = build_data_loader(read_manifest(out / "corpus" / "train.jsonl"),
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
    losses = []

    def step(k):
        with spans("loader.next"):
            batch = next(batches)
        with spans("fm_train_step"):
            dev_batch = {"audio": torch.from_numpy(batch["audio"]).to(dev),
                         "audio_lens": torch.from_numpy(batch["audio_lens"]).to(dev)}
            lr = optim.eden2_lr(rec["base_lr"], k, rec["lr_batches"],
                                warmup_batches=rec["warmup_batches"],
                                warmup_start=rec["warmup_start"])
            metrics = train_step.fm_train_step(model, optimizer, cond_fn, dev_batch, lr,
                                               train_step.step_generator(rec["draw_seed"], k, dev))
        with spans("loss_fetch"):
            losses.append(float(metrics["loss"]))

    check = mix["check_steps"]
    grad_norms = None
    times = []
    for k in range(check):
        t = harness.clock()
        step(k)
        times.append(harness.clock() - t)
        if k == 0:
            grad_norms = first_grad_norms(optimizer)
    change = {n: float((p.detach() - start[n]).norm()) for n, p in model.named_parameters()}
    del start
    harness.phase(f"rank {rank} first steps, {[round(t, 3) for t in times]} s")
    spans.seconds.clear()
    _barrier(world)
    harness.sync(dev)
    window_start = time.time()
    t0 = harness.clock()
    k = check
    while True:
        step(k)
        k += 1
        # rank 0's clock closes the window for every rank
        stop = torch.tensor([float(harness.clock() - t0 >= r.seconds)], device=dev)
        if world > 1:
            torch.distributed.broadcast(stop, 0)
        if stop.item():
            break
    wall = harness.clock() - t0
    n_steps = k - check
    obs = {}
    if r.trace:
        # after the window, when the loader's prefetch has drained as it would
        # over a long run; the loader's wait is read over every step
        traced = mix["trace_steps"]
        with Trace(dev) as trace:
            for k in range(check + n_steps, check + n_steps + traced):
                step(k)
        obs = trace.digest()
        length = int(rec["duration"] * cfg["sampling_rate"])
        shapes = yardstick.branch_shapes(cfg, rec["local_batch"], length)
        obs.update(steps=traced, spans=dict(spans.seconds),
                   flop=traced * 3 * yardstick.fm_forward_flop(cfg, rec["local_batch"], length),
                   istft_bound_s=[yardstick.istft_bound_s(*s) for _ in range(traced) for s in shapes],
                   adjoint_bound_s=[yardstick.adjoint_bound_s(*s) for _ in range(traced)
                                    for s in shapes])
    memory = harness.memory_peak(dev)
    return {"losses": losses[:check], "grad_norms": grad_norms, "change_norms": change,
            "n_steps": n_steps, "wall": wall, "memory": memory, "obs": obs,
            "window_start": window_start,
            "jax": sorted(m for m in ("jax", "jaxlib", "flax", "flow2gan_tpu") if m in sys.modules)}


def _rank_entry(rank, r, port, out):
    torch.save(rank_main(r, rank, port, out), Path(out) / f"rank{rank}.pt")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(r: harness.Run) -> harness.Result:
    mix, world = r.mix, r.mix["world"]
    out = tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR"))
    try:
        if world == 1:
            ranks = [rank_main(r, 0, 0, out)]
        else:
            torch.multiprocessing.spawn(_rank_entry, args=(r, free_port(), out), nprocs=world)
            ranks = [torch.load(Path(out) / f"rank{k}.pt", weights_only=False)
                     for k in range(world)]
        for k, rk in enumerate(ranks):
            if rk["jax"]:
                raise RuntimeError(f"rank {k} loaded {rk['jax']}")
        dev = r.device
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        rec = recipe(r)
        check = mix["check_steps"]
        corpus = [json.loads(line)["sources"][0]["source"]
                  for line in (Path(out) / "corpus" / "train.jsonl").read_text().splitlines()]
        theirs = follow_training(r.cfg, harness.weights(r, dev), rec, corpus, check, dev,
                                 rows=mix["reference_rows"])
        numbers = {}
        for rk in ranks:
            ours = (follow_training(r.cfg, harness.weights(r, dev), rec, corpus, check, dev,
                                    tf32=True, rows=mix["reference_rows"]) if r.control else rk)
            got, detail = training_numbers(ours, theirs, check, detail=True)
            print(f"worst parameters {detail}", file=sys.stderr)
            for key, v in got.items():
                numbers[key] = max(numbers.get(key, 0.0), v)
            if r.control:
                break
    finally:
        shutil.rmtree(out, ignore_errors=True)
    lead = ranks[0]
    audio = lead["n_steps"] * mix["batch"] * mix["crop_s"]
    obs = lead["obs"]
    if r.trace:
        obs = dict(obs, ranks=[rk["obs"] for rk in ranks])
    e2e = {"train_audio_s_per_s": audio / lead["wall"],
           "peak_mem_gib": max(rk["memory"] for rk in ranks) / 2**30}
    return harness.Result(attempted=lead["n_steps"], failed=0, end_to_end=e2e, obs=obs,
                          checks=numbers, memory_peak_bytes=max(rk["memory"] for rk in ranks),
                          window_start=lead["window_start"])
