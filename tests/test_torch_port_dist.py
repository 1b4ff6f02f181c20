"""The port's data parallelism on the CPU: two processes over gloo (spawned,
with a `file://` rendezvous) against one process on the same global batch,
and against the JAX package's steps.

- one FM step of 2 ranks x 2 rows equals one port step on the global batch
  of 4 (loss 1e-6 relative, parameters after ScaledAdam 1e-6 of the
  model's max |p|, the step's deltas 1e-5 of their norm),
  also when the ranks hold different valid lengths, where a mean per rank
  averaged over the ranks is not the global loss; the ranks' parameters
  stay bitwise equal;
- the same with JAX's draws given to both sides, against the JAX package's
  loss, gradient and ScaledAdam update on the global batch: parameter
  deltas within 1e-4 of their norm;
- one GAN D step and one G step at 2 Euler steps, the same way against one
  process, and their losses against the JAX package's;
- the draws of a shard are its rows of the global batch's draws;
- the loaders' per-process shards are disjoint, complete and equal to the
  JAX package's;
- the trainers as 2 ranks: only rank 0 writes.

The spawned ranks import this module, so JAX and the JAX package are
imported by the tests that use them, not at its top. Torch keeps two
intra-op threads per process.
"""

import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed
import torch.multiprocessing

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.api import init_weights
from flow2gan_tpu_torch.bin import finetune, pretrain, train_tokenizer
from flow2gan_tpu_torch.data import audio_io, dataset
from flow2gan_tpu_torch.models import FMDraws, RolloutDraws, build_generator, get_generator_config
from flow2gan_tpu_torch.models import discriminators as pd
from flow2gan_tpu_torch.models import gan as pgan
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram
from flow2gan_tpu_torch.parallel import dist
from flow2gan_tpu_torch.parallel.dist import Shard
from flow2gan_tpu_torch.training import checkpoint as ckpt
from flow2gan_tpu_torch.training import gan_step as pgs
from flow2gan_tpu_torch.training.optim import ScaledAdam
from flow2gan_tpu_torch.training.train_step import fm_train_step, step_generator

WORLD = 2
B, L = 4, 4096  # the global batch; 2 rows per rank
FRAMES = 1 + L // 64  # mel_24k_tiny's hop
LR = 0.035 * 0.1
TINY = dict(get_generator_config("mel_24k_tiny"))
RECON = ((32, 64, 128, 256), (5, 10, 20, 40))
DISC = ((2,), (128,))  # one MPD period, one MRD window: (periods, fft_sizes)
LENS = {"equal": [L, L, L, L], "unequal": [L, L - 300, L // 2, L // 2 - 700]}
GAN_L = 2048
GAN_LENS = [GAN_L, GAN_L - 300, GAN_L // 2, GAN_L // 2 - 300]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ the ranks


def _rank_entry(rank: int, world: int, init_file: str, out_dir: str, fn_name: str, spec):
    """One spawned rank: join a gloo group, run `fn_name(spec)`, save what it
    returns as rank<r>.pt."""
    torch.set_num_threads(2)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    torch.distributed.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                                         world_size=world)
    try:
        torch.save(globals()[fn_name](spec), Path(out_dir) / f"rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def _spawn(tmp_path: Path, fn_name: str, spec) -> list:
    out = tmp_path / f"out_{fn_name}"
    out.mkdir()
    torch.multiprocessing.spawn(_rank_entry, args=(WORLD, str(tmp_path / f"init_{fn_name}"),
                                                   str(out), fn_name, spec), nprocs=WORLD)
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def _fm_model(spec) -> torch.nn.Module:
    model = build_generator(spec["cfg"])
    model.load_state_dict(spec["state"])
    return model


def _fm_step(spec) -> dict:
    """One `fm_train_step` on this rank's rows of `spec`'s global batch; the
    draws from the step generator, or `spec`'s global draws where given."""
    cfg = spec["cfg"]
    model = _fm_model(spec)
    shard = dist.shard()
    if "x0" in spec:
        def draw(audio, n_frames, generator, train=True, shard=Shard()):
            return FMDraws(shard.rows(spec["x0"]), shard.rows(spec["t"]),
                           gates=torch.ones(model.num_limiters))
        model.draw = draw
    mel = LogMelSpectrogram(24000, cfg["mel_n_fft"], cfg["mel_hop_length"], cfg["n_mels"])
    opt = ScaledAdam(model.named_parameters(), clipping_scale=2.0)
    batch = {"audio": shard.rows(spec["audio"]), "audio_lens": shard.rows(spec["lens"])}
    metrics = fm_train_step(model, opt, mel, batch, LR, step_generator(1, 0, "cpu"))
    return {"loss": float(metrics["loss"]), "params": model.state_dict()}


def _traced_fm_step(spec) -> dict:
    """`_fm_step` with the program's tracing on: also its counters and the
    names of its spans."""
    tracing.enable()
    out = _fm_step(spec)
    drained = tracing.drain()
    return dict(out, counters=drained.counters, spans=[s.name for s in drained.spans])


def _gan_models(spec):
    generator = build_generator(spec["cfg"])
    generator.load_state_dict(spec["generator"])
    disc = pd.Discriminators(*DISC)
    disc.load_state_dict(spec["discriminator"])
    return generator, disc


def _gan_steps(spec) -> dict:
    """A D step, then a G step at 2 Euler steps (gates all 1) on this rank's
    rows, with `spec`'s global x0 of each."""
    cfg = spec["cfg"]
    generator, disc = _gan_models(spec)
    mel = LogMelSpectrogram(24000, cfg["mel_n_fft"], cfg["mel_hop_length"], cfg["n_mels"])
    opt_d = ScaledAdam(disc.named_parameters(), clipping_scale=2.0)
    d_step, g_step, _ = pgs.make_gan_steps(
        generator, disc, mel, pgan.make_mel_recon_fns(24000, *RECON),
        ScaledAdam(generator.named_parameters(), clipping_scale=2.0), opt_d,
        lambda b: 0.002 * 0.1, lambda b: 0.02 * 0.1, n_timesteps=2)
    grads_d = []
    step_d = opt_d.step

    def keep_grads(lr):
        grads_d.extend(p.grad.clone() for g in opt_d.groups for p in g.params)
        step_d(lr)

    opt_d.step = keep_grads
    shard = dist.shard()
    batch = {"audio": shard.rows(spec["audio"]), "audio_lens": shard.rows(spec["lens"])}
    m_d = d_step(batch, RolloutDraws(shard.rows(spec["x0_d"])))
    m_g = g_step(batch, RolloutDraws(shard.rows(spec["x0_g"]),
                                     torch.ones(2, generator.num_limiters)))
    names = [n for g in opt_d.groups for n in g.names]
    return {"loss_d": float(m_d["loss_d"]), "loss_g": float(m_g["loss_g"]),
            "mel_recon": float(m_g["mel_recon_loss"]), "grads_d": dict(zip(names, grads_d)),
            "generator": generator.state_dict(), "discriminator": disc.state_dict()}


def _trainer(spec) -> dict:
    """`bin/pretrain.py` or `bin/finetune.py` run in this rank, with every
    checkpoint write recorded, and the parameters that the trainer's
    equal-start check was given, as they are when the run ends."""
    writes, replicated = [], []
    save, check = ckpt.save_checkpoint, dist.assert_replicas_equal

    def recording(filename, *args, **kwargs):
        writes.append(Path(filename).name)
        return save(filename, *args, **kwargs)

    def keeping(tensors, *args, **kwargs):
        replicated.extend(tensors)
        return check(tensors, *args, **kwargs)

    ckpt.save_checkpoint = recording
    dist.assert_replicas_equal = keeping
    module = finetune if spec["trainer"] == "finetune" else pretrain
    pd.DiscriminatorP.CHANNELS = (8, 16, 16, 32, 32)
    finetune.Discriminators = lambda: pd.Discriminators((2, 3), (256, 128))
    history = module.run(module.get_parser().parse_args(spec["argv"]))
    return {"writes": writes, "history": history,
            "params": [p.detach().clone() for p in replicated]}


# ---------------------------------------------------------------- inputs


def _audio(batch, length, seed):
    """Tones plus noise at different levels per row, float32 (batch, length)."""
    rng = np.random.RandomState(seed)
    t = np.arange(length) / 24000
    rows = [(0.1 + 0.2 * i) * np.sin(2 * np.pi * (150.0 + 70 * i) * t + i) for i in range(batch)]
    return torch.from_numpy((np.stack(rows) + 0.03 * rng.randn(batch, length)).astype(np.float32))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _param_err(ours: dict, ref: dict) -> float:
    """max |ours - ref| over max |ref|, both over every parameter (a tensor
    that starts at zero, a bias, holds one step's delta only)."""
    return (max(float((ours[k] - v).abs().max()) for k, v in ref.items())
            / max(float(v.abs().max()) for v in ref.values()))


def _grad_err(ours: dict, ref: dict):
    """(whole, worst): |ours - ref| / |ref| over every tensor together, and
    of the worst tensor."""
    whole = (sum(float((ours[k] - v).square().sum()) for k, v in ref.items())
             / sum(float(v.square().sum()) for v in ref.values())) ** 0.5
    return whole, max(float((ours[k] - v).norm() / (v.norm() + 1e-30)) for k, v in ref.items())


def _ranks_equal(results, key) -> bool:
    return all(torch.equal(results[0][key][k], v) for k, v in results[1][key].items())


def _delta_err(before: dict, after: dict, j_before: dict, j_after: dict) -> float:
    """|port delta - JAX delta| / |JAX delta| over every tensor."""
    num = sum(float(((after[k] - before[k]) - (j_after[k] - j_before[k])).square().sum())
              for k in j_before)
    den = sum(float((j_after[k] - j_before[k]).square().sum()) for k in j_before)
    return (num / den) ** 0.5


# ------------------------------------------------------------------ tests


def test_draws_of_a_shard_are_its_rows_of_the_global_draws():
    """Every rank draws for the global batch and keeps its rows, so that 2
    ranks draw what one process draws; the gates are whole on every rank."""
    model = init_weights(build_generator(TINY), torch.Generator().manual_seed(0))
    whole = model.draw(torch.zeros(B, L), FRAMES, torch.Generator().manual_seed(5))
    roll = model.draw_rollout(B, FRAMES, 2, torch.Generator().manual_seed(6))
    assert whole.branch_weight is not None  # mel_24k_tiny has branch dropout
    for r in range(WORLD):
        s = Shard(r, WORLD)
        part = model.draw(torch.zeros(B // WORLD, L), FRAMES, torch.Generator().manual_seed(5),
                          shard=s)
        rows = slice(r * B // WORLD, (r + 1) * B // WORLD)
        for field in ("x0", "t", "branch_weight"):
            assert torch.equal(getattr(part, field), getattr(whole, field)[rows]), field
        assert torch.equal(part.gates, whole.gates)
        rpart = model.draw_rollout(B // WORLD, FRAMES, 2, torch.Generator().manual_seed(6),
                                   shard=s)
        assert torch.equal(rpart.x0, roll.x0[rows]) and torch.equal(rpart.gates, roll.gates)


@pytest.mark.parametrize("lens", ["equal", "unequal"])
def test_fm_step_of_two_ranks_equals_one_process(tmp_path, lens):
    """mel_24k_tiny (branch dropout on): the draws from the step generator on
    both sides. The limited parameters lie past their bounds in places, so
    the limiters' sign flips act (each decided on the global gradient). With
    unequal valid lengths the ranks' own masked means, averaged, miss the
    global loss by far more than the tolerance."""
    model = init_weights(build_generator(TINY), torch.Generator().manual_seed(3))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("residual_scale.scale"):
                p[::3] = 1.3
                p[1::3] = 0.3
            elif name.endswith("log_scale"):
                p.fill_(1.8)
    spec = {"cfg": TINY, "state": model.state_dict(), "audio": _audio(B, L, 4),
            "lens": torch.tensor(LENS[lens])}
    one = _fm_step(spec)
    ranks = _spawn(tmp_path, "_fm_step", spec)
    assert _ranks_equal(ranks, "params")
    assert ranks[0]["loss"] == ranks[1]["loss"]
    assert _rel(ranks[0]["loss"], one["loss"]) < 1e-6
    assert _param_err(ranks[0]["params"], one["params"]) < 1e-6
    # the step's deltas (~5e-6 on weights of ~0.03) agree to float32's
    # rounding of p + delta
    assert _delta_err(spec["state"], ranks[0]["params"], spec["state"], one["params"]) < 1e-5

    # the mean per rank, averaged over the ranks
    mel = LogMelSpectrogram(24000, TINY["mel_n_fft"], TINY["mel_hop_length"], TINY["n_mels"])
    means = []
    for r in range(WORLD):
        s = Shard(r, WORLD)
        audio, lens_r = s.rows(spec["audio"]), s.rows(spec["lens"])
        draws = model.draw(audio, FRAMES, step_generator(1, 0, "cpu"), shard=s)
        with torch.no_grad():
            means.append(float(model(mel(audio), audio, lens_r, draws)))
    naive = sum(means) / WORLD
    assert (_rel(naive, one["loss"]) > 1e-2) == (lens == "unequal"), (naive, one["loss"])


@functools.lru_cache(maxsize=None)
def _jax_pair():
    """The JAX module, its perturbed mel_24k_tiny params (branch dropout
    off) and the port's copy, from the training tests."""
    from .test_torch_port_train import _pair

    return _pair("tiny")


def _jax_fm_draws(jm, params, audio, step_rng):
    """x0 and t as the JAX package's FM step draws them under `step_rng` at
    batch 0: the first and second draws of the top-level "noise" stream
    (no mel noise in this config)."""
    import jax

    def draw(module, audio):
        x0 = jax.random.normal(module.make_rng("noise"), audio.shape) * module.init_noise_scale
        return x0, jax.random.uniform(module.make_rng("noise"), (audio.shape[0],))

    noise = jax.random.fold_in(jax.random.fold_in(step_rng, 0), 0)
    return [np.array(x) for x in jm.apply({"params": params}, audio, method=draw,
                                          rngs={"noise": noise})]


def test_fm_step_of_two_ranks_matches_jax(tmp_path, monkeypatch):
    """The JAX package's FM step (`make_fm_train_step`, gates patched to 1)
    on the global batch with unequal valid lengths, and 2 ranks of the port
    given JAX's draws: the loss within 1e-5, the parameter deltas within
    1e-4 of their norm."""
    import jax
    import jax.numpy as jnp

    from flow2gan_tpu.models import norms as jnorms
    from flow2gan_tpu.ops import mel as jmel
    from flow2gan_tpu.training.optim import eden2_lr as j_eden2_lr
    from flow2gan_tpu.training.optim import scaled_adam as j_scaled_adam
    from flow2gan_tpu.training.train_step import init_train_state, make_fm_train_step
    from flow2gan_tpu_torch.compat.from_jax import jax_params_to_state_dict

    jm, params, model, cfg = _jax_pair()
    monkeypatch.setattr(jnorms, "_gate", lambda module, train, prob=0.6:
                        jnp.float32(1.0) if train else None)
    audio, lens = _audio(B, L, 8), torch.tensor(LENS["unequal"])
    j_mel = jmel.LogMelSpectrogram(sampling_rate=24000, n_fft=cfg["mel_n_fft"],
                                   hop_length=cfg["mel_hop_length"], n_mels=cfg["n_mels"])
    opt = j_scaled_adam(clipping_scale=2.0)
    step = make_fm_train_step(jm, opt, lr_fn=lambda b: j_eden2_lr(0.035, b, 7500.0,
                                                                  warmup_start=0.1),
                              mel_fn=j_mel, donate=False)
    step_rng = jax.random.PRNGKey(23)
    j_batch = {"audio": jnp.asarray(audio.numpy()), "audio_lens": jnp.asarray(lens.numpy())}
    state, metrics = step(init_train_state(params, opt), j_batch, step_rng)
    x0, t = _jax_fm_draws(jm, params, j_batch["audio"], step_rng)
    assert float(metrics["lr"]) == pytest.approx(LR)

    spec = {"cfg": cfg, "state": model.state_dict(), "audio": audio, "lens": lens,
            "x0": torch.from_numpy(x0), "t": torch.from_numpy(t)}
    ranks = _spawn(tmp_path, "_fm_step", spec)
    assert _ranks_equal(ranks, "params")
    assert _rel(ranks[0]["loss"], float(metrics["loss"])) < 1e-5
    before = {k: v.float() for k, v in spec["state"].items()}
    assert _delta_err(before, ranks[0]["params"], jax_params_to_state_dict(params),
                      jax_params_to_state_dict(state.params)) < 1e-4


def test_gan_steps_of_two_ranks_equal_one_process_and_match_jax(tmp_path, monkeypatch):
    """A D step then a G step at 2 Euler steps (gates patched to 1, x0 as
    the JAX package's `_rollout` draws it), unequal valid lengths, at batch
    4 x 2048 with one period and one window of the discriminators: 2 ranks
    against one port process on the global batch (losses and the D step's
    summed gradient 1e-6, parameters 1e-6 of max |p|), and against the JAX
    package's on it (its D step of `make_gan_steps`, then its G objective at
    the D step's result): the D and G losses and the mel loss within 1e-5.

    The parameter deltas are not held to JAX's here. A first ScaledAdam
    step moves an element by lr * rms * g / (|g| + 1e-8): where a gradient
    cancels to within rounding (the D gradient is the hinge's fake half
    minus its real half), two float32 implementations move it differently,
    and at some inputs by more than 1e-4 of the deltas' norm, in one
    process as in two (two equal one to 1e-6). The FM step's deltas agree
    with JAX's to 1e-4 above, and `test_torch_port_gan_steps.py` holds one
    process's GAN steps to JAX's at its own inputs."""
    import jax
    import jax.numpy as jnp

    from flow2gan_tpu.models import discriminators as jd
    from flow2gan_tpu.models import gan as jgan
    from flow2gan_tpu.models import norms as jnorms
    from flow2gan_tpu.ops import mel as jmel
    from flow2gan_tpu.training import gan_step as jgs
    from flow2gan_tpu.training.optim import eden2_lr as j_eden2_lr
    from flow2gan_tpu.training.optim import scaled_adam as j_scaled_adam
    from flow2gan_tpu_torch.compat.from_jax import load_jax_params

    from .test_torch_port_gan import _perturbed
    from .test_torch_port_gan_steps import _jax_x0

    jm, params_g, model, cfg = _jax_pair()
    monkeypatch.setattr(jnorms, "_gate", lambda module, train, prob=0.6:
                        jnp.float32(1.0) if train else None)
    jdisc = jd.Discriminators(periods=DISC[0], fft_sizes=DISC[1])
    zeros = jnp.zeros((B, GAN_L))
    params_d = _perturbed(jax.jit(jdisc.init)(jax.random.PRNGKey(2), zeros, zeros)["params"], 11)
    disc = load_jax_params(pd.Discriminators(*DISC), params_d)
    audio, lens = _audio(B, GAN_L, 21), torch.tensor(GAN_LENS)
    j_batch = {"audio": jnp.asarray(audio.numpy()), "audio_lens": jnp.asarray(lens.numpy())}
    j_mel = jmel.LogMelSpectrogram(sampling_rate=24000, n_fft=cfg["mel_n_fft"],
                                   hop_length=cfg["mel_hop_length"], n_mels=cfg["n_mels"])
    opt_g, opt_d = j_scaled_adam(clipping_scale=2.0), j_scaled_adam(clipping_scale=2.0)
    j_recon = jgan.make_mel_recon_fns(24000, *RECON)
    j_d_step, _, _ = jgs.make_gan_steps(
        jm, jdisc, j_mel, j_recon, opt_g, opt_d,
        lr_g_fn=lambda b: j_eden2_lr(0.002, b, 20000, warmup_start=0.1),
        lr_d_fn=lambda b: j_eden2_lr(0.02, b, 5000, warmup_start=0.1),
        n_timesteps=2, donate=False)
    step_rng = jax.random.PRNGKey(17)
    state1, md = j_d_step(jgs.init_gan_train_state(params_g, params_d, opt_g, opt_d), j_batch,
                          step_rng)
    # the G step's objective at the D step's result (its batch index folds 1)
    _, j_g = jgs.make_gan_loss_fns(jm, jdisc, j_mel, j_recon, n_timesteps=2)
    _, mg = jax.jit(j_g)(params_g, state1.params_d, j_batch, jax.random.fold_in(step_rng, 1))
    cond = j_mel(j_batch["audio"])
    # each step folds its batch index into the key, then `_rollout` folds 0
    x0 = [_jax_x0(jm, params_g, cond, jax.random.fold_in(jax.random.fold_in(step_rng, i), 0))
          for i in (0, 1)]

    spec = {"cfg": cfg, "generator": model.state_dict(), "discriminator": disc.state_dict(),
            "audio": audio, "lens": lens, "x0_d": torch.from_numpy(x0[0]),
            "x0_g": torch.from_numpy(x0[1])}
    one = _gan_steps(spec)
    ranks = _spawn(tmp_path, "_gan_steps", spec)
    for side in ("generator", "discriminator"):
        assert _ranks_equal(ranks, side), side
        assert _param_err(ranks[0][side], one[side]) < 1e-6, side
    for key in ("loss_d", "loss_g", "mel_recon"):
        assert ranks[0][key] == ranks[1][key] and _rel(ranks[0][key], one[key]) < 1e-6, key
    assert _rel(ranks[0]["loss_d"], float(md["loss_d"])) < 1e-5
    assert _rel(ranks[0]["loss_g"], float(mg["loss_g"])) < 1e-5
    whole, _ = _grad_err(ranks[0]["grads_d"], one["grads_d"])
    assert whole < 1e-6, whole
    # the G step's losses are taken after the D step, with each side's D
    assert _rel(ranks[0]["mel_recon"], float(mg["mel_recon_loss"])) < 1e-5


@pytest.mark.parametrize("n,shuffle", [(10, True), (11, True), (7, False), (1, True)])
def test_loader_shards_are_disjoint_complete_and_match_jax(tmp_path, n, shuffle):
    """Process i of 2 loads idx[i::2] of the epoch's order cut to equal
    sizes, as the JAX loader does; a dataset smaller than the process count
    is loaded whole by each."""
    from flow2gan_tpu.data import dataset as j_dataset

    recs = [dataset.Recording(f"r{i}", str(tmp_path / f"r{i}.wav"), 24000, 24000)
            for i in range(n)]
    seen = []
    for r in range(WORLD):
        ours = dataset.DataLoader(dataset.RecordingDataset(recs, train=True, duration=0.5),
                                  batch_size=2, shuffle=shuffle, seed=7, process_index=r,
                                  process_count=WORLD)
        theirs = j_dataset.DataLoader(
            j_dataset.RecordingDataset([j_dataset.Recording(**vars(x)) for x in recs],
                                       train=True, duration=0.5),
            batch_size=2, shuffle=shuffle, seed=7, process_index=r, process_count=WORLD)
        for epoch in (1, 2):
            ours.set_epoch(epoch)
            theirs.set_epoch(epoch)
            np.testing.assert_array_equal(ours._indices(), theirs._indices())
            assert len(ours) == len(theirs)
        seen.append(ours._indices().tolist())
    if n < WORLD:
        assert seen == [list(range(n))] * WORLD
    else:
        assert not set(seen[0]) & set(seen[1]) and len(seen[0]) == len(seen[1]) == n // WORLD
        assert len(set(seen[0]) | set(seen[1])) == n - n % WORLD


def _corpus(root: Path, n: int, seconds: float = 0.5, sr: int = 24000) -> Path:
    rng = np.random.RandomState(0)
    (root / "wav").mkdir(parents=True, exist_ok=True)
    recs = []
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n):
        path = root / "wav" / f"r{i}.wav"
        x = 0.3 * np.sin(2 * np.pi * (110.0 + 30 * i) * t) + 0.02 * rng.randn(t.size)
        audio_io.write_wav(path, x.astype(np.float32), sr)
        recs.append(dataset.Recording(f"r{i}", str(path), sr, t.size))
    manifest = root / "recordings.jsonl.gz"
    dataset.write_recording_manifest(recs, manifest)
    return manifest


@pytest.mark.parametrize("trainer", ["pretrain", "finetune", "pretrain_tokens",
                                     "finetune_tokens"])
def test_trainers_as_two_ranks_write_on_rank_zero_only(tmp_path, trainer):
    """A global --batch-size of 4 as 2 ranks of 2: every rank logs the same
    global loss and ends with the same parameters, rank 0 writes every
    checkpoint (epoch-0, the batch checkpoints, the epoch's) and the only
    log file, rank 1 writes nothing. The `_tokens` cases run token_24k_tiny
    with a codebook fit on the corpus: the embedding's gradient is
    all-reduced with the rest, so the ranks' tables stay bitwise equal."""
    manifest = _corpus(tmp_path, 8)
    exp = tmp_path / "exp"
    trainer, _, tokens = trainer.partition("_")
    name = "token_24k_tiny" if tokens else "mel_24k_tiny"
    argv = ["--exp-dir", str(exp), "--model-name", name, "--device", "cpu",
            "--train-recordings", str(manifest), "--valid-recordings", str(manifest),
            "--batch-size", "4", "--duration", "0.25", "--num-workers", "1", "--num-epochs", "1",
            "--save-every-n", "1", "--keep-last-k", "1", "--average-period", "1",
            "--valid-interval", "2"]
    if tokens:
        argv += ["--tokenizer", str(train_tokenizer.main([
            "--model-name", "token_24k_tiny", "--recordings", str(manifest),
            "--output", str(tmp_path / "codebook.npz"), "--iters", "4", "--device", "cpu"]))]
    if trainer == "finetune":
        init = tmp_path / "fm.pt"
        torch.save(init_weights(build_generator(get_generator_config(name)),
                                torch.Generator().manual_seed(9))
                   .state_dict(), init)
        argv += ["--generator-model-path", str(init), "--n-timesteps", "2",
                 "--gen-start-batch-idx", "1"]
    ranks = _spawn(tmp_path, "_trainer", {"trainer": trainer, "argv": argv})
    assert [h["batch_idx_train"] for h in ranks[0]["history"]] == [1, 2]  # 8 recordings / 4
    assert [h["loss"] for h in ranks[0]["history"]] == [h["loss"] for h in ranks[1]["history"]]
    assert len(ranks[0]["params"]) == len(ranks[1]["params"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(ranks[0]["params"], ranks[1]["params"]))
    if tokens:
        table = ckpt.load_checkpoint(exp / "epoch-1.pt")["model"]
        table = table["generator"] if trainer == "finetune" else table
        first = ckpt.load_checkpoint(exp / "epoch-0.pt")["model"]
        first = first["generator"] if trainer == "finetune" else first
        assert table["token_embed.weight"].shape == (64, 24)
        assert not torch.equal(table["token_embed.weight"], first["token_embed.weight"])
        assert any(torch.equal(p, table["token_embed.weight"]) for p in ranks[1]["params"])
    assert ranks[0]["writes"] == ["epoch-0.pt", "checkpoint-1.pt", "checkpoint-2.pt",
                                  "epoch-1.pt"]
    assert ranks[1]["writes"] == []
    assert sorted(p.name for p in exp.glob("*.pt")) == ["checkpoint-2.pt", "epoch-0.pt",
                                                       "epoch-1.pt"]
    assert len(list((exp / "log").iterdir())) == 1
    last = ckpt.load_checkpoint(exp / "checkpoint-2.pt")
    assert last["sampler"]["dl_states"] == [{"epoch": 1, "consumed": 2}]


def test_torchrun_launches_the_trainer(tmp_path):
    """The launch line of the README: `torch.distributed.run` starts 2
    processes of `bin/pretrain.py` on the CPU, which join over gloo from
    torchrun's environment (a rendezvous on this host only) and train the
    global batch; rank 0 writes the checkpoints and the log."""
    import subprocess
    import sys

    manifest = _corpus(tmp_path, 8)
    exp = tmp_path / "exp"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "flow2gan_tpu_torch.bin.pretrain", "--exp-dir", str(exp), "--model-name",
           "mel_24k_tiny", "--device", "cpu", "--train-recordings", str(manifest),
           "--batch-size", "4", "--duration", "0.25", "--num-workers", "1", "--num-epochs", "1",
           "--save-every-n", "2", "--keep-last-k", "1", "--log-interval", "1"]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, cwd=Path(__file__).resolve().parents[1], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert sorted(p.name for p in exp.glob("*.pt")) == ["checkpoint-2.pt", "epoch-0.pt",
                                                       "epoch-1.pt"]
    logs = list((exp / "log").iterdir())
    assert len(logs) == 1
    text = logs[0].read_text()
    assert "(0/2)" in text and "rank 0 of 2: backend gloo, device cpu" in text
    assert ckpt.load_checkpoint(exp / "epoch-1.pt")["batch_idx_train"] == 2
