"""Both packages' GAN fine-tuners over one whole run on the CPU.

`flow2gan_tpu.bin.finetune.run` and `flow2gan_tpu_torch.bin.finetune.run`
take the same flags, the same generator `.ckpt`, the same discriminator
init, the same batches and the same draws, and train mel_24k_tiny, then
token_24k_tiny (each check is a case of each), for one
epoch of 26 batches at 2 Euler steps with `--remat-rollout true`: a 6-batch
D-only warm-up, then strict D/G alternation (16 D and 10 G updates), both
Eden2 schedules through the end of their 8-update warm-up, ScaledAdam's
scale updates, the running average every 4 batches (batch 26, the last, is
not in it) and both exports of each package's `save_averaged_model`:
the windowed one over (epoch-0, epoch-1] and `--use-averaged-model false`,
the last weights. The token run's codebook (vocab 64) is fit on the corpus
by the port's `bin/train_tokenizer`; both packages load the one `.npz` and
tokenize each batch themselves.

Setup. The discriminators are `Discriminators(periods=(2, 3),
fft_sizes=(256, 128))` at full channel width on both sides, the JAX init at
the CLI's seed loaded into the port's. Each batch's x0 is the JAX step's
own (the "noise" stream of `fold_in(PRNGKey(seed + 1), batch)`), handed to
the port's `draw_rollout`; the limiter gates are 1 on both sides (JAX's
`_gate` patched to a constant). The JAX CLI runs on one of the suite's
virtual CPU devices, its `init` calls jitted (eager, they took ~30 s) and
its initial train state placed on its mesh as its steps' outputs are (else
the D step compiles twice).

Tolerances, set from the drift measured per batch on this run, float32 on
both sides:
- the batches, the D/G order and the draws' batch indices: equal; each lr
  to 1e-6 (float32 against float64 arithmetic of the same schedule);
- each step's loss: 3e-5 of JAX's. The first steps differ by ~1e-7; the
  differences grow as both sides compound their rounding, to at most
  3.4e-6 for mel, 8.6e-6 for tokens (G steps from batch 13 on);
- a parameter tree (the final generator, the running average, the two
  exports): the whole tree's difference to 5e-4 of its change over the run
  (measured 4.1e-5 to 5.2e-5 for mel, 8.3e-5 to 1.1e-4 for tokens, growing
  about linearly with the steps), and each tensor's to 5e-3 of its change
  (measured at most 5.0e-4) beyond a
  floor of 4 float32 ulps of the tensor (a BiasNorm `log_scale` that moved
  6e-6 differs by one ulp);
- the final discriminators: the whole tree to 1e-2 of its change, each
  tensor to 3e-2. Measured: 2.2e-3 and 7.4e-3 (tokens 3.0e-3 and 9.8e-3).
  Every score lies in the
  hinge's linear part, so the D gradient of the MRD's band convs is a
  difference of two near-equal means and its float32 rounding shows at
  ~1e-3 of a tensor's gradient (`test_torch_port_gan_steps.py`); from the
  first D step on, those tensors' moves differ by up to 2.4e-2 and the whole
  tree's by ~5e-6 of its norm a step. A fault of the trainer, not rounding,
  moves a step by its whole size: ScaledAdam's scale-update period 4 -> 5,
  its scalar lr scale 0.1 -> 0.11 or the running average taken a batch
  late, each alone in the port, missed the generator's limits by 20-650x,
  and the first two the discriminators' by ~3x; a tokenizer that drops
  the centroids' norms from its scores missed the token case's by ~300x;
- each package's exports against its own checkpoints: exact.
"""

import functools
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow2gan_tpu.bin import finetune as j_finetune
from flow2gan_tpu.bin import save_averaged_model as j_save_averaged_model
from flow2gan_tpu.models import build_generator as j_build_generator
from flow2gan_tpu.models import discriminators as jd
from flow2gan_tpu.parallel import mesh as jmesh
from flow2gan_tpu.training import checkpoint as jckpt

from flow2gan_tpu_torch.bin import finetune, save_averaged_model, train_tokenizer
from flow2gan_tpu_torch.compat.from_jax import jax_params_to_state_dict, load_jax_params
from flow2gan_tpu_torch.models import RolloutDraws
from flow2gan_tpu_torch.models import discriminators as pd
from flow2gan_tpu_torch.models import generator as pgen
from flow2gan_tpu_torch.training import checkpoint as ckpt

from .test_torch_port_gan_steps import _jax_x0, _patch_gate
from .test_torch_port_tokens import _jax_x0 as _jax_token_x0
from .test_torch_port_tokens import _pair as _token_pair
from .test_torch_port_train import _pair
from .test_torch_port_trainer import _corpus

SEED, N_STEPS, N_RECORDINGS, BATCH = 3, 2, 52, 2
N_BATCHES = N_RECORDINGS // BATCH
GEN_START, AVERAGE_PERIOD = 6, 4
PERIODS, FFT_SIZES = (2, 3), (256, 128)
MODELS = ["mel_24k_tiny", "token_24k_tiny"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The full-width discriminators make each step heavy: two intra-op
    threads let this file share the CPU with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class _JitInit:
    """A flax module whose `init` runs jitted; everything else is the
    module's own."""

    def __init__(self, module):
        self.module = module

    def init(self, *args, **kwargs):
        return jax.jit(functools.partial(self.module.init, **kwargs))(*args)

    def __getattr__(self, name):
        return getattr(self.module, name)


def _flags(model, exp_dir, manifest, init, codebook):
    tokens = ["--tokenizer", str(codebook)] if codebook else []
    return ["--exp-dir", str(exp_dir), "--model-name", model, *tokens,
            "--generator-model-path", str(init), "--train-recordings", str(manifest),
            "--batch-size", str(BATCH), "--duration", "0.25", "--num-workers", "1",
            "--seed", str(SEED), "--n-timesteps", str(N_STEPS), "--num-epochs", "1",
            "--gen-start-batch-idx", str(GEN_START), "--average-period", str(AVERAGE_PERIOD),
            "--warmup-batches", "8", "--remat-rollout", "true", "--tensorboard", "false",
            "--valid-interval", "100000", "--save-every-n", "100000", "--log-interval", "1"]


def _recording(steps, record):
    """Wrap a `make_gan_steps` so that each D/G call appends (side, audio,
    loss, lr) to `record`."""
    def wrapped(*args, **kwargs):
        d_step, g_step, eval_step = steps(*args, **kwargs)

        def wrap(step, side):
            def call(state_or_batch, *rest):
                out = step(state_or_batch, *rest)
                jax_side = isinstance(out, tuple)
                metrics = out[1] if jax_side else out
                batch = rest[0] if jax_side else state_or_batch
                record.append((side, np.asarray(batch["audio"]),
                               float(metrics["loss_d" if side == "D" else "loss_g"]),
                               float(metrics["lr_d" if side == "D" else "lr_g"])))
                return out
            return call

        return wrap(d_step, "D"), wrap(g_step, "G"), eval_step
    return wrapped


@pytest.fixture(scope="module", params=MODELS)
def runs(request, tmp_path_factory):
    """One run of each fine-tuner and the four exports, for the mel and the
    token family; the token run's codebook is fit on the corpus by the
    port's bin/train_tokenizer, and both packages load it."""
    model = request.param
    root = tmp_path_factory.mktemp("ft_run")
    manifest = _corpus(root, n=N_RECORDINGS)
    codebook, generator_class = None, pgen.MelAudioGenerator
    if model.startswith("token"):
        codebook = train_tokenizer.main([
            "--model-name", model, "--recordings", str(manifest),
            "--output", str(root / "codebook.npz"), "--iters", "8", "--device", "cpu"])
        generator_class = pgen.TokenAudioGenerator
        jm, params_g, _, cfg = _token_pair("tiny")
    else:
        jm, params_g, _, cfg = _pair("tiny")
    init = root / "generator.ckpt"
    jckpt.save_checkpoint(init, params=params_g)
    j_disc = jd.Discriminators(periods=PERIODS, fft_sizes=FFT_SIZES)
    audio0 = jnp.zeros((2, int(0.25 * 24000)), jnp.float32)
    params_d = jax.jit(j_disc.init)(jax.random.PRNGKey(SEED), audio0, audio0)["params"]
    j_record, p_record, batch_idx, drawn = [], [], [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOW2GAN_COMPILATION_CACHE", "off")
        _patch_gate(mp, 1.0)
        # ---- JAX
        mp.setattr(j_finetune, "Discriminators", lambda: _JitInit(j_disc))
        mp.setattr(j_finetune, "build_generator", lambda c: _JitInit(j_build_generator(c)))
        mesh = jmesh.make_mesh(("data",), jax.devices()[:1])
        mp.setattr(j_finetune, "make_mesh", lambda axes: mesh)
        init_state = j_finetune.init_gan_train_state
        mp.setattr(j_finetune, "init_gan_train_state",
                   lambda *a: jmesh.replicate(init_state(*a), mesh))
        mp.setattr(j_finetune, "make_gan_steps", _recording(j_finetune.make_gan_steps, j_record))
        j_finetune.run(j_finetune.get_parser().parse_args(
            _flags(model, root / "jax", manifest, init, codebook)))

        # ---- the port, from the same discriminator init and the JAX draws
        mp.setattr(finetune, "Discriminators", lambda: pd.Discriminators(PERIODS, FFT_SIZES))
        mp.setattr(finetune, "init_discriminators", lambda m, g: load_jax_params(m, params_d))
        step_generator = finetune.step_generator

        def recording_generator(seed, idx, device):
            batch_idx.append(idx)
            return step_generator(seed, idx, device)

        draw = generator_class.draw_rollout

        def jax_draws(self, batch, n_frames, n_timesteps, generator, train=True, **kw):
            ours = draw(self, batch, n_frames, n_timesteps, generator, train, **kw)
            key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(SEED + 1),
                                                        batch_idx[-1]), 0)
            if codebook:
                x0 = _jax_token_x0(jm, params_g, jnp.zeros((batch, n_frames), jnp.int32), key)
            else:
                x0 = _jax_x0(jm, params_g, jnp.zeros((batch, cfg["n_mels"], n_frames)), key)
            assert x0.shape == tuple(ours.x0.shape)
            drawn.append(batch_idx[-1])
            gates = None if ours.gates is None else torch.ones_like(ours.gates)
            return RolloutDraws(torch.from_numpy(x0), gates)

        mp.setattr(finetune, "step_generator", recording_generator)
        mp.setattr(generator_class, "draw_rollout", jax_draws)
        mp.setattr(finetune, "make_gan_steps", _recording(finetune.make_gan_steps, p_record))
        history = finetune.run(finetune.get_parser().parse_args(
            [*_flags(model, root / "port", manifest, init, codebook), "--device", "cpu"]))

        exports = {}
        for windowed in (True, False):
            mode = "windowed" if windowed else "last"
            flags = ["--epoch", "1", "--avg", "1", "--load-gan", "true",
                     "--use-averaged-model", str(windowed).lower()]
            out = root / f"jax_{mode}.ckpt"
            mp.setattr(sys, "argv", ["save_averaged_model", "--exp-dir", str(root / "jax"),
                                     *flags, "--output", str(out)])
            j_save_averaged_model.main()
            exports[mode] = (
                torch.load(save_averaged_model.main(["--exp-dir", str(root / "port"), *flags,
                                                     "--output", str(root / f"port_{mode}.pt")]),
                           weights_only=True),
                jax_params_to_state_dict(jckpt.load_checkpoint(out)["model"]))
    return dict(root=root, j_record=j_record, p_record=p_record, history=history,
                drawn=drawn, exports=exports, start_g=jax_params_to_state_dict(params_g),
                start_d=jax_params_to_state_dict(params_d))


def _tree_errs(ours: dict, ref: dict, start: dict):
    """(whole, worst): the tree's |ours - ref| against its change |ref -
    start|, and the worst tensor's, beyond a floor of 4 float32 ulps of
    the tensor."""
    assert set(ours) == set(ref) == set(start)
    d = {k: (ours[k].double() - ref[k].double()).norm().item() for k in ref}
    c = {k: (ref[k].double() - start[k].double()).norm().item() for k in ref}
    whole = (sum(x * x for x in d.values()) / sum(x * x for x in c.values())) ** 0.5
    ulps = {k: 4 * 2.0 ** -23 * ref[k].double().norm().item() for k in ref}
    return whole, max(max(0.0, d[k] - ulps[k]) / (c[k] + 1e-30) for k in ref)


def _jax_epoch(root, key):
    return jckpt.load_checkpoint(root / "jax" / "epoch-1.ckpt")[key]


def _port_epoch(root, key):
    return ckpt.load_checkpoint(root / "port" / "epoch-1.pt")[key]


def test_batches_sides_and_lrs_match_jax(runs):
    j, p, h = runs["j_record"], runs["p_record"], runs["history"]
    assert len(j) == len(p) == len(h) == N_BATCHES
    sides = ["D"] * GEN_START + ["G", "D"] * ((N_BATCHES - GEN_START) // 2)
    assert [r[0] for r in j] == [r[0] for r in p] == [x["side"] for x in h] == sides
    for a, b in zip(j, p):
        np.testing.assert_array_equal(a[1], b[1])
    assert runs["drawn"] == list(range(N_BATCHES))
    for a, b, x in zip(j, p, h):
        assert b[3] == x["lr"] and b[3] == pytest.approx(a[3], rel=1e-6)
    # both warm-ups end inside the run, at each side's 9th update: the D
    # side's at batch 12, the G side's at batch 23; the lr falls after it
    lr_d = [x["lr"] for x in h if x["side"] == "D"]
    lr_g = [x["lr"] for x in h if x["side"] == "G"]
    assert lr_d[0] == pytest.approx(0.02 * 0.1) and lr_g[0] == pytest.approx(0.002 * 0.1)
    assert lr_d[9] < lr_d[8] > lr_d[7] and lr_g[9] < lr_g[8] > lr_g[7]


def test_losses_track_jax(runs):
    errs = [abs(b[2] - a[2]) / abs(a[2]) for a, b in zip(runs["j_record"], runs["p_record"])]
    assert max(errs) < 3e-5, errs


@pytest.mark.parametrize("side", ["generator", "discriminator"])
def test_final_parameters_match_jax(runs, side):
    root = runs["root"]
    whole, worst = _tree_errs(_port_epoch(root, "model")[side],
                              jax_params_to_state_dict(_jax_epoch(root, "model")[side]),
                              runs["start_g" if side == "generator" else "start_d"])
    limits = (5e-4, 5e-3) if side == "generator" else (1e-2, 3e-2)
    assert whole < limits[0] and worst < limits[1], (whole, worst)


def test_running_average_matches_jax(runs):
    root = runs["root"]
    whole, worst = _tree_errs(_port_epoch(root, "model_avg"),
                              jax_params_to_state_dict(_jax_epoch(root, "model_avg")),
                              runs["start_g"])
    assert whole < 5e-4 and worst < 5e-3, (whole, worst)


@pytest.mark.parametrize("mode", ["windowed", "last"])
def test_exports_match_jax(runs, mode):
    ours, theirs = runs["exports"][mode]
    whole, worst = _tree_errs(ours, theirs, runs["start_g"])
    assert whole < 5e-4 and worst < 5e-3, (whole, worst)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_exports_are_the_last_weights_and_the_window(runs, package):
    """`--use-averaged-model false` over epoch 1 is the generator of
    epoch-1 itself; the windowed export over (epoch-0, epoch-1] is the
    running average (epoch-0 is batch 0), which leaves out batch 26."""
    root = runs["root"]
    if package == "jax":
        last = jax_params_to_state_dict(_jax_epoch(root, "model")["generator"])
        avg = jax_params_to_state_dict(_jax_epoch(root, "model_avg"))
        windowed, plain = (runs["exports"][m][1] for m in ("windowed", "last"))
    else:
        last = _port_epoch(root, "model")["generator"]
        avg = {k: v.float() for k, v in _port_epoch(root, "model_avg").items()}
        windowed, plain = (runs["exports"][m][0] for m in ("windowed", "last"))
    assert set(plain) == set(last) == set(windowed) == set(avg)
    for k in last:
        torch.testing.assert_close(plain[k], last[k], rtol=0, atol=0)
        torch.testing.assert_close(windowed[k], avg[k], rtol=0, atol=0)
    assert not all(torch.equal(windowed[k], last[k]) for k in last)
