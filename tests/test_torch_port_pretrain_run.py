"""Both packages' FM trainers over one whole run on the CPU.

`flow2gan_tpu.bin.pretrain.run` and `flow2gan_tpu_torch.bin.pretrain.run`
take the same flags, the same initial parameters (the JAX init at the CLI's
seed, loaded into the port), the same batches and the same draws, and train
mel_24k_tiny and token_24k_tiny (each check is a case of each) for one epoch
of 16 batches at batch 8 (the JAX CLI asks for a batch that splits over
the suite's 8 virtual devices): the Eden2 warm-up of 8 batches ending inside the
run, ScaledAdam's scale updates, branch dropout, the running average every 4
batches, and each package's windowed `save_averaged_model` over (epoch-0,
epoch-1]. The token run's codebook (vocab 64) is fit on the corpus by the
port's `bin/train_tokenizer`; both packages load the one `.npz`.

Setup. Each batch's draws are the JAX step's own, handed to the port's
`draw`: x0 and t, the first two draws of the "noise" stream of
`fold_in(fold_in(PRNGKey(seed + 1), batch), 0)`, and the branch-dropout
weights, the first draw of its "dropout" stream (`fold_in(..., 2)`); the
limiter gates are 1 on both sides (JAX's `_gate` patched to a constant). The
JAX CLI runs on one of the suite's virtual CPU devices, its `init` jitted and
its initial state placed on its mesh, as in `test_torch_port_finetune_run.py`.

Tolerances, float32 on both sides, set from the drift measured on this
run: the batches equal, each lr to 1e-6; each step's loss to 2e-5 of JAX's
(measured at most 1.3e-6 for mel, 1.2e-6 for tokens); the final generator,
the running average and the export: the whole tree's difference to 1e-3 of
its change over the run (measured at most 1.3e-4 for mel, 8.7e-5 for
tokens), and each tensor's to 5e-2 of its change beyond a floor of 4
float32 ulps of the tensor (measured at most 1.4e-2: mel's first cond
encoder BiasNorm `log_scale`, a scalar near 1.0 that moved 9.5e-5 over the
run and differs by 15 ulps; every other tensor at most 4.1e-3). A fault of
the trainer moves far more: ScaledAdam's scalar lr scale 0.1 -> 0.11 in the
port alone put every tree at ~1e-2 of its change (10x the limit, ~90x the
drift) and each tensor's worst at ~0.1.
"""

import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow2gan_tpu.bin import pretrain as j_pretrain
from flow2gan_tpu.bin import save_averaged_model as j_save_averaged_model
from flow2gan_tpu.models import build_generator as j_build_generator
from flow2gan_tpu.parallel import mesh as jmesh
from flow2gan_tpu.training import checkpoint as jckpt

from flow2gan_tpu_torch.bin import pretrain, save_averaged_model, train_tokenizer
from flow2gan_tpu_torch.compat.from_jax import jax_params_to_state_dict, load_jax_params
from flow2gan_tpu_torch.models import FMDraws
from flow2gan_tpu_torch.models import generator as pgen
from flow2gan_tpu_torch.training import checkpoint as ckpt

from .test_torch_port_finetune_run import _JitInit, _tree_errs
from .test_torch_port_gan_steps import _patch_gate
from .test_torch_port_trainer import _corpus

SEED, N_RECORDINGS, BATCH, AVERAGE_PERIOD, WARMUP = 5, 128, 8, 4, 8
N_BATCHES = N_RECORDINGS // BATCH
MODELS = ["mel_24k_tiny", "token_24k_tiny"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads let this file share the CPU with the other test
    workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _flags(model, exp_dir, manifest, codebook):
    tokens = ["--tokenizer", str(codebook)] if codebook else []
    return ["--exp-dir", str(exp_dir), "--model-name", model, *tokens,
            "--train-recordings", str(manifest), "--batch-size", str(BATCH),
            "--duration", "0.25", "--num-workers", "1", "--seed", str(SEED), "--num-epochs", "1",
            "--average-period", str(AVERAGE_PERIOD), "--warmup-batches", str(WARMUP),
            "--tensorboard", "false", "--valid-interval", "100000", "--save-every-n", "100000",
            "--log-interval", "1"]


def _jax_draws(jm, params, audio, batch_idx):
    """x0, t and the branch-dropout weights of the JAX FM step at
    `batch_idx` under the CLI's step key (`make_fm_train_step`'s streams)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), batch_idx)

    def draw(module, audio):
        x0 = jax.random.normal(module.make_rng("noise"), audio.shape) * module.init_noise_scale
        t = jax.random.uniform(module.make_rng("noise"), (audio.shape[0],))
        # the generator's branch dropout, as its forward draws it
        b, nb = audio.shape[0], module.num_branches
        k1, k2 = jax.random.split(module.make_rng("dropout"))
        idx = jax.random.randint(k1, (b,), 0, nb)
        mask = jnp.ones((b, nb)).at[jnp.arange(b), idx].set(0.0) * (nb / (nb - 1))
        drop = jax.random.uniform(k2, (b, 1)) < module.branch_dropout
        return x0, t, jnp.where(drop, mask, jnp.ones_like(mask))

    return [torch.from_numpy(np.array(x)) for x in jm.apply(
        {"params": params}, jnp.asarray(audio), method=draw,
        rngs={"noise": jax.random.fold_in(rng, 0), "dropout": jax.random.fold_in(rng, 2)})]


@pytest.fixture(scope="module", params=MODELS)
def runs(request, tmp_path_factory):
    """One run of each trainer and each package's windowed export."""
    model = request.param
    root = tmp_path_factory.mktemp("fm_run")
    manifest = _corpus(root, n=N_RECORDINGS)
    codebook, generator_class = None, pgen.MelAudioGenerator
    if model.startswith("token"):
        codebook = train_tokenizer.main([
            "--model-name", model, "--recordings", str(manifest),
            "--output", str(root / "codebook.npz"), "--iters", "8", "--device", "cpu"])
        generator_class = pgen.TokenAudioGenerator
    j_record, p_record, batch_idx, init = [], [], [], {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLOW2GAN_COMPILATION_CACHE", "off")
        _patch_gate(mp, 1.0)
        # ---- JAX, its initial parameters kept
        jm = {}

        def build(cfg):
            jm["module"] = j_build_generator(cfg)
            return _JitInit(jm["module"])

        mp.setattr(j_pretrain, "build_generator", build)
        mesh = jmesh.make_mesh(("data",), jax.devices()[:1])
        mp.setattr(j_pretrain, "make_mesh", lambda axes: mesh)
        init_state = j_pretrain.init_train_state

        def keep_init(params, optimizer):
            init["params"] = jax.tree.map(np.asarray, params)
            return jmesh.replicate(init_state(params, optimizer), mesh)

        mp.setattr(j_pretrain, "init_train_state", keep_init)
        make_step = j_pretrain.make_fm_train_step

        def recording_step(*args, **kwargs):
            step = make_step(*args, **kwargs)

            def call(state, batch, rng):
                audio = np.asarray(batch["audio"])
                state, metrics = step(state, batch, rng)
                j_record.append((audio, float(metrics["loss"]), float(metrics["lr"])))
                return state, metrics
            return call

        mp.setattr(j_pretrain, "make_fm_train_step", recording_step)
        j_pretrain.run(j_pretrain.get_parser().parse_args(_flags(model, root / "jax", manifest,
                                                                 codebook)))

        # ---- the port, from the JAX init and the JAX draws
        mp.setattr(pretrain, "init_weights", lambda m, g: load_jax_params(m, init["params"]))
        step_generator = pretrain.step_generator

        def recording_generator(seed, idx, device):
            batch_idx.append(idx)
            return step_generator(seed, idx, device)

        def jax_draws(self, audio, n_frames, generator, train=True, **kw):
            assert train
            x0, t, weight = _jax_draws(jm["module"], init["params"], audio.numpy(), batch_idx[-1])
            return FMDraws(x0, t, torch.ones(self.num_limiters), weight)

        step = pretrain.fm_train_step

        def recording_step_port(model_, optimizer, cond_fn, batch, lr, generator):
            metrics = step(model_, optimizer, cond_fn, batch, lr, generator)
            p_record.append((batch["audio"].numpy(), float(metrics["loss"]), float(lr)))
            return metrics

        mp.setattr(pretrain, "step_generator", recording_generator)
        mp.setattr(generator_class, "draw", jax_draws)
        mp.setattr(pretrain, "fm_train_step", recording_step_port)
        pretrain.run(pretrain.get_parser().parse_args(
            [*_flags(model, root / "port", manifest, codebook), "--device", "cpu"]))

        flags = ["--epoch", "1", "--avg", "1"]
        mp.setattr(sys, "argv", ["save_averaged_model", "--exp-dir", str(root / "jax"), *flags,
                                 "--output", str(root / "jax_windowed.ckpt")])
        j_save_averaged_model.main()
        exports = (torch.load(save_averaged_model.main(["--exp-dir", str(root / "port"), *flags,
                                                        "--output", str(root / "port.pt")]),
                              weights_only=True),
                   jax_params_to_state_dict(jckpt.load_checkpoint(root / "jax_windowed.ckpt")
                                            ["model"]))
    return dict(root=root, j_record=j_record, p_record=p_record, batch_idx=batch_idx,
                exports=exports, start=jax_params_to_state_dict(init["params"]))


def test_batches_and_lrs_match_jax(runs):
    j, p = runs["j_record"], runs["p_record"]
    assert len(j) == len(p) == N_BATCHES
    assert runs["batch_idx"] == list(range(N_BATCHES))
    for a, b in zip(j, p):
        np.testing.assert_array_equal(a[0], b[0])
        assert b[2] == pytest.approx(a[2], rel=1e-6)
    lrs = [x[2] for x in p]  # the warm-up ends inside the run, then the lr falls
    assert lrs[0] == pytest.approx(0.035 * 0.1) and lrs[WARMUP - 1] < lrs[WARMUP] > lrs[WARMUP + 1]


def test_losses_track_jax(runs):
    errs = [abs(b[1] - a[1]) / abs(a[1]) for a, b in zip(runs["j_record"], runs["p_record"])]
    assert max(errs) < 2e-5, errs


@pytest.mark.parametrize("tree", ["generator", "running_average", "export"])
def test_trained_parameters_match_jax(runs, tree):
    root = runs["root"]
    jax_epoch = jckpt.load_checkpoint(root / "jax" / "epoch-1.ckpt")
    port_epoch = ckpt.load_checkpoint(root / "port" / "epoch-1.pt")
    ours, theirs = {
        "generator": (port_epoch["model"], jax_params_to_state_dict(jax_epoch["model"])),
        "running_average": ({k: v.float() for k, v in port_epoch["model_avg"].items()},
                            jax_params_to_state_dict(jax_epoch["model_avg"])),
        "export": runs["exports"]}[tree]
    whole, worst = _tree_errs(ours, theirs, runs["start"])
    assert whole < 1e-3 and worst < 5e-2, (whole, worst)
