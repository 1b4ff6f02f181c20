"""The port's GAN stage against the JAX package, module by module, on the CPU:
the non-log mel frontend at every scale of the multi-scale loss, each
discriminator and the bundle (scores and every feature map), the four
losses, the discriminator tree through `compat/from_jax.py`, the
discriminators' init; and `bin/finetune.py` end to end on mel_24k_tiny with
its checkpoints, resume, the `--load-gan` CLIs and the flags that are not
ported yet.

Tolerances, relative to the reference's max |.|: 1e-5 for the mels and the
losses, 1e-4 for discriminator scores and feature maps (float32 through up to
six convolutions, summed in other orders).
"""

import functools
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow2gan_tpu.bin.finetune import get_parser as j_get_parser
from flow2gan_tpu.models import discriminators as jd
from flow2gan_tpu.models import gan as jgan
from flow2gan_tpu.ops import mel as jmel

import flow2gan_tpu_torch
from flow2gan_tpu_torch.bin import finetune, infer, save_averaged_model
from flow2gan_tpu_torch.compat.from_jax import load_gan_params, load_jax_params
from flow2gan_tpu_torch.data import audio_io
from flow2gan_tpu_torch.models import build_generator, get_gan_config, get_generator_config
from flow2gan_tpu_torch.models import discriminators as pd
from flow2gan_tpu_torch.models import gan as pgan
from flow2gan_tpu_torch.ops import mel as pmel
from flow2gan_tpu_torch.training import checkpoint as ckpt

from .test_torch_port_trainer import _corpus

SCALES = list(zip(get_gan_config("gan_multi_scale_mel_recon").mel_recon_n_ffts,
                  get_gan_config("gan_multi_scale_mel_recon").mel_recon_n_mels))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The full-width discriminators and the JAX compiles make this file one
    of the suite's heaviest: two intra-op threads let it share the CPU with
    the other test workers instead of oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-12)


def _audio(batch, length, seed):
    """Tones plus noise at different levels per row, float32 (batch, length)."""
    rng = np.random.RandomState(seed)
    t = np.arange(length) / 24000
    rows = [(0.1 + 0.2 * i) * np.sin(2 * np.pi * (150.0 + 70 * i) * t + i) for i in range(batch)]
    return (np.stack(rows) + 0.03 * rng.randn(batch, length)).astype(np.float32)


# ------------------------------------------------------------------- mels


@pytest.mark.parametrize("n_fft,n_mels", SCALES)
def test_mel_spectrogram_matches_jax(n_fft, n_mels):
    """Every scale of the multi-scale mel loss (hop n_fft // 4, power 1),
    the tiny ones (n_fft 32: 17 bins for 5 mels) with the filterbank JAX
    builds, bit for bit."""
    audio = _audio(2, 4096, n_fft)
    ref = jmel.MelSpectrogram(sampling_rate=24000, n_fft=n_fft, hop_length=n_fft // 4,
                              n_mels=n_mels)(jnp.asarray(audio))
    ours = pmel.MelSpectrogram(24000, n_fft, n_fft // 4, n_mels)(torch.from_numpy(audio))
    assert ours.shape == (2, n_mels, 1 + 4096 // (n_fft // 4))
    assert _rel_err(ours.numpy(), ref) < 1e-5
    np.testing.assert_array_equal(pmel.melscale_fbanks(n_fft // 2 + 1, 0.0, 12000.0, n_mels, 24000),
                                  jmel.melscale_fbanks(n_fft // 2 + 1, 0.0, 12000.0, n_mels, 24000))


# ---------------------------------------------------------- discriminators


def _perturbed(params, seed):
    """The JAX init with every bias moved off zero, so that the biases are
    held too."""
    rng = np.random.RandomState(seed)

    def move(path, p):
        p = np.asarray(p)
        if getattr(path[-1], "key", "") == "bias":
            p = p + 0.02 * rng.randn(*p.shape)
        return p.astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, params)


@functools.lru_cache(maxsize=None)
def _jax_module(kind, arg, length):
    """(JAX module, perturbed params, port module with them)."""
    if kind == "P":
        jmod, port = jd.DiscriminatorP(period=arg), pd.DiscriminatorP(arg)
        args = (jnp.zeros((2, length)),)
    elif kind == "R":
        jmod, port = jd.DiscriminatorR(window_length=arg), pd.DiscriminatorR(arg)
        args = (jnp.zeros((2, length)),)
    else:
        jmod, port = jd.Discriminators(*arg), pd.Discriminators(*arg)
        args = (jnp.zeros((2, length)), jnp.zeros((2, length)))
    params = _perturbed(jax.jit(jmod.init)(jax.random.PRNGKey(0), *args)["params"], seed=length)
    return jmod, params, load_jax_params(port, params)


def _nchw(x):
    x = np.asarray(x)
    return x.transpose(0, 3, 1, 2) if x.ndim == 4 else x


def _check_judgement(ours, theirs):
    """(score, fmaps) of one sub-discriminator, port NCHW against JAX NHWC."""
    (score, fmap), (j_score, j_fmap) = ours, theirs
    assert _rel_err(score.detach().numpy(), _nchw(j_score)) < 1e-4
    assert len(fmap) == len(j_fmap)
    for a, b in zip(fmap, j_fmap):
        assert _rel_err(a.detach().numpy(), _nchw(b)) < 1e-4


@pytest.mark.parametrize("period", [2, 3, 5, 7, 11])
def test_discriminator_p_matches_jax(period):
    """4097 samples: a multiple of none of the periods, so the reflect pad
    runs every time."""
    jmod, params, port = _jax_module("P", period, 4097)
    x = _audio(2, 4097, period)
    ref = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out[0].shape == (2, np.asarray(ref[0]).shape[1]) and len(out[1]) == 5
    _check_judgement(out, ref)


@pytest.mark.parametrize("window", [2048, 1024, 512])
def test_discriminator_r_matches_jax(window):
    jmod, params, port = _jax_module("R", window, 4096)
    x = _audio(2, 4096, window)
    ref = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        out = port(torch.from_numpy(x))
    assert out[0].shape[:2] == (2, 1) and len(out[1]) == 21
    _check_judgement(out, ref)


FULL = ("D", ((2, 3, 5, 7, 11), (2048, 1024, 512)), 4096)  # the default bundle


def test_discriminators_match_jax():
    """The default bundle (periods 2-11, windows 2048/1024/512) at batch 2 x
    4096: every score and feature map of real and fake, both halves."""
    jmod, params, port = _jax_module(*FULL)
    y, y_hat = _audio(2, 4096, 1), _audio(2, 4096, 2)
    ref = jax.jit(jmod.apply)({"params": params}, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        out = port(torch.from_numpy(y), torch.from_numpy(y_hat))
    for ours, theirs, n in zip(out, ref, (5, 3)):  # MPD, then MRD
        scores_r, scores_f, fmaps_r, fmaps_f = ours
        assert len(scores_r) == len(scores_f) == n
        for i in range(n):
            _check_judgement((scores_r[i], fmaps_r[i]), (theirs[0][i], theirs[2][i]))
            _check_judgement((scores_f[i], fmaps_f[i]), (theirs[1][i], theirs[3][i]))


def test_discriminators_judge_is_forward_per_signal():
    port = pd.init_discriminators(pd.Discriminators((2, 3), (256, 128)),
                                  torch.Generator().manual_seed(2))
    y, y_hat = (torch.from_numpy(_audio(2, 4096, s)) for s in (3, 4))
    with torch.no_grad():
        (mp, mr) = port(y, y_hat)
        (real_mp, real_mr), (fake_mp, fake_mr) = port.judge(y), port.judge(y_hat)
    for a, b in zip(mp + mr, (real_mp[0], fake_mp[0], real_mp[1], fake_mp[1],
                              real_mr[0], fake_mr[0], real_mr[1], fake_mr[1])):
        assert a is not b
        for x, z in zip(a, b):
            pairs = zip(x, z) if isinstance(x, list) else [(x, z)]
            assert all(torch.equal(u, v) for u, v in pairs)


def test_init_discriminators_draws_flax_default():
    """LeCun-normal kernels (std sqrt(1 / fan_in), cut at 2 std) and zero
    biases, as flax's `nn.Conv` default; the same seed draws the same."""
    # the default bundle's JAX init (`_perturbed` moves biases only)
    ref = _jax_module(*FULL)[1]["discriminator_0"]["discriminators_0"]["convs_4"]["kernel"]
    port = pd.init_discriminators(pd.Discriminators((2,), (512,)), torch.Generator().manual_seed(0))
    w = port.discriminator_0.discriminators[0].convs[4].weight
    assert abs(w.std().item() / float(np.std(ref)) - 1.0) < 0.02
    assert w.abs().max().item() <= 2 * (1.0 / 5120) ** 0.5 / 0.87962566103423978
    assert all(not m.bias.any() for m in port.modules() if isinstance(m, torch.nn.Conv2d))
    again = pd.init_discriminators(pd.Discriminators((2,), (512,)), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(port.parameters(), again.parameters()))


def test_from_jax_is_strict_on_the_discriminator_tree():
    jmod, params, port = _jax_module(*FULL)
    names = set(port.state_dict())
    assert "discriminator_0.discriminators.1.convs.4.weight" in names
    assert "discriminator_1.discriminators.0.band_convs.4.2.weight" in names
    assert "discriminator_1.discriminators.2.conv_post.bias" in names
    assert port.discriminator_0.discriminators[0].convs[1].weight.shape == (128, 32, 5, 1)
    fresh = pd.Discriminators
    missing = jax.tree_util.tree_map(np.asarray, params)
    del missing["discriminator_1"]["discriminators_0"]["band_convs_2_3"]
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(fresh(), missing)
    extra = jax.tree_util.tree_map(np.asarray, params)
    extra["discriminator_0"]["discriminators_1"]["emb"] = {"embedding": np.zeros((4, 1024))}
    with pytest.raises(KeyError, match="unused"):
        load_jax_params(fresh(), extra)
    wrong = jax.tree_util.tree_map(np.asarray, params)
    wrong["discriminator_0"]["discriminators_0"]["convs_0"]["kernel"] = np.zeros((3, 1, 1, 32))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_jax_params(fresh(), wrong)
    gen = build_generator(get_generator_config("mel_24k_tiny"))
    with pytest.raises(KeyError, match="'generator' and 'discriminator'"):
        load_gan_params(gen, fresh(), {"discriminator": params})


# ------------------------------------------------------------------ losses


def _loss_inputs(seed):
    rng = np.random.RandomState(seed)
    scores = [[rng.randn(2, n).astype(np.float32) * 1.5 for n in (7, 12, 30)] for _ in range(2)]
    fmaps = [[[rng.randn(2, c, 9, w).astype(np.float32) for c, w in ((4, 3), (8, 5))]
              for _ in range(3)] for _ in range(2)]
    return scores, fmaps


@pytest.mark.parametrize("name", ["discriminator", "generator", "feature_matching", "mel_recon"])
def test_gan_losses_match_jax(name):
    scores, fmaps = _loss_inputs(0)
    t = lambda tree: jax.tree_util.tree_map(torch.from_numpy, tree)  # noqa: E731
    j = lambda tree: jax.tree_util.tree_map(jnp.asarray, tree)  # noqa: E731
    if name == "discriminator":
        ours, ref = pgan.discriminator_loss(*t(scores)), jgan.discriminator_loss(*j(scores))
    elif name == "generator":
        ours, ref = pgan.generator_loss(t(scores[1])), jgan.generator_loss(j(scores[1]))
    elif name == "feature_matching":
        ours, ref = pgan.feature_matching_loss(*t(fmaps)), jgan.feature_matching_loss(*j(fmaps))
    else:
        real, fake = _audio(2, 4096, 5), _audio(2, 4096, 6)
        ours = pgan.mel_recon_loss(torch.from_numpy(real), torch.from_numpy(fake),
                                   pgan.make_mel_recon_fns(24000))
        ref = jgan.mel_recon_loss(jnp.asarray(real), jnp.asarray(fake),
                                  jgan.make_mel_recon_fns(24000))
    assert abs(float(ours) - float(ref)) <= 1e-5 * abs(float(ref))


def test_feature_matching_detaches_the_real_side():
    real = torch.ones(2, 3, requires_grad=True)
    fake = torch.zeros(2, 3, requires_grad=True)
    pgan.feature_matching_loss([[real]], [[fake]]).backward()
    assert real.grad is None and torch.equal(fake.grad, torch.full((2, 3), -1.0 / 6))


# ------------------------------------------------- the fine-tuning trainer


def _ft_args(exp_dir, manifest, *extra):
    return ["--exp-dir", str(exp_dir), "--model-name", "mel_24k_tiny", "--device", "cpu",
            "--train-recordings", str(manifest), "--valid-recordings", str(manifest),
            "--batch-size", "2", "--duration", "0.25", "--num-workers", "2", "--seed", "3",
            "--n-timesteps", "2", "--gen-start-batch-idx", "2", "--save-every-n", "2",
            "--keep-last-k", "1", "--average-period", "1", "--log-interval", "1",
            "--valid-interval", "6", *extra]


@pytest.fixture(scope="module")
def finetuned(tmp_path_factory):
    """mel_24k_tiny fine-tuned from a saved generator for 2 epochs in one run,
    and the second epoch again, resumed from a copy of the first's
    epoch-1.pt (6 recordings, batch 2: 3 batches an epoch). The trainer's
    logic is what is tested here, so the discriminators are few and narrow:
    the full bundle is held against JAX above."""
    root = tmp_path_factory.mktemp("ft")
    manifest = _corpus(root)
    init = root / "fm.pt"
    torch.save(flow2gan_tpu_torch.get_model("mel_24k_tiny", device="cpu", seed=9).module.state_dict(),
               init)
    common = ("--generator-model-path", str(init))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pd.DiscriminatorP, "CHANNELS", (8, 16, 16, 32, 32))
        mp.setattr(finetune, "Discriminators", lambda: pd.Discriminators((2, 3), (256, 128)))
        runs = {"straight": finetune.run(finetune.get_parser().parse_args(
            _ft_args(root / "exp", manifest, *common, "--num-epochs", "2")))}
        (root / "resumed").mkdir()
        shutil.copy(root / "exp" / "epoch-1.pt", root / "resumed" / "epoch-1.pt")
        runs["resumed"] = finetune.run(finetune.get_parser().parse_args(
            _ft_args(root / "resumed", manifest, *common, "--num-epochs", "2", "--start-epoch", "2")))
    return root, manifest, init, runs


def test_finetune_alternates_and_resumes_exactly(finetuned):
    """D-only warm-up to --gen-start-batch-idx 2, then strict D/G
    alternation; a run resumed from epoch-1.pt continues the batch count
    and the alternation, and ends where the straight run ends, bit for
    bit."""
    root, _, _, runs = finetuned
    sides = [(h["batch_idx_train"], h["side"]) for h in runs["straight"]]
    assert sides == [(1, "D"), (2, "D"), (3, "G"), (4, "D"), (5, "G"), (6, "D")]
    assert [(h["batch_idx_train"], h["side"]) for h in runs["resumed"]] == sides[3:]
    for h in runs["straight"]:
        assert np.isfinite(h["loss"]) and h["clip_scale"] == 1.0
    assert runs["straight"][0]["lr"] == pytest.approx(0.02 * 0.1)  # Eden2 warmup from 0.1
    assert runs["straight"][2]["lr"] == pytest.approx(0.002 * 0.1)  # the G side's first update
    assert [h["loss"] for h in runs["resumed"]] == [h["loss"] for h in runs["straight"][3:]]
    a, b = ckpt.load_checkpoint(root / "resumed" / "epoch-2.pt"), ckpt.load_checkpoint(
        root / "exp" / "epoch-2.pt")
    for side in ("generator", "discriminator"):
        assert all(torch.equal(v, b["model"][side][k]) for k, v in a["model"][side].items())


def test_finetune_checkpoints_hold_both_sides(finetuned):
    root, _, init, _ = finetuned
    exp = root / "exp"
    assert sorted(p.name for p in exp.glob("*.pt")) == [
        "checkpoint-6.pt", "epoch-0.pt", "epoch-1.pt", "epoch-2.pt"]
    assert sorted(p.name for p in (root / "resumed").glob("*.pt")) == [
        "checkpoint-6.pt", "epoch-1.pt", "epoch-2.pt"]
    first, last = ckpt.load_checkpoint(exp / "epoch-0.pt"), ckpt.load_checkpoint(exp / "epoch-2.pt")
    assert set(last["model"]) == {"generator", "discriminator"}
    assert set(last["optimizer"]) == {"g", "d"}
    assert last["optimizer"]["d"]["step"] == 4 and last["optimizer"]["g"]["step"] == 2
    assert last["batch_idx_train"] == 6 and last["train_disc"] is False
    assert last["n_timesteps"] == 2 and last["model_name"] == "mel_24k_tiny"
    assert last["model_avg"].keys() == last["model"]["generator"].keys()
    assert all(v.dtype == torch.float64 for v in last["model_avg"].values())
    fm = torch.load(init, weights_only=True)
    assert all(torch.equal(first["model"]["generator"][k], v) for k, v in fm.items())
    for side in ("generator", "discriminator"):
        assert not all(torch.equal(v, first["model"][side][k])
                       for k, v in last["model"][side].items())
    assert first["train_disc"] is True and first["optimizer"]["d"]["step"] == 0


def test_load_gan_clis_export_and_serve_the_generator(finetuned, tmp_path):
    root, manifest, _, _ = finetuned
    exp = root / "exp"
    with pytest.raises(ValueError, match="--load-gan"):
        save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "1",
                                  "--use-averaged-model", "false", "--output",
                                  str(tmp_path / "x.pt")])
    out = save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "2",
                                    "--load-gan", "true", "--output", str(tmp_path / "avg.pt")])
    last = ckpt.load_checkpoint(exp / "epoch-2.pt")["model"]["generator"]
    avg = torch.load(out, weights_only=True)
    assert avg.keys() == last.keys() and not all(torch.equal(avg[k], last[k]) for k in avg)
    plain = save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "1",
                                      "--use-averaged-model", "false", "--load-gan", "true",
                                      "--output", str(tmp_path / "plain.pt")])
    assert all(torch.equal(v, last[k]) for k, v in torch.load(plain, weights_only=True).items())
    served = flow2gan_tpu_torch.get_model("mel_24k_tiny", checkpoint=out, device="cpu")
    assert torch.isfinite(served.infer(np.zeros((1, 20, 8), np.float32), n_timesteps=2)).all()

    common = ["--model-name", "mel_24k_tiny", "--exp-dir", str(exp), "--recordings",
              str(manifest), "--root-path", str(root), "--batch-size", "4", "--device", "cpu",
              "--num-workers", "1", "--n-timesteps", "2"]
    with pytest.raises(ValueError, match="--load-gan"):
        infer.main([*common, "--epoch", "2", "--output-dir", str(tmp_path / "no")])
    written = infer.main([*common, "--epoch", "2", "--load-gan", "true",
                          "--output-dir", str(tmp_path / "out")])
    assert len(written) == 6
    for path in written:
        wav, sr = audio_io.read_wav(path)
        src = audio_io.read_wav(root / path.relative_to(tmp_path / "out"))[0]
        assert sr == 24000 and wav.shape == src.shape and np.isfinite(wav).all()


@pytest.mark.parametrize("flag,value,item", [
    ("--test-recordings", "test.jsonl", "'Observability'"),
    ("--print-diagnostics", "true", "'Observability'"),
    ("--inf-check", "true", "'Observability'"),
    ("--tensorboard", "true", "'Observability'"),
    ("--profile-dir", "prof", "'Observability'"),
])
def test_finetune_flags_not_ported_raise_and_name_their_item(flag, value, item, tmp_path):
    args = finetune.get_parser().parse_args([flag, value, "--device", "cpu",
                                             "--exp-dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match=f"{flag}.*ROADMAP.md, {item}"):
        finetune.run(args)


@pytest.mark.parametrize("flag,value", [
    ("--train-dls-weights", "1,2"), ("--freeze-modules", "cond_encoder"),
    ("--lr-scale-rules", "cond_encoder=0.5"), ("--resume-from", "checkpoint-4.pt"),
])
def test_finetune_shared_options_are_ported(flag, value):
    """The fine-tuner's shared options pass the check
    (tests/test_torch_port_resume.py runs them)."""
    finetune.check_ported(finetune.get_parser().parse_args([flag, value]), finetune._LATER)


def test_finetune_multi_process_raises_and_needs_the_card(monkeypatch, tmp_path):
    """A multi-process launch needs a global --batch-size that divides by
    the world size; one process on the card needs the card."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--batch-size 3 is the global batch.*world size 2"):
        finetune.run(finetune.get_parser().parse_args(["--device", "cpu", "--batch-size", "3"]))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = finetune.get_parser().parse_args(["--exp-dir", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        finetune.run(args)


def test_finetune_parser_keeps_the_jax_flags_and_defaults():
    """Every flag of the JAX fine-tuner, with its default, but --tensorboard
    (off: not ported) and --device (the port's own)."""
    ours = vars(finetune.get_parser().parse_args([]))
    theirs = vars(j_get_parser().parse_args([]))
    assert set(ours) - set(theirs) == {"device"} and set(theirs) <= set(ours)
    differ = {k for k in theirs if ours[k] != theirs[k] and k != "exp_dir"}
    assert differ == {"tensorboard"}
    assert str(ours["exp_dir"]) == str(theirs["exp_dir"])
