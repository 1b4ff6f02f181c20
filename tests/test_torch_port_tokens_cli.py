"""The port's token family through its command lines on the CPU, at
token_24k_tiny on a synthetic corpus: `bin/train_tokenizer` (the codebook
loads in both packages), `bin/pretrain --tokenizer` with checkpoints and
`bin/save_averaged_model`, and with `--use-bf16 true`, `bin/finetune
--tokenizer` at 2 Euler steps, `bin/infer --tokenizer`, and `bin/infer_dir`
on wavs with `--tokenizer` and on token files with `--tokens true`, whole
and chunked. Data parallelism and `--resume-from` on a token config are
in tests/test_torch_port_dist.py and tests/test_torch_port_resume.py.

The fine-tuner's discriminators are narrowed, as in the mel fine-tuner's
test: the trainer's logic is what is tested here, and the full
discriminators are held against JAX in `tests/test_torch_port_gan.py`.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow2gan_tpu.models.config import get_generator_config as j_get_config
from flow2gan_tpu.ops import mel as jmel
from flow2gan_tpu.ops import tokenizer as jtok

import flow2gan_tpu_torch
from flow2gan_tpu_torch.bin import (
    finetune,
    infer,
    infer_dir,
    pretrain,
    save_averaged_model,
    train_tokenizer,
)
from flow2gan_tpu_torch.data import audio_io, dataset
from flow2gan_tpu_torch.models import TokenAudioGenerator, get_generator_config
from flow2gan_tpu_torch.models import discriminators as pd
from flow2gan_tpu_torch.ops.tokenizer import MelKMeansTokenizer
from flow2gan_tpu_torch.training import checkpoint as ckpt

from .test_torch_port_infer import _voiced
from .test_torch_port_trainer import _corpus

MODEL = ["--model-name", "token_24k_tiny", "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _train_args(exp_dir, manifest, *extra):
    return [*MODEL, "--exp-dir", str(exp_dir), "--train-recordings", str(manifest),
            "--valid-recordings", str(manifest), "--batch-size", "2", "--duration", "0.25",
            "--num-workers", "2", "--seed", "3", "--save-every-n", "2", "--keep-last-k", "1",
            "--average-period", "1", "--log-interval", "1", "--valid-interval", "2",
            "--num-epochs", "1", *extra]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A codebook fit by bin/train_tokenizer on 6 recordings of 0.5 s (one
    silent), token_24k_tiny pretrained on them for one epoch (3 steps) and
    averaged, and fine-tuned from the average at 2 Euler steps (D, G, D)."""
    root = tmp_path_factory.mktemp("tokens")
    manifest = _corpus(root)
    codebook = train_tokenizer.main(["--model-name", "token_24k_tiny", "--recordings",
                                     str(manifest), "--output", str(root / "codebook.npz"),
                                     "--iters", "8", "--device", "cpu"])
    fm = pretrain.run(pretrain.get_parser().parse_args(
        _train_args(root / "fm", manifest, "--tokenizer", str(codebook))))
    averaged = save_averaged_model.main(["--exp-dir", str(root / "fm"), "--epoch", "1",
                                         "--avg", "1"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pd.DiscriminatorP, "CHANNELS", (8, 16, 16, 32, 32))
        mp.setattr(finetune, "Discriminators", lambda: pd.Discriminators((2, 3), (256, 128)))
        gan = finetune.run(finetune.get_parser().parse_args(_train_args(
            root / "gan", manifest, "--tokenizer", str(codebook), "--n-timesteps", "2",
            "--gen-start-batch-idx", "1", "--generator-model-path", str(averaged))))
    return dict(root=root, manifest=manifest, codebook=codebook, fm=fm, averaged=averaged,
                gan=gan)


def test_train_tokenizer_fits_a_codebook_both_packages_load(trained):
    cfg = get_generator_config("token_24k_tiny")
    ours = MelKMeansTokenizer.from_file(trained["codebook"], expect_config=cfg)
    theirs = jtok.MelKMeansTokenizer.from_file(trained["codebook"],
                                               expect_config=j_get_config("token_24k_tiny"))
    assert ours.vocab_size == 64 and ours.centroids.shape == (64, 20)
    np.testing.assert_array_equal(np.asarray(theirs.centroids), ours.centroids.numpy())
    assert torch.isfinite(ours.centroids).all()
    # the fit is deterministic, and --vocab-size overrides the config's
    again = train_tokenizer.main(["--model-name", "token_24k_tiny", "--recordings",
                                  str(trained["manifest"]), "--output",
                                  str(trained["root"] / "again.npz"), "--iters", "8",
                                  "--device", "cpu"])
    np.testing.assert_array_equal(np.load(again)["centroids"], ours.centroids.numpy())
    small = train_tokenizer.main(["--model-name", "token_24k_tiny", "--recordings",
                                  str(trained["manifest"]), "--output",
                                  str(trained["root"] / "small.npz"), "--iters", "2",
                                  "--vocab-size", "16", "--device", "cpu"])
    assert np.load(small)["centroids"].shape == (16, 20)
    with pytest.raises(ValueError, match="vocab_size=16, model config expects 64"):
        MelKMeansTokenizer.from_file(small, expect_config=cfg)


def test_train_tokenizer_frames_are_the_unpadded_mels(trained):
    """Each recording is padded to whole seconds and its mel cut back to
    the frames the pad cannot reach: those equal the JAX package's log-mel
    of the recording as it is, within 1e-5."""
    args = train_tokenizer.get_parser().parse_args(["--recordings", str(trained["manifest"]),
                                                    "--output", "x.npz"])
    cfg = get_generator_config("token_24k_tiny")
    ours = train_tokenizer.mel_frames(args, cfg, torch.device("cpu"))
    j_mel = jmel.LogMelSpectrogram(sampling_rate=24000, n_fft=256, hop_length=64, n_mels=20)
    ref = []
    for rec in dataset.read_recording_manifest(trained["manifest"]):
        audio = audio_io.read_wav(rec.path)[0]
        keep = audio.shape[-1] // 64 + 1 - 256 // 64
        ref.append(np.asarray(j_mel(jnp.asarray(audio)))[0, :, :keep].T)
    ref = np.concatenate(ref)
    assert ours.shape == ref.shape == (6 * (12000 // 64 - 3), 20)
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


def test_pretrain_with_tokenizer_trains_and_its_average_serves(trained):
    history, fm = trained["fm"], trained["root"] / "fm"
    assert [h["batch_idx_train"] for h in history] == [1, 2, 3]
    assert all(np.isfinite(h["loss"]) for h in history)
    assert sorted(p.name for p in fm.glob("*.pt")) == ["averaged.pt", "checkpoint-2.pt",
                                                        "epoch-0.pt", "epoch-1.pt"]
    first, last = (ckpt.load_checkpoint(fm / f"epoch-{e}.pt")["model"] for e in (0, 1))
    assert last["token_embed.weight"].shape == (64, 24)
    moved = [not torch.equal(v, first[k]) for k, v in last.items()]
    assert sum(moved) / len(moved) > 0.9
    vm = flow2gan_tpu_torch.get_model("token_24k_tiny", checkpoint=trained["averaged"],
                                      tokenizer=trained["codebook"], device="cpu")
    assert isinstance(vm.module, TokenAudioGenerator)
    wav = vm.reconstruct(_voiced(0.5, 1)[None])
    assert wav.shape == (1, (12000 // 64 + 1) * 64) and torch.isfinite(wav).all()


def test_trainers_need_the_tokenizer_for_a_token_config(trained, tmp_path):
    """A token config without --tokenizer raises before any step, in both
    trainers; so does a codebook for another config."""
    args = _train_args(tmp_path / "x", trained["manifest"])
    with pytest.raises(ValueError, match="token_24k_tiny is token-conditioned; pass --tokenizer"):
        pretrain.run(pretrain.get_parser().parse_args(args))
    with pytest.raises(ValueError, match="token-conditioned; pass --tokenizer"):
        finetune.run(finetune.get_parser().parse_args(args))
    wrong = tmp_path / "wrong.npz"
    MelKMeansTokenizer(np.zeros((64, 100), np.float32), 24000, 1024, 256, 100).save(wrong)
    with pytest.raises(ValueError, match="mel_n_fft=1024, model config expects 256"):
        pretrain.run(pretrain.get_parser().parse_args([*args, "--tokenizer", str(wrong)]))


def test_finetune_with_tokenizer_alternates_and_moves_both_sides(trained):
    history, gan = trained["gan"], trained["root"] / "gan"
    assert [h["side"] for h in history] == ["D", "G", "D"]
    assert all(np.isfinite(h["loss"]) for h in history)
    first, last = (ckpt.load_checkpoint(gan / f"epoch-{e}.pt")["model"] for e in (0, 1))
    for side in ("generator", "discriminator"):
        moved = [not torch.equal(v, first[side][k]) for k, v in last[side].items()]
        assert sum(moved) / len(moved) > 0.9, side
    exported = save_averaged_model.main(["--exp-dir", str(gan), "--epoch", "1", "--avg", "1",
                                         "--load-gan", "true"])
    vm = flow2gan_tpu_torch.get_model("token_24k_tiny", checkpoint=exported, device="cpu")
    assert torch.isfinite(vm.infer(np.arange(12)[None] % 64, n_timesteps=2)).all()


def test_infer_with_tokenizer_reconstructs_the_manifest(trained, tmp_path):
    common = [*MODEL, "--exp-dir", str(trained["root"] / "fm"), "--epoch", "1",
              "--recordings", str(trained["manifest"]), "--output-dir", str(tmp_path / "out"),
              "--batch-size", "2", "--num-workers", "1"]
    written = infer.main([*common, "--tokenizer", str(trained["codebook"])])
    recs = dataset.read_recording_manifest(trained["manifest"])
    assert len(written) == len(recs)
    for path in written:
        out, sr = audio_io.read_wav(path)
        assert sr == 24000 and out.shape == (1, 12000) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="pass --tokenizer"):
        infer.main(common)


def test_infer_dir_on_wavs_and_token_files_whole_and_chunked(trained, tmp_path):
    """wavs with --tokenizer and .npy ids with --tokens true, each whole and
    in 8-frame chunks: frames * hop samples, finite; the token files hold the
    wavs' own tokens, so the two modes write the same audio."""
    wav_dir, tok_dir = tmp_path / "wavs", tmp_path / "tokens"
    wav_dir.mkdir()
    tok_dir.mkdir()
    vm = flow2gan_tpu_torch.get_model("token_24k_tiny", checkpoint=trained["averaged"],
                                      tokenizer=trained["codebook"], device="cpu")
    for i, secs in enumerate((0.3, 0.9)):
        audio = _voiced(secs, i)
        audio_io.write_wav(wav_dir / f"u{i}.wav", audio, 24000)
        ids = vm.tokens(audio_io.read_wav(wav_dir / f"u{i}.wav")[0]).numpy()
        np.save(tok_dir / f"u{i}.npy", ids if i else ids[0].astype(np.int32))  # (1, T) and (T,)
    common = [*MODEL, "--checkpoint", str(trained["averaged"])]
    runs = {}
    for name, flags in [("wav", ["--input-dir", str(wav_dir), "--tokenizer",
                                 str(trained["codebook"])]),
                        ("tokens", ["--input-dir", str(tok_dir), "--tokens", "true"])]:
        for chunk in ("0", "8"):
            runs[name, chunk] = [audio_io.read_wav(p)[0] for p in infer_dir.main(
                [*common, *flags, "--chunk-size", chunk, "--output-dir",
                 str(tmp_path / f"{name}_{chunk}")])]
    for i, secs in enumerate((0.3, 0.9)):
        frames = int(secs * 24000) // 64 + 1
        outs = [runs[key][i] for key in sorted(runs)]
        assert all(o.shape == (1, frames * 64) and np.isfinite(o).all() for o in outs)
        np.testing.assert_array_equal(runs["wav", "0"][i], runs["tokens", "0"][i])
        np.testing.assert_array_equal(runs["wav", "8"][i], runs["tokens", "8"][i])


def test_infer_dir_checks_token_inputs(trained, tmp_path):
    common = [*MODEL, "--checkpoint", str(trained["averaged"]), "--input-dir", str(tmp_path),
              "--output-dir", str(tmp_path / "out")]
    np.save(tmp_path / "a.npy", np.asarray([3, 64, 1]))
    with pytest.raises(ValueError, match=r"a.npy: token ids must lie in \[0, 64\)"):
        infer_dir.main([*common, "--tokens", "true"])
    np.save(tmp_path / "a.npy", np.zeros((20, 5), np.float32))
    with pytest.raises(ValueError, match="a.npy: token files hold integer ids"):
        infer_dir.main([*common, "--tokens", "true"])
    with pytest.raises(ValueError, match="pass --tokens true .* or --tokenizer"):
        infer_dir.main(common)
    shutil.rmtree(tmp_path / "out", ignore_errors=True)


def test_pretrain_with_tokenizer_in_bf16(trained, tmp_path):
    """`--use-bf16 true` on token_24k_tiny: the same 3 steps as the float32
    run of the fixture, finite, the embedding table trained and kept
    float32, and each step's loss within 1e-2 of the float32 run's (the
    first is taken on the same weights and draws)."""
    exp = tmp_path / "fm_bf16"
    history = pretrain.run(pretrain.get_parser().parse_args(_train_args(
        exp, trained["manifest"], "--tokenizer", str(trained["codebook"]), "--use-bf16", "true")))
    assert [h["batch_idx_train"] for h in history] == [1, 2, 3]
    f32 = [h["loss"] for h in trained["fm"]]
    assert [h["loss"] for h in history] != f32  # the bf16 casts did run
    assert all(abs(h["loss"] - ref) <= 1e-2 * abs(ref) for h, ref in zip(history, f32))
    first, last = (ckpt.load_checkpoint(exp / f"epoch-{e}.pt")["model"] for e in (0, 1))
    assert last["token_embed.weight"].dtype == torch.float32
    assert not torch.equal(last["token_embed.weight"], first["token_embed.weight"])
