"""The port's trainer CLI and its data pipeline on the CPU: a few steps of
mel_24k_tiny on a synthetic corpus, the averaged export served by
`get_model`, the observability and shared flags being taken, and the WAV,
manifest and batch readers against the JAX package's."""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from flow2gan_tpu.bin.pretrain import get_parser as j_get_parser
from flow2gan_tpu.data import audio_io as j_audio_io
from flow2gan_tpu.data import dataset as j_dataset

import flow2gan_tpu_torch
from flow2gan_tpu_torch.bin import pretrain, save_averaged_model
from flow2gan_tpu_torch.data import audio_io, dataset
from flow2gan_tpu_torch.training import checkpoint as ckpt


def _corpus(root: Path, n: int = 6, seconds: float = 0.5, sr: int = 24000) -> Path:
    """n voiced tones plus noise as PCM16 WAVs, one of them silent, and their
    manifest."""
    rng = np.random.RandomState(0)
    (root / "wav").mkdir(parents=True, exist_ok=True)
    recs = []
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n):
        x = 0.3 * np.sin(2 * np.pi * (110.0 + 30 * i) * t) + 0.02 * rng.randn(t.size)
        x = np.zeros_like(x) if i == 3 else x
        path = root / "wav" / f"r{i}.wav"
        audio_io.write_wav(path, x.astype(np.float32), sr)
        recs.append(dataset.Recording(f"r{i}", str(path), sr, t.size))
    manifest = root / "recordings.jsonl.gz"
    dataset.write_recording_manifest(recs, manifest)
    return manifest


def _args(exp_dir, manifest, *extra):
    return ["--exp-dir", str(exp_dir), "--model-name", "mel_24k_tiny", "--device", "cpu",
            "--train-recordings", str(manifest), "--valid-recordings", str(manifest),
            "--batch-size", "2", "--duration", "0.25", "--num-workers", "2",
            "--save-every-n", "2", "--keep-last-k", "1", "--average-period", "1",
            "--log-interval", "1", "--valid-interval", "2", *extra]


def test_pretrain_trains_tiny_on_cpu_and_its_average_serves(tmp_path):
    manifest = _corpus(tmp_path)
    exp = tmp_path / "exp"
    history = pretrain.run(pretrain.get_parser().parse_args(_args(exp, manifest, "--num-epochs", "1")))
    assert [h["batch_idx_train"] for h in history] == [1, 2, 3]  # 6 recordings, batch 2
    assert all(np.isfinite(h["loss"]) and h["clip_scale"] == 1.0 for h in history)
    assert history[0]["lr"] == pytest.approx(0.035 * 0.1)  # Eden2 warmup starts at 0.1
    # a second epoch resumes from epoch-1.pt and continues the batch count
    more = pretrain.run(pretrain.get_parser().parse_args(
        _args(exp, manifest, "--num-epochs", "2", "--start-epoch", "2")))
    assert [h["batch_idx_train"] for h in more] == [4, 5, 6]
    names = sorted(p.name for p in exp.glob("*.pt"))
    assert names == ["checkpoint-6.pt", "epoch-0.pt", "epoch-1.pt", "epoch-2.pt"]
    last = ckpt.load_checkpoint(exp / "epoch-2.pt")
    assert last["batch_idx_train"] == 6 and last["optimizer"]["step"] == 6
    assert all(v.dtype == torch.float64 for v in last["model_avg"].values())

    out = save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "2"])
    model = flow2gan_tpu_torch.get_model("mel_24k_tiny", checkpoint=out, device="cpu")
    avg = torch.load(out, weights_only=True)
    assert avg.keys() == last["model"].keys()
    assert not all(torch.equal(avg[k], last["model"][k]) for k in avg)
    wav = model.infer(np.random.RandomState(0).randn(2, 20, 12).astype(np.float32))
    assert wav.shape == (2, 12 * 64) and torch.isfinite(wav).all()
    plain = save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "1",
                                      "--use-averaged-model", "false",
                                      "--output", str(tmp_path / "plain.pt")])
    for k, v in torch.load(plain, weights_only=True).items():
        torch.testing.assert_close(v, last["model"][k], rtol=0, atol=0)
    with pytest.raises(SystemExit, match="start checkpoint"):
        save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "3"])
    # --load-gan takes a GAN checkpoint's generator; the FM trainer's running
    # average is the generator's already, and its "model" is taken as it is
    gan = save_averaged_model.main(["--exp-dir", str(exp), "--epoch", "2", "--avg", "2",
                                    "--load-gan", "true", "--output", str(tmp_path / "g.pt")])
    for k, v in torch.load(gan, weights_only=True).items():
        torch.testing.assert_close(v, avg[k], rtol=0, atol=0)


def reaches_the_data(module, argv, tmp_path) -> None:
    """`module.run(argv)` on mel_24k_tiny gets as far as its data: it stops
    at the missing --train-recordings, having taken every flag before."""
    args = module.get_parser().parse_args([*argv, "--model-name", "mel_24k_tiny", "--device",
                                           "cpu", "--exp-dir", str(tmp_path / "exp")])
    with pytest.raises(SystemExit, match="--train-recordings is required"):
        module.run(args)


@pytest.mark.parametrize("flag,value", [
    ("--test-recordings", "test.jsonl"), ("--save-infer-steps", "1"),
    ("--print-diagnostics", "true"), ("--inf-check", "true"), ("--tensorboard", "true"),
    ("--profile-dir", "prof"),
])
def test_observability_flags_are_ported(flag, value, tmp_path):
    """Each is taken (tests/test_torch_port_observability.py runs them), and
    its help names no later slice."""
    parser = pretrain.get_parser()
    action = next(a for a in parser._actions if flag in a.option_strings)
    assert "not ported" not in (action.help or "")
    reaches_the_data(pretrain, [flag, value], tmp_path)


@pytest.mark.parametrize("flag,value", [
    ("--train-dls-weights", "1,2"), ("--freeze-modules", "cond_encoder"),
    ("--lr-scale-rules", "cond_encoder=0.5"), ("--resume-from", "checkpoint-4.pt"),
])
def test_shared_options_are_ported(flag, value):
    """The trainers' shared options are taken (tests/test_torch_port_resume.py
    runs them)."""
    args = pretrain.get_parser().parse_args([flag, value])
    assert getattr(args, flag[2:].replace("-", "_")) == value


def test_multi_process_runs_raise(monkeypatch):
    """A multi-process launch runs, with a global --batch-size that must
    divide by the world size (tests/test_torch_port_dist.py runs one); the
    check comes before the process group is joined."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="--batch-size 3 is the global batch.*world size 2"):
        pretrain.run(pretrain.get_parser().parse_args(["--batch-size", "3", "--device", "cpu"]))


def test_no_cpu_fallback_on_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = pretrain.get_parser().parse_args(["--exp-dir", str(tmp_path)])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        pretrain.run(args)


def test_parser_keeps_the_jax_flags_and_defaults():
    """Every flag of the JAX trainer, with its default (--tensorboard on),
    and --device (the port's own)."""
    ours = vars(pretrain.get_parser().parse_args([]))
    theirs = vars(j_get_parser().parse_args([]))
    assert set(ours) - set(theirs) == {"device"} and set(theirs) <= set(ours)
    differ = {k for k in theirs if ours[k] != theirs[k] and k != "exp_dir"}
    assert differ == set() and ours["tensorboard"] is True
    assert str(ours["exp_dir"]) == str(theirs["exp_dir"])


def test_wav_io_and_manifest_match_jax(tmp_path):
    manifest = _corpus(tmp_path, n=2)
    recs = dataset.read_recording_manifest(manifest)
    assert recs == [dataset.Recording(**vars(r)) for r in j_dataset.read_recording_manifest(manifest)]
    for r in recs:
        ours, sr = audio_io.read_wav(r.path)
        theirs, jsr = j_audio_io.read_wav(r.path)
        assert sr == jsr == 24000 and ours.shape == (1, r.num_samples)
        np.testing.assert_array_equal(ours, theirs)
    stereo = np.stack([np.linspace(-0.5, 0.5, 100), np.zeros(100)]).astype(np.float32)
    audio_io.write_wav(tmp_path / "st.wav", stereo, 16000)
    back, _ = audio_io.read_wav(tmp_path / "st.wav")
    assert np.abs(back - stereo).max() <= 0.5 / 32768 + 1e-9
    np.testing.assert_allclose(audio_io.resample(stereo, 16000, 24000),
                               j_audio_io.resample(stereo, 16000, 24000), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("train", [True, False])
def test_batches_match_jax(tmp_path, train):
    """The same crops, gains and silence handling as the JAX loader: one
    batch stream per (seed, epoch), item for item."""
    recs = dataset.read_recording_manifest(_corpus(tmp_path))
    kw = dict(sampling_rate=24000, batch_size=2, num_workers=2, train=train, duration=0.3,
              max_load_times=3, seed=5, drop_last=train)
    ours = dataset.build_data_loader(recs, **kw)
    theirs = j_dataset.build_data_loader([j_dataset.Recording(**vars(r)) for r in recs], **kw)
    theirs.process_index, theirs.process_count = 0, 1
    for epoch in (1, 2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        a, b = list(ours), list(theirs)
        assert len(a) == len(b) == len(ours) == 3
        for x, y in zip(a, b):
            np.testing.assert_allclose(x["audio"], y["audio"], rtol=0, atol=1e-7)
            np.testing.assert_array_equal(x["audio_lens"], y["audio_lens"])
            assert x["file_names"] == y["file_names"]


def test_loader_stops_cleanly_when_the_consumer_breaks(tmp_path):
    recs = dataset.read_recording_manifest(_corpus(tmp_path))
    loader = dataset.build_data_loader(recs, batch_size=1, num_workers=2, duration=0.2)
    it = iter(loader)
    next(it)
    it.close()
    assert len(list(loader)) == len(recs)
    assert os.path.exists(recs[0].path)
