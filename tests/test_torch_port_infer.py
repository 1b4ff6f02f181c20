"""The port's inference CLIs and their data path, on the CPU: streamed
chunked synthesis (mirroring tests/test_infer_dir.py, and against the JAX
package's `streaming_infer` on one synth), checkpoint resolution on the port
trainer's checkpoints (mirroring tests/test_infer_cli.py), the native WAV
reader against `read_wav`, whole-file batches against the JAX loader's, and
one run of each CLI on mel_24k_tiny."""

import struct
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from flow2gan_tpu.bin.infer_dir import streaming_infer as j_streaming_infer
from flow2gan_tpu.data import dataset as j_dataset

from flow2gan_tpu_torch.api import init_weights
from flow2gan_tpu_torch.bin import infer, infer_dir
from flow2gan_tpu_torch.bin.infer_dir import streaming_infer
from flow2gan_tpu_torch.data import audio_io, dataset, native_audio
from flow2gan_tpu_torch.models import build_generator, get_generator_config
from flow2gan_tpu_torch.training import checkpoint as ckpt

# ------------------------------------------------------------ streaming


def _frame_local_synth(hop):
    """Sample j of frame i is the frame's first mel value: with such a model,
    streaming with any halo reproduces whole-file synthesis exactly."""
    def synth(cond):
        return np.repeat(np.asarray(cond)[:, 0, :], hop, axis=-1)
    return synth


def test_streaming_equals_full_for_local_model():
    hop, frames = 4, 37
    mel = np.random.RandomState(0).randn(3, frames).astype(np.float32)
    synth = _frame_local_synth(hop)
    full = synth(mel[None])[0]
    for chunk in (5, 10, 37, 64):
        out = streaming_infer(synth, mel, chunk, num_layers=2, hop=hop)
        assert out.shape == full.shape, (chunk, out.shape)
        np.testing.assert_array_equal(out, full)


def test_streaming_output_length_various_sizes():
    hop = 8
    synth = _frame_local_synth(hop)
    for frames in (1, 7, 100, 101):
        out = streaming_infer(synth, np.ones((2, frames), np.float32), 16, num_layers=8, hop=hop)
        assert out.shape == (frames * hop,)


@pytest.mark.parametrize("frames,chunk,num_layers", [(37, 5, 2), (100, 16, 8), (9, 64, 1)])
def test_streaming_matches_jax_on_one_synth(frames, chunk, num_layers):
    """A synth that mixes neighbouring frames and sees each chunk's edge
    padding: the chunks, halos, padding and cuts of both implementations
    agree, so their outputs do, bit for bit."""
    hop = 4
    shapes = []

    def synth(cond):
        cond = np.asarray(cond)
        shapes.append(cond.shape)
        mixed = cond[:, 0] + 0.5 * np.roll(cond[:, 1], 1, axis=-1) + 0.25 * cond[:, 2] ** 2
        return np.repeat(mixed, hop, axis=-1) * np.linspace(0.5, 1.5, hop * cond.shape[-1])

    mel = np.random.RandomState(frames).randn(3, frames).astype(np.float32)
    ours = streaming_infer(synth, mel, chunk, num_layers=num_layers, hop=hop)
    ours_shapes, shapes[:] = list(shapes), []
    theirs = j_streaming_infer(lambda params, cond: synth(cond), None, mel, chunk,
                               num_layers=num_layers, hop=hop)
    np.testing.assert_array_equal(ours, theirs)
    assert ours_shapes == shapes and set(ours_shapes) == {(1, 3, chunk + 6 * num_layers)}


# -------------------------------------------------- checkpoint resolution


TINY = get_generator_config("mel_24k_tiny")


@pytest.fixture(scope="module")
def tiny_ckpts(tmp_path_factory):
    """epoch-1..3.pt as the port's trainer writes them, holding the init
    scaled by 1, 2, 3, their running averages equal to the same, at batches
    100, 200, 300."""
    d = tmp_path_factory.mktemp("exp")
    init = init_weights(build_generator(TINY), torch.Generator().manual_seed(0)).state_dict()
    for epoch, bidx in [(1, 100), (2, 200), (3, 300)]:
        scaled = {k: v * epoch for k, v in init.items()}
        ckpt.save_checkpoint(d / f"epoch-{epoch}.pt", model=scaled,
                             model_avg={k: v.double() for k, v in scaled.items()},
                             train_params={"batch_idx_train": bidx})
    return d, init


def _args(exp_dir, **kw):
    base = dict(checkpoint=None, hf_model_name=None, epoch=None, avg=None,
                use_averaged_model=True, load_gan=False, exp_dir=exp_dir)
    return SimpleNamespace(**{**base, **kw})


def _first(sd):
    return sd["cond_encoder.in_proj.weight"]


def test_resolve_epoch(tiny_ckpts):
    d, init = tiny_ckpts
    sd = infer.resolve_params(_args(d, epoch=2), build_generator(TINY))
    torch.testing.assert_close(_first(sd), 2.0 * _first(init), rtol=1e-6, atol=0)


def test_resolve_plain_average(tiny_ckpts):
    d, init = tiny_ckpts
    sd = infer.resolve_params(_args(d, epoch=3, avg=2, use_averaged_model=False),
                              build_generator(TINY))
    torch.testing.assert_close(_first(sd), 2.5 * _first(init), rtol=1e-6, atol=0)


def test_resolve_windowed_average(tiny_ckpts):
    """(avg3 * 300 - avg1 * 100) / 200 = 4x the init."""
    d, init = tiny_ckpts
    sd = infer.resolve_params(_args(d, epoch=3, avg=2), build_generator(TINY))
    torch.testing.assert_close(_first(sd), 4.0 * _first(init), rtol=1e-5, atol=0)


def test_resolve_requires_source(tiny_ckpts):
    d, _ = tiny_ckpts
    with pytest.raises(ValueError, match="--checkpoint, --hf-model-name, or --epoch"):
        infer.resolve_params(_args(d), build_generator(TINY))
    with pytest.raises(FileNotFoundError, match="downloads nothing"):
        infer.resolve_params(_args(d, hf_model_name="libritts-mel-1-step"), build_generator(TINY))
    # a checkpoint with no GAN generator to unwrap is taken as it is
    plain = infer.resolve_params(_args(d, epoch=1), build_generator(TINY))
    unwrapped = infer.resolve_params(_args(d, epoch=1, load_gan=True), build_generator(TINY))
    assert all(torch.equal(plain[k], unwrapped[k]) for k in plain)


def _write_manifest(path, wavs):
    recs = []
    for i, w in enumerate(wavs):
        n = audio_io.read_wav(w)[0].shape[-1]
        recs.append(dataset.Recording(f"u{i}", str(w), 24000, n))
    dataset.write_recording_manifest(recs, path)
    return path


def _voiced(seconds, seed):
    t = np.arange(int(seconds * 24000)) / 24000
    rng = np.random.RandomState(seed)
    return (0.3 * np.sin(2 * np.pi * (120 + 40 * seed) * t) + 0.02 * rng.randn(t.size)).astype(
        np.float32)


def test_infer_absolute_manifest_stays_in_output_dir(tiny_ckpts, tmp_path):
    """A manifest of absolute paths and no --root-path writes inside
    --output-dir and leaves the sources as they were."""
    d, _ = tiny_ckpts
    src = tmp_path / "corpus" / "spk"
    src.mkdir(parents=True)
    audio_io.write_wav(src / "u0.wav", _voiced(0.5, 0), 24000)
    before = (src / "u0.wav").read_bytes()
    man = _write_manifest(tmp_path / "recs.jsonl.gz", [src / "u0.wav"])
    out_dir = tmp_path / "out"
    written = infer.main(["--model-name", "mel_24k_tiny", "--checkpoint", str(d / "epoch-1.pt"),
                          "--recordings", str(man), "--output-dir", str(out_dir),
                          "--device", "cpu", "--num-workers", "1"])
    assert written and all(str(w).startswith(str(out_dir)) for w in written)
    assert (src / "u0.wav").read_bytes() == before


def test_infer_runs_the_windowed_average_over_a_manifest(tiny_ckpts, tmp_path):
    """bin/infer end to end: --epoch 3 --avg 2 over a manifest with
    --root-path; one output per input at its length, finite, in the
    manifest's relative layout."""
    d, _ = tiny_ckpts
    root = tmp_path / "corpus"
    wavs = []
    for i, secs in enumerate((0.4, 0.73, 1.1)):
        (root / f"spk{i % 2}").mkdir(parents=True, exist_ok=True)
        wavs.append(root / f"spk{i % 2}" / f"u{i}.wav")
        audio_io.write_wav(wavs[-1], _voiced(secs, i), 24000)
    man = _write_manifest(tmp_path / "recs.jsonl.gz", wavs)
    out_dir = tmp_path / "out"
    written = infer.main(["--model-name", "mel_24k_tiny", "--exp-dir", str(d), "--epoch", "3",
                          "--avg", "2", "--recordings", str(man), "--root-path", str(root),
                          "--output-dir", str(out_dir), "--batch-size", "2", "--device", "cpu",
                          "--num-workers", "1", "--n-timesteps", "2"])
    assert sorted(written) == sorted(out_dir / w.relative_to(root) for w in wavs)
    for w in wavs:
        out, sr = audio_io.read_wav(out_dir / w.relative_to(root))
        assert sr == 24000 and out.shape[-1] == audio_io.read_wav(w)[0].shape[-1]
        assert np.isfinite(out).all() and np.abs(out).max() > 0
    # a token config reconstructs through its codebook, which it must be given
    with pytest.raises(ValueError, match="token_24k_tiny is token-conditioned; pass --tokenizer"):
        infer.main(["--model-name", "token_24k_tiny", "--recordings", str(man), "--output-dir",
                    str(out_dir), "--device", "cpu"])


# ---------------------------------------------------------- infer_dir


def test_infer_dir_whole_chunked_and_mel(tiny_ckpts, tmp_path):
    """bin/infer_dir end to end on wavs (whole and --chunk-size), and on
    .npy and .pt mels; the output length is frames * hop."""
    d, _ = tiny_ckpts
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for i, secs in enumerate((0.3, 0.9)):
        audio_io.write_wav(wav_dir / f"u{i}.wav", _voiced(secs, i), 24000)
    common = ["--model-name", "mel_24k_tiny", "--checkpoint", str(d / "epoch-2.pt"),
              "--device", "cpu"]
    whole = infer_dir.main([*common, "--input-dir", str(wav_dir), "--output-dir",
                            str(tmp_path / "whole")])
    chunked = infer_dir.main([*common, "--input-dir", str(wav_dir), "--output-dir",
                              str(tmp_path / "chunked"), "--chunk-size", "8"])
    for w, c, secs in zip(whole, chunked, (0.3, 0.9)):
        frames = int(secs * 24000) // 64 + 1
        a, b = audio_io.read_wav(w)[0], audio_io.read_wav(c)[0]
        assert a.shape == b.shape == (1, frames * 64)
        assert np.isfinite(a).all() and np.isfinite(b).all()
    mel_dir = tmp_path / "mels"
    mel_dir.mkdir()
    rng = np.random.RandomState(0)
    np.save(mel_dir / "a.npy", rng.randn(20, 13).astype(np.float32))
    torch.save(torch.from_numpy(rng.randn(1, 20, 7).astype(np.float32)), mel_dir / "b.pt")
    out = infer_dir.main([*common, "--input-dir", str(mel_dir), "--output-dir",
                          str(tmp_path / "from_mel"), "--mel", "true"])
    assert [audio_io.read_wav(p)[0].shape for p in out] == [(1, 13 * 64), (1, 7 * 64)]
    # token files need a token config, and a codebook file must exist
    with pytest.raises(ValueError, match="--tokens true needs a token_\\* config"):
        infer_dir.main([*common, "--input-dir", str(mel_dir), "--output-dir",
                        str(tmp_path / "x"), "--tokens", "true"])
    with pytest.raises(FileNotFoundError, match="c.npz"):
        infer_dir.main([*common, "--input-dir", str(mel_dir), "--output-dir",
                        str(tmp_path / "x"), "--tokenizer", str(tmp_path / "c.npz")])


# ------------------------------------------------------ the native reader


def _write_float_wav(path, audio: np.ndarray, sr: int):
    """IEEE float32 WAV, (channels, time)."""
    data = np.ascontiguousarray(audio.T).astype("<f4").tobytes()
    ch = audio.shape[0]
    fmt = struct.pack("<HHIIHH", 3, ch, sr, sr * 4 * ch, 4 * ch, 32)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(data)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(data)) + data)


@pytest.mark.parametrize("kind", ["int16", "float32", "stereo"])
def test_native_reader_matches_read_wav(tmp_path, kind):
    rng = np.random.RandomState(1)
    x = (0.3 * rng.randn(2 if kind == "stereo" else 1, 5000)).astype(np.float32)
    path = tmp_path / f"{kind}.wav"
    if kind == "float32":
        _write_float_wav(path, x, 24000)
    else:
        audio_io.write_wav(path, x, 24000)
    ref = audio_io.read_wav(path)[0].mean(axis=0)
    assert native_audio.available()
    before = native_audio.reads
    whole = native_audio.read_crop_mono(path, 0, 10_000)  # clipped to the file's length
    crop = native_audio.read_crop_mono(path, 1234, 2000)
    tail = native_audio.read_crop_mono(path, 4900, 500)
    assert native_audio.reads == before + 3
    np.testing.assert_allclose(whole, ref, rtol=0, atol=1e-7)
    np.testing.assert_allclose(crop, ref[1234:3234], rtol=0, atol=1e-7)
    np.testing.assert_allclose(tail, ref[4900:], rtol=0, atol=1e-7)
    assert native_audio.read_crop_mono(tmp_path / "missing.wav", 0, 10) is None


def test_crops_fall_back_to_python_without_the_library(tmp_path, monkeypatch, caplog):
    """With FLOW2GAN_NO_NATIVE=1 the loader reads in Python, logs it once,
    and its crops are the native reader's."""
    recs = [dataset.Recording("a", str(tmp_path / "a.wav"), 24000, 7200)]
    audio_io.write_wav(recs[0].path, _voiced(0.3, 3), 24000)
    kw = dict(batch_size=1, num_workers=1, train=True, duration=0.1, seed=2)
    native = list(dataset.build_data_loader(recs, **kw))
    monkeypatch.setenv("FLOW2GAN_NO_NATIVE", "1")
    monkeypatch.setattr(native_audio, "_tried", False)
    monkeypatch.setattr(native_audio, "_lib", None)
    with caplog.at_level("WARNING"):
        python = list(dataset.build_data_loader(recs, **kw)) + list(
            dataset.build_data_loader(recs, **kw))
    assert sum("reading WAVs in Python" in r.message for r in caplog.records) == 1
    assert native_audio.read_crop_mono(recs[0].path, 0, 10) is None
    np.testing.assert_array_equal(native[0]["audio"], python[0]["audio"])


# ------------------------------------------------------ whole-file batches


def test_whole_file_batches_match_jax(tmp_path):
    """duration=None: whole files, names relative to root_path, no effects,
    padded to the bucket length; the same batches as the JAX loader's."""
    root = tmp_path / "corpus"
    (root / "s").mkdir(parents=True)
    for i, secs in enumerate((0.2, 0.5, 0.37)):
        audio_io.write_wav(root / "s" / f"u{i}.wav", _voiced(secs, i), 24000)
    _write_float_wav(root / "s" / "f.wav", _voiced(0.25, 5)[None], 24000)
    recs = dataset.scan_dir_to_recordings(root)
    assert recs == [dataset.Recording(**vars(r)) for r in j_dataset.scan_dir_to_recordings(root)]
    assert [r.num_samples for r in recs] == [6000, 4800, 12000, 8880]
    kw = dict(root_path=str(root), sampling_rate=24000, batch_size=3, num_workers=2,
              train=False, apply_effects=False)
    ours = list(dataset.build_data_loader(recs, **kw))
    theirs = list(j_dataset.build_data_loader([j_dataset.Recording(**vars(r)) for r in recs], **kw))
    assert len(ours) == len(theirs) == 2
    for x, y in zip(ours, theirs):
        assert x["audio"].shape[1] % 4096 == 0
        np.testing.assert_array_equal(x["audio"], y["audio"])
        np.testing.assert_array_equal(x["audio_lens"], y["audio_lens"])
        assert x["file_names"] == y["file_names"]
    assert ours[0]["file_names"] == ["s/f.wav", "s/u0.wav", "s/u1.wav"]
