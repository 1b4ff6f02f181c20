"""The port's recipe layer on the CPU, each piece held against its JAX-repo
counterpart on the same inputs from a numpy seed: `LinearFilterSpectrogram`
and `update_ema_model`; the corpus and manifest CLIs against the JAX repo's
scripts (the same WAV bytes, the same manifest rows); the MR-STFT, YIN
pitch/periodicity/V-UV and Fréchet functions and `collect_results` against
the JAX scripts'; the metric CLIs failing closed; the quick-start CLIs; and
`recipes/preflight_pipeline.sh --device cpu` end to end at mel_24k_tiny,
every artifact checked. The recipes' flags are held against the JAX
repo's `run_libritts.sh`, `results/r4_generalization/drive_gen.sh` and
`results/r5_token_gen/drive_token_gen.sh`, and
the trainers' step records (`<exp>/steps.jsonl`) against a fresh and a
resumed run.
"""

import argparse
import gzip
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flow2gan_tpu.ops.mel import LinearFilterSpectrogram as JLinearFilterSpectrogram
from flow2gan_tpu.training import checkpoint as jckpt

from flow2gan_tpu_torch.bin import (
    collect_results,
    compute_fsd,
    compute_pesq_visqol,
    compute_pitch_periodicity,
    from_mel,
    from_wav,
    make_rehearsal_corpus,
    make_synthetic_corpus,
    prepare_recordings_libritts,
    prepare_test_list_libritts,
)
from flow2gan_tpu_torch.bin.pretrain import add_step_record, open_step_records
from flow2gan_tpu_torch.data.audio_io import read_wav, resample, write_wav
from flow2gan_tpu_torch.models import get_generator_config
from flow2gan_tpu_torch.ops.mel import LinearFilterSpectrogram
from flow2gan_tpu_torch.training import checkpoint as ckpt

REPO = Path(__file__).resolve().parents[1]
RECIPES = REPO / "flow2gan_tpu_torch" / "recipes"
REL = 1e-9  # the metric functions, relative


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _jax_script(name: str):
    """The JAX repo's `scripts/<name>.py` as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_repo_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run_jax_main(monkeypatch, name: str, argv: list):
    monkeypatch.setattr(sys, "argv", [name, *map(str, argv)])
    _jax_script(name).main()


def _manifest_rows(path: Path, root: Path) -> list:
    """The manifest's rows, with each source relative to `root`."""
    rows = []
    with gzip.open(path, "rt") as f:
        for line in f:
            d = json.loads(line)
            d["sources"][0]["source"] = str(Path(d["sources"][0]["source"]).relative_to(root))
            rows.append(d)
    return rows


def _close(a: float, b: float, rel: float = REL) -> bool:
    return abs(a - b) <= rel * max(abs(a), abs(b), 1e-30)


# ------------------------------------------------------------------ helpers


@pytest.mark.parametrize("sr,n_filter,n_fft,hop,f_min,f_max,power", [
    (24000, 64, 1024, None, 0.0, None, 2.0),
    (24000, 100, 512, 128, 20.0, 8000.0, 1.0),
    (44100, 80, 2048, 512, 0.0, None, 2.0),
])
def test_linear_filter_spectrogram_matches_jax(sr, n_filter, n_fft, hop, f_min, f_max, power):
    audio = np.random.RandomState(0).randn(2, 12000).astype(np.float32) * 0.3
    ref = np.asarray(JLinearFilterSpectrogram(sample_rate=sr, n_filter=n_filter, n_fft=n_fft,
                                              hop_length=hop, f_min=f_min, f_max=f_max,
                                              power=power)(jnp.asarray(audio)))
    ours = LinearFilterSpectrogram(sr, n_filter, n_fft, hop_length=hop, f_min=f_min, f_max=f_max,
                                   power=power)(torch.from_numpy(audio)).numpy()
    assert ours.shape == ref.shape == (2, n_filter, 12000 // (hop or n_fft // 2) + 1)
    assert np.abs(ours - ref).max() <= 1e-5 * np.abs(ref).max()


def test_update_ema_model_matches_jax():
    rng = np.random.RandomState(1)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 2)}
    ema = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    cur = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    for decay in (0.999, 0.5):
        ref = jckpt.update_ema_model({"m": {"x": ema["a"], "y": ema["b"]}, "z": ema["c"]},
                                     {"m": {"x": cur["a"], "y": cur["b"]}, "z": cur["c"]}, decay)
        ours = ckpt.update_ema_model({k: torch.from_numpy(v) for k, v in ema.items()},
                                     {k: torch.from_numpy(v) for k, v in cur.items()}, decay)
        for k, r in [("a", ref["m"]["x"]), ("b", ref["m"]["y"]), ("c", ref["z"])]:
            assert ours[k].dtype == torch.float64
            assert np.abs(ours[k].numpy() - np.asarray(r)).max() <= 1e-7 * np.abs(r).max()


# ------------------------------------------------------------- corpus and data


def test_synthetic_corpus_matches_jax_script(tmp_path, monkeypatch):
    args = ["--n-train", "3", "--n-test", "2", "--n-dev", "1", "--duration", "0.5",
            "--train-repeat", "2"]
    _run_jax_main(monkeypatch, "make_synthetic_corpus",
                  ["--corpus-dir", tmp_path / "jax", "--data-dir", tmp_path / "jax_m", *args])
    make_synthetic_corpus.main(["--corpus-dir", str(tmp_path / "port"), "--data-dir",
                                str(tmp_path / "port_m"), *args])
    jax_wavs = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.wav"))
    port_wavs = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.wav"))
    assert jax_wavs == port_wavs and len(port_wavs) == 6
    for rel in port_wavs:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    for split, n in (("train_clean_100", 6), ("test_clean", 2), ("dev_clean", 1)):
        name = f"libritts_recordings_{split}.jsonl.gz"
        ours = _manifest_rows(tmp_path / "port_m" / name, tmp_path / "port")
        assert ours == _manifest_rows(tmp_path / "jax_m" / name, tmp_path / "jax")
        assert len(ours) == n


def test_synthetic_corpus_splits_are_disjoint():
    """Train, test and dev draw from disjoint seeds: no test utterance is a
    train one."""
    train = [make_synthetic_corpus.synth_utterance(i, 24000, 0.25) for i in range(3)]
    test = make_synthetic_corpus.synth_utterance(100_000, 24000, 0.25)
    assert all(not np.array_equal(t, test) for t in train)
    assert np.array_equal(make_synthetic_corpus.synth_utterance(7, 24000, 0.25),
                          make_synthetic_corpus.synth_utterance(7, 24000, 0.25))


def _sources(tmp_path: Path) -> Path:
    src = tmp_path / "src"
    src.mkdir()
    for i, seconds in enumerate((3.0, 1.5, 1.0)):
        write_wav(src / f"s{i}.wav", make_synthetic_corpus.synth_utterance(50 + i, 24000, seconds),
                  24000)
    return src


def test_rehearsal_corpus_matches_jax_script(tmp_path, monkeypatch):
    src = _sources(tmp_path)
    args = ["--source-dir", src, "--crop-sec", "1.0", "--stride-sec", "0.5", "--n-test", "2",
            "--train-repeat", "2"]
    _run_jax_main(monkeypatch, "make_rehearsal_corpus",
                  ["--corpus-dir", tmp_path / "jax", "--data-dir", tmp_path / "jax_m", *args])
    make_rehearsal_corpus.main(["--corpus-dir", str(tmp_path / "port"), "--data-dir",
                                str(tmp_path / "port_m"), *map(str, args)])
    port_wavs = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.wav"))
    assert port_wavs == sorted(p.relative_to(tmp_path / "jax")
                               for p in (tmp_path / "jax").rglob("*.wav"))
    for rel in port_wavs:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()
    for split in ("train_clean_100", "test_clean", "dev_clean"):
        name = f"libritts_recordings_{split}.jsonl.gz"
        assert (_manifest_rows(tmp_path / "port_m" / name, tmp_path / "port")
                == _manifest_rows(tmp_path / "jax_m" / name, tmp_path / "jax"))
    assert ((tmp_path / "port_m" / "test_clean_files.txt").read_text()
            == (tmp_path / "jax_m" / "test_clean_files.txt").read_text())


def test_rehearsal_corpus_needs_source_dir(tmp_path):
    with pytest.raises(SystemExit):
        make_rehearsal_corpus.main(["--corpus-dir", str(tmp_path / "c"), "--data-dir",
                                    str(tmp_path / "m")])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A small synthetic corpus in the LibriTTS layout."""
    root = tmp_path_factory.mktemp("corpus")
    make_synthetic_corpus.main(["--corpus-dir", str(root / "LibriTTS"), "--data-dir",
                                str(root / "m"), "--n-train", "2", "--n-test", "3", "--n-dev",
                                "1", "--duration", "0.5"])
    return root


def test_prepare_recordings_matches_jax_script(corpus, tmp_path, monkeypatch):
    args = ["--corpus-dir", corpus / "LibriTTS", "--splits",
            "train-clean-100,train-clean-360,dev-clean,test-clean"]
    _run_jax_main(monkeypatch, "prepare_recordings_libritts", [*args, "--output-dir", tmp_path / "j"])
    prepare_recordings_libritts.main([*map(str, args), "--output-dir", str(tmp_path / "p")])
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) and len(names) == 3
    for name in names:
        ours = _manifest_rows(tmp_path / "p" / name, corpus)
        assert ours == _manifest_rows(tmp_path / "j" / name, corpus) and ours


def test_prepare_test_list_matches_jax_script(corpus, tmp_path, monkeypatch):
    for max_files in ("0", "2"):
        args = ["--corpus-dir", corpus / "LibriTTS", "--split", "test-clean",
                "--max-files", max_files]
        _run_jax_main(monkeypatch, "prepare_test_list_libritts",
                      [*args, "--output", tmp_path / "j.txt"])
        prepare_test_list_libritts.main([*map(str, args), "--output", str(tmp_path / "p.txt")])
        ours = (tmp_path / "p.txt").read_text()
        assert ours == (tmp_path / "j.txt").read_text()
        assert len(ours.splitlines()) == (3 if max_files == "0" else 2)


# ------------------------------------------------------------------- metrics


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """(ref, gen) WAV pairs: a close copy, a noisy one at another rate, a
    silent one, and one of another utterance."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.RandomState(2)
    out = []
    for i, (kind, sr_gen) in enumerate([("close", 24000), ("noisy", 22050), ("silent", 24000),
                                        ("other", 24000)]):
        ref = make_synthetic_corpus.synth_utterance(300 + i, 24000, 1.0)
        if kind == "close":
            gen = ref + 0.01 * rng.randn(len(ref)).astype(np.float32)
        elif kind == "noisy":
            gen = resample((ref + 0.1 * rng.randn(len(ref))).astype(np.float32), 24000, sr_gen)
        elif kind == "silent":
            gen = np.zeros_like(ref)
        else:
            gen = make_synthetic_corpus.synth_utterance(400 + i, 24000, 1.0)
        (root / "ref").mkdir(exist_ok=True)
        (root / "gen").mkdir(exist_ok=True)
        write_wav(root / "ref" / f"{kind}.wav", ref, 24000)
        write_wav(root / "gen" / f"{kind}.wav", np.clip(gen, -1, 1), sr_gen)
        out.append((root / "ref" / f"{kind}.wav", root / "gen" / f"{kind}.wav"))
    return root, out


def test_mr_stft_matches_jax(pairs):
    jax_script = _jax_script("compute_pesq_visqol")
    for ref, gen in pairs[1]:
        ours = compute_pesq_visqol.compute_one((ref, gen, False))
        theirs = jax_script.compute_one((ref, gen, False))
        assert ours.keys() == theirs.keys()
        assert _close(ours["mrstft"], theirs["mrstft"]) and math.isfinite(ours["mrstft"])
        assert ours["pesq"] == theirs["pesq"]
    x = np.random.RandomState(3).randn(9000)
    y = x + 0.05 * np.random.RandomState(4).randn(9000)
    assert _close(compute_pesq_visqol.mr_stft_distance(x, y), jax_script.mr_stft_distance(x, y))


def test_yin_and_pitch_metrics_match_jax(pairs):
    jax_script = _jax_script("compute_pitch_periodicity")
    for ref, gen in pairs[1]:
        ours = compute_pitch_periodicity.compute_one((ref, gen))
        theirs = jax_script.compute_one((ref, gen))
        assert ours.keys() == theirs.keys()
        for key in ("pitch_rmse_cents", "periodicity_rmse", "vuv_f1"):
            if theirs[key] is None:
                assert ours[key] is None
            else:
                assert _close(ours[key], theirs[key]), key
    t = np.arange(16000) / 16000
    tone = (np.sin(2 * np.pi * 200 * t) + 0.3 * np.sin(2 * np.pi * 400 * t)).astype(np.float32)
    f0, per = compute_pitch_periodicity.yin_track(tone, 16000)
    jf0, jper = jax_script.yin_track(tone, 16000)
    np.testing.assert_allclose(f0, jf0, rtol=REL)
    np.testing.assert_allclose(per, jper, rtol=REL)
    assert abs(np.median(f0) - 200.0) < 2.0 and np.median(per) > 0.9


def test_frechet_distance_matches_jax():
    jax_script = _jax_script("compute_fsd")
    rng = np.random.RandomState(5)
    a, b = rng.randn(40, 8), rng.randn(30, 8) * 1.3 + 0.2
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0), np.cov(b, rowvar=False))
    ours = compute_fsd.frechet_distance(*args)
    assert _close(ours, jax_script.frechet_distance(*args)) and ours > 0
    assert abs(compute_fsd.frechet_distance(args[0], args[1], args[0], args[1])) < 1e-6


def test_compute_fsd_needs_a_local_model(pairs, tmp_path):
    root, _ = pairs
    with pytest.raises(SystemExit, match="local wav2vec2"):
        compute_fsd.main(["--ref-dir", str(root / "ref"), "--gen-dir", str(root / "gen"),
                          "--model-path", str(tmp_path / "missing"),
                          "--output", str(tmp_path / "fsd.json")])
    assert not (tmp_path / "fsd.json").exists()


@pytest.mark.parametrize("module", [compute_pesq_visqol, compute_pitch_periodicity])
def test_metrics_fail_closed_on_no_pairs(module, pairs, tmp_path):
    root, _ = pairs
    (tmp_path / "empty").mkdir()
    with pytest.raises(SystemExit) as e:
        module.main(["--ref-dir", str(root / "ref"), "--gen-dir", str(tmp_path / "empty"),
                     "--output", str(tmp_path / "m.json")])
    assert e.value.code == 2 and not (tmp_path / "m.json").exists()


def _exp_with_metrics(root: Path, pairs) -> Path:
    """An exp dir whose rows hold the metric JSONs of the JAX scripts'
    per-file functions on `pairs`."""
    pesq = _jax_script("compute_pesq_visqol")
    pitch = _jax_script("compute_pitch_periodicity")
    exp = root / "exp"
    for row, chosen in [("gan_1step", pairs[:2]), ("gan_4step", pairs[1:]),
                        ("fm_1step", pairs[::2])]:
        d = exp / row
        d.mkdir(parents=True)
        files = [pesq.compute_one((r, g, False)) for r, g in chosen]
        summary = {"pesq": None, "visqol": None,
                   "mrstft": float(np.mean([f["mrstft"] for f in files])),
                   "pesq_unavailable": "pesq package not installed",
                   "visqol_unavailable": "visqol binary not on PATH or --with-visqol not set",
                   "n_files": len(files)}
        (d / "metrics_pesq.json").write_text(json.dumps({"summary": summary, "files": files}))
        files = [pitch.compute_one(p) for p in chosen]
        summary = {k: float(np.mean([f[k] for f in files if f[k] is not None]))
                   for k in ("pitch_rmse_cents", "periodicity_rmse", "vuv_f1")}
        summary["n_files"] = len(files)
        (d / "metrics_pitch.json").write_text(json.dumps({"summary": summary, "files": files}))
    return exp


def test_collect_results_matches_jax_script(pairs, tmp_path, monkeypatch):
    exp = _exp_with_metrics(tmp_path, pairs[1])
    args = ["--exp-dir", exp, "--steps", "1", "2", "4", "--extra", f"fm_1step:{exp / 'fm_1step'}"]
    _run_jax_main(monkeypatch, "collect_minipipe_results", [*args, "--output-dir", tmp_path / "j"])
    summary = collect_results.main([*map(str, args), "--output-dir", str(tmp_path / "p")])
    assert list(summary) == ["gan_1step", "gan_4step", "fm_1step"]
    names = sorted(p.name for p in (tmp_path / "p").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "j").iterdir()) and len(names) == 8
    for name in names:
        assert (tmp_path / "p" / name).read_text() == (tmp_path / "j" / name).read_text(), name

    # --reference sets another run's rows beside these, with the MR-STFT's
    # relative difference
    collect_results.main([*map(str, args), "--output-dir", str(tmp_path / "r"),
                          "--reference", str(tmp_path / "j" / "summary.json")])
    md = (tmp_path / "r" / "summary.md").read_text()
    assert md.startswith((tmp_path / "j" / "summary.md").read_text())
    assert md.count("| +0.0% |") == 3 and md.count("| reference |") == 3


def test_collect_results_fails_closed(tmp_path):
    exp = tmp_path / "exp"
    (exp / "fm_1step").mkdir(parents=True)
    (exp / "fm_1step" / "metrics_pesq.json").write_text(json.dumps(
        {"summary": {"mrstft": None, "pesq": None, "n_files": 0}}))
    (exp / "fm_2step").mkdir()
    for extra in (f"fm_1step:{exp / 'fm_1step'}", f"fm_2step:{exp / 'fm_2step'}"):
        with pytest.raises(SystemExit) as e:
            collect_results.main(["--exp-dir", str(exp), "--output-dir", str(tmp_path / "o"),
                                  "--extra", extra])
        assert e.value.code == 2
    with pytest.raises(SystemExit) as e:  # no rows at all
        collect_results.main(["--exp-dir", str(exp), "--output-dir", str(tmp_path / "o")])
    assert e.value.code == 2


# ------------------------------------------------------------ quick-start CLIs


def test_from_mel_and_from_wav(corpus, tmp_path):
    wav = sorted((corpus / "LibriTTS" / "test-clean").rglob("*.wav"))[0]
    out = from_wav.main(["--wav-file", str(wav), "--model-name", "mel_24k_tiny", "--device",
                         "cpu", "--n-timesteps", "2", "--output", str(tmp_path / "w.wav")])
    audio, sr = read_wav(out)
    assert sr == 24000 and audio.shape[-1] >= 12000 and np.isfinite(audio).all()
    cfg = get_generator_config("mel_24k_tiny")
    mel = np.random.RandomState(6).randn(cfg.n_mels, 20).astype(np.float32)
    np.save(tmp_path / "m.npy", mel)
    torch.save(torch.from_numpy(mel), tmp_path / "m.pt")
    outs = [read_wav(from_mel.main(["--mel-file", str(tmp_path / f"m.{ext}"), "--model-name",
                                    "mel_24k_tiny", "--device", "cpu", "--n-timesteps", "1",
                                    "--output", str(tmp_path / f"{ext}.wav")]))[0]
            for ext in ("npy", "pt")]
    assert outs[0].shape == (1, 20 * cfg.mel_hop_length) and np.array_equal(outs[0], outs[1])
    with pytest.raises(SystemExit):  # the input is required
        from_mel.main(["--device", "cpu"])


# ------------------------------------------------------------------- recipes


def _options(script: Path) -> set:
    return set(re.findall(r"^\s*(--[a-z-]+)\)", script.read_text(), re.M))


def test_run_libritts_takes_the_jax_recipes_options():
    jax_options = _options(REPO / "run_libritts.sh")
    ours = _options(RECIPES / "run_libritts.sh")
    assert len(jax_options) == 18 and jax_options <= ours
    assert ours - jax_options == {"--world-size", "--device", "--hf-dir", "--fsd-model-path"}
    text = (RECIPES / "run_libritts.sh").read_text()
    defaults = re.findall(r"^([a-z_]+=.*)$", (REPO / "run_libritts.sh").read_text(), re.M)
    assert len(defaults) == 21
    for default in defaults:
        assert f"\n{default}\n" in text, default
    assert "torch.distributed.run --standalone --nproc-per-node" in text


def _words(script: Path) -> str:
    """The script's text with its line continuations joined, its quotes
    dropped and its runs of blanks made one space."""
    text = re.sub(r"\\\n\s*", " ", script.read_text())
    return re.sub(r"[ \t]+", " ", text.replace('"', ""))


# (the port's drive, the JAX drive, the flags that both pass, the port's stage-5 lines)
_DRIVES = {
    "mel": ("drive_generalization.sh", "r4_generalization/drive_gen.sh", [
        "--n-train 300 --n-test 20 --n-dev 4 --duration 3.0 --train-repeat 80",
        "--n-train 300 --n-test 20 --n-dev 4 --duration 3.0 --train-repeat 40",
        "--model-name mel_24k_base --train-splits train_clean_100",
        "--fm-epochs 4 --fm-batch 16 --fm-avg 2",
        "--valid-interval 100000 --save-every-n 1000000 --log-interval 200 --keep-last-k 3",
        "--gan-epochs 1 --gan-batch 16 --gan-avg 1",
        "--gen-start-batch-idx 100 --valid-interval 100000 --save-every-n 1000000 "
        "--log-interval 100 --remat-rollout true",
        "for n in 1 2 4",
    ], ['gan_rows "$R/exp_seed$SEED2" "seed${SEED2}_" --seed "$SEED2"',
        'ln -sfn "$R/exp/fm" "$R/exp_seed$SEED2/fm"']),
    "token": ("drive_token_generalization.sh", "r5_token_gen/drive_token_gen.sh", [
        "--n-train 300 --n-test 20 --n-dev 4 --duration 3.0 --train-repeat 80",
        "--n-train 300 --n-test 20 --n-dev 4 --duration 3.0 --train-repeat 40",
        "M=token_24k_base",
        # the codebook: bin/train_tokenizer.py's defaults on the GAN manifest's train split
        "--model-name $M --recordings $G/manifests_gan/libritts_recordings_train_clean_100.jsonl.gz "
        "--output $R/tokenizer_1024.npz",
        "--exp-dir $R/exp/fm --model-name $M --tokenizer",
        "--num-epochs 4 --batch-size 16 --base-lr 0.035 --lr-batches 7500 --duration 1.5 "
        "--valid-interval 100000 --save-every-n 1000000 --log-interval 200 --keep-last-k 3",
        "--exp-dir $R/exp/fm --epoch 4 --avg 2 --output $R/exp/fm/averaged.",
        "--n-timesteps $n --num-epochs 1 --batch-size 16",
        "--valid-recordings $G/manifests_gan/libritts_recordings_dev_clean.jsonl.gz",
        "--gen-start-batch-idx 100 --valid-interval 100000 --save-every-n 1000000 "
        "--log-interval 100 --remat-rollout true",
        "--epoch 1 --avg 1 --load-gan true --output",
        "for n in 1 2 4",
    ], ['gan_row "$R/exp_seed$SEED2" "seed${SEED2}_" --seed "$SEED2"',
        'finetune "$exp/gan_${n}step" $n "$@"']),
}


@pytest.mark.parametrize("drive", sorted(_DRIVES))
def test_drive_generalization_keeps_the_jax_drives_budgets(drive):
    """The replay's corpus, codebook, FM and GAN flags are the JAX drive's;
    stage 5 repeats the GAN rows at another seed, from the same FM
    generator."""
    ours_name, jax_name, flags, stage5 = _DRIVES[drive]
    jax_drive = _words(REPO / "results" / jax_name)
    ours = _words(RECIPES / ours_name)
    for flag in flags:
        assert flag in jax_drive and flag in ours, flag
    assert "git " not in ours and "drive_lib.sh" in ours
    text = (RECIPES / ours_name).read_text()
    for line in stage5:
        assert line in text, line
    if drive == "token":  # the GAN stage at one step count, from the averaged FM generator
        assert "n=1" in jax_drive and "n=1" in ours
        assert "--generator-model-path $R/exp/fm/averaged." in jax_drive
        assert "--generator-model-path $R/exp/fm/averaged.pt" in ours


_STAND_IN_PYTHON = r"""#!{python}
# The interpreter the drives call, with the heavy CLIs stood in for:
# bin.finetune copies a GAN run's two epoch checkpoints into --exp-dir;
# bin.infer writes nothing; the metric CLIs copy a row's metric files; FSD
# fails (it is optional). Every call is logged; the rest runs for real.
import json, os, shutil, sys
from pathlib import Path

args = sys.argv[1:]
with open(os.environ["CALLS"], "a") as f:
    f.write(json.dumps(args) + "\n")
module = args[1] if args[:1] == ["-m"] else None
if module == "flow2gan_tpu_torch.bin.finetune":
    run = Path(args[args.index("--exp-dir") + 1])
    run.mkdir(parents=True, exist_ok=True)
    for f in Path(os.environ["CKPTS"]).glob("epoch-*.pt"):
        shutil.copy(f, run)
elif module == "flow2gan_tpu_torch.bin.infer":
    pass
elif module in ("flow2gan_tpu_torch.bin.compute_pesq_visqol",
                "flow2gan_tpu_torch.bin.compute_pitch_periodicity"):
    out = Path(args[args.index("--output") + 1])
    kind = "pesq" if module.endswith("visqol") else "pitch"
    shutil.copy(Path(os.environ["METRICS"]) / f"{{out.parent.name}}_metrics_{{kind}}.json", out)
elif module == "flow2gan_tpu_torch.bin.compute_fsd":
    sys.exit(1)
else:
    os.execv(sys.executable, [sys.executable, *args])
"""

# (GAN step counts, the JAX rows, the rows' metric files, the stage names of one n, its infer flags)
_STAGE_4 = {
    "mel": ((1, 2, 4), "r4_generalization/summary.json", "torch_generalization",
            ("train_and_export", "export_last", "infer_and_metrics", "last_infer_and_metrics"),
            ["--model-name", "mel_24k_base"]),
    "token": ((1,), "r5_token_gen/summary.json", "r5_token_gen",
              ("train_and_export", "export_last", "infer", "metrics", "last_infer",
               "last_metrics"),
              ["--model-name", "token_24k_base", "--tokenizer"]),
}


@pytest.mark.parametrize("drive", sorted(_STAGE_4))
def test_drive_generalization_scores_the_windowed_and_the_last_weights(tmp_path, drive):
    """The replay's GAN stage (stage 4) with the trainer, inference and the
    metric CLIs stood in for: each run is exported twice before its
    checkpoints are deleted, the windowed running average to exp/ and the
    last weights of epoch-1 to exp_last/, both are scored, and the
    last-weights rows are collected into $OUT/last/ against the JAX rows."""
    steps, jax_rows, metrics, stages, infer_flags = _STAGE_4[drive]
    ckpts = tmp_path / "ckpts"
    g0 = {"w": torch.zeros(3), "b": torch.ones(2)}
    g1 = {"w": torch.tensor([1.0, 2.0, 3.0]), "b": torch.tensor([0.5, 0.25])}
    avg = {"w": torch.tensor([0.5, 1.0, 1.5], dtype=torch.float64), "b": torch.ones(2, dtype=torch.float64)}
    for epoch, gen, running in ((0, g0, {k: v.double() for k, v in g0.items()}), (1, g1, avg)):
        ckpt.save_checkpoint(ckpts / f"epoch-{epoch}.pt",
                             model={"generator": gen, "discriminator": {"d": torch.ones(1)}},
                             model_avg=running, train_params={"batch_idx_train": 750 * epoch})
    python = tmp_path / "python"
    python.write_text(_STAND_IN_PYTHON.format(python=sys.executable))
    python.chmod(0o755)
    work, out, calls = tmp_path / "R", tmp_path / "OUT", tmp_path / "calls.jsonl"
    rows = REPO / "results" / metrics
    for n in (1, 2, 4):
        for m in ("pesq", "pitch"):
            dst = work / "exp" / f"fm_{n}step" / f"metrics_{m}.json"
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_text((rows / f"fm_{n}step_metrics_{m}.json").read_text())
    env = {**os.environ, "R": str(work), "G": str(tmp_path / "G"), "OUT": str(out),
           "PYTHON": str(python), "CKPTS": str(ckpts), "METRICS": str(rows), "CALLS": str(calls)}
    proc = subprocess.run(["bash", str(RECIPES / _DRIVES[drive][0]), "4", "4"], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for n in steps:
        windowed = torch.load(work / "exp" / f"gan_{n}step" / "generator.pt", weights_only=True)
        last = torch.load(work / "exp_last" / f"gan_{n}step" / "generator.pt", weights_only=True)
        assert all(torch.equal(windowed[k], avg[k].float()) for k in avg)
        assert all(torch.equal(last[k], g1[k]) for k in g1)
        assert not list((work / "exp" / f"gan_{n}step").glob("epoch-*.pt"))
        for e in ("exp", "exp_last"):
            assert (work / e / f"gan_{n}step" / "metrics_pitch.json").is_file()
    calls = [json.loads(x) for x in calls.read_text().splitlines()]
    infers = [c for c in calls if c[:2] == ["-m", "flow2gan_tpu_torch.bin.infer"]]
    assert len(infers) == 2 * len(steps)
    assert all(f in c for c in infers for f in infer_flags)
    for summary in (out / "summary.json", out / "last" / "summary.json"):
        assert set(json.loads(summary.read_text())) == (
            {f"gan_{n}step" for n in steps} | {"fm_1step", "fm_2step", "fm_4step"})
    assert jax_rows in (out / "last" / "summary.md").read_text()
    recorded = [json.loads(x)["stage"] for x in (out / "stage_times.jsonl").read_text().splitlines()]
    assert recorded == [f"gan_{n}step_{s}" for n in steps for s in stages]


def test_step_records_start_afresh_and_append_on_resume(tmp_path):
    """`<exp>/steps.jsonl` is emptied where a run starts afresh, appended to
    where it resumes, and holds each record as soon as it is added."""
    path = tmp_path / "steps.jsonl"
    path.write_text('{"batch_idx_train": 9, "stale": true}\n')
    runs = [argparse.Namespace(start_epoch=1, resume_from=None),
            argparse.Namespace(start_epoch=2, resume_from=None),
            argparse.Namespace(start_epoch=1, resume_from="checkpoint-4.pt")]
    for i, args in enumerate(runs):
        history = []
        f = open_step_records(args, tmp_path)
        try:
            add_step_record(history, f, {"batch_idx_train": i + 1, "ms": 1.5})
            on_disk = [json.loads(x) for x in path.read_text().splitlines()]
            assert on_disk[-1] == history[-1] == {"batch_idx_train": i + 1, "ms": 1.5}
        finally:
            f.close()
    assert [x["batch_idx_train"] for x in map(json.loads, path.read_text().splitlines())] == [1, 2, 3]


def test_preflight_pipeline_on_cpu(tmp_path):
    """recipes/preflight_pipeline.sh --device cpu at mel_24k_tiny: every
    stage's artifacts, the trainers' step records (FM 3 steps; GAN D, D, G)
    and finite metrics on both test files."""
    work = tmp_path / "pf"
    env = {**os.environ, "PYTHON": sys.executable, "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(["bash", str(RECIPES / "preflight_pipeline.sh"), "--device", "cpu",
                           "--n-train", "3", "--duration", "0.5", str(work)],
                          capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("PREFLIGHT_OK")
    for split, n in (("train_clean_100", 6), ("test_clean", 2), ("dev_clean", 2)):
        with gzip.open(work / "manifests" / f"libritts_recordings_{split}.jsonl.gz", "rt") as f:
            assert len(f.readlines()) == n
    exp = work / "exp"
    for name in ("fm/epoch-0.pt", "fm/epoch-1.pt", "fm/averaged.pt", "gan_1step/epoch-0.pt",
                 "gan_1step/epoch-1.pt", "gan_1step/generator.pt"):
        assert (exp / name).is_file(), name
    fm_steps = [json.loads(x) for x in (exp / "fm/steps.jsonl").read_text().splitlines()]
    gan_steps = [json.loads(x) for x in (exp / "gan_1step/steps.jsonl").read_text().splitlines()]
    assert [s["batch_idx_train"] for s in fm_steps] == [1, 2, 3]
    assert [s["side"] for s in gan_steps] == ["D", "D", "G"]
    assert all(math.isfinite(s["loss"]) and s["ms"] > 0 for s in fm_steps + gan_steps)
    wavs = sorted((exp / "gan_1step/test_clean_wavs/test-clean").rglob("*.wav"))
    assert [w.name for w in wavs] == ["test_0000.wav", "test_0001.wav"]
    pesq = json.loads((exp / "gan_1step/metrics_pesq.json").read_text())["summary"]
    pitch = json.loads((exp / "gan_1step/metrics_pitch.json").read_text())["summary"]
    assert pesq["n_files"] == pitch["n_files"] == 2
    assert math.isfinite(pesq["mrstft"]) and math.isfinite(pitch["periodicity_rmse"])
    assert pesq["pesq"] is None and pesq["pesq_unavailable"]


def test_run_libritts_world_size_2_on_cpu(corpus, tmp_path):
    """Stages 1-3 with `--world-size 2`: the FM trainer as 2 gloo processes
    under torch.distributed.run (the global batch of 4 split 2 and 2), its
    checkpoints and log from rank 0 alone, then the average."""
    env = {**os.environ, "PYTHON": sys.executable, "OMP_NUM_THREADS": "1"}
    exp = tmp_path / "exp"
    proc = subprocess.run(
        ["bash", str(RECIPES / "run_libritts.sh"), "--stage", "1", "--stop-stage", "3",
         "--corpus-dir", str(corpus / "LibriTTS"), "--data-dir", str(tmp_path / "m"),
         "--exp-dir", str(exp), "--model-name", "mel_24k_tiny", "--train-splits", "train_clean_100",
         "--fm-epochs", "1", "--fm-batch", "2", "--fm-avg", "1", "--world-size", "2",
         "--device", "cpu", "--fm-extra-args",
         "--valid-interval 100000 --num-workers 1 --duration 0.25 --tensorboard false"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "2 process(es)" in proc.stdout and "Pipeline done." in proc.stdout
    assert {p.name for p in (exp / "fm").glob("*.pt")} == {"epoch-0.pt", "epoch-1.pt",
                                                           "averaged.pt"}
    steps = [json.loads(x) for x in (exp / "fm/steps.jsonl").read_text().splitlines()]
    assert len(steps) == 1 and math.isfinite(steps[0]["loss"])
    log = "".join(p.read_text() for p in (exp / "fm/log").glob("log-train*"))
    assert "rank 0 of 2: backend gloo" in log
