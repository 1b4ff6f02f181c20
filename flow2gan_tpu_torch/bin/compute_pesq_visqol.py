#!/usr/bin/env python3
"""PESQ, ViSQOL and multi-resolution STFT distance between a directory of
generated WAVs and the ground truth; the port's counterpart of the JAX
repo's `scripts/compute_pesq_visqol.py`, with its flags and output.

    python -m flow2gan_tpu_torch.bin.compute_pesq_visqol --ref-dir data/LibriTTS/test-clean \
        --gen-dir exp/gan_1step/test_clean_wavs/test-clean --output metrics_pesq.json

- The MR-STFT distance is computed here in numpy: spectral convergence plus
  log-magnitude L1, averaged over FFT sizes 1024/2048/512 (auraloss's
  defaults). It is the one metric that always runs.
- Wide-band PESQ needs the `pesq` package. Where it is not installed, or
  fails on a clip, the file's PESQ is null and the summary says why.
- ViSQOL needs a `visqol` binary on PATH and `--with-visqol` (speech mode;
  clips under 1 s are zero-padded to 1 s). Otherwise it is null and the
  summary says why.

It writes each file's metrics and their mean to `--output`, and fails (exit
2, nothing written) when no pair of files is found to score.
"""

from __future__ import annotations

import argparse
import json
import logging
import shutil
import subprocess
import tempfile
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

MRSTFT_FFTS = ((1024, 120, 600), (2048, 240, 1200), (512, 50, 240))


def get_parser():
    p = argparse.ArgumentParser(description="PESQ / ViSQOL / MR-STFT metrics")
    p.add_argument("--ref-dir", type=Path, required=True)
    p.add_argument("--gen-dir", type=Path, required=True)
    p.add_argument("--file-list", type=Path, default=None)
    p.add_argument("--num-workers", type=int, default=8)
    p.add_argument("--with-visqol", action="store_true")
    p.add_argument("--output", type=Path, default=None)
    return p


def _stft_mag(x: np.ndarray, n_fft: int, hop: int, win_length: int) -> np.ndarray:
    """|STFT| of a reflect-padded signal, a periodic Hann window of
    `win_length` centred in `n_fft`; (frames, n_fft // 2 + 1)."""
    win = np.hanning(win_length + 1)[:-1].astype(np.float64)
    pad = n_fft // 2
    x = np.pad(x, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    w = np.zeros(n_fft)
    off = (n_fft - win_length) // 2
    w[off:off + win_length] = win
    return np.abs(np.fft.rfft(x[idx] * w, axis=-1))


def mr_stft_distance(ref: np.ndarray, gen: np.ndarray) -> float:
    """Spectral convergence + log-magnitude L1, averaged over resolutions."""
    total = 0.0
    for n_fft, hop, win in MRSTFT_FFTS:
        r = _stft_mag(ref, n_fft, hop, win)
        g = _stft_mag(gen, n_fft, hop, win)
        sc = np.linalg.norm(r - g) / (np.linalg.norm(r) + 1e-9)
        lm = np.abs(np.log(r + 1e-7) - np.log(g + 1e-7)).mean()
        total += sc + lm
    return float(total / len(MRSTFT_FFTS))


def compute_one(pair) -> dict:
    """The metrics of one (ref, gen, with_visqol) pair. Runs in a worker
    process, on the CPU."""
    from flow2gan_tpu_torch.data.audio_io import read_wav, resample, write_wav

    ref_path, gen_path, with_visqol = pair
    ref, sr_r = read_wav(ref_path)
    gen, sr_g = read_wav(gen_path)
    ref, gen = ref.mean(0), gen.mean(0)
    if sr_g != sr_r:
        gen = resample(gen, sr_g, sr_r)
    n = min(len(ref), len(gen))
    ref, gen = ref[:n], gen[:n]

    out = {"file": str(gen_path), "mrstft": mr_stft_distance(ref, gen)}

    ref16 = resample(ref, sr_r, 16000)
    gen16 = resample(gen, sr_r, 16000)
    try:
        from pesq import pesq as pesq_fn

        out["pesq"] = float(pesq_fn(16000, ref16, gen16, "wb"))
    except ImportError:
        out["pesq"] = None
        out["pesq_unavailable"] = "pesq package not installed"
    except Exception as e:  # e.g. no utterance found in a silent or short clip
        logging.warning(f"pesq failed on {gen_path}: {e}")
        out["pesq"] = None
        out["pesq_unavailable"] = f"pesq failed: {e}"

    if with_visqol and shutil.which("visqol"):
        if len(ref16) < 16000:
            pad = 16000 - len(ref16)
            ref16 = np.pad(ref16, (0, pad))
            gen16 = np.pad(gen16, (0, pad))
        with tempfile.TemporaryDirectory() as td:
            rp, gp = Path(td) / "ref.wav", Path(td) / "gen.wav"
            write_wav(rp, ref16, 16000)
            write_wav(gp, gen16, 16000)
            try:
                res = subprocess.run(["visqol", "--reference_file", str(rp), "--degraded_file",
                                      str(gp), "--use_speech_mode"],
                                     capture_output=True, text=True, timeout=120)
                for line in res.stdout.splitlines():
                    if "MOS-LQO" in line:
                        out["visqol"] = float(line.split()[-1])
            except Exception as e:
                logging.warning(f"visqol failed on {gen_path}: {e}")
    return out


def file_pairs(ref_dir: Path, gen_dir: Path, file_list) -> list:
    """(ref, gen) paths that both exist: the names of `file_list`, or every
    WAV under `gen_dir` matched by its path relative to it."""
    if file_list:
        names = [line.strip() for line in open(file_list) if line.strip()]
        pairs = [(ref_dir / n, gen_dir / n) for n in names]
    else:
        pairs = [(ref_dir / f.relative_to(gen_dir), f) for f in sorted(gen_dir.rglob("*.wav"))]
    return [(r, g) for r, g in pairs if r.exists() and g.exists()]


def refuse_empty(pairs, args) -> None:
    """Exit 2 when there is nothing to score: an empty evaluation is a
    failure of the pipeline, not a result."""
    logging.info(f"Scoring {len(pairs)} file pairs")
    if not pairs:
        logging.error(f"FAILED: 0 file pairs to score (ref-dir={args.ref_dir}, "
                      f"gen-dir={args.gen_dir}): refusing to write an empty summary")
        raise SystemExit(2)


def write_results(summary: dict, results: list, output) -> None:
    print(json.dumps(summary))
    if output:
        output.parent.mkdir(parents=True, exist_ok=True)
        output.write_text(json.dumps({"summary": summary, "files": results}, indent=2))


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    args = get_parser().parse_args(argv)
    pairs = [(r, g, args.with_visqol) for r, g in file_pairs(args.ref_dir, args.gen_dir,
                                                             args.file_list)]
    refuse_empty(pairs, args)
    try:
        from pesq import pesq as _  # noqa: F401
    except ImportError:
        logging.warning("pesq package not installed; PESQ will be null")

    with ProcessPoolExecutor(max_workers=args.num_workers) as ex:
        results = list(ex.map(compute_one, pairs))

    summary = {}
    for key in ("pesq", "visqol", "mrstft"):
        vals = [r.get(key) for r in results if r.get(key) is not None]
        summary[key] = float(np.mean(vals)) if vals else None
    # a null says why, so that no reader takes an unavailable backend for a score
    if summary["pesq"] is None:
        reasons = {r["pesq_unavailable"] for r in results if "pesq_unavailable" in r}
        summary["pesq_unavailable"] = "; ".join(sorted(reasons)) if reasons else "no file pairs scored"
    if summary["visqol"] is None:
        summary["visqol_unavailable"] = (
            "visqol binary not on PATH or --with-visqol not set"
            if not (args.with_visqol and shutil.which("visqol")) else "no file pairs scored")
    summary["n_files"] = len(results)
    write_results(summary, results, args.output)
    return summary


if __name__ == "__main__":
    main()
