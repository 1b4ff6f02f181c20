#!/usr/bin/env bash
# Preflight of the recipe with the PyTorch port at mel_24k_tiny: a synthetic
# corpus -> FM pretraining -> average (the avg == epochs window, which needs
# the epoch-0 snapshot) -> GAN fine-tuning -> export -> inference -> metrics,
# through the same CLIs and flags as a full drive; it ends by requiring
# scored metrics with n_files > 0 and prints PREFLIGHT_OK. Run it before a
# long drive: it catches in minutes what the drive would find after hours.
#
# Usage: flow2gan_tpu_torch/recipes/preflight_pipeline.sh [--device cuda|cpu]
#          [--n-train N] [--duration SECONDS] [workdir]
# (defaults: cuda, 6 utterances of 1.0 s, build/preflight). The interpreter
# is $PYTHON (default python3).
set -euo pipefail
REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
py=${PYTHON:-python3}

device=cuda
n_train=6
duration=1.0
R="$REPO/build/preflight"
while [[ $# -gt 0 ]]; do
  case "$1" in
    --device) device="$2"; shift 2;;
    --n-train) n_train="$2"; shift 2;;
    --duration) duration="$2"; shift 2;;
    -*) echo "unknown option $1"; exit 1;;
    *) R="$1"; shift;;
  esac
done
rm -rf "$R" && mkdir -p "$R"
M="$R/manifests"

"$py" -m flow2gan_tpu_torch.bin.make_synthetic_corpus \
  --corpus-dir "$R/LibriTTS" --data-dir "$M" \
  --n-train "$n_train" --n-test 2 --n-dev 2 --duration "$duration" --train-repeat 2

"$py" -m flow2gan_tpu_torch.bin.pretrain \
  --model-name mel_24k_tiny --exp-dir "$R/exp/fm" \
  --train-recordings "$M/libritts_recordings_train_clean_100.jsonl.gz" \
  --valid-recordings "$M/libritts_recordings_dev_clean.jsonl.gz" \
  --num-epochs 1 --batch-size 2 --duration "$duration" \
  --valid-interval 100000 --log-interval 5 --num-workers 2 --device "$device"

# avg == epochs: the window (epoch-0, epoch-1]
"$py" -m flow2gan_tpu_torch.bin.save_averaged_model \
  --exp-dir "$R/exp/fm" --epoch 1 --avg 1

"$py" -m flow2gan_tpu_torch.bin.finetune \
  --model-name mel_24k_tiny --exp-dir "$R/exp/gan_1step" \
  --generator-model-path "$R/exp/fm/averaged.pt" \
  --train-recordings "$M/libritts_recordings_train_clean_100.jsonl.gz" \
  --valid-recordings "$M/libritts_recordings_dev_clean.jsonl.gz" \
  --n-timesteps 1 --num-epochs 1 --batch-size 2 --duration "$duration" \
  --gen-start-batch-idx 2 --valid-interval 100000 --log-interval 5 --num-workers 2 \
  --device "$device"

"$py" -m flow2gan_tpu_torch.bin.save_averaged_model \
  --exp-dir "$R/exp/gan_1step" --epoch 1 --avg 1 \
  --load-gan true --output "$R/exp/gan_1step/generator.pt"

"$py" -m flow2gan_tpu_torch.bin.infer \
  --model-name mel_24k_tiny \
  --checkpoint "$R/exp/gan_1step/generator.pt" \
  --recordings "$M/libritts_recordings_test_clean.jsonl.gz" \
  --root-path "$R/LibriTTS" \
  --output-dir "$R/exp/gan_1step/test_clean_wavs" \
  --n-timesteps 1 --num-workers 2 --device "$device"

"$py" -m flow2gan_tpu_torch.bin.compute_pesq_visqol \
  --ref-dir "$R/LibriTTS/test-clean" \
  --gen-dir "$R/exp/gan_1step/test_clean_wavs/test-clean" \
  --output "$R/exp/gan_1step/metrics_pesq.json" --num-workers 2
"$py" -m flow2gan_tpu_torch.bin.compute_pitch_periodicity \
  --ref-dir "$R/LibriTTS/test-clean" \
  --gen-dir "$R/exp/gan_1step/test_clean_wavs/test-clean" \
  --output "$R/exp/gan_1step/metrics_pitch.json" --num-workers 2

"$py" - "$R/exp/gan_1step/metrics_pesq.json" "$R/exp/gan_1step/metrics_pitch.json" <<'PY'
import json, math, sys
pesq, pitch = (json.load(open(p))["summary"] for p in sys.argv[1:])
assert pesq["n_files"] > 0 and pitch["n_files"] > 0, (pesq, pitch)
assert math.isfinite(pesq["mrstft"]) and math.isfinite(pitch["periodicity_rmse"]), (pesq, pitch)
print(f"preflight metrics: n_files={pesq['n_files']} mrstft={pesq['mrstft']:.3f}")
PY
echo "PREFLIGHT_OK"
