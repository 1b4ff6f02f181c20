#!/usr/bin/env bash
# Held-out generalisation drive with the PyTorch port: train mel_24k_base on
# a procedural speech-like corpus and score it on held-out utterances whose
# parameter draws it never saw (bin/make_synthetic_corpus.py, disjoint seed
# ranges). The same stages and budgets as the JAX repo's
# results/r4_generalization/drive_gen.sh, through recipes/run_libritts.sh:
#
#   corpus  300 train x 3 s (repeat 80 for FM, 40 for the GAN), 20 test, 4 dev
#   FM      4 epochs at batch 16 (6,000 steps), averaged over the last 2
#   FM rows n = 1/2/4 Euler steps from the averaged FM generator
#   GAN     per n: 1 epoch of 750 batches at batch 16, a 100-batch D-only
#           warm-up, --remat-rollout, exported twice: over (epoch-0, epoch-1]
#           (the running average, taken every 200 batches) to
#           $R/exp/gan_{n}step/, and as the last weights of epoch-1
#           (--use-averaged-model false), the export the JAX drive's GAN rows
#           had, to $R/exp_last/gan_{n}step/; both are scored
#   GAN'    the GAN rows again at --seed $SEED2 (the discriminators' init,
#           the batch order and the noise and flow-time draws change), from
#           the same averaged FM generator, so that two seeds' spread shows
#
# Fail-closed: set -e stops at any failed stage, the metric CLIs exit
# non-zero on 0 scored pairs and the collector on empty rows. Resumable by
# stage: each step is skipped where its output already exists. A GAN run's
# checkpoints are deleted once its generator.pt is exported.
#
# Usage: drive_generalization.sh [start_stage] [stop_stage]
#   stage 1 = preflight     stage 2 = corpus + FM pretraining + average
#   stage 3 = FM rows       stage 4 = GAN rows, one n at a time; the
#                                     last-weights rows to $OUT/last/
#   stage 5 = the GAN rows at the second seed, to $OUT/seed$SEED2/ (and
#             $OUT/seed$SEED2/last/)
# Environment: R (work dir, default build/torch_gen), OUT (results dir,
# default results/torch_generalization), PYTHON. Every step runs on the card.
# Each stage's wall time goes to $OUT/stage_times.jsonl, the trainers' step
# medians to $OUT/step_medians.json, the run's disk use to $OUT/disk.jsonl.
set -euo pipefail
REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
py=${PYTHON:-python3}
recipe="$REPO/flow2gan_tpu_torch/recipes/run_libritts.sh"

R=${R:-$REPO/build/torch_gen}
OUT=${OUT:-$REPO/results/torch_generalization}
SEED2=1  # the trainers' default --seed is 42
GAN_ARGS="--gen-start-batch-idx 100 --valid-interval 100000 --save-every-n 1000000 --log-interval 100 --remat-rollout true"
JAX_SUMMARY="$REPO/results/r4_generalization/summary.json"
mkdir -p "$R" "$OUT"
LOG=$R/drive.log
TIMES=$R/stage_times.jsonl

stage=${1:-1}
stop=${2:-9}

timed() {  # timed NAME CMD...: run CMD, append its wall seconds to $TIMES
  local name=$1; shift
  local t0; t0=$(date +%s.%N)
  "$@"
  "$py" -c 'import json, sys; print(json.dumps({"stage": sys.argv[1], "seconds": float(sys.argv[3]) - float(sys.argv[2])}))' \
    "$name" "$t0" "$(date +%s.%N)" >> "$TIMES"
}

has_rows() {  # has_rows FILE: FILE exists with n_files > 0
  "$py" -c '
import json, os, sys
p = sys.argv[1]
sys.exit(0 if os.path.exists(p) and json.load(open(p)).get("summary", {}).get("n_files", 0) > 0 else 1)
' "$1"
}

disk() {  # disk NAME DIR: append DIR's size in bytes to $R/disk.jsonl
  "$py" -c '
import json, os, sys
n = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(sys.argv[2]) for f in fs)
print(json.dumps({"what": sys.argv[1], "bytes": n}))
' "$1" "$2" >> "$R/disk.jsonl"
}

collect() {  # collect EXP OUT: EXP's GAN rows and the FM rows, and EXP's step medians
  local extra=(fm_1step:$R/exp/fm_1step fm_2step:$R/exp/fm_2step fm_4step:$R/exp/fm_4step)
  mkdir -p "$2"
  "$py" -m flow2gan_tpu_torch.bin.collect_results --exp-dir "$1" --output-dir "$2" \
    --steps 1 2 4 --extra "${extra[@]}" --reference "$JAX_SUMMARY" 2>&1 | tee -a "$LOG"
  "$py" - "$1" "$2" <<'PY'
import json, statistics, sys
from pathlib import Path
exp, out = Path(sys.argv[1]), Path(sys.argv[2])

def summary(records):
    ms = [x["ms"] for x in records]
    return {"steps": len(ms), "median_ms": statistics.median(ms),
            "median_ms_after_first_10": statistics.median(ms[10:]) if len(ms) > 10 else None,
            "total_s": sum(ms) / 1e3} if ms else None

medians = {}
for name in ["fm", "gan_1step", "gan_2step", "gan_4step"]:
    f = exp / name / "steps.jsonl"
    if f.exists():
        recs = [json.loads(line) for line in f.read_text().splitlines() if line]
        if name == "fm":
            medians[name] = summary(recs)
        else:
            medians[name] = {side: summary([x for x in recs if x["side"] == side])
                             for side in ("D", "G")}
(out / "step_medians.json").write_text(json.dumps(medians, indent=2) + "\n")
PY
  for f in stage_times.jsonl disk.jsonl; do
    if [ -f "$R/$f" ]; then cp "$R/$f" "$OUT/"; fi
  done
}

gan_rows() {  # gan_rows EXP TAG [trainer flags]: train, export and score the GAN at n = 1, 2, 4
  local exp=$1 tag=$2; shift 2
  local last=${exp}_last  # the last-weights exports, scored as rows of their own
  for n in 1 2 4; do
    if [ ! -f "$exp/gan_${n}step/generator.pt" ] || [ ! -f "$last/gan_${n}step/generator.pt" ]; then
      rm -rf "$exp/gan_${n}step" "$last/gan_${n}step"  # a half-trained run starts again
      timed "${tag}gan_${n}step_train_and_export" bash "$recipe" --stage 4 --stop-stage 4 \
        --corpus-dir "$R/LibriTTS" --data-dir "$R/manifests_gan" --exp-dir "$exp" \
        --model-name mel_24k_base --train-splits train_clean_100 \
        --n-timesteps-list "$n" \
        --gan-epochs 1 --gan-batch 16 --gan-avg 1 \
        --gan-extra-args "$GAN_ARGS $*" \
        2>&1 | tee -a "$LOG"
      timed "${tag}gan_${n}step_export_last" "$py" -m flow2gan_tpu_torch.bin.save_averaged_model \
        --exp-dir "$exp/gan_${n}step" --epoch 1 --avg 1 --use-averaged-model false \
        --load-gan true --output "$last/gan_${n}step/generator.pt" 2>&1 | tee -a "$LOG"
      disk "${tag}gan_${n}step_checkpoints" "$exp/gan_${n}step"
      rm -f "$exp/gan_${n}step"/epoch-*.pt "$exp/gan_${n}step"/checkpoint-*.pt
    fi
    for e in "$exp" "$last"; do
      if ! has_rows "$e/gan_${n}step/metrics_pitch.json"; then
        local kind=""
        if [ "$e" = "$last" ]; then kind="last_"; fi
        timed "${tag}gan_${n}step_${kind}infer_and_metrics" bash "$recipe" --stage 5 --stop-stage 6 \
          --corpus-dir "$R/LibriTTS" --data-dir "$R/manifests_gan" --exp-dir "$e" \
          --model-name mel_24k_base --train-splits train_clean_100 \
          --n-timesteps-list "$n" 2>&1 | tee -a "$LOG"
      fi
    done
  done
}

if [ "$stage" -le 1 ] && [ "$stop" -ge 1 ]; then
  timed preflight bash "$REPO/flow2gan_tpu_torch/recipes/preflight_pipeline.sh" \
    "$R/preflight" > "$R/preflight.log" 2>&1 \
    || { tail -30 "$R/preflight.log"; exit 1; }
  tail -2 "$R/preflight.log" | tee -a "$LOG"
  rm -rf "$R/preflight"
fi

if [ "$stage" -le 2 ] && [ "$stop" -ge 2 ]; then
  if [ ! -f "$R/manifests_gan/libritts_recordings_test_clean.jsonl.gz" ]; then
    # the same WAVs twice (the same seeds), each time with its manifests
    timed corpus "$py" -m flow2gan_tpu_torch.bin.make_synthetic_corpus \
      --corpus-dir "$R/LibriTTS" --data-dir "$R/manifests_fm" \
      --n-train 300 --n-test 20 --n-dev 4 --duration 3.0 --train-repeat 80 2>&1 | tee -a "$LOG"
    "$py" -m flow2gan_tpu_torch.bin.make_synthetic_corpus \
      --corpus-dir "$R/LibriTTS" --data-dir "$R/manifests_gan" \
      --n-train 300 --n-test 20 --n-dev 4 --duration 3.0 --train-repeat 40 2>&1 | tee -a "$LOG"
  fi
  if [ ! -f "$R/exp/fm/averaged.pt" ]; then
    timed fm_train_and_average bash "$recipe" --stage 2 --stop-stage 3 \
      --corpus-dir "$R/LibriTTS" --data-dir "$R/manifests_fm" --exp-dir "$R/exp" \
      --model-name mel_24k_base --train-splits train_clean_100 \
      --fm-epochs 4 --fm-batch 16 --fm-avg 2 \
      --fm-extra-args "--valid-interval 100000 --save-every-n 1000000 --log-interval 200 --keep-last-k 3" \
      2>&1 | tee -a "$LOG"
    disk fm_checkpoints "$R/exp/fm"
  fi
fi

if [ "$stage" -le 3 ] && [ "$stop" -ge 3 ]; then
  # FM baselines on the held-out split at every published step count
  for n in 1 2 4; do
    if ! has_rows "$R/exp/fm_${n}step/metrics_pitch.json"; then
      timed "fm_${n}step_infer" "$py" -m flow2gan_tpu_torch.bin.infer \
        --model-name mel_24k_base \
        --checkpoint "$R/exp/fm/averaged.pt" \
        --recordings "$R/manifests_fm/libritts_recordings_test_clean.jsonl.gz" \
        --root-path "$R/LibriTTS" \
        --output-dir "$R/exp/fm_${n}step/test_clean_wavs" \
        --n-timesteps $n 2>&1 | tee -a "$LOG"
      timed "fm_${n}step_metrics" bash -c '
        "$0" -m flow2gan_tpu_torch.bin.compute_pesq_visqol --ref-dir "$1/LibriTTS/test-clean" \
          --gen-dir "$1/exp/fm_$2step/test_clean_wavs/test-clean" \
          --output "$1/exp/fm_$2step/metrics_pesq.json"
        "$0" -m flow2gan_tpu_torch.bin.compute_pitch_periodicity --ref-dir "$1/LibriTTS/test-clean" \
          --gen-dir "$1/exp/fm_$2step/test_clean_wavs/test-clean" \
          --output "$1/exp/fm_$2step/metrics_pitch.json"' "$py" "$R" "$n" 2>&1 | tee -a "$LOG"
    fi
  done
  collect "$R/exp" "$OUT"
fi

if [ "$stage" -le 4 ] && [ "$stop" -ge 4 ]; then
  gan_rows "$R/exp" ""
  collect "$R/exp" "$OUT"
  collect "$R/exp_last" "$OUT/last"
fi

if [ "$stage" -le 5 ] && [ "$stop" -ge 5 ]; then
  # the GAN stage again at another seed, from the same averaged FM generator
  mkdir -p "$R/exp_seed$SEED2"
  ln -sfn "$R/exp/fm" "$R/exp_seed$SEED2/fm"
  gan_rows "$R/exp_seed$SEED2" "seed${SEED2}_" --seed "$SEED2"
  collect "$R/exp_seed$SEED2" "$OUT/seed$SEED2"
  collect "$R/exp_seed${SEED2}_last" "$OUT/seed$SEED2/last"
fi
echo "DRIVE_GENERALIZATION_DONE $(date -u)" | tee -a "$LOG"
