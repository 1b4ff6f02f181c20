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
CORPUS=$R/LibriTTS
TEST_MANIFEST=$R/manifests_fm/libritts_recordings_test_clean.jsonl.gz
mkdir -p "$R" "$OUT"
LOG=$R/drive.log
TIMES=$R/stage_times.jsonl

stage=${1:-1}
stop=${2:-9}

source "$REPO/flow2gan_tpu_torch/recipes/drive_lib.sh"

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
      score "fm_${n}step" "$R/exp/fm/averaged.pt" "$R/exp/fm_${n}step" "$n" --model-name mel_24k_base
    fi
  done
  collect "$R/exp" "$OUT" 1 2 4
fi

if [ "$stage" -le 4 ] && [ "$stop" -ge 4 ]; then
  gan_rows "$R/exp" ""
  collect "$R/exp" "$OUT" 1 2 4
  collect "$R/exp_last" "$OUT/last" 1 2 4
fi

if [ "$stage" -le 5 ] && [ "$stop" -ge 5 ]; then
  # the GAN stage again at another seed, from the same averaged FM generator
  mkdir -p "$R/exp_seed$SEED2"
  ln -sfn "$R/exp/fm" "$R/exp_seed$SEED2/fm"
  gan_rows "$R/exp_seed$SEED2" "seed${SEED2}_" --seed "$SEED2"
  collect "$R/exp_seed$SEED2" "$OUT/seed$SEED2" 1 2 4
  collect "$R/exp_seed${SEED2}_last" "$OUT/seed$SEED2/last" 1 2 4
fi
echo "DRIVE_GENERALIZATION_DONE $(date -u)" | tee -a "$LOG"
