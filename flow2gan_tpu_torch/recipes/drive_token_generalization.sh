#!/usr/bin/env bash
# Held-out generalisation drive of the token family with the PyTorch port:
# fit a k-means codebook over the log-mel frames of the procedural
# speech-like corpus of drive_generalization.sh, train token_24k_base on the
# codebook's ids alone, and score it on held-out utterances whose parameter
# draws it never saw. The same stages and budgets as the JAX repo's
# results/r5_token_gen/drive_token_gen.sh, through the port's CLIs (no
# recipe takes a tokenizer):
#
#   corpus    300 train x 3 s (repeat 80 for FM, 40 for the GAN), 20 test,
#             4 dev: drive_generalization.sh's, reused where $G holds it
#   codebook  bin/train_tokenizer.py on the GAN manifest's train split, its
#             defaults (K = 1024, 2000 recordings, 2M frames, 30 iterations)
#   FM        4 epochs at batch 16 (6,000 steps), averaged over the last 2
#   FM rows   n = 1/2/4 Euler steps from the averaged FM generator, tokens only
#   GAN       n = 1: 1 epoch of 750 batches at batch 16, a 100-batch D-only
#             warm-up, --remat-rollout, exported twice: over (epoch-0,
#             epoch-1] (the running average, taken every 200 batches; the
#             export the JAX drive's GAN row had) to $R/exp/gan_1step/, and
#             as the last weights of epoch-1 (--use-averaged-model false) to
#             $R/exp_last/gan_1step/; both are scored
#   GAN'      the GAN row again at --seed $SEED2, from the same averaged FM
#             generator, so that two seeds' spread shows
#
# Fail-closed: set -e stops at any failed stage, the metric CLIs exit
# non-zero on 0 scored pairs and the collector on empty rows. Resumable by
# stage: each step is skipped where its output already exists. A GAN run's
# checkpoints are deleted once both its exports exist.
#
# Usage: drive_token_generalization.sh [start_stage] [stop_stage]
#   stage 1 = preflight     stage 2 = corpus + codebook + FM pretraining + average
#   stage 3 = FM rows       stage 4 = the GAN row; the last-weights row to $OUT/last/
#   stage 5 = the GAN row at the second seed, to $OUT/seed$SEED2/ (and
#             $OUT/seed$SEED2/last/)
# Environment: R (work dir, default build/torch_token_gen), G (the corpus
# and its manifests, default drive_generalization.sh's build/torch_gen), OUT
# (results dir, default results/torch_token_generalization), PYTHON. Every
# step runs on the card. Each stage's wall time goes to
# $OUT/stage_times.jsonl, the trainers' step medians to
# $OUT/step_medians.json, the run's disk use to $OUT/disk.jsonl.
set -euo pipefail
REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
py=${PYTHON:-python3}

M=token_24k_base
R=${R:-$REPO/build/torch_token_gen}
G=${G:-$REPO/build/torch_gen}
OUT=${OUT:-$REPO/results/torch_token_generalization}
SEED2=1  # the trainers' default --seed is 42
TOK=$R/tokenizer_1024.npz
GAN_ARGS="--gen-start-batch-idx 100 --valid-interval 100000 --save-every-n 1000000 --log-interval 100 --remat-rollout true"
JAX_SUMMARY="$REPO/results/r5_token_gen/summary.json"
CORPUS=$G/LibriTTS
TEST_MANIFEST=$G/manifests_fm/libritts_recordings_test_clean.jsonl.gz
mkdir -p "$R" "$G" "$OUT"
LOG=$R/drive.log
TIMES=$R/stage_times.jsonl

stage=${1:-1}
stop=${2:-9}

source "$REPO/flow2gan_tpu_torch/recipes/drive_lib.sh"

pretrain() {  # FM pretraining on the codebook's ids, then the average of its last 2 epochs
  "$py" -m flow2gan_tpu_torch.bin.pretrain \
    --exp-dir "$R/exp/fm" --model-name $M --tokenizer "$TOK" \
    --train-recordings "$G/manifests_fm/libritts_recordings_train_clean_100.jsonl.gz" \
    --valid-recordings "$G/manifests_fm/libritts_recordings_dev_clean.jsonl.gz" \
    --num-epochs 4 --batch-size 16 --base-lr 0.035 --lr-batches 7500 \
    --duration 1.5 \
    --valid-interval 100000 --save-every-n 1000000 --log-interval 200 \
    --keep-last-k 3
  "$py" -m flow2gan_tpu_torch.bin.save_averaged_model \
    --exp-dir "$R/exp/fm" --epoch 4 --avg 2 \
    --output "$R/exp/fm/averaged.pt"
}

finetune() {  # finetune RUN N [trainer flags]: the GAN stage from the averaged FM generator, then the windowed export
  local run=$1 n=$2; shift 2
  "$py" -m flow2gan_tpu_torch.bin.finetune \
    --exp-dir "$run" --model-name $M --tokenizer "$TOK" \
    --generator-model-path "$R/exp/fm/averaged.pt" \
    --n-timesteps $n --num-epochs 1 --batch-size 16 \
    --train-recordings "$G/manifests_gan/libritts_recordings_train_clean_100.jsonl.gz" \
    --valid-recordings "$G/manifests_gan/libritts_recordings_dev_clean.jsonl.gz" \
    $GAN_ARGS "$@"
  "$py" -m flow2gan_tpu_torch.bin.save_averaged_model \
    --exp-dir "$run" --epoch 1 --avg 1 --load-gan true --output "$run/generator.pt"
}

gan_row() {  # gan_row EXP TAG [trainer flags]: train, export twice and score the GAN at n = 1
  local exp=$1 tag=$2; shift 2
  local last=${exp}_last n=1  # the last-weights export, scored as a row of its own
  if [ ! -f "$exp/gan_${n}step/generator.pt" ] || [ ! -f "$last/gan_${n}step/generator.pt" ]; then
    rm -rf "$exp/gan_${n}step" "$last/gan_${n}step"  # a half-trained run starts again
    timed "${tag}gan_${n}step_train_and_export" finetune "$exp/gan_${n}step" $n "$@" 2>&1 | tee -a "$LOG"
    timed "${tag}gan_${n}step_export_last" "$py" -m flow2gan_tpu_torch.bin.save_averaged_model \
      --exp-dir "$exp/gan_${n}step" --epoch 1 --avg 1 --use-averaged-model false \
      --load-gan true --output "$last/gan_${n}step/generator.pt" 2>&1 | tee -a "$LOG"
    disk "${tag}gan_${n}step_checkpoints" "$exp/gan_${n}step"
    rm -f "$exp/gan_${n}step"/epoch-*.pt "$exp/gan_${n}step"/checkpoint-*.pt
  fi
  for e in "$exp" "$last"; do
    if ! has_rows "$e/gan_${n}step/metrics_pitch.json"; then
      local kind=""
      if [ "$e" = "$last" ]; then kind="_last"; fi
      score "${tag}gan_${n}step$kind" "$e/gan_${n}step/generator.pt" "$e/gan_${n}step" $n \
        --model-name $M --tokenizer "$TOK"
    fi
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
  if [ ! -f "$G/manifests_gan/libritts_recordings_test_clean.jsonl.gz" ]; then
    # the same WAVs twice (the same seeds), each time with its manifests
    timed corpus "$py" -m flow2gan_tpu_torch.bin.make_synthetic_corpus \
      --corpus-dir "$G/LibriTTS" --data-dir "$G/manifests_fm" \
      --n-train 300 --n-test 20 --n-dev 4 --duration 3.0 --train-repeat 80 2>&1 | tee -a "$LOG"
    "$py" -m flow2gan_tpu_torch.bin.make_synthetic_corpus \
      --corpus-dir "$G/LibriTTS" --data-dir "$G/manifests_gan" \
      --n-train 300 --n-test 20 --n-dev 4 --duration 3.0 --train-repeat 40 2>&1 | tee -a "$LOG"
  fi
  if [ ! -f "$TOK" ]; then
    timed codebook "$py" -m flow2gan_tpu_torch.bin.train_tokenizer \
      --model-name $M \
      --recordings "$G/manifests_gan/libritts_recordings_train_clean_100.jsonl.gz" \
      --output "$R/tokenizer_1024.npz" 2>&1 | tee -a "$LOG"
  fi
  if [ ! -f "$R/exp/fm/averaged.pt" ]; then
    timed fm_train_and_average pretrain 2>&1 | tee -a "$LOG"
    disk fm_checkpoints "$R/exp/fm"
  fi
fi

if [ "$stage" -le 3 ] && [ "$stop" -ge 3 ]; then
  # tokens-only reconstruction of utterances the model has never seen
  for n in 1 2 4; do
    if ! has_rows "$R/exp/fm_${n}step/metrics_pitch.json"; then
      score "fm_${n}step" "$R/exp/fm/averaged.pt" "$R/exp/fm_${n}step" $n \
        --model-name $M --tokenizer "$TOK"
    fi
  done
  collect "$R/exp" "$OUT" 1
fi

if [ "$stage" -le 4 ] && [ "$stop" -ge 4 ]; then
  gan_row "$R/exp" ""
  collect "$R/exp" "$OUT" 1
  collect "$R/exp_last" "$OUT/last" 1
fi

if [ "$stage" -le 5 ] && [ "$stop" -ge 5 ]; then
  # the GAN stage again at another seed, from the same averaged FM generator
  gan_row "$R/exp_seed$SEED2" "seed${SEED2}_" --seed "$SEED2"
  collect "$R/exp_seed$SEED2" "$OUT/seed$SEED2" 1
  collect "$R/exp_seed${SEED2}_last" "$OUT/seed$SEED2/last" 1
fi
echo "DRIVE_TOKEN_GENERALIZATION_DONE $(date -u)" | tee -a "$LOG"
