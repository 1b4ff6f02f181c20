#!/usr/bin/env bash
# Trace of the token drive's one missed ordering: the FM rows' pitch RMSE
# rose from fm_1step to fm_2step (1587 -> 1650 cents) where the JAX rows'
# fell. It measures how far the FM rows move with what the drive left to
# chance, each on the drive's own corpus, flags and average
# (../../flow2gan_tpu_torch/recipes/drive_token_generalization.sh, stage 2):
#   - the training seed: FM pretraining at --seed 1 with the drive's
#     codebook (tokenizer_1024.npz, beside this script), its rows at 1/2/4
#     steps under bin/infer's default draw (--seed 0);
#   - the inference draw: that model's rows again at --seed 1 and 2;
#   - the codebook: FM pretraining at the drive's --seed 42 with each
#     CODEBOOK given, its rows under the default draw.
# Each model's rows go to $OUT/<model>/infer_seed<S>/ (summary.md beside the
# JAX rows), the stage times to $OUT/stage_times.jsonl. Runs on the card,
# from the repository root:
#
#   R=<work dir> OUT=<dir> bash results/torch_token_generalization/trace_fm_pitch.sh [CODEBOOK.npz ...]
set -euo pipefail
HERE=$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)
REPO=$(cd "$HERE/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
py=${PYTHON:-python3}

M=token_24k_base
R=${R:-$REPO/build/token_trace}
OUT=${OUT:-$HERE/trace}
JAX_SUMMARY="$REPO/results/r5_token_gen/summary.json"
CORPUS=$R/LibriTTS
TEST_MANIFEST=$R/manifests_fm/libritts_recordings_test_clean.jsonl.gz
mkdir -p "$R" "$OUT"
LOG=$R/trace.log
TIMES=$R/stage_times.jsonl
source "$REPO/flow2gan_tpu_torch/recipes/drive_lib.sh"

fm() {  # fm NAME CODEBOOK SEED: the drive's FM stage into $R/NAME/fm
  "$py" -m flow2gan_tpu_torch.bin.pretrain \
    --exp-dir "$R/$1/fm" --model-name $M --tokenizer "$2" --seed "$3" \
    --train-recordings "$R/manifests_fm/libritts_recordings_train_clean_100.jsonl.gz" \
    --valid-recordings "$R/manifests_fm/libritts_recordings_dev_clean.jsonl.gz" \
    --num-epochs 4 --batch-size 16 --base-lr 0.035 --lr-batches 7500 \
    --duration 1.5 \
    --valid-interval 100000 --save-every-n 1000000 --log-interval 200 \
    --keep-last-k 3
  "$py" -m flow2gan_tpu_torch.bin.save_averaged_model \
    --exp-dir "$R/$1/fm" --epoch 4 --avg 2 --output "$R/$1/fm/averaged.pt"
  rm -f "$R/$1/fm"/epoch-*.pt "$R/$1/fm"/checkpoint-*.pt
}

rows() {  # rows NAME CODEBOOK INFER_SEED: NAME's FM rows at 1/2/4 steps under one draw
  local exp=$R/$1/infer_seed$3
  for n in 1 2 4; do
    score "$1_seed$3_fm_${n}step" "$R/$1/fm/averaged.pt" "$exp/fm_${n}step" $n \
      --model-name $M --tokenizer "$2" --seed "$3"
  done
  mkdir -p "$OUT/$1/infer_seed$3"
  "$py" -m flow2gan_tpu_torch.bin.collect_results --exp-dir "$exp" \
    --output-dir "$OUT/$1/infer_seed$3" --steps 1 --reference "$JAX_SUMMARY" \
    --extra fm_1step:$exp/fm_1step fm_2step:$exp/fm_2step fm_4step:$exp/fm_4step 2>&1 | tee -a "$LOG"
  cp "$TIMES" "$OUT/"
}

# the drive's corpus: the same WAVs, its FM manifests
timed corpus "$py" -m flow2gan_tpu_torch.bin.make_synthetic_corpus \
  --corpus-dir "$R/LibriTTS" --data-dir "$R/manifests_fm" \
  --n-train 300 --n-test 20 --n-dev 4 --duration 3.0 --train-repeat 80 2>&1 | tee -a "$LOG"

timed fm_train_seed1 fm train_seed1 "$HERE/tokenizer_1024.npz" 1 2>&1 | tee -a "$LOG"
for s in 0 1 2; do
  rows train_seed1 "$HERE/tokenizer_1024.npz" $s
done
for codebook in "$@"; do
  name=codebook_$(basename "$codebook" .npz)
  timed "fm_train_$name" fm "$name" "$codebook" 42 2>&1 | tee -a "$LOG"
  rows "$name" "$codebook" 0
done
echo "TRACE_FM_PITCH_DONE $(date -u)" | tee -a "$LOG"
