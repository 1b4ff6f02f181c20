#!/usr/bin/env bash
# The LibriTTS recipe with the PyTorch port: data preparation -> FM
# pretraining -> checkpoint averaging -> GAN fine-tuning and export ->
# inference -> objective metrics (stages 1-6), or stage 0: inference with the
# released checkpoints, then the metrics. The same stages, options and
# defaults as the JAX repo's run_libritts.sh; the port's checkpoints are
# `.pt` files (`averaged.pt`, `generator.pt`).
#
# Usage: flow2gan_tpu_torch/recipes/run_libritts.sh --stage 1 --stop-stage 6 [--corpus-dir ...]
#        flow2gan_tpu_torch/recipes/run_libritts.sh --stage 0 --stop-stage 6 \
#          --hf-dir <dir of libritts-mel-{n}-step.pt>   # the released models
#
# Scale knobs default to the reference recipe (200-epoch FM at global batch
# 512, 20-epoch GAN at batch 64); override them to run the same pipeline at
# rehearsal scale (flow2gan_tpu_torch/recipes/drive_generalization.sh).
# --world-size N runs each trainer as N data-parallel processes
# (torch.distributed.run, one card each; --fm-batch/--gan-batch are global).
# --device cpu runs every step on the CPU (the preflight's scale only).
# The interpreter is $PYTHON (default python3).

set -euo pipefail

REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
py=${PYTHON:-python3}

stage=1
stop_stage=6
corpus_dir=data/LibriTTS
data_dir=data/manifests
exp_dir=exp
model_name=mel_24k_base
n_timesteps_list="1 2 4"
train_splits="train_clean_100,train_clean_360"
valid_split="dev_clean"
test_split="test_clean"
fm_epochs=200
fm_batch=512
fm_avg=40
gan_epochs=20
gan_batch=64
gan_avg=4
fm_extra_args=""
gan_extra_args=""
world_size=1
device=cuda
hf_dir=exp/hf_checkpoints
fsd_model_path=""

while [[ $# -gt 0 ]]; do
  case "$1" in
    --stage) stage="$2"; shift 2;;
    --stop-stage) stop_stage="$2"; shift 2;;
    --corpus-dir) corpus_dir="$2"; shift 2;;
    --data-dir) data_dir="$2"; shift 2;;
    --exp-dir) exp_dir="$2"; shift 2;;
    --model-name) model_name="$2"; shift 2;;
    --n-timesteps-list) n_timesteps_list="$2"; shift 2;;
    --train-splits) train_splits="$2"; shift 2;;
    --valid-split) valid_split="$2"; shift 2;;
    --test-split) test_split="$2"; shift 2;;
    --fm-epochs) fm_epochs="$2"; shift 2;;
    --fm-batch) fm_batch="$2"; shift 2;;
    --fm-avg) fm_avg="$2"; shift 2;;
    --gan-epochs) gan_epochs="$2"; shift 2;;
    --gan-batch) gan_batch="$2"; shift 2;;
    --gan-avg) gan_avg="$2"; shift 2;;
    --fm-extra-args) fm_extra_args="$2"; shift 2;;
    --gan-extra-args) gan_extra_args="$2"; shift 2;;
    --world-size) world_size="$2"; shift 2;;
    --device) device="$2"; shift 2;;
    --hf-dir) hf_dir="$2"; shift 2;;
    --fsd-model-path) fsd_model_path="$2"; shift 2;;
    *) echo "unknown option $1"; exit 1;;
  esac
done

log() { echo "$(date '+%Y-%m-%d %H:%M:%S') $*"; }

# the trainers: one process, or N data-parallel ones
if [ "$world_size" -gt 1 ]; then
  train=("$py" -m torch.distributed.run --standalone --nproc-per-node "$world_size")
else
  train=("$py")
fi

# "train_clean_100,train_clean_360" -> comma-joined manifest paths
train_manifests=""
for s in ${train_splits//,/ }; do
  m="$data_dir/libritts_recordings_${s}.jsonl.gz"
  train_manifests="${train_manifests:+$train_manifests,}$m"
done
valid_manifest="$data_dir/libritts_recordings_${valid_split}.jsonl.gz"
test_manifest="$data_dir/libritts_recordings_${test_split}.jsonl.gz"

# which exp subdirectories stage 6 scores: "gan" (stages 1-5) or "hf" (stage 0)
metrics_prefix=gan

if [ $stage -le 0 ] && [ $stop_stage -ge 0 ]; then
  log "Stage 0: inference with the released checkpoints in $hf_dir"
  # the port downloads nothing: each libritts-mel-{n}-step.pt must be in $hf_dir
  if [ ! -f "$test_manifest" ]; then
    log "Stage 0: test manifest missing; preparing manifests first"
    "$py" -m flow2gan_tpu_torch.bin.prepare_recordings_libritts \
      --corpus-dir "$corpus_dir" --output-dir "$data_dir"
  fi
  for n in $n_timesteps_list; do
    "$py" -m flow2gan_tpu_torch.bin.infer \
      --model-name "$model_name" \
      --hf-model-name "libritts-mel-${n}-step" \
      --checkpoint "$hf_dir/libritts-mel-${n}-step.pt" \
      --recordings "$test_manifest" \
      --root-path "$corpus_dir" \
      --output-dir "$exp_dir/hf_${n}step/${test_split}_wavs" \
      --n-timesteps "$n" --device "$device"
  done
  metrics_prefix=hf
  if [ $stop_stage -ge 5 ]; then
    log "Stage 0 done; jumping to metrics (stage 6) on the released models' outputs."
    stage=6
    stop_stage=6
  else
    log "Stage 0 done (stop-stage $stop_stage; rerun with --stop-stage 6 to score its outputs)."
    exit 0
  fi
fi

if [ $stage -le 1 ] && [ $stop_stage -ge 1 ]; then
  log "Stage 1: prepare manifests"
  "$py" -m flow2gan_tpu_torch.bin.prepare_recordings_libritts \
    --corpus-dir "$corpus_dir" --output-dir "$data_dir"
  "$py" -m flow2gan_tpu_torch.bin.prepare_test_list_libritts \
    --corpus-dir "$corpus_dir" --split "${test_split//_/-}" \
    --output "$data_dir/${test_split}_files.txt"
fi

if [ $stage -le 2 ] && [ $stop_stage -ge 2 ]; then
  log "Stage 2: Flow-Matching pretraining ($fm_epochs epochs, global batch $fm_batch, $world_size process(es))"
  # reference: 200 epochs, batch 256 x 2 GPUs
  "${train[@]}" -m flow2gan_tpu_torch.bin.pretrain \
    --exp-dir "$exp_dir/fm" --model-name "$model_name" \
    --train-recordings "$train_manifests" \
    --valid-recordings "$valid_manifest" \
    --num-epochs "$fm_epochs" --batch-size "$fm_batch" \
    --base-lr 0.035 --lr-batches 7500 \
    --duration 1.5 --device "$device" $fm_extra_args
fi

if [ $stage -le 3 ] && [ $stop_stage -ge 3 ]; then
  log "Stage 3: average FM checkpoints (avg-$fm_avg of $fm_epochs)"
  "$py" -m flow2gan_tpu_torch.bin.save_averaged_model \
    --exp-dir "$exp_dir/fm" --epoch "$fm_epochs" --avg "$fm_avg" \
    --output "$exp_dir/fm/averaged.pt"
fi

if [ $stage -le 4 ] && [ $stop_stage -ge 4 ]; then
  for n in $n_timesteps_list; do
    log "Stage 4: GAN finetune, n_timesteps=$n ($gan_epochs epochs, batch $gan_batch)"
    "${train[@]}" -m flow2gan_tpu_torch.bin.finetune \
      --exp-dir "$exp_dir/gan_${n}step" --model-name "$model_name" \
      --generator-model-path "$exp_dir/fm/averaged.pt" \
      --n-timesteps "$n" --num-epochs "$gan_epochs" --batch-size "$gan_batch" \
      --train-recordings "$train_manifests" \
      --valid-recordings "$valid_manifest" --device "$device" $gan_extra_args
    log "Stage 4b: export averaged GAN generator (avg-$gan_avg of $gan_epochs)"
    "$py" -m flow2gan_tpu_torch.bin.save_averaged_model \
      --exp-dir "$exp_dir/gan_${n}step" --epoch "$gan_epochs" --avg "$gan_avg" \
      --load-gan true \
      --output "$exp_dir/gan_${n}step/generator.pt"
  done
fi

if [ $stage -le 5 ] && [ $stop_stage -ge 5 ]; then
  for n in $n_timesteps_list; do
    log "Stage 5: inference on ${test_split}, n_timesteps=$n"
    "$py" -m flow2gan_tpu_torch.bin.infer \
      --model-name "$model_name" \
      --checkpoint "$exp_dir/gan_${n}step/generator.pt" \
      --recordings "$test_manifest" \
      --root-path "$corpus_dir" \
      --output-dir "$exp_dir/gan_${n}step/${test_split}_wavs" \
      --n-timesteps "$n" --device "$device"
  done
fi

if [ $stage -le 6 ] && [ $stop_stage -ge 6 ]; then
  test_dir="${test_split//_/-}"
  for n in $n_timesteps_list; do
    log "Stage 6: metrics, n_timesteps=$n (${metrics_prefix} outputs)"
    out="$exp_dir/${metrics_prefix}_${n}step"
    # MR-STFT and pitch must succeed (they exit non-zero on 0 scored pairs);
    # FSD stays optional: it needs transformers and a local wav2vec2 model
    "$py" -m flow2gan_tpu_torch.bin.compute_pesq_visqol \
      --ref-dir "$corpus_dir/$test_dir" --gen-dir "$out/${test_split}_wavs/$test_dir" \
      --output "$out/metrics_pesq.json"
    "$py" -m flow2gan_tpu_torch.bin.compute_pitch_periodicity \
      --ref-dir "$corpus_dir/$test_dir" --gen-dir "$out/${test_split}_wavs/$test_dir" \
      --output "$out/metrics_pitch.json"
    fsd_args=()
    if [ -n "$fsd_model_path" ]; then fsd_args=(--model-path "$fsd_model_path"); fi
    "$py" -m flow2gan_tpu_torch.bin.compute_fsd \
      --ref-dir "$corpus_dir/$test_dir" --gen-dir "$out/${test_split}_wavs/$test_dir" \
      --output "$out/metrics_fsd.json" "${fsd_args[@]}" \
      || log "Stage 6: FSD not computed (optional: needs transformers and --fsd-model-path)"
  done
fi

log "Pipeline done."
