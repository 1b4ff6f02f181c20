#!/usr/bin/env bash
# Directory inference with the PyTorch port in its three modes: WAVs,
# mel files, and WAVs in streaming chunks (the counterpart of the JAX repo's
# infer_dir.sh, whose inputs were fixed fixture directories).
#
# Usage: flow2gan_tpu_torch/recipes/infer_dir.sh --wav-dir DIR [--mel-dir DIR]
#          [--checkpoint FILE] [--out-dir DIR]
# Without --checkpoint the model has random weights from a seed, which shows
# only that the path runs. Outputs go to <out-dir>/{out_wav,out_mel,out_stream}.
# The interpreter is $PYTHON (default python3); every call runs on the card.
set -euo pipefail
REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
py=${PYTHON:-python3}

wav_dir=""
mel_dir=""
out_dir=.
ckpt_arg=()
while [[ $# -gt 0 ]]; do
  case "$1" in
    --wav-dir) wav_dir="$2"; shift 2;;
    --mel-dir) mel_dir="$2"; shift 2;;
    --checkpoint) ckpt_arg=(--checkpoint "$2"); shift 2;;
    --out-dir) out_dir="$2"; shift 2;;
    *) echo "unknown option $1"; exit 1;;
  esac
done
if [ -z "$wav_dir" ]; then echo "--wav-dir is required"; exit 1; fi

"$py" -m flow2gan_tpu_torch.bin.infer_dir "${ckpt_arg[@]}" \
  --input-dir "$wav_dir" --output-dir "$out_dir/out_wav" \
  --n-timesteps 4

if [ -n "$mel_dir" ]; then
  "$py" -m flow2gan_tpu_torch.bin.infer_dir "${ckpt_arg[@]}" \
    --input-dir "$mel_dir" --output-dir "$out_dir/out_mel" \
    --mel true --n-timesteps 4
fi

"$py" -m flow2gan_tpu_torch.bin.infer_dir "${ckpt_arg[@]}" \
  --input-dir "$wav_dir" --output-dir "$out_dir/out_stream" \
  --n-timesteps 4 --chunk-size 100
