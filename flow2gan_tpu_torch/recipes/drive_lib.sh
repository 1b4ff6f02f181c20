# Helpers of the held-out drives (drive_generalization.sh,
# drive_token_generalization.sh), sourced by each. The caller sets:
#   py             the interpreter
#   R              the drive's work directory (disk.jsonl goes there)
#   OUT            the results directory
#   LOG            the drive's log
#   TIMES          the stage-time records ($R/stage_times.jsonl)
#   CORPUS         the corpus root (LibriTTS layout)
#   TEST_MANIFEST  the held-out split's recordings manifest
#   JAX_SUMMARY    the JAX run's summary.json the rows are set beside

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

score() {  # score NAME CKPT DIR N [infer flags]: synthesise the held-out split, then its metrics
  local name=$1 ckpt=$2 dir=$3 n=$4; shift 4
  timed "${name}_infer" "$py" -m flow2gan_tpu_torch.bin.infer \
    --checkpoint "$ckpt" --recordings "$TEST_MANIFEST" --root-path "$CORPUS" \
    --output-dir "$dir/test_clean_wavs" --n-timesteps "$n" "$@" 2>&1 | tee -a "$LOG"
  timed "${name}_metrics" bash -c '
    "$0" -m flow2gan_tpu_torch.bin.compute_pesq_visqol --ref-dir "$1/test-clean" \
      --gen-dir "$2/test_clean_wavs/test-clean" --output "$2/metrics_pesq.json"
    "$0" -m flow2gan_tpu_torch.bin.compute_pitch_periodicity --ref-dir "$1/test-clean" \
      --gen-dir "$2/test_clean_wavs/test-clean" --output "$2/metrics_pitch.json"' \
    "$py" "$CORPUS" "$dir" 2>&1 | tee -a "$LOG"
}

collect() {  # collect EXP DEST STEPS...: EXP's GAN rows and the FM rows, and EXP's step medians
  local exp=$1 dest=$2; shift 2
  local extra=(fm_1step:$R/exp/fm_1step fm_2step:$R/exp/fm_2step fm_4step:$R/exp/fm_4step)
  mkdir -p "$dest"
  "$py" -m flow2gan_tpu_torch.bin.collect_results --exp-dir "$exp" --output-dir "$dest" \
    --steps "$@" --extra "${extra[@]}" --reference "$JAX_SUMMARY" 2>&1 | tee -a "$LOG"
  "$py" - "$exp" "$dest" <<'PY'
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
