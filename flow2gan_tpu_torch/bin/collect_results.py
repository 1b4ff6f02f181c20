#!/usr/bin/env python3
"""Collect a recipe run's metrics into one `summary.json` and a markdown
table `summary.md`; the port's counterpart of the JAX repo's
`scripts/collect_minipipe_results.py`, with its flags and output.

    python -m flow2gan_tpu_torch.bin.collect_results --exp-dir exp --output-dir results/run \
        --steps 1 2 4 --extra fm_1step:exp/fm_1step

Rows are `gan_{n}step` for each `--steps` n (`<exp-dir>/gan_{n}step`,
skipped where it holds no metrics) and each `--extra name:dir` (required).
A row is the `summary` of each `metrics_{pesq,pitch,fsd}.json` in its
directory; each file is also copied to `<output-dir>/<row>_metrics_<kind>.json`.
It exits 2 on a row whose metrics are empty, a required row without
metrics, or no rows at all.

`--reference summary.json` (another run's, e.g. the JAX package's) adds a
second table to `summary.md`: each row beside the reference's row of the
same name, with the MR-STFT's relative difference.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

HEADER = ["| model | MR-STFT ↓ | pitch RMSE (cents) ↓ | periodicity RMSE ↓ | V/UV F1 ↑ |",
          "|---|---|---|---|---|"]


def get_parser():
    p = argparse.ArgumentParser(description="Collect recipe metrics into summary.json/.md")
    p.add_argument("--exp-dir", type=Path, required=True)
    p.add_argument("--output-dir", type=Path, required=True)
    p.add_argument("--steps", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--extra", type=str, nargs="*", default=[],
                   help="extra named metric dirs, e.g. fm:<path-to-dir>")
    p.add_argument("--reference", type=Path, default=None,
                   help="another run's summary.json to set beside this one in summary.md")
    return p


def row_is_empty(row: dict) -> bool:
    """True when a summary scored zero files, or no summary holds a value."""
    any_value = False
    for s in row.values():
        if s.get("n_files") == 0:
            return True
        any_value = any_value or any(v is not None for k, v in s.items()
                                     if k != "n_files" and not k.endswith("_unavailable"))
    return not any_value


def _v(d: dict, key: str) -> float:
    x = d.get(key)  # null means unavailable
    return float("nan") if x is None else x


def metric_cells(row: dict) -> str:
    pq, pt = row.get("pesq", {}), row.get("pitch", {})
    return (f"{_v(pq, 'mrstft'):.3f} | {_v(pt, 'pitch_rmse_cents'):.0f} "
            f"| {_v(pt, 'periodicity_rmse'):.3f} | {_v(pt, 'vuv_f1'):.3f}")


def table(summary: dict) -> list:
    return HEADER + [f"| {name} | {metric_cells(row)} |" for name, row in summary.items()]


def comparison(summary: dict, reference: dict, label: str) -> list:
    """Each row beside the reference's row of the same name."""
    lines = [f"| model | run | MR-STFT ↓ | pitch RMSE (cents) ↓ | periodicity RMSE ↓ "
             f"| V/UV F1 ↑ | MR-STFT vs {label} |", "|---|---|---|---|---|---|---|"]
    for name, row in summary.items():
        ref = reference.get(name)
        rel = "n/a"
        if ref is not None:
            ours, theirs = _v(row.get("pesq", {}), "mrstft"), _v(ref.get("pesq", {}), "mrstft")
            rel = f"{(ours - theirs) / theirs:+.1%}"
        lines.append(f"| {name} | this run | {metric_cells(row)} | {rel} |")
        if ref is not None:
            lines.append(f"| {name} | {label} | {metric_cells(ref)} | |")
    return lines


def main(argv=None) -> dict:
    args = get_parser().parse_args(argv)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    summary, failures = {}, []

    def read_metrics(name: str, d: Path, required: bool = False):
        row, pending = {}, {}
        for kind in ("pesq", "pitch", "fsd"):
            f = d / f"metrics_{kind}.json"
            if f.exists():
                data = json.loads(f.read_text())
                row[kind] = data.get("summary", data)
                pending[f"{name}_metrics_{kind}.json"] = data
        if row and row_is_empty(row):
            failures.append(f"{name}: metrics present but empty ({d})")
            return
        if not row:
            if required:
                failures.append(f"{name}: no metrics_*.json found in {d}")
            return
        for fname, data in pending.items():
            (args.output_dir / fname).write_text(json.dumps(data, indent=2) + "\n")
        summary[name] = row

    for n in args.steps:
        read_metrics(f"gan_{n}step", args.exp_dir / f"gan_{n}step")
    for spec in args.extra:
        name, sep, path = spec.partition(":")
        if not sep or not Path(path).is_dir():
            raise SystemExit(f"--extra expects name:<existing-dir>, got {spec!r}")
        read_metrics(name, Path(path), required=True)

    (args.output_dir / "summary.json").write_text(json.dumps(summary, indent=2) + "\n")
    lines = table(summary)
    if args.reference is not None:
        reference = json.loads(args.reference.read_text())
        name = f"{args.reference.parent.name}/{args.reference.name}"
        lines += ["", f"Against `{name}`:", ""] + comparison(summary, reference, "reference")
    (args.output_dir / "summary.md").write_text("\n".join(lines) + "\n")
    print("\n".join(lines))
    if failures:
        for f in failures:
            print(f"COLLECT_FAILED {f}")
        raise SystemExit(2)
    if not summary:
        print("COLLECT_FAILED no rows collected at all")
        raise SystemExit(2)
    return summary


if __name__ == "__main__":
    main()
