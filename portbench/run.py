"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`portbench/configs/<config>.json`) and a traffic mix
(`portbench/traffic/<traffic>.json`), whose `driver` names
`portbench/drivers/<driver>.py`; each per-layer metric is read by
`portbench/metrics/<name>.py`, and the limits of the numbers that decide
`correct` are in `portbench/limits/<workload>.json`. With `--trace 0` the
line holds the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics, read from a profiled window.

The run needs the CUDA cards the cell asks for and exits with a code other
than 0, printing no result, without them; so it does where the program
(`flow2gan_tpu_torch`) is missing, or where the JAX package or JAX itself
has been loaded once the window has closed.

`--control 1` puts the reference, computed in TF32, in the program's place,
and `--fault <name>` plants a fault in the timed path (`portbench/faults.py`):
readings for the limits, which the benchmark's own runs never make.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path

PORTBENCH = Path(__file__).resolve().parent
CHECKOUT = PORTBENCH.parent
# kernel and compile caches at fixed paths inside the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CHECKOUT / "build" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "flow2gan_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name, the part before the first
    dot, is one of FORBIDDEN, compared whole."""
    modules = sys.modules if modules is None else modules
    return sorted({name for name in modules if name.split(".", 1)[0] in FORBIDDEN})


def load_benchmark() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def cell_metrics(bench: dict, workload: str, key: str) -> list:
    return [m for m in bench[key] if workload in m.get("workloads", [workload])]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"portbench.metrics.{name}",
                                                  PORTBENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def make_run(bench: dict, workload: str, seed: int, seconds: float, trace: bool, device,
             fault=None, control=False, cfg_override=None, mix_override=None):
    from portbench import harness, traffic

    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = cfg_override or json.loads((CHECKOUT / config["file"]).read_text())["config"]
    mix = dict(traffic.load(cell["traffic"]), **(mix_override or {}))
    return harness.Run(workload=workload, config_name=cell["config"], cfg=cfg, mix=mix, seed=seed,
                       seconds=seconds, trace=trace, device=device,
                       limits=harness.load_limits(workload), fault=fault, control=control)


def result_line(bench: dict, r, res, setup_s: float, device_kind: str, chips: int) -> dict:
    """The result's JSON object, `checks` last."""
    checks = {k: {"value": v, "limit": r.limits.get(k)} for k, v in res.checks.items()}
    correct = bool(checks) and all(c["limit"] is not None and c["value"] <= c["limit"]
                                   for c in checks.values())
    metrics = {}
    if r.trace:
        for m in cell_metrics(bench, r.workload, "per_layer"):
            value = reader(m["name"])(res.obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(res.end_to_end, setup_s=setup_s)
        for m in cell_metrics(bench, r.workload, "end_to_end"):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": chips,
              "memory_peak_bytes": res.memory_peak_bytes}
    line = {"correct": correct, "attempted": res.attempted, "failed": res.failed,
            "metrics": metrics, "device": device}
    if r.trace:
        obs = res.obs
        ranks = obs.get("ranks") or [obs]
        device["busy_s"] = sum(o["busy_s"] for o in ranks) / len(ranks)
        device["window_s"] = obs["window_s"]
        top = sorted(obs["device_s"].items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(obs["idle_by_span"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [list(x) for x in top],
                             "idle_gaps": [list(x) for x in gaps]}
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)

    from portbench import harness

    started = harness.process_start()
    bench = load_benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    importlib.import_module("flow2gan_tpu_torch")
    drivers = importlib.import_module("portbench.drivers." + _driver(cell))
    r = make_run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                 torch.device("cuda", 0), fault=args.fault, control=bool(args.control))
    res = drivers.run(r)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {found}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    line = result_line(bench, r, res, res.window_start - started,
                       torch.cuda.get_device_name(0), cell["chips"])
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def _driver(cell: dict) -> str:
    from portbench import traffic

    return traffic.load(cell["traffic"])["driver"]


if __name__ == "__main__":
    sys.exit(main())
