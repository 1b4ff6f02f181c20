"""Every entry of BENCHMARK.json resolves to its files, and the file keeps
to the contract's shapes."""

import importlib
import json
import re
from pathlib import Path

import pytest

from portbench import run as bench_run, traffic

CHECKOUT = Path(bench_run.__file__).resolve().parents[1]
BENCH = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "-m", "portbench.run"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert NAME.match(config["name"])
    body = json.loads((CHECKOUT / config["file"]).read_text())
    assert config["file"].startswith("portbench/configs/")
    assert body["name"] == config["name"] and body["reduced"] == config["reduced"]
    assert set(body["config"]) >= {"n_ffts", "channels", "num_layers", "sampling_rate"}


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cells_resolve(cell):
    assert NAME.match(cell["name"]) and cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}
    mix = traffic.load(cell["traffic"])
    importlib.import_module("portbench.drivers." + mix["driver"])
    limits = json.loads((CHECKOUT / "portbench" / "limits" / f"{cell['name']}.json").read_text())
    assert limits["limits"] and all(v > 0 for v in limits["limits"].values())
    e2e = bench_run.cell_metrics(BENCH, cell["name"], "end_to_end")
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    per_layer = bench_run.cell_metrics(BENCH, cell["name"], "per_layer")
    assert per_layer and all(m["moves"] in names for m in per_layer)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert callable(bench_run.reader(m["name"]))
    assert sum(c["chips"] == 4 for c in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)
