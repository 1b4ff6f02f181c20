"""What every driver shares: a run's description, the program built from a
configuration file and the run's weights, and the reading of the clock and
the device.

A driver (`portbench/drivers/<kind>.py`) has one function, `run(r: Run)`,
that sets the program up, drives its window, reads what it needs and
returns a `Result`; `portbench/run.py` turns that into the result line.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from portbench.reference.model import param_specs
from portbench.weights import make_weights

LIMIT_DIR = Path(__file__).resolve().parent / "limits"


@dataclasses.dataclass
class Run:
    workload: str
    config_name: str
    cfg: dict  # the configuration's `config`, as it is run
    mix: dict  # the traffic file
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    limits: Dict[str, float]
    fault: Optional[str] = None  # a fault planted in the timed path (tests, readings)
    control: bool = False  # the reference in TF32 put in the program's place

    def seed_for(self, *stream: int) -> int:
        """A 62-bit seed for one use of the run's seed."""
        return int(np.random.default_rng([self.seed % 2**63, 7, *stream]).integers(2**62))


@dataclasses.dataclass
class Result:
    attempted: int
    failed: int
    end_to_end: Dict[str, float]  # this cell's end-to-end metrics (not setup_s)
    obs: dict  # what the per-layer readers read (traced runs)
    checks: Dict[str, float]  # the numbers compared, by name
    memory_peak_bytes: int
    window_start: float  # time.time() at the window's first request


def phase(name: str) -> None:
    """Note on standard error how far set-up has come, in seconds since
    the process started."""
    print(f"phase {name} {time.time() - process_start():.2f} s", file=sys.stderr, flush=True)


def process_start() -> float:
    """This process's start, in `time.time()` seconds (Linux /proc)."""
    ticks = os.sysconf("SC_CLK_TCK")
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return boot + start_ticks / ticks


def load_limits(workload: str) -> Dict[str, float]:
    path = LIMIT_DIR / f"{workload}.json"
    return json.loads(path.read_text())["limits"] if path.exists() else {}


def weights(r: Run, device: torch.device) -> Dict[str, torch.Tensor]:
    return make_weights(param_specs(r.cfg), r.seed_for(0), device)


def build_generator(r: Run, device: torch.device):
    """The program's generator for the configuration, on `device`, with the
    run's weights: `build_generator`, then `load_state_dict`."""
    from flow2gan_tpu_torch.models import build_generator as build
    from flow2gan_tpu_torch.utils import AttributeDict

    cfg = AttributeDict(r.cfg)
    with torch.device(device):
        module = build(cfg)
    module = module.to(device)
    module.load_state_dict(weights(r, device), strict=True)
    return module, cfg


def vocoder(r: Run, device: torch.device):
    """`build_generator`, then the serving API's `VocoderModel`, with TF32
    off as `api.get_model` sets it."""
    from flow2gan_tpu_torch.api import VocoderModel
    from flow2gan_tpu_torch.utils import disable_tf32

    if device.type == "cuda":
        disable_tf32()
    module, cfg = build_generator(r, device)
    return VocoderModel(module, cfg, device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def sample(r: Run, n_done: int, k: int, must: Tuple[int, ...] = ()) -> list:
    """`k` indices of the `n_done` finished requests, drawn from the seed,
    with `must` (those that exist) among them."""
    rng = np.random.default_rng([r.seed % 2**63, 11])
    rest = [i for i in rng.permutation(n_done).tolist() if i not in must]
    return sorted({*(i for i in must if i < n_done), *rest[: max(0, k - len(must))]})


def clock() -> float:
    return time.perf_counter()
