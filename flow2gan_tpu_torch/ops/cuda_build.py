"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exports a plain C interface. It is compiled with `nvcc`
for Hopper (`sm_90a`) into a shared library under `build/kernels/` at the
root of the checkout, at first use, and loaded with `ctypes`. The library's
file name carries a hash of the source and flags, so an edited source is
rebuilt and never mixed with a stale build. Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # 0.0 when an earlier build of the same source was reused
    log: str  # nvcc's output, with ptxas' register and spill report


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(cuda_home, "bin", "nvcc")


@functools.lru_cache(maxsize=None)
def build(name: str) -> Build:
    """Compile `csrc/<name>.cu` unless a build of this exact source exists."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}-{digest[:16]}.so"
    if out.exists():
        return Build(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    start = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True, timeout=600,
    )
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: another process never loads half a file
    return Build(out, seconds, proc.stdout + proc.stderr)


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name).path))
