"""Run provenance recorded into every checkpoint, counterpart of
`flow2gan_tpu/training/env.py`: JAX's keys, with the torch and CUDA versions
and the card's name in place of the jax and flax versions."""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Dict, List

import torch

from flow2gan_tpu_torch.parallel import dist


def _git(args: List[str], cwd: str) -> str:
    """git's output, or "" where there is no git or no repository (a copy of
    the tree)."""
    try:
        return subprocess.check_output(["git", *args], cwd=cwd,
                                       stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return ""


def get_env_info(device: torch.device) -> Dict[str, str]:
    """git-sha1 (with "-dirty" for uncommitted changes), hostname,
    python-version, num-devices (the processes of the run, one device
    each), backend (the device's type), torch-version, cuda-version (""
    for a CPU build) and device-name."""
    repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sha = _git(["rev-parse", "HEAD"], repo_dir)
    dirty = bool(_git(["status", "--porcelain"], repo_dir))
    device = torch.device(device)
    return {
        "torch-version": str(torch.__version__),  # a str subclass torch.load refuses
        "cuda-version": torch.version.cuda or "",
        "device-name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "backend": device.type,
        "num-devices": str(dist.world_size()),
        "git-sha1": sha + ("-dirty" if sha and dirty else ""),
        "hostname": socket.gethostname(),
        "python-version": sys.version.split()[0],
    }
