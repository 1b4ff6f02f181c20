"""Checkpoints and the icefall averaging machinery, counterpart of
`flow2gan_tpu/training/checkpoint.py`.

A checkpoint is a `torch.save`d dict: the model's `state_dict` ("model"), the
float64 running average of the parameters ("model_avg"), the optimizer's
state, the trainer's own values (the batch count) and, in a batch
checkpoint, the sampler's position ("sampler": each training loader's
epoch and consumed batches, and the state of the Python RNG that picks the
loader of each batch), from which `--resume-from` continues mid-epoch. Only
rank 0 of a multi-process run writes; every rank reads. The GAN trainer's
"model" is `{"generator": ..., "discriminator": ...}`, its "optimizer"
`{"g": ..., "d": ...}`, and its "model_avg" the generator's alone.
Averaging:

- the Polyak running average avg = cur * (period/step) + avg * (1 -
  period/step), in float64 (`update_averaged_model`);
- a plain mean of N checkpoints (`average_checkpoints`);
- the average over a window (start, end] by differencing the two
  checkpoints' running averages, with the reference's overflow-safe rescaling
  (`average_checkpoints_with_averaged_model`), which is how the released
  models were made;
- topk retention of the batch checkpoints.
"""

from __future__ import annotations

import glob
import logging
import os
import random
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from flow2gan_tpu_torch.compat.from_jax import is_jax_checkpoint, load_jax_checkpoint  # noqa: F401
from flow2gan_tpu_torch.compat.from_reference import load_torch_file

Pathlike = Union[str, Path]
StateDict = Dict[str, torch.Tensor]


def _on_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_cpu(v) for v in tree)
    return tree


def save_checkpoint(
    filename: Pathlike,
    model: StateDict,
    model_avg: Optional[StateDict] = None,
    optimizer_state: Optional[dict] = None,
    train_params: Optional[Dict[str, Any]] = None,
    sampler_state: Optional[Dict[str, Any]] = None,
) -> None:
    """Save a training checkpoint, atomically (a reader never sees half a
    file). The tensors are moved to the CPU first."""
    logging.info(f"Saving checkpoint to {filename}")
    ckpt = {"model": model, "model_avg": model_avg, "optimizer": optimizer_state,
            "sampler": sampler_state}
    for k, v in (train_params or {}).items():
        if k in ckpt:
            raise KeyError(f"train param {k!r} clashes with a checkpoint entry")
        ckpt[k] = v
    Path(filename).parent.mkdir(parents=True, exist_ok=True)
    tmp = f"{filename}.tmp"
    torch.save(_on_cpu(ckpt), tmp)
    os.replace(tmp, str(filename))


def load_checkpoint(filename: Pathlike) -> Dict[str, Any]:
    """A checkpoint the port wrote. A JAX `.ckpt` raises: its optimizer
    state does not carry over (`compat/from_jax.py`), so training cannot
    resume from one."""
    if is_jax_checkpoint(filename):
        raise ValueError(f"{filename} is a JAX checkpoint: its weights load into the port "
                         "(get_model, bin/infer --checkpoint, --generator-model-path), but its "
                         "optimizer state is laid out otherwise, so training cannot resume from it")
    return torch.load(str(filename), map_location="cpu", weights_only=True)


# ------------------------------------------------------------------ averaging


def average_state_trees(tree1: StateDict, tree2: StateDict, weight_1: float, weight_2: float,
                        scaling_factor: float = 1.0) -> StateDict:
    """(tree1 * w1 + tree2 * w2) * scaling_factor, in float64."""
    return {k: (tree1[k].double() * weight_1 + tree2[k].double() * weight_2) * scaling_factor
            for k in tree1}


def update_averaged_model(model_avg: StateDict, model_cur: StateDict, average_period: int,
                          batch_idx_train: int) -> StateDict:
    """Running Polyak average in float64: avg = cur * (period/step) +
    avg * (1 - period/step)."""
    weight_cur = average_period / batch_idx_train
    return average_state_trees(model_avg, model_cur, 1.0 - weight_cur, weight_cur)


def average_checkpoints(filenames: List[Pathlike], load_gan: bool = False) -> StateDict:
    """Plain mean of the "model" entries of N checkpoints (with `load_gan`,
    of a GAN checkpoint's generator: `load_torch_file`), as float32."""
    if not filenames:
        raise ValueError("no checkpoints to average")
    avg = {k: v.double() for k, v in load_torch_file(filenames[0], load_gan).items()}
    for fname in filenames[1:]:
        for k, v in load_torch_file(fname, load_gan).items():
            avg[k] += v.double()
    return {k: (v / len(filenames)).float() for k, v in avg.items()}


def average_checkpoints_with_averaged_model(filename_start: Pathlike,
                                            filename_end: Pathlike) -> StateDict:
    """Average over (start, end] by differencing the two checkpoints' running
    averages, rescaled so that no term overflows:

      avg = (avg_end + avg_start * (w_start / w_end)) * w_end,
      w_end = end / (end - start), w_start = 1 - w_end.
    """
    start = load_checkpoint(filename_start)
    end = load_checkpoint(filename_end)
    b_start, b_end = int(start["batch_idx_train"]), int(end["batch_idx_train"])
    interval = b_end - b_start
    if interval <= 0:
        raise ValueError(f"empty window: batch {b_start} to batch {b_end}")
    weight_end = b_end / interval
    weight_start = 1.0 - weight_end
    avg = average_state_trees(end["model_avg"], start["model_avg"], weight_1=1.0,
                              weight_2=weight_start / weight_end, scaling_factor=weight_end)
    return {k: v.float() for k, v in avg.items()}


def sampler_state_snapshot(epoch: int, train_dls, rng_py: random.Random) -> Dict[str, Any]:
    """What the epoch loop needs to continue mid-epoch: each training
    loader's position and the state of the RNG that picks the loader."""
    version, state, gauss = rng_py.getstate()
    return {"epoch": epoch, "dl_states": [dl.state_dict() for dl in train_dls],
            "rng_py": {"version": version, "state": list(state), "gauss": gauss}}


def restore_sampler_state(snapshot: Dict[str, Any], train_dls) -> Tuple[int, random.Random]:
    """Put the loaders back where `sampler_state_snapshot` found them;
    returns the epoch and the loader-picking RNG."""
    if len(snapshot["dl_states"]) != len(train_dls):
        raise ValueError(f"the checkpoint's sampler holds {len(snapshot['dl_states'])} "
                         f"training loaders, this run has {len(train_dls)}")
    for dl, state in zip(train_dls, snapshot["dl_states"]):
        dl.load_state_dict(state)
    r = snapshot["rng_py"]
    rng_py = random.Random()
    rng_py.setstate((int(r["version"]), tuple(int(x) for x in r["state"]),
                     None if r["gauss"] is None else float(r["gauss"])))
    return int(snapshot["epoch"]), rng_py


# ------------------------------------------------------- filename management


def save_checkpoint_with_global_batch_idx(out_dir: Pathlike, global_batch_idx: int,
                                          **kwargs) -> Path:
    """Save 'checkpoint-{global_batch_idx}.pt' in out_dir."""
    filename = Path(out_dir) / f"checkpoint-{global_batch_idx}.pt"
    save_checkpoint(filename, **kwargs)
    return filename


def find_checkpoints(out_dir: Pathlike, iteration: int = 0) -> List[str]:
    """The 'checkpoint-N.pt' files of out_dir, newest (largest N) first;
    with iteration < 0 only those with N >= -iteration."""
    pattern = re.compile(r"checkpoint-([0-9]+)\.pt$")
    found = []
    for c in glob.glob(f"{out_dir}/checkpoint-[0-9]*.pt"):
        match = pattern.search(c)
        if not match:
            logging.warning(f"Invalid checkpoint filename {c}")
            continue
        found.append((int(match.group(1)), c))
    found.sort(reverse=True)
    return [c for n, c in found if iteration >= 0 or n >= -iteration]


def remove_checkpoints(out_dir: Pathlike, topk: int) -> None:
    """Keep only the topk newest batch checkpoints."""
    if topk < 1:
        raise ValueError(f"topk must be >= 1, got {topk}")
    for c in find_checkpoints(out_dir)[topk:]:
        os.remove(c)
