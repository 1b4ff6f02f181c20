"""Numeric sanitizers for `--inf-check`, counterpart of
`flow2gan_tpu/training/hooks.py`: finiteness flags over a state dict, the
names of non-finite tensors, the modules whose outputs went non-finite, and
the trainer's policy for non-finite losses.

The flags stay on the device until the host checks them; each scan fetches
its flags once. `find_nonfinite_module_outputs` puts a forward hook on every
module (JAX taps every module with `capture_intermediates`). Forward hooks
fire in execution order, each module's after its submodules', so the first
module whose output is not finite while its inputs were is where the value
was born.
"""

from __future__ import annotations

import logging
import math
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import torch
from torch import nn

from flow2gan_tpu_torch.training.err import raise_nonfinite_loss_error

ROOT = "<root>"  # the name of a model's own module in the tables


def _all_finite(tensors: Iterable[torch.Tensor], device=None) -> torch.Tensor:
    """Whether every floating tensor is finite, a boolean on their device
    (`device` where there are none: integer ids, say)."""
    flags = [torch.isfinite(t).all() for t in tensors if t.is_floating_point()]
    return torch.stack(flags).all() if flags else torch.tensor(True, device=device)


def finite_flags(state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """All-finite flags per top-level module (the first part of each name)
    and over everything ("__all__"), as device booleans."""
    groups: Dict[str, List[torch.Tensor]] = {}
    for name, t in state.items():
        groups.setdefault(name.split(".")[0], []).append(t)
    flags = {k: _all_finite(v) for k, v in groups.items()}
    flags["__all__"] = _all_finite(state.values())
    return flags


def check_finite(flags: Mapping[str, torch.Tensor], what: str) -> bool:
    """Host-side check of `finite_flags`: warns for each top-level module
    that is not finite, and returns whether everything is."""
    host = {k: bool(v) for k, v in flags.items()}
    if not host["__all__"]:
        for k, ok in host.items():
            if k != "__all__" and not ok:
                logging.warning(f"The sum of {what}.{k} is not finite")
    return host["__all__"]


def find_nonfinite_leaves(state: Mapping[str, torch.Tensor], limit: int = 10) -> List[str]:
    """The names of the tensors of `state` that hold a non-finite value, in
    its order, at most `limit`."""
    names = [k for k, t in state.items() if t.is_floating_point()]
    if not names:
        return []
    ok = torch.stack([torch.isfinite(state[k]).all() for k in names]).tolist()
    return [k for k, good in zip(names, ok) if not good][:limit]


def _tensors(obj) -> List[torch.Tensor]:
    """The floating tensors in a module's inputs or outputs."""
    if isinstance(obj, torch.Tensor):
        return [obj] if obj.is_floating_point() else []
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    if isinstance(obj, dict):
        return [t for x in obj.values() for t in _tensors(x)]
    return []


def module_name(name: str) -> str:
    """A module's table name: its dotted path, the model itself `<root>`."""
    return name or ROOT


def find_nonfinite_module_outputs(model: nn.Module, forward: Callable[[], object],
                                  limit: int = 20) -> List[str]:
    """Run `forward()` (a pass through `model`) with a forward hook on every
    module of `model`, and return the modules whose outputs held a
    non-finite value: first those whose inputs were all finite (where a
    value was born), then those that passed on a non-finite input, each
    group in execution order, a module once, at most `limit` in all. The
    hooks are removed when the pass ends."""
    records: List[Tuple[str, torch.Tensor, torch.Tensor]] = []

    def hook(name):
        def record(module, args, kwargs, output):
            outs = _tensors(output)
            if outs:
                records.append((name, _all_finite(outs),
                                _all_finite(_tensors((args, kwargs)), outs[0].device)))
        return record

    handles = [m.register_forward_hook(hook(module_name(n)), with_kwargs=True)
               for n, m in model.named_modules()]
    try:
        with torch.no_grad():
            forward()
    finally:
        for h in handles:
            h.remove()
    if not records:
        return []
    flags = torch.stack([torch.stack([out_ok, in_ok]) for _, out_ok, in_ok in records]).tolist()
    born, passed = [], []
    for (name, _, _), (out_ok, in_ok) in zip(records, flags):
        if not out_ok and name not in born and name not in passed:
            (born if in_ok else passed).append(name)
    return (born + passed)[:limit]


class NonfiniteLossGuard:
    """If ScaledAdam zeroed the gradients (clip_scale == 0), the parameters
    are untouched and training goes on (a warning and one bad-model dump);
    if the gradients were applied, or the streak reaches `max_streak`, save
    the model and stop with the actionable error."""

    def __init__(self, max_streak: int = 25):
        self.max_streak = max_streak
        self.streak = 0
        self.dumped = False

    def check(self, loss_val: float, clip_scale: float, batch_idx: int,
              save_bad_model: Callable[[str], None],
              params_tree: Optional[Mapping[str, torch.Tensor]] = None,
              intermediates_fn: Optional[Callable[[], List[str]]] = None) -> None:
        """`params_tree` (a state dict) names the non-finite parameters;
        `intermediates_fn()` replays the offending batch and returns the
        modules whose outputs were not finite
        (`find_nonfinite_module_outputs`). Both are `--inf-check`'s."""
        if math.isfinite(loss_val):
            self.streak = 0
            return
        self.streak += 1
        logging.warning(f"Non-finite loss at batch {batch_idx} (streak {self.streak}, "
                        f"clip_scale {clip_scale})")
        if not self.dumped:
            save_bad_model("-first-nonfinite")
            self.dumped = True
        if params_tree is not None:
            bad = find_nonfinite_leaves(params_tree)
            if bad:
                logging.warning(f"Non-finite params at: {bad}")
        if intermediates_fn is not None:
            try:
                for name in intermediates_fn():
                    logging.warning(f"The output of module {name} is not finite")
            except Exception as e:  # the diagnostics must not hide the error path
                logging.warning(f"inf-check forward replay failed: {e!r}", exc_info=True)
        if clip_scale != 0.0 or self.streak >= self.max_streak:
            save_bad_model("")
            raise_nonfinite_loss_error(batch_idx)
