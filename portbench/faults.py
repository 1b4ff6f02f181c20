"""Faults planted in the timed path, to show that the comparison that
decides `correct` fails them: the tests drive whole runs with each, and
`run.py --fault <name>` reads their numbers on the card. Never used by the
benchmark's own runs.

- `shift_output`: every served waveform comes out one sample late (an
  answer altered where it is produced);
- `half_batch`: each training step sees the first half of its rows, the
  mean taken over them;
- `frozen_step`: the optimizer's step returns the state unchanged;
- `no_exchange`: the ranks do not sum their gradients (the exchange between
  chips left out).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

FAULTS = ("shift_output", "half_batch", "frozen_step", "no_exchange")


@contextlib.contextmanager
def planted(name: Optional[str]):
    if name is None:
        yield
        return
    if name not in FAULTS:
        raise ValueError(f"unknown fault {name!r}; one of {FAULTS}")
    from flow2gan_tpu_torch import api
    from flow2gan_tpu_torch.parallel import dist
    from flow2gan_tpu_torch.training import optim, train_step

    saved = []

    def patch(owner, attr, value):
        saved.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, value)

    if name == "shift_output":
        infer = api.VocoderModel.infer
        patch(api.VocoderModel, "infer",
              lambda self, *a, **k: torch.roll(infer(self, *a, **k), 1, dims=-1))
    elif name == "half_batch":
        step = train_step.fm_train_step

        def half(model, optimizer, cond_fn, batch, lr, generator):
            n = batch["audio"].shape[0] // 2
            return step(model, optimizer, cond_fn, {k: v[:n] for k, v in batch.items()}, lr,
                        generator)

        patch(train_step, "fm_train_step", half)
    elif name == "frozen_step":
        patch(optim.ScaledAdam, "step", lambda self, lr: None)
    else:
        patch(dist, "all_reduce_grads_", lambda params, extra=(): None)
    try:
        yield
    finally:
        for owner, attr, value in reversed(saved):
            setattr(owner, attr, value)
