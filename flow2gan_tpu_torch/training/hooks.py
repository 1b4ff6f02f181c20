"""The trainer's policy for non-finite losses, counterpart of
`NonfiniteLossGuard` in `flow2gan_tpu/training/hooks.py`. Host-side: it reads
the loss and the clipping factor that the trainer has already fetched."""

from __future__ import annotations

import logging
import math
from typing import Callable

from flow2gan_tpu_torch.training.err import raise_nonfinite_loss_error


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
              save_bad_model: Callable[[str], None]) -> None:
        if math.isfinite(loss_val):
            self.streak = 0
            return
        self.streak += 1
        logging.warning(f"Non-finite loss at batch {batch_idx} (streak {self.streak}, "
                        f"clip_scale {clip_scale})")
        if not self.dumped:
            save_bad_model("-first-nonfinite")
            self.dumped = True
        if clip_scale != 0.0 or self.streak >= self.max_streak:
            save_bad_model("")
            raise_nonfinite_loss_error(batch_idx)
