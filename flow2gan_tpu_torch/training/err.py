"""Actionable error messages, counterpart of `flow2gan_tpu/training/err.py`."""


def raise_nonfinite_loss_error(batch_idx: int):
    """The trainer's stop on a diverged model: there is no AMP grad scaler,
    so the signal is a non-finite loss or gradient."""
    raise RuntimeError(
        f"""
    The training loss or gradients became non-finite at batch {batch_idx}.
    This usually means the model diverged. Things to try:
    - Reduce --base-lr (the ScaledAdam default 0.035 assumes the reference
      batch size; halve it and resume from the last good checkpoint).
    - Inspect the bad-model checkpoint that was just saved (bad-model*.pt).
    """
    )
