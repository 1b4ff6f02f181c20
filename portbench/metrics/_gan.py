"""Helpers of the GAN cells' readers: the device times of the program's
spans, as the GAN driver drained them into `obs["program"]` (none where
the program has no such span, or on the CPU)."""

from __future__ import annotations


def span_ms(obs: dict, name: str):
    """The device ms of each span `name` in the traced window, or None."""
    ms = obs.get("program", {}).get("device_ms", {}).get(name)
    return ms if ms and None not in ms else None
