"""Helpers of the per-layer metric readers. A reader is a module
`portbench/metrics/<metric name>.py` with `read(obs) -> float or None`,
where `obs` is what the traced window's driver reduced its trace and spans
to (`tracing.Trace.digest` plus the driver's counts; a training run's
ranks under `ranks`). A reader that finds nothing to read returns None,
and the metric is left out of the result line."""

from __future__ import annotations

import statistics


def ranks(obs: dict) -> list:
    return obs.get("ranks") or [obs]


def mean(values):
    values = [v for v in values if v is not None]
    return statistics.fmean(values) if values else None


def on_device(obs: dict) -> bool:
    """Whether the trace saw any device work (a CPU run sees none)."""
    return bool(obs.get("kernels"))


def roofline(measured, bounds):
    """The time-weighted share of the bound over the window's launches of a
    kernel: the sum of each launch's bound over the sum of its measured
    times, in %. None where the trace's launches and the expected ones do
    not pair up."""
    if not measured or len(measured) != len(bounds):
        return None
    return 100.0 * sum(bounds) / sum(measured)
