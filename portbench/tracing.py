"""The harness's spans and the reduction of a profiler trace to what the
per-layer metrics read.

`Spans` times the harness's own calls into the program on the host clock
(`infer`, `to_host`, `loader.next`, `fm_train_step`, `loss_fetch`) and, in a
traced run, marks them in the trace (`record_function`), so that an idle
gap on the device can be put down to what the host was doing. `Trace` runs
the profiler (host and device) over the traced window and reduces the
device's operations to a `digest`: the window's length, the union of the
device's busy intervals, device seconds by kernel family, the kernel count,
each iSTFT and adjoint launch's device time in order, and the idle time by
host span.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch

from portbench import yardstick

WINDOW = "portbench.window"


class Spans:
    """Host-clock durations of the harness's calls, by name; marked in the
    trace when `traced`."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        mark = torch.profiler.record_function(name) if self.traced else contextlib.nullcontext()
        start = time.perf_counter()
        with mark:
            yield
        self.seconds[name].append(time.perf_counter() - start)


class Trace:
    """The profiler over a traced window: `with trace: ...` around the work,
    `digest()` after it."""

    def __init__(self, device: torch.device):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.device = device
        self.prof = torch.profiler.profile(activities=activities)
        self._mark = None

    def __enter__(self):
        self.prof.__enter__()
        self._mark = torch.profiler.record_function(WINDOW)
        self._mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        return False

    def digest(self, idle_kernels=(yardstick.NCCL,)) -> dict:
        """The window's device work: `window_s`; `busy_s`, the union of the
        intervals of device operations whose family is not in
        `idle_kernels` (a collective spins while it waits); `device_s` by
        family; `kernels`, the count of kernel launches; `istft_s` and
        `adjoint_s`, each launch's seconds in order; `idle_by_span`, the idle
        seconds by the innermost harness span around the gap's middle."""
        window, marks, ops = None, [], []
        for e in self.prof.profiler.kineto_results.events():
            name, start = e.name(), e.start_ns()
            end = start + e.duration_ns()
            on_device = str(e.device_type()).endswith("CUDA")
            if e.is_user_annotation():
                if on_device:
                    continue
                if name == WINDOW:
                    window = (start, end)
                else:
                    marks.append((start, end, name))
            elif on_device:
                ops.append((start, end, name))
        if window is None:
            raise RuntimeError("the trace holds no window mark")
        w0, w1 = window
        ops = sorted(o for o in ops if w0 <= o[0] < w1)
        fam = [yardstick.family(n) for _, _, n in ops]
        busy = yardstick.merged((max(s, w0), min(e, w1)) for (s, e, _), f in zip(ops, fam)
                                if f not in idle_kernels)
        gaps, cursor = [], w0
        for s, e in busy + [(w1, w1)]:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        idle = []
        for s, e in gaps:
            mid = (s + e) / 2
            around = [m for m in marks if m[0] <= mid <= m[1]]
            label = min(around, key=lambda m: m[1] - m[0])[2] if around else "outside spans"
            idle.append((label, (e - s) / 1e9))
        return {
            "window_s": (w1 - w0) / 1e9,
            "busy_s": sum(e - s for s, e in busy) / 1e9,
            "device_s": yardstick.sum_by((f, (e - s) / 1e9) for (s, e, _), f in zip(ops, fam)),
            "kernels": sum(1 for f in fam if f != "copies (DMA)"),
            "istft_s": [(e - s) / 1e9 for (s, e, _), f in zip(ops, fam) if f == yardstick.ISTFT],
            "adjoint_s": [(e - s) / 1e9 for (s, e, _), f in zip(ops, fam)
                          if f == yardstick.ADJOINT],
            "idle_by_span": yardstick.sum_by(idle),
        }
