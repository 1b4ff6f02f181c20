"""A profiler trace reduced to its digest, with each idle gap on the device
put down to the host thread that ended it: the reduction of
`tracing.Trace.digest` as a pure function over tuples, with the
attribution the program's own spans need.

`trace_tuples` reads a finished `torch.profiler.profile` into
- the window: (start, end) of the `portbench.window` mark;
- ops: (start, end, name, correlation) of each device operation;
- launches: (correlation, thread) of each runtime call that launched one;
- marks: (start, end, name, thread) of each host annotation (a span of the
  harness or of the program, a collective's own mark).

`reduce_trace` gives what `Trace.digest` gives (`window_s`, `busy_s`,
`device_s`, `kernels`, `istft_s`, `adjoint_s`) and two idle readings:
- `idle_by_span`: each gap goes to the thread that launched the device
  operation that ends it (its correlation matched to a launch), and is
  labelled with that thread's innermost mark at the gap's middle. Where no
  launch is found, or no mark of that thread is open there (autograd's
  thread between its collectives), the gap goes to the innermost mark at
  its middle on any thread that launched device work (on any thread at
  all in a trace with no launches), or to "outside spans".
- `idle_in`: for each mark name, the idle seconds during which a mark of
  that name was open on the gap's thread, wherever it sat on the stack.
Times are nanoseconds in, seconds out.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench import yardstick

WINDOW = "portbench.window"
OUTSIDE = "outside spans"


def trace_tuples(prof, window_name: str = WINDOW):
    """(window, ops, launches, marks) of a finished profiler's events; the
    window is None where the trace holds no window mark."""
    window, ops, launches, marks = None, [], [], []
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        on_device = str(e.device_type()).endswith("CUDA")
        if e.is_user_annotation():
            if on_device:
                continue
            if name == window_name:
                window = (start, end)
            else:
                marks.append((start, end, name, e.start_thread_id()))
        elif on_device:
            ops.append((start, end, name, e.correlation_id()))
        elif name.startswith(("cuda", "cuLaunch")):  # a CUDA API call on the host
            launches.append((e.correlation_id(), e.start_thread_id()))
    return window, ops, launches, marks


class _Open:
    """The marks open over a sequence of (start, end) gaps taken in
    ascending order."""

    def __init__(self, marks: Iterable[tuple]):
        self.marks = sorted(marks)
        self.starts = [m[0] for m in self.marks]
        self.next = 0
        self.live: List[tuple] = []

    def over(self, s: int, e: int) -> List[tuple]:
        stop = bisect.bisect_left(self.starts, e)
        self.live.extend(self.marks[self.next:stop])
        self.next = max(self.next, stop)
        self.live = [m for m in self.live if m[1] > s]
        return self.live


def _innermost(marks: Sequence[tuple], mid: float) -> Optional[tuple]:
    around = [m for m in marks if m[0] <= mid <= m[1]]
    return min(around, key=lambda m: m[1] - m[0]) if around else None


def _open_seconds(marks: Sequence[tuple], s: int, e: int) -> Dict[str, float]:
    """Seconds of (s, e) during which a mark of each name was open."""
    by_name = defaultdict(list)
    for m in marks:
        lo, hi = max(m[0], s), min(m[1], e)
        if hi > lo:
            by_name[m[2]].append((lo, hi))
    return {name: sum(b - a for a, b in yardstick.merged(iv)) / 1e9
            for name, iv in by_name.items()}


def reduce_trace(window: Tuple[int, int], ops: Sequence[tuple], launches: Sequence[tuple],
                 marks: Sequence[tuple], idle_kernels=(yardstick.NCCL,)) -> dict:
    """The digest of a traced window (see the module's docstring); a
    collective's kernel (`idle_kernels`) counts as idle, since it spins
    while it waits."""
    w0, w1 = window
    ops = sorted(o for o in ops if w0 <= o[0] < w1)
    fam = [yardstick.family(o[2]) for o in ops]
    busy_ops = [o for o, f in zip(ops, fam) if f not in idle_kernels]
    busy = yardstick.merged((s, min(e, w1)) for s, e, _, _ in busy_ops)
    first = {}  # a busy interval's start -> the correlation of its first op
    for s, _, _, corr in busy_ops:
        first.setdefault(s, corr)
    gaps, cursor = [], w0
    for s, e in busy + [(w1, w1)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)

    thread_of = dict(launches)
    launching = set(thread_of.values())
    by_thread = defaultdict(list)
    for m in marks:
        by_thread[m[3]].append(m)
    sweeps = {t: _Open(ms) for t, ms in by_thread.items()}
    anywhere = _Open(m for m in marks if m[3] in launching or not launching)
    idle, idle_in = [], defaultdict(float)
    for s, e in gaps:
        mid = (s + e) / 2
        thread = thread_of.get(first.get(e)) if e < w1 else None
        live = sweeps[thread].over(s, e) if thread in sweeps else []
        inner = _innermost(live, mid)
        if inner is None:
            inner = _innermost(anywhere.over(s, e), mid)
            live = sweeps[inner[3]].over(s, e) if inner else []
        idle.append((inner[2] if inner else OUTSIDE, (e - s) / 1e9))
        for name, sec in _open_seconds(live, s, e).items():
            idle_in[name] += sec
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "device_s": yardstick.sum_by((f, (e - s) / 1e9) for (s, e, _, _), f in zip(ops, fam)),
        "kernels": sum(1 for f in fam if f != "copies (DMA)"),
        "istft_s": [(e - s) / 1e9 for (s, e, _, _), f in zip(ops, fam) if f == yardstick.ISTFT],
        "adjoint_s": [(e - s) / 1e9 for (s, e, _, _), f in zip(ops, fam)
                      if f == yardstick.ADJOINT],
        "idle_by_span": yardstick.sum_by(idle),
        "idle_in": dict(idle_in),
    }
