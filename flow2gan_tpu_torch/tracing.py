"""Spans and counters at the port's layer boundaries, on the profiler's
host clock.

The switch is off by default and is process-wide: `enable()` turns it on
in the process that calls it (each spawned rank turns it on in its own).
While it is off, `span` is one test of a module flag and returns a shared
null context, and `count` does nothing.

While it is on:
- each `span` is kept in memory with its name, index (the Euler step, the
  branch), start and end, thread, parent (the innermost span open on the
  same thread) and request (the id of the root span open when it started;
  a span on another thread takes that root's request);
- starts and ends are `time.time_ns()`, the host timebase of
  `torch.profiler`'s events, so a span lines up with the device operations
  of a trace of the same window;
- while a profiler runs, a span is also a `torch.profiler.record_function`,
  so that the trace shows the program's names over its kernels;
- a span given a CUDA `device` also records a pair of timing events on that
  device's current stream; `drain()` resolves them, after one synchronise,
  into the device ms of the stream's work between them, waits included;
- `count(name, n)` adds to a counter.

A count made on a thread inside `uncounted()` is dropped: a CUDA graph's
capture launches nothing, and its replays launch nothing from the host, so
neither adds to the counters.

`drain()` returns the finished spans and the counters, and clears both;
nothing is written out here.

The spans: `api.infer` (root: one serving request), `cond_encoder`,
`solve.step` (index: the Euler step), `branch` (index: the estimator),
`infer.graph_capture` and `infer.graph_replay` (a call's CUDA graph, inside
`api.infer`: a replay passes no `cond_encoder`, `solve.step` or `branch`);
`fm.step` (root: one FM training step), `fm.frontend`, `fm.draws`,
`fm.forward`, `fm.backward`, `dist.grads`; `gan.d_step` and `gan.g_step`
(root, device: one GAN fine-tuning step, `training/gan_step.py`),
`gan.rollout` (the generator's solve inside a GAN step), `gan.judge`
(device; `models/discriminators.Discriminators.judge`, index 0 the MPD, 1
the MRD), `gan.losses`, `gan.backward` (device); `optim.step` (device);
`dist.all_reduce` (device); `loader.assemble` (on the loader's pool
threads), `loader.wait`. The
counters: `collectives` and `collective_bytes` (each all-reduce of
`parallel/dist.py` and its bytes), `istft.launches` and
`istft.adjoint_launches` (the fused iSTFT kernels the host launched: a
graph replay adds none, and the kernels it runs are read from the
profiler), `infer.graph_captures`, `infer.graph_replays` and
`infer.eager_calls` (the way each `api.VocoderModel.infer` call ran),
`gan.d_steps` and `gan.g_steps` (GAN steps taken),
`solve.recomputed_steps` (Euler steps that `solve(..., remat=True)`
recomputes in backward), `convnext.fused_blocks` and `convnext.eager_blocks`
(ConvNeXt blocks on the card in eval form, no grad, that ran the chain's
kernels, or the eager chain: bf16, hooked or gated),
`convnext.train_fused_blocks` and `convnext.train_eager_blocks` (blocks on
the card in train form, grad enabled, that ran through
`ops/convnext_chain_train.py`'s Function, or the eager chain: bf16 or
hooked; a block that checkpointing recomputes counts again),
`convnext.norm_film_launches`, `convnext.prelu_launches` and
`convnext.residual_launches` (the chain's kernels the host launched;
`ops/convnext_chain.py`), and `convnext.prelu_fwd_launches`,
`convnext.prelu_bwd_launches`, `convnext.norm_film_bwd_launches` and
`convnext.dwconv_bwd_launches` (the train form's;
`ops/convnext_chain_train.py`).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch

_NULL = contextlib.nullcontext()
_on = False
_lock = threading.Lock()
_local = threading.local()
_ids = itertools.count(1)
_root: Optional["_Span"] = None  # the root span open last
_done: List["_Span"] = []
_counters: Dict[str, int] = {}
_pool: Dict[torch.device, List[torch.cuda.Event]] = {}  # timing events, by device


class Span(NamedTuple):
    """One finished span, as `drain` returns it. Times are `time.time_ns()`
    nanoseconds; `device_ms` is None for a span without a CUDA device."""

    name: str
    index: Optional[int]
    start_ns: int
    end_ns: int
    thread: int
    id: int
    parent: Optional[int]
    request: Optional[int]
    device_ms: Optional[float]


class Drained(NamedTuple):
    spans: List[Span]
    counters: Dict[str, int]


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def span(name: str, index: Optional[int] = None, device: Optional[torch.device] = None,
         root: bool = False):
    """A context that keeps a span while the switch is on. `root` starts a
    request where no span is open on this thread; `device` (a CUDA device)
    also times that device's current stream."""
    if not _on:
        return _NULL
    return _Span(name, index, device, root)


def count(name: str, n: int = 1) -> None:
    if _on and not getattr(_local, "uncounted", False):
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


@contextlib.contextmanager
def uncounted():
    """Drops the counts made on this thread while the context is open."""
    outer = getattr(_local, "uncounted", False)
    _local.uncounted = True
    try:
        yield
    finally:
        _local.uncounted = outer


def counter(name: str) -> int:
    """A counter's value so far, without draining it."""
    return _counters.get(name, 0)


def drain() -> Drained:
    """The spans finished and the counters counted since the last drain,
    which are cleared; each device span's CUDA events are resolved after
    one synchronise of their device."""
    global _done, _counters
    with _lock:
        done, counters = _done, _counters
        _done, _counters = [], {}
    timed = [s for s in done if s.events is not None]
    for device in {s.device for s in timed}:
        torch.cuda.synchronize(device)
    device_ms = {}
    for s in timed:
        device_ms[s.id] = s.events[0].elapsed_time(s.events[1])
        _pool.setdefault(s.device, []).extend(s.events)
    return Drained([Span(s.name, s.index, s.start, s.end, s.thread, s.id, s.parent, s.request,
                         device_ms.get(s.id)) for s in done], counters)


def _events(device: torch.device):
    with _lock:
        free = _pool.get(device)
        if free and len(free) >= 2:
            return free.pop(), free.pop()
    return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)


class _Span:
    __slots__ = ("name", "index", "device", "root", "events", "mark", "id", "parent", "request",
                 "thread", "start", "end")

    def __init__(self, name, index, device, root):
        self.name, self.index, self.root = name, index, root
        timed = device is not None and device.type == "cuda"
        if timed and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device if timed else None
        self.events = _events(device) if timed else None
        self.mark = None

    def __enter__(self):
        global _root
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.thread = threading.get_ident()
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent = None
            with _lock:
                if self.root:
                    _root = self
                    self.request = self.id
                else:
                    self.request = _root.request if _root is not None else None
        stack.append(self)
        self.start = time.time_ns()
        if torch.autograd._profiler_enabled():
            self.mark = torch.profiler.record_function(self.name)
            self.mark.__enter__()
        if self.events is not None:
            self.events[0].record(torch.cuda.current_stream(self.device))
        return self

    def __exit__(self, *exc):
        global _root
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if self.mark is not None:
            self.mark.__exit__(*exc)
        self.end = time.time_ns()
        _local.stack.pop()
        with _lock:
            if _root is self:
                _root = None
            _done.append(self)
        return False
