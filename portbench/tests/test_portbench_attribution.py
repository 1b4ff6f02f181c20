"""The trace reduction of `portbench/attribution.py` on hand-made traces: it
gives `Trace.digest`'s numbers, puts each idle gap down to the thread that
launched the operation ending it, and sums the idle time under each span
name; and on the card, a drained program span starts where its
`record_function` does."""

import statistics
import types

import pytest
import torch

from portbench import attribution
from portbench.tracing import Trace


def _event(name, start, end, device="CPU", kind="cpu_op", corr=0, thread=1):
    return types.SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: end - start,
        device_type=lambda: f"DeviceType.{device}",
        is_user_annotation=lambda: kind == "user_annotation",
        correlation_id=lambda: corr, activity_type=lambda: kind, start_thread_id=lambda: thread)


def _profiler(events):
    results = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def _kernel(name, start, end, corr):
    return _event(name, start, end, device="CUDA", kind="kernel", corr=corr)


def _launch(corr, thread, at):
    return _event("cudaLaunchKernel", at, at + 1, kind="cuda_runtime", corr=corr, thread=thread)


def _mark(name, start, end, thread):
    return _event(name, start, end, kind="user_annotation", thread=thread)


# one request on thread 7 (two Euler steps, the second's branch), the
# autograd thread 8 around a collective, and a pool thread 9, which launches
# nothing, with short spans over two gaps
EVENTS = [
    _mark(attribution.WINDOW, 0, 1000, 7),
    _mark("infer", 0, 900, 7), _mark("api.infer", 10, 890, 7),
    _mark("solve.step", 100, 450, 7), _mark("solve.step", 450, 880, 7),
    _mark("branch", 460, 600, 7), _mark("dist.all_reduce", 600, 700, 8),
    _mark("loader.assemble", 590, 640, 9), _mark("loader.assemble", 855, 866, 9),
    _kernel("sm90_xmma_gemm_f32f32", 200, 300, 1), _launch(1, 7, 150),
    _kernel("fused_istft_kernel", 500, 520, 2), _launch(2, 7, 480),
    _kernel("ncclDevKernel_AllReduce", 640, 690, 3), _launch(3, 8, 630),
    _kernel("vectorized_elementwise_kernel", 700, 760, 4), _launch(4, 8, 695),
    _kernel("Memcpy DtoH (Device -> Pageable)", 800, 850, 5),  # no launch in the trace
    _kernel("vectorized_elementwise_kernel", 870, 880, 7), _launch(7, 8, 865),
    _kernel("fused_istft_adjoint_kernel", 1200, 1300, 6),  # after the window
]


def test_digest_numbers_are_trace_digests():
    prof = _profiler(EVENTS)
    trace = Trace.__new__(Trace)
    trace.prof = prof
    old = trace.digest()
    new = attribution.reduce_trace(*attribution.trace_tuples(prof))
    for key in ("window_s", "busy_s", "device_s", "kernels", "istft_s", "adjoint_s"):
        assert new[key] == old[key], key
    # the old rule: the innermost mark at the gap's middle on any thread
    assert old["idle_by_span"] == pytest.approx(
        {"solve.step": 440e-9, "loader.assemble": 200e-9, attribution.OUTSIDE: 120e-9})
    # with no launch in the trace every gap takes the old rule
    bare = [e for e in EVENTS if e.activity_type() != "cuda_runtime"]
    assert attribution.reduce_trace(*attribution.trace_tuples(_profiler(bare)))["idle_by_span"] \
        == old["idle_by_span"]


def test_gaps_go_to_the_launching_thread():
    got = attribution.reduce_trace(*attribution.trace_tuples(_profiler(EVENTS)))
    # gaps: 0-200 and 300-500, ended by thread 7's GEMM and iSTFT, their
    # middles in step 0; 520-700 (the collective counts as idle), ended by
    # thread 8's kernel inside its span; 760-800, ended by a copy with no
    # launch, and 850-870, ended by thread 8 with no span of its own open:
    # the innermost mark of a launching thread (step 1, not the pool
    # thread's); 880-1000, the window's end: no mark
    assert got["busy_s"] == pytest.approx(240e-9)
    assert got["idle_by_span"] == pytest.approx(
        {"solve.step": 460e-9, "dist.all_reduce": 180e-9, attribution.OUTSIDE: 120e-9})
    assert got["idle_in"] == pytest.approx({
        "infer": (200 + 200 + 40 + 20) * 1e-9, "api.infer": (190 + 200 + 40 + 20) * 1e-9,
        "solve.step": (100 + 200 + 40 + 20) * 1e-9, "branch": 40e-9, "dist.all_reduce": 100e-9})


def test_gaps_without_marks_are_outside_spans():
    events = [_mark(attribution.WINDOW, 0, 100, 1), _kernel("k", 40, 60, 1), _launch(1, 3, 30)]
    got = attribution.reduce_trace(*attribution.trace_tuples(_profiler(events)))
    assert got["idle_by_span"] == pytest.approx({attribution.OUTSIDE: 80e-9})
    assert got["idle_in"] == {}


@pytest.mark.card
def test_drained_spans_start_with_their_marks(card):
    from flow2gan_tpu_torch import tracing

    x = torch.randn(1024, 1024, device=card)
    tracing.enable()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):  # a profiler's first annotations cost more
                with tracing.span("warm"):
                    pass
            for k in range(20):
                with tracing.span("solve.step", k, device=card):
                    x = x @ x / 1024
        torch.cuda.synchronize(card)
        spans = sorted((s for s in tracing.drain().spans if s.name == "solve.step"),
                       key=lambda s: s.start_ns)
    finally:
        tracing.disable()
    marks = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name() == "solve.step"
                   and not str(e.device_type()).endswith("CUDA"))
    assert len(marks) == len(spans) == 20
    offsets = [abs(m - s.start_ns) for s, m in zip(spans, marks)]
    assert max(offsets) < 100_000, statistics.median(offsets)
    assert all(s.device_ms > 0 for s in spans)
