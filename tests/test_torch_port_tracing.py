"""The port's spans and counters (`flow2gan_tpu_torch/tracing.py`) on the
CPU, at mel_24k_tiny sizes:

- off (the default), `span` is one shared null context, and a serving call
  and an FM step record nothing;
- on, a span's parent is the innermost span open on its thread, and its
  request is the open root's, also on another thread;
- a call at n Euler steps gives one `api.infer`, one `cond_encoder`, n
  `solve.step` and n spans per branch; an FM step its phases and one
  `optim.step`; the loader one `loader.assemble` per batch;
- two gloo ranks count one collective per limiter, per gradient bucket and
  for the loss count, and their bytes;
- under a profiler each span is also a `record_function`, on the span's
  clock;
- outputs and parameters are bitwise the same with the switch on and off.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.api import VocoderModel, init_weights
from flow2gan_tpu_torch.data import audio_io, dataset
from flow2gan_tpu_torch.models import build_generator, get_generator_config
from flow2gan_tpu_torch.models.norms import LIMITERS, BiasNorm
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram
from flow2gan_tpu_torch.training.optim import ScaledAdam
from flow2gan_tpu_torch.training.train_step import fm_train_step, step_generator
from flow2gan_tpu_torch.utils import AttributeDict
from tests import test_torch_port_dist as tdist

CPU = torch.device("cpu")
TINY = dict(get_generator_config("mel_24k_tiny"))
# three branches, as the released configurations have
TINY3 = dict(TINY, n_ffts=(128, 64, 32), hop_lengths=(64, 32, 16), channels=(32, 32, 32),
             conv_kernel_sizes=(7, 7, 7), num_layers=(1, 1, 1))


@pytest.fixture(autouse=True)
def _fresh():
    """Each test starts and ends with the switch off and nothing kept."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()
    torch.set_num_threads(threads)


def _vocoder(cfg):
    module = init_weights(build_generator(cfg), torch.Generator().manual_seed(0))
    return VocoderModel(module, AttributeDict(cfg), CPU)


def _fm_setup(seed=1):
    model = init_weights(build_generator(TINY), torch.Generator().manual_seed(seed))
    opt = ScaledAdam(model.named_parameters(), clipping_scale=2.0)
    mel = LogMelSpectrogram(24000, TINY["mel_n_fft"], TINY["mel_hop_length"], TINY["n_mels"])
    batch = {"audio": tdist._audio(2, 4096, 3), "audio_lens": torch.tensor([4096, 3000])}
    return model, opt, mel, batch


def _fm_steps(n=2):
    model, opt, mel, batch = _fm_setup()
    losses = [float(fm_train_step(model, opt, mel, batch, 3e-3, step_generator(5, k, CPU))["loss"])
              for k in range(n)]
    return losses, model.state_dict()


def test_off_records_nothing():
    assert not tracing.enabled()
    null = tracing.span("api.infer", root=True)
    assert null is tracing.span("branch", 2, device=CPU)
    assert isinstance(null, contextlib.nullcontext)
    tracing.count("collectives")
    _vocoder(TINY).infer(torch.randn(1, TINY["n_mels"], 12), n_timesteps=2)
    _fm_steps(1)
    drained = tracing.drain()
    assert drained.spans == [] and drained.counters == {}


def test_parents_requests_and_threads():
    tracing.enable()
    seen = {}

    def other(key):
        with tracing.span("loader.assemble"):
            pass
        seen[key] = True

    with tracing.span("api.infer", root=True):
        with tracing.span("solve.step", 0):
            with tracing.span("branch", 1):
                worker = threading.Thread(target=other, args=("inside",))
                worker.start()
                worker.join(timeout=10)
            with tracing.span("fm.step", root=True):  # a root inside a span is a child
                pass
        tracing.count("collectives", 2)
    worker = threading.Thread(target=other, args=("after",))
    worker.start()
    worker.join(timeout=10)
    assert not worker.is_alive() and seen == {"inside": True, "after": True}
    tracing.count("collectives")
    drained = tracing.drain()
    by = {}
    for s in drained.spans:
        by.setdefault(s.name, []).append(s)
    root = by["api.infer"][0]
    assert root.parent is None and root.request == root.id
    step, branch, nested = by["solve.step"][0], by["branch"][0], by["fm.step"][0]
    assert (step.parent, step.index, step.request) == (root.id, 0, root.id)
    assert (branch.parent, branch.index, branch.request) == (step.id, 1, root.id)
    assert (nested.parent, nested.request) == (step.id, root.id)
    inside, after = by["loader.assemble"]
    assert inside.thread != root.thread and inside.parent is None
    assert inside.request == root.id and after.request is None
    assert all(s.start_ns <= s.end_ns and s.device_ms is None for s in drained.spans)
    assert root.start_ns <= step.start_ns <= branch.start_ns <= branch.end_ns <= root.end_ns
    assert drained.counters == {"collectives": 3}
    assert tracing.drain() == ([], {})


@pytest.mark.parametrize("n_steps", [1, 2, 4])
def test_infer_spans(n_steps):
    vm = _vocoder(TINY3)
    tracing.enable()
    vm.infer(torch.randn(2, TINY3["n_mels"], 10), n_timesteps=n_steps)
    spans = tracing.drain().spans
    (root,) = [s for s in spans if s.name == "api.infer"]
    (enc,) = [s for s in spans if s.name == "cond_encoder"]
    steps = sorted((s for s in spans if s.name == "solve.step"), key=lambda s: s.index)
    branches = [s for s in spans if s.name == "branch"]
    assert [s.index for s in steps] == list(range(n_steps))
    assert len(branches) == 3 * n_steps == len(vm.module.estimators) * n_steps
    assert sorted(b.index for b in branches) == sorted(list(range(3)) * n_steps)
    assert enc.parent == root.id and all(s.parent == root.id for s in steps)
    assert {b.parent for b in branches} == {s.id for s in steps}
    assert {s.request for s in spans} == {root.id} and len(spans) == 2 + 4 * n_steps


def test_fm_step_spans():
    tracing.enable()
    _fm_steps(1)
    spans = tracing.drain().spans
    names = [s.name for s in spans]
    for name in ("fm.step", "fm.frontend", "fm.draws", "fm.forward", "fm.backward", "dist.grads",
                 "optim.step", "cond_encoder"):
        assert names.count(name) == 1, name
    assert names.count("branch") == len(TINY["n_ffts"])
    (root,) = [s for s in spans if s.name == "fm.step"]
    phases = {s.name: s for s in spans if s.parent == root.id}
    assert set(phases) == {"fm.frontend", "fm.draws", "fm.forward", "fm.backward", "dist.grads",
                           "optim.step"}
    order = sorted(phases.values(), key=lambda s: s.start_ns)
    assert [s.name for s in order] == ["fm.frontend", "fm.draws", "fm.forward", "fm.backward",
                                       "dist.grads", "optim.step"]
    assert phases["optim.step"].device_ms is None  # a CPU step has no device time


def test_loader_assembles_each_batch_once(tmp_path):
    sr, n = 24000, 10
    recs = []
    for i in range(n):
        path = tmp_path / f"r{i}.wav"
        x = 0.3 * np.sin(2 * np.pi * (110.0 + 20 * i) * np.arange(sr // 2) / sr)
        audio_io.write_wav(path, x.astype(np.float32), sr)
        recs.append(dataset.Recording(f"r{i}", str(path), sr, sr // 2))
    loader = dataset.build_data_loader(recs, sampling_rate=sr, batch_size=3, num_workers=2,
                                       train=True, duration=0.25, seed=4, drop_last=True)
    tracing.enable()
    batches = list(loader)
    spans = tracing.drain().spans
    assert len(batches) == len(loader) == 3
    assert sum(s.name == "loader.assemble" for s in spans) == 3
    waits = [s for s in spans if s.name == "loader.wait"]
    assert len(waits) == 4  # each batch, then the end of the epoch
    assembles = [s for s in spans if s.name == "loader.assemble"]
    assert all(s.thread != waits[0].thread for s in assembles)


def test_two_ranks_count_their_collectives(tmp_path):
    model = init_weights(build_generator(TINY), torch.Generator().manual_seed(3))
    spec = {"cfg": TINY, "state": model.state_dict(), "audio": tdist._audio(4, 4096, 4),
            "lens": torch.tensor(tdist.LENS["unequal"])}
    ranks = tdist._spawn(tmp_path, "_traced_fm_step", spec)
    limited = [m.log_scale if isinstance(m, BiasNorm) else m.scale for m in model.modules()
               if isinstance(m, LIMITERS)]
    assert len(limited) == model.num_limiters
    params = [p for p in model.parameters() if p.requires_grad]
    limiter_bytes = sum(p.numel() * 4 for p in limited)  # each limiter's summed gradient
    grad_bytes = sum(p.numel() * p.element_size() for p in params) + 4  # and the loss
    assert grad_bytes < 64 << 20  # one bucket
    for rank in ranks:
        counters = rank["counters"]
        assert counters["collectives"] == model.num_limiters + 1 + 1  # limiters, bucket, count
        count_bytes = counters["collective_bytes"] - limiter_bytes - grad_bytes
        assert count_bytes in (4, 8)  # the global count, one element
        assert rank["spans"].count("dist.all_reduce") == counters["collectives"]
    assert ranks[0]["counters"] == ranks[1]["counters"]


def test_spans_mark_the_profilers_trace():
    tracing.enable()
    with tracing.span("before"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):  # a profiler's first annotations cost more
            with tracing.span("warm"):
                pass
        for k in range(5):
            with tracing.span("solve.step", k):
                torch.ones(8).sum()
    spans = sorted((s for s in tracing.drain().spans if s.name == "solve.step"),
                   key=lambda s: s.start_ns)
    marks = sorted((e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name() == "solve.step")
    assert len(marks) == len(spans) == 5
    assert not any(e.name() == "before" for e in prof.profiler.kineto_results.events())
    slack = 50_000  # ns: the profiler converts its own clock to this one
    for span, (start, end) in zip(spans, marks):
        # one clock: the mark is entered after the span's start and left
        # before its end (the card's test holds the starts within 100 us)
        assert span.start_ns - slack <= start <= end <= span.end_ns + slack


def test_outputs_are_the_same_with_the_switch_on():
    vm = _vocoder(TINY3)
    mel = torch.randn(2, TINY3["n_mels"], 10)
    off = vm.infer(mel, n_timesteps=2, seed=9)
    off_losses, off_params = _fm_steps()
    tracing.enable()
    on = vm.infer(mel, n_timesteps=2, seed=9)
    on_losses, on_params = _fm_steps()
    assert torch.equal(on, off) and on_losses == off_losses
    assert all(torch.equal(on_params[k], v) for k, v in off_params.items())
    assert tracing.drain().spans
