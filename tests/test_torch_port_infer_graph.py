"""`VocoderModel.infer`'s CUDA graphs (`api.GraphRule`, `api.InferGraph`) on
the CPU, at mel_24k_tiny / token_24k_tiny sizes:

- the rule, with a fake capture and replay: a repeated key captures, then
  replays; another key runs eager and drops the graph; a key whose capture
  raised runs eager from then on, logged once; off CUDA every call is eager;
- a replay copies its inputs into the static buffers, returns a copy of the
  static output and counts nothing, as it launches nothing from the host;
  replays from several threads take turns on the static buffers;
- the counts made while a capture is open are dropped (`uncounted`), and
  the cached device constants it reads are held (`stft.holding`);
- `VocoderModel.infer` on the CPU is the eager path it was, over repeated and
  changing keys, and so is a call routed through a fake graph.

The graph itself needs the card: `chip_smoke.py` phase 22 holds replays
against the eager path bit for bit there.
"""

import gc
import logging
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.api import GraphRule, InferGraph, VocoderModel, init_weights
from flow2gan_tpu_torch.models import build_generator, get_generator_config
from flow2gan_tpu_torch.ops import fused_istft
from flow2gan_tpu_torch.ops import stft as pstft
from flow2gan_tpu_torch.utils import AttributeDict

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()
    torch.set_num_threads(threads)


class FakeGraph:
    """A graph that 'replays' by returning its inputs' sum plus its tag."""

    def __init__(self, tag):
        self.tag = tag

    def __call__(self, a, b):
        return a + b + self.tag


class Calls:
    """The rule's callables for one key, with a log of what ran."""

    def __init__(self, log, fail=False):
        self.log, self.fail = log, fail
        self.graphs = []

    def eager(self):
        self.log.append("eager")
        return torch.tensor(-1.0)

    def capture(self, a, b):
        self.log.append("capture")
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")
        graph = FakeGraph(100.0 * (len(self.graphs) + 1))
        self.graphs.append(weakref.ref(graph))
        return graph, torch.tensor(0.0)

    def inputs(self):
        return torch.tensor(1.0), torch.tensor(2.0)


def _run(rule, key, calls):
    return float(rule(key, calls.eager, calls.capture, calls.inputs))


def test_rule_captures_a_repeated_key_then_replays_and_drops_it_for_another():
    tracing.enable()
    log = []
    calls = Calls(log)
    rule = GraphRule(cuda=True)
    outs = [_run(rule, key, calls) for key in ("a", "a", "a", "a", "b", "a", "a", "a")]
    assert log == ["eager", "capture", "eager", "eager", "capture"]
    # eager; the capture's own output; two replays of graph 1; eager "b" drops
    # it; eager "a" again; a fresh capture and its replay
    assert outs == [-1.0, 0.0, 103.0, 103.0, -1.0, -1.0, 0.0, 203.0]
    gc.collect()
    assert calls.graphs[0]() is None and calls.graphs[1]() is rule.graph
    assert tracing.drain().counters == {"infer.eager_calls": 3, "infer.graph_captures": 2,
                                        "infer.graph_replays": 3}


def test_rule_off_cuda_runs_every_call_eager():
    tracing.enable()
    log = []
    rule = GraphRule(cuda=False)
    outs = [_run(rule, "a", Calls(log)) for _ in range(4)]
    assert log == ["eager"] * 4 and outs == [-1.0] * 4 and rule.graph is None
    assert tracing.drain().counters == {"infer.eager_calls": 4}


def test_rule_runs_a_key_whose_capture_failed_eager_without_retrying(caplog):
    tracing.enable()
    log = []
    failing, working = Calls(log, fail=True), Calls(log)
    rule = GraphRule(cuda=True)
    with caplog.at_level(logging.WARNING):
        outs = [_run(rule, "a", failing) for _ in range(4)]
        outs += [_run(rule, "b", working) for _ in range(3)]
        outs += [_run(rule, "a", failing) for _ in range(2)]
    assert log == ["eager", "capture", "eager", "eager", "eager",
                   "eager", "capture", "eager", "eager"]
    assert outs == [-1.0] * 5 + [0.0, 103.0] + [-1.0] * 2
    warnings = [r for r in caplog.records if "capture failed" in r.getMessage()]
    assert len(warnings) == 1 and "'a'" in warnings[0].getMessage()
    assert tracing.drain().counters == {"infer.eager_calls": 7, "infer.graph_captures": 1,
                                        "infer.graph_replays": 1}


class _Replayer:
    """What `CUDAGraph.replay` does for `InferGraph`: recompute the static
    output from the static inputs in place."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.mark.parametrize("on", [True, False])
def test_infer_graph_replay_copies_inputs_clones_output_and_counts_nothing(on):
    cond, x0, out = torch.zeros(2, 3), torch.zeros(2, 3), torch.zeros(2, 3)
    graph = InferGraph(_Replayer(lambda: torch.add(cond, x0, out=out)), cond, x0, out, [])
    if on:
        tracing.enable()
    a = graph(torch.ones(2, 3), torch.full((2, 3), 2.0))
    b = graph(torch.ones(2, 3), torch.full((2, 3), 5.0))
    assert torch.equal(a, torch.full((2, 3), 3.0)) and torch.equal(b, torch.full((2, 3), 6.0))
    assert a.data_ptr() != b.data_ptr() != out.data_ptr()
    assert torch.equal(cond, torch.ones(2, 3)) and torch.equal(x0, torch.full((2, 3), 5.0))
    assert tracing.drain().counters == {}


def test_replays_from_threads_take_turns_on_the_static_buffers():
    """Each thread's replays return the sum of its own inputs, though every
    replay sleeps between reading the static inputs and writing the static
    output."""
    cond, x0, out = torch.zeros(64), torch.zeros(64), torch.zeros(64)

    def replay():
        a = cond.clone()
        time.sleep(1e-3)
        torch.add(a, x0, out=out)

    rule = GraphRule(cuda=True)
    rule.key, rule.graph = "a", InferGraph(_Replayer(replay), cond, x0, out, [])
    wrong = []

    def caller(k):
        for i in range(20):
            v = float(100 * k + i)
            got = rule("a", None, None, lambda: (torch.full((64,), v), torch.full((64,), v)))
            if not torch.equal(got, torch.full((64,), 2 * v)):
                wrong.append((k, i))

    threads = [threading.Thread(target=caller, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and wrong == []


@pytest.mark.parametrize("on", [True, False])
def test_uncounted_drops_this_threads_counts(on):
    if on:
        tracing.enable()
    tracing.count("istft.launches")
    with tracing.uncounted():
        tracing.count("istft.launches", 3)
        tracing.count("collectives")
        other = threading.Thread(target=tracing.count, args=("istft.launches", 5))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
    tracing.count("istft.launches")
    assert tracing.drain().counters == ({"istft.launches": 7} if on else {})


def test_holding_keeps_the_cached_constants_read_inside():
    x = torch.randn(2, 1024, generator=torch.Generator().manual_seed(0))
    pstft.stft(x, 128, 32)  # cached before: a hit is held too
    with pstft.holding() as held:
        spec = pstft.stft(x, 128, 32)
        fused_istft.fused_istft(spec, 128, 32, 1024)
    consts = pstft._stft_consts(128, CPU)
    env = pstft.envelope(spec.shape[-2], 128, 32, CPU)
    assert held[0] is consts and any(h is env for h in held)
    assert any(h is pstft._istft_consts(128, CPU) for h in held)
    alive = weakref.ref(env)
    del consts, env
    for cached in (pstft._stft_consts, pstft._istft_consts, pstft.envelope):
        cached.cache_clear()
    gc.collect()
    assert alive() is not None  # evicted, and still held
    del held
    gc.collect()
    assert alive() is None


TINY = dict(get_generator_config("mel_24k_tiny"))
TOKEN_TINY = dict(get_generator_config("token_24k_tiny"))


def _vocoder(cfg):
    module = init_weights(build_generator(cfg), torch.Generator().manual_seed(0))
    return VocoderModel(module, AttributeDict(cfg), CPU)


def _cond(cfg, batch, frames, seed):
    rng = np.random.RandomState(seed)
    if cfg.get("conditioning") == "tokens":
        return rng.randint(0, cfg["vocab_size"], (batch, frames))
    return rng.randn(batch, cfg["n_mels"], frames).astype(np.float32)


def _eager(vm, cond, n, seed, clamp=True):
    """The eager path as `infer` ran it before graphs: x0 from a fresh
    generator, then the solve."""
    cond = torch.as_tensor(cond)
    cond = cond.float() if cond.is_floating_point() else cond
    hop = vm.module.cond_hop_length
    x0 = torch.randn(cond.shape[0], cond.shape[-1] * hop, generator=torch.Generator().manual_seed(
        seed), dtype=torch.float32) * vm.module.init_noise_scale
    with torch.inference_mode():
        return vm.module.infer_from_noise(x0, cond, None, n, clamp)


# (batch, frames, n_timesteps, seed, clamp_pred): repeated keys, a new seed,
# a new shape, a new step count, a new clamp
CALLS = [(2, 20, 1, 0, True), (2, 20, 1, 0, True), (2, 20, 1, 7, True), (1, 20, 1, 0, True),
         (1, 20, 2, 0, True), (1, 20, 2, 0, True), (1, 20, 2, 0, False)]


@pytest.mark.parametrize("cfg", [TINY, TOKEN_TINY], ids=["mel", "tokens"])
def test_vocoder_infer_on_cpu_stays_eager_and_unchanged(cfg):
    vm = _vocoder(cfg)
    tracing.enable()
    for batch, frames, n, seed, clamp in CALLS:
        cond = _cond(cfg, batch, frames, seed=batch)
        out = vm.infer(cond, n_timesteps=n, seed=seed, clamp_pred=clamp)
        assert torch.equal(out, _eager(vm, cond, n, seed, clamp))
    assert vm.graphs.graph is None
    assert tracing.drain().counters == {"infer.eager_calls": len(CALLS)}


def _cpu_capture(module, space, n, clamp_pred, cond, x0):
    """`InferGraph.capture` without a card: the warm-up runs eagerly, the
    'capture' runs once more uncounted, and a replay recomputes the static
    output uncounted, as a graph launches nothing from the host."""
    cond, x0 = cond.clone(), x0.clone()

    def run(cond, x0):
        return module.infer_from_noise(x0, cond, None, n, clamp_pred)

    first = run(cond, x0)
    with pstft.holding() as constants, tracing.uncounted():
        out = run(cond, x0)

    def replay():
        with tracing.uncounted():
            out.copy_(run(cond, x0))

    return InferGraph(_Replayer(replay), cond, x0, out, constants), first


def test_vocoder_infer_through_a_graph_equals_eager_and_counts_what_ran(monkeypatch):
    """The graph path of `VocoderModel.infer`, with the CPU standing in for
    the card: the same outputs as the eager path at every seed, held outputs
    kept apart, and the plain iSTFT's launches counted as a card's host
    would launch them (one a branch and Euler step of the eager call and of
    the capture's warm-up; none in the capture or the replays)."""
    plain = fused_istft.istft_plain

    def counted(*args, **kwargs):
        tracing.count("istft.launches")
        return plain(*args, **kwargs)

    monkeypatch.setattr(fused_istft, "istft_plain", counted)
    monkeypatch.setattr(InferGraph, "capture", staticmethod(_cpu_capture))
    vm = _vocoder(TINY)
    vm.graphs.cuda = True
    cond = _cond(TINY, 2, 20, seed=3)
    seeds = [4, 4, 5, 6, 4]
    tracing.enable()
    outs = [vm.infer(cond, n_timesteps=2, seed=s) for s in seeds]
    counters = tracing.drain().counters
    for s, out in zip(seeds, outs):
        assert torch.equal(out, _eager(vm, cond, 2, s))
    assert len({o.data_ptr() for o in outs}) == len(outs) and not torch.equal(outs[2], outs[3])
    assert vm.graphs.graph.constants  # the envelopes and DFT matrices it read
    # two branches, two Euler steps: four launches an eager call
    assert counters == {"infer.eager_calls": 1, "infer.graph_captures": 1,
                        "infer.graph_replays": 3, "istft.launches": 2 * 2 * 2}
    other = _cond(TINY, 2, 24, seed=3)
    assert torch.equal(vm.infer(other, n_timesteps=2, seed=4), _eager(vm, other, 2, 4))
    assert vm.graphs.graph is None


def test_vocoder_infer_after_a_failed_capture_draws_the_seeds_x0(monkeypatch, caplog):
    """The capture draws x0 before it fails; the eager call that stands in
    for it draws the same x0 again, from a fresh generator."""
    def failing(module, space, n, clamp_pred, cond, x0):
        raise RuntimeError("operation not permitted when stream is capturing")

    monkeypatch.setattr(InferGraph, "capture", staticmethod(failing))
    vm = _vocoder(TINY)
    vm.graphs.cuda = True
    cond = _cond(TINY, 2, 20, seed=3)
    with caplog.at_level(logging.WARNING):
        for s in (4, 4, 5):
            assert torch.equal(vm.infer(cond, n_timesteps=1, seed=s), _eager(vm, cond, 1, s))
    assert vm.graphs.failed and vm.graphs.graph is None
