"""Bulk synthesis: one caller in a closed loop hands `VocoderModel.infer` a
batch of log-mels of one length in host memory and waits for the waveforms
in host memory, cycling through the mix's lengths in seeded orders.

A request runs from the call with the host-memory mels to the waveforms'
arrival in host memory. The window's rate is all the audio returned over
all of its wall time; the tail is over all of its requests."""

from __future__ import annotations

import time

from portbench import faults, harness, traffic, yardstick
from portbench.reference.check import Reference, rel_err
from portbench.tracing import Spans, Trace


def run(r: harness.Run) -> harness.Result:
    cfg, mix, dev = r.cfg, r.mix, r.device
    vm = harness.vocoder(r, dev)
    harness.phase("program built")
    lengths = traffic.lengths_frames(mix, cfg)
    conds = [traffic.mels(r.seed, i, cfg, mix["batch"], f, dev) for i, f in enumerate(lengths)]
    harness.phase("requests made")
    steps, hop, sr = mix["n_timesteps"], cfg["mel_hop_length"], cfg["sampling_rate"]
    spans = Spans(traced=r.trace)

    def call(cond, seed):
        with spans("infer"):
            out = vm.infer(cond, n_timesteps=steps, seed=seed)
        with spans("to_host"):
            return out.cpu().numpy()

    with faults.planted(r.fault):
        for c in conds:  # every shape the window sends
            call(c, 0)
        harness.sync(dev)
        harness.phase("warm")
        spans.seconds.clear()
        budget = mix["trace_requests"] if r.trace else None
        order = traffic.order(r.seed, len(lengths))
        done, lat, outs = [], [], []
        trace = Trace(dev) if r.trace else None
        window_start = time.time()
        if trace:
            trace.__enter__()
        t0 = harness.clock()
        for k, i in enumerate(order):
            seed = r.seed_for(1, k)
            start = harness.clock()
            outs.append(call(conds[i], seed))
            end = harness.clock()
            done.append((i, seed))
            lat.append(end - start)
            if (budget is not None and len(done) == budget) or (
                    budget is None and end - t0 >= r.seconds):
                break
        if trace:
            trace.__exit__(None, None, None)
        wall = harness.clock() - t0
    memory = harness.memory_peak(dev)
    audio_s = sum(mix["batch"] * lengths[i] * hop / sr for i, _ in done)
    obs = {}
    if trace:
        obs = trace.digest()
        obs.update(requests=len(done), audio_s=audio_s, spans=dict(spans.seconds),
                   flop=sum(yardstick.serve_flop(cfg, mix["batch"], lengths[i], steps)
                            for i, _ in done),
                   istft_bound_s=[yardstick.istft_bound_s(*shape) for i, _ in done
                                  for _ in range(steps)
                                  for shape in yardstick.branch_shapes(cfg, mix["batch"],
                                                                       lengths[i] * hop)])
    del vm
    longest = [k for k, (i, _) in enumerate(done) if lengths[i] == max(lengths)][:1]
    picked = harness.sample(r, len(done), mix["check_requests"], tuple(longest))
    ref = Reference(cfg, harness.weights(r, dev), dev)
    ctl = Reference(cfg, harness.weights(r, dev), dev, tf32=True) if r.control else None
    worst = 0.0 if picked else float("inf")
    for k in picked:
        i, seed = done[k]
        theirs = ref.synth(conds[i], steps, seed)
        ours = ctl.synth(conds[i], steps, seed) if ctl else outs[k]
        worst = max(worst, rel_err(ours, theirs))
    return harness.Result(
        attempted=len(done), failed=0,
        end_to_end={"xrt": audio_s / wall,
                    "latency_ms_p95": yardstick.percentile(lat, 95) * 1e3},
        obs=obs, checks={"wave_rel_err": worst}, memory_peak_bytes=memory,
        window_start=window_start)
