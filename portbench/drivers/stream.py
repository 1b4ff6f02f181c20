"""Streaming synthesis: one stream at a time, closed loop, through the
serving CLI's chunked path (`bin/infer_dir.streaming_infer` over
`make_synth`): each chunk of the stream's log-mels is synthesised with its
halo of context and the halos cut from the output.

A request is one chunk: from handing the chunk's host-memory mels to the
synthesis until its waveform is in host memory. The window's rate counts
only the halo-trimmed audio of the chunks it finished; a stream still open
when the window closes is cut there."""

from __future__ import annotations

import time

from portbench import faults, harness, traffic, yardstick
from portbench.reference.check import Reference, rel_err
from portbench.tracing import Spans, Trace


class WindowClosed(Exception):
    pass


def run(r: harness.Run) -> harness.Result:
    from flow2gan_tpu_torch.bin import infer_dir

    cfg, mix, dev = r.cfg, r.mix, r.device
    vm = harness.vocoder(r, dev)
    harness.phase("program built")
    lengths = traffic.lengths_frames(mix, cfg)
    streams = [traffic.mels(r.seed, i, cfg, 1, f, dev)[0] for i, f in enumerate(lengths)]
    harness.phase("requests made")
    steps, chunk, hop = mix["n_timesteps"], mix["chunk_frames"], cfg["mel_hop_length"]
    layers, sr = max(cfg["num_layers"]), cfg["sampling_rate"]
    spans = Spans(traced=r.trace)
    seed = r.seed_for(1)
    lat, state = [], {"deadline": None}

    with faults.planted(r.fault):
        synth = infer_dir.make_synth(vm, steps, seed)

        def timed(seg):
            if state["deadline"] is not None and state["deadline"]():
                raise WindowClosed
            start = harness.clock()
            with spans("infer"):
                wav = synth(seg)
            lat.append(harness.clock() - start)
            return wav

        infer_dir.streaming_infer(timed, streams[0][:, : 2 * chunk], chunk, layers, hop)  # warm
        harness.sync(dev)
        harness.phase("warm")
        lat.clear()
        spans.seconds.clear()
        budget = mix["trace_chunks"] if r.trace else None
        order = traffic.order(r.seed, len(lengths))
        trace = Trace(dev) if r.trace else None
        window_start = time.time()
        if trace:
            trace.__enter__()
        t0 = harness.clock()
        state["deadline"] = None if budget is not None else (lambda: harness.clock() - t0 >= r.seconds)
        done, audio_s = [], 0.0
        for i in order:
            if budget is not None and len(lat) >= budget:
                break  # a traced window ends with a whole stream
            n_before = len(lat)
            try:
                wav = infer_dir.streaming_infer(timed, streams[i], chunk, layers, hop)
            except WindowClosed:
                frames = lengths[i]
                audio_s += sum(min(chunk, frames - c * chunk) for c in range(len(lat) - n_before)) * hop / sr
                break
            done.append((i, wav))
            audio_s += len(wav) / sr
        wall = harness.clock() - t0
        if trace:
            trace.__exit__(None, None, None)
    memory = harness.memory_peak(dev)
    obs = {}
    if trace:
        obs = trace.digest()
        shapes = []
        length = (chunk + 6 * layers) * hop
        for _ in lat:
            shapes += [yardstick.istft_bound_s(*s) for _ in range(steps)
                       for s in yardstick.branch_shapes(cfg, 1, length)]
        obs.update(requests=len(lat), audio_s=audio_s, spans=dict(spans.seconds),
                   flop=len(lat) * yardstick.serve_flop(cfg, 1, chunk + 6 * layers, steps),
                   istft_bound_s=shapes)
    del vm, synth
    longest = [k for k, (i, _) in enumerate(done) if lengths[i] == max(lengths)][:1]
    picked = harness.sample(r, len(done), mix["check_streams"], tuple(longest))
    ref = Reference(cfg, harness.weights(r, dev), dev)
    ctl = Reference(cfg, harness.weights(r, dev), dev, tf32=True) if r.control else None
    worst = 0.0 if picked else float("inf")
    for k in picked:
        i, wav = done[k]
        theirs = ref.stream(streams[i], steps, seed, chunk, 3 * layers)
        ours = ctl.stream(streams[i], steps, seed, chunk, 3 * layers) if ctl else wav
        worst = max(worst, rel_err(ours, theirs) if ours.shape == theirs.shape else float("inf"))
    return harness.Result(
        attempted=len(lat), failed=0,
        end_to_end={"xrt": audio_s / wall,
                    "latency_ms_p95": yardstick.percentile(lat, 95) * 1e3},
        obs=obs, checks={"wave_rel_err": worst}, memory_peak_bytes=memory,
        window_start=window_start)
