"""Smoke run of the PyTorch port (`flow2gan_tpu_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card (sm_90a) and the
CUDA toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):

1. the card (`nvidia-smi` name and power limit) and the torch / CUDA versions;
2. the build of `flow2gan_tpu_torch/csrc/fused_istft.cu` with nvcc: its time
   and ptxas' register report;
3. the fused iSTFT kernel against its plain PyTorch version on the card at
   the six branch shapes of mel_24k_base and mel_44k_128band_512x_base
   (batch 16) and at edge shapes, with its time, the plain version's, the
   time of `torch.istft` (a yardstick the port never calls) and the bound;
4. the main path: `get_model("mel_24k_base")` and `infer` on a (16, 100, 94)
   mel at 1, 2 and 4 Euler steps, with the launch count of the kernel over
   that run, then the per-call time and x-real-time over timed calls, and
   mel_44k_128band_512x_base once at 1 step;
5. card against CPU: the same weights and x0 through `infer_from_noise`;
6. `reconstruct` from a waveform;
7. the device-time breakdown of one 1-step call (torch.profiler);
8. the `kernels` JSON line, then the card line and the result line.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from flow2gan_tpu_torch import get_model
from flow2gan_tpu_torch.ops import cuda_build
from flow2gan_tpu_torch.ops import fused_istft as fused
from flow2gan_tpu_torch.ops.stft import hann_window_np
from flow2gan_tpu_torch.utils import disable_tf32

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, and float32 FMA rate outside the
# tensor cores (the kernel accumulates in IEEE float32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
ISTFT_TOL = 1e-5  # kernel vs plain, relative to max|plain|
CARD_VS_CPU_TOL = 1e-4  # whole model, relative to max|CPU|
TIMED_SAMPLES = 25
TIMED_CALLS = 20
SLEEP_CYCLES = 2_000_000  # about 1 ms of GPU spin ahead of each timed sample

# (n_fft, hop, batch, t_f, length): the iSTFT shapes of one Euler step of
# mel_24k_base (94 mel frames) and mel_44k_128band_512x_base (87 mel frames)
MAIN_SHAPES = [
    (512, 256, 16, 95, 24064),
    (256, 128, 16, 189, 24064),
    (128, 64, 16, 377, 24064),
    (1024, 512, 16, 88, 44544),
    (512, 256, 16, 175, 44544),
    (256, 128, 16, 349, 44544),
]
EDGE_SHAPES = [
    (512, 256, 3, 95, 24064),  # odd batch
    (256, 128, 16, 189, 25000),  # length above the default: zero pad
    (128, 64, 5, 377, 20000),  # length below the default: trim
    (512, 256, 4, 2, 256),  # T_f <= k
    (1024, 256, 2, 3, 512),  # k = 4, T_f <= k
    (128, 64, 1, 1, 64),  # one frame: the output is all pad
]


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(fn, samples: int = TIMED_SAMPLES) -> list:
    """Device times of fn() in ms, one per sample. Each sample queues fn
    behind a GPU spin so that the host's launch overhead stays out of the
    measured span."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(samples):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        stop.record()
        pairs.append((start, stop))
    torch.cuda.synchronize()
    return [s.elapsed_time(e) for s, e in pairs]


def istft_bound_ms(n_fft, batch, t_f, length):
    """(bytes_ms, ops_ms, matmul_ops_ms) of the iSTFT on this card, at the
    data-sheet rates. The bound is the larger of the first two.

    bytes: the spectrogram read once, the waveform written once and the two
    window-folded iDFT matrices. ops: the fewest the function needs, an
    inverse real FFT per frame (2.5 N log2 N FLOP), the window multiply and
    the overlap-add (2 N per frame) and the envelope divide (one per output
    sample). matmul_ops: the 2 * B * T_f * 2F * N FLOP of the matmul form the
    kernel computes, which is no bound: an FFT does the same work in far fewer.
    """
    n_freq = n_fft // 2 + 1
    frames = batch * t_f
    bytes_ = frames * n_freq * 8 + batch * length * 4 + 2 * n_freq * n_fft * 4
    flop = frames * (2.5 * n_fft * math.log2(n_fft) + 2 * n_fft) + batch * length
    matmul_flop = 2 * frames * 2 * n_freq * n_fft
    return tuple(x * 1e3 for x in (
        bytes_ / HBM_BYTES_PER_S, flop / FP32_FLOP_PER_S, matmul_flop / FP32_FLOP_PER_S))


def check_istft_shape(n_fft, hop, batch, t_f, length, timed: bool) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(n_fft + t_f + batch)
    n_freq = n_fft // 2 + 1
    imag = torch.randn(batch, t_f, n_freq, generator=gen, device="cuda")
    # the spectrum of a real signal has no imaginary part at DC and Nyquist;
    # the port's iSTFT ignores it there, cuFFT's inverse (torch.istft) does not
    imag[..., 0] = imag[..., -1] = 0.0
    spec = torch.complex(torch.randn(batch, t_f, n_freq, generator=gen, device="cuda"), imag)
    ref = fused.istft_plain(spec, n_fft, hop, length=length)
    out = fused.istft_kernel(spec, n_fft, hop, length=length)
    torch.cuda.synchronize()
    if out.shape != (batch, length) or not torch.isfinite(out).all():
        raise AssertionError(f"kernel output {tuple(out.shape)} not finite or not {(batch, length)}")
    abs_err = (out - ref).abs().max().item()
    rel_err = abs_err / max(ref.abs().max().item(), 1e-30)
    row = dict(n_fft=n_fft, hop=hop, batch=batch, t_f=t_f, length=length,
               max_abs_err=abs_err, max_rel_err=rel_err)
    if rel_err > ISTFT_TOL:
        raise AssertionError(f"fused iSTFT disagrees with its plain version: {row}")
    if timed:
        window = torch.from_numpy(hann_window_np(n_fft)).cuda()
        spec_ft = spec.transpose(1, 2).contiguous()  # torch.istft's (B, F, T) layout

        def library():
            return torch.istft(spec_ft, n_fft, hop, window=window, center=True, length=length)

        lib_err = (library() - ref).abs().max().item() / ref.abs().max().item()
        fns = {
            "ms": lambda: fused.istft_kernel(spec, n_fft, hop, length=length),
            "plain_ms": lambda: fused.istft_plain(spec, n_fft, hop, length=length),
            "library_ms": library,
        }
        times = {key: [] for key in fns}
        # two interleaved rounds, so drift on the card falls on all three alike
        for key in [*fns, *reversed(fns)]:
            times[key] += device_ms(fns[key])
        bytes_ms, ops_ms, matmul_ops_ms = istft_bound_ms(n_fft, batch, t_f, length)
        row.update({key: statistics.median(v) for key, v in times.items()})
        row.update(samples=len(times["ms"]), library_max_rel_err=lib_err,
                   bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms, ops_ms=ops_ms,
                   bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                   matmul_ops_ms=matmul_ops_ms)
    return row


def time_calls(fn, calls: int = TIMED_CALLS):
    """Host wall time per call in ms, each call ended by a device sync."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def main_path(card: str, model, mel):
    """Serve mel_24k_base at 1/2/4 steps; returns the kernel's launches over
    one call at each step count, and the median ms of a 1-step call."""
    fused.launches = 0
    for n in (1, 2, 4):
        before = fused.launches
        wav = model.infer(mel, n_timesteps=n)
        torch.cuda.synchronize()
        if wav.shape != (16, 24064) or not torch.isfinite(wav).all():
            raise AssertionError(f"{n}-step output {tuple(wav.shape)} not finite (16, 24064)")
        if fused.launches - before != 3 * n:
            raise AssertionError(f"{n}-step call launched the kernel {fused.launches - before} "
                                 f"times, expected {3 * n}")
    launches = fused.launches
    print(f"main path: mel_24k_base infer at 1/2/4 steps, batch 16, fused_istft launches {launches}")

    audio_s = 16 * 24064 / 24000
    median_ms = {}
    for n in (1, 2, 4):
        ms = time_calls(lambda: model.infer(mel, n_timesteps=n))
        med = median_ms[n] = statistics.median(ms)
        print("main path timing " + json.dumps({
            "config": "mel_24k_base", "n_timesteps": n, "batch": 16, "mel_frames": 94,
            "audio_s": audio_s, "calls": len(ms), "ms_median": med, "ms_min": min(ms),
            "ms_max": max(ms), "x_real_time_median": audio_s / med * 1e3,
            "x_real_time_min": audio_s / max(ms) * 1e3, "x_real_time_max": audio_s / min(ms) * 1e3,
            "card": card,
        }))

    model44 = get_model("mel_44k_128band_512x_base", device="cuda", seed=0)
    mel44 = torch.from_numpy(np.random.RandomState(1).randn(16, 128, 87).astype(np.float32))
    before = fused.launches
    wav = model44.infer(mel44, n_timesteps=1)
    torch.cuda.synchronize()
    if wav.shape != (16, 44544) or not torch.isfinite(wav).all() or fused.launches - before != 3:
        raise AssertionError(f"44.1 kHz 1-step call: {tuple(wav.shape)}, "
                             f"{fused.launches - before} launches")
    ms = time_calls(lambda: model44.infer(mel44, n_timesteps=1), calls=5)
    print("44.1 kHz: mel_44k_128band_512x_base 1 step, batch 16 " + json.dumps(
        {"ms_median": statistics.median(ms), "x_real_time_median":
         16 * 44544 / 44100 / statistics.median(ms) * 1e3, "card": card}))
    return launches, median_ms[1]


def card_vs_cpu():
    gpu = get_model("mel_24k_base", device="cuda", seed=0).module
    cpu = get_model("mel_24k_base", device="cpu", seed=0).module
    rng = np.random.RandomState(2)
    cond = rng.randn(2, 100, 94).astype(np.float32)
    noise = (0.1 * rng.randn(2, 24064)).astype(np.float32)
    for n in (1, 2, 4):
        with torch.inference_mode():
            before = fused.launches
            a = gpu.infer_from_noise(torch.from_numpy(noise).cuda(), torch.from_numpy(cond).cuda(),
                                     n_timesteps=n).cpu()
            if fused.launches - before != 3 * n:
                raise AssertionError("card run did not go through the kernel")
            b = cpu.infer_from_noise(torch.from_numpy(noise), torch.from_numpy(cond), n_timesteps=n)
        abs_err = (a - b).abs().max().item()
        rel = abs_err / b.abs().max().item()
        print(f"card vs CPU {n} step(s), batch 2: max_abs_err={abs_err:.3e} max_rel_err={rel:.3e}")
        if not rel <= CARD_VS_CPU_TOL:
            raise AssertionError(f"card and CPU disagree at {n} steps: {rel}")


def profile_one_call(card: str, model, mel, wall_ms: float):
    """Device time of one 1-step mel_24k_base call by kernel family, and the
    device's busy share against the unprofiled median call time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.infer(mel, n_timesteps=1)
        torch.cuda.synchronize()

    def dev_us(e):  # the attribute's name differs across torch versions
        return getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)

    def family(name):
        for key in ("fused_istft", "gemm", "conv_depthwise"):
            if key in name:
                return key
        return "elementwise, reductions, copies"

    kernels = [(dev_us(e), e.key, e.count) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and dev_us(e) > 0]
    total_ms = sum(k[0] for k in kernels) / 1e3
    families = {}
    for us, name, _ in kernels:
        families[family(name)] = families.get(family(name), 0.0) + us / 1e3
    print("profile 1 step " + json.dumps({
        "device_ms": total_ms, "call_ms_median_unprofiled": wall_ms,
        "device_busy_share": total_ms / wall_ms if total_ms else "not measured",
        "device_events": sum(k[2] for k in kernels),
        "by_family_ms": families,
        "top": [{"name": name[:80], "ms": us / 1e3, "count": count}
                for us, name, count in sorted(kernels, reverse=True)[:8]],
        "card": card,
    }))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    # IEEE float32 for the plain iSTFT's matmuls from the first comparison
    # on; get_model would set the same
    disable_tf32()
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}")

    build = cuda_build.build("fused_istft")
    print(f"build: {build.path.name} in {build.seconds:.2f} s")
    for line in build.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    print(f"bound_ms = max(bytes / {HBM_BYTES_PER_S:.3g} B/s, FFT-form FLOP / "
          f"{FP32_FLOP_PER_S:.3g} FLOP/s): H100 SXM data sheet, HBM3 and FP32 on CUDA cores; "
          "matmul_ops_ms is the matmul form's FLOP at the same rate, not a bound")
    shapes = []
    for shape in MAIN_SHAPES:
        shapes.append(check_istft_shape(*shape, timed=True))
        print("istft shape " + json.dumps(shapes[-1]))
    for shape in EDGE_SHAPES:
        print("istft edge " + json.dumps(check_istft_shape(*shape, timed=False)))

    model = get_model("mel_24k_base", device="cuda", seed=0)
    # the request's mel arrives in host memory, as a server receives it
    mel = torch.from_numpy(np.random.RandomState(0).randn(16, 100, 94).astype(np.float32))
    launches, wall_ms = main_path(card, model, mel)
    card_vs_cpu()
    audio = 0.1 * torch.randn(4, 24000, generator=torch.Generator().manual_seed(3))
    wav = model.reconstruct(audio, n_timesteps=1)
    if wav.shape != (4, 24064) or not torch.isfinite(wav).all():
        raise AssertionError(f"reconstruct gave {tuple(wav.shape)}")
    print(f"reconstruct: (4, 24000) waveform -> {tuple(wav.shape)}, finite")
    profile_one_call(card, model, mel, wall_ms)

    step = shapes[:3]  # the three branches of one mel_24k_base Euler step
    print(json.dumps({"kernels": [{
        "name": "fused_istft",
        "route": "cuda",
        "source": "flow2gan_tpu_torch/csrc/fused_istft.cu",
        "replaces": "flow2gan_tpu/ops/pallas_istft.py:240",
        "launches": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "max_rel_err": max(s["max_rel_err"] for s in shapes),
        "ms": sum(s["ms"] for s in step),
        "plain_ms": sum(s["plain_ms"] for s in step),
        "bound_ms": sum(s["bound_ms"] for s in step),
        "bound_by": ("operations" if sum(s["ops_ms"] for s in step)
                     >= sum(s["bytes_ms"] for s in step) else "bytes"),
        "matmul_ops_ms": sum(s["matmul_ops_ms"] for s in step),
        "library_ms": sum(s["library_ms"] for s in step),
        "per": "one mel_24k_base Euler step at batch 16: the sum over its three branch shapes",
        "shapes": shapes,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
