"""The iSTFT's adjoint kernel against an older version of its source, on one
NVIDIA GPU: both checked against the plain adjoint, then timed in turns in
one process (old, new, new, old), at every timed shape of `chip_smoke.py`
and at the training and GAN rollout shapes at batches 16, 64 and 256.

Run from the repository root on the card, with the older source written out
first (any path; `build/` is ignored by git):

    git show 1813a8c:flow2gan_tpu_torch/csrc/fused_istft.cu > build/ab/fused_istft_old.cu
    python3 adjoint_ab.py build/ab/fused_istft_old.cu

The older source must export the adjoint launcher of PR 4-7,
`fused_istft_adjoint_launch(grad, tables, env, out, batch, t_f, n_fft, hop,
length, tiles, frames_per_tile, smem_bytes, stream)`; its plan is computed
here by that version's rule (`old_plan`). Prints a JSON line per shape and
the card line, and writes the rows to chiprun_out/adjoint_ab.json.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
from pathlib import Path

import torch

import chip_smoke
from flow2gan_tpu_torch.ops import cuda_build
from flow2gan_tpu_torch.ops import fused_istft as fused
from flow2gan_tpu_torch.ops.stft import envelope

BATCHES = (16, 64, 256)
SHAPES = (chip_smoke.MAIN_SHAPES
          + [(n, h, b, t, length) for b in BATCHES
             for n, h, _, t, length in chip_smoke.TRAIN_SHAPES + chip_smoke.GAN_SHAPES])


def old_plan(batch, t_f, n_fft, hop, sm_count):
    """(tiles, frames_per_tile, smem_bytes) by PR 4-7's `adjoint_plan`: four
    blocks per SM, at most 64 KB of frame buffers a block."""
    max_frames = 64 * 1024 // (8 * n_fft)
    per_tile = min(max(-(-batch * t_f // (4 * sm_count)), 1), max_frames, t_f)
    span = (per_tile - 1) * hop + n_fft
    return -(-t_f // per_tile), per_tile, 8 * n_fft + 8 * per_tile * n_fft + 4 * span


def load_old(src: Path):
    lib = ctypes.CDLL(str(cuda_build.build_file(src).path))
    lib.fused_istft_adjoint_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    lib.fused_istft_adjoint_launch.restype = ctypes.c_int
    return lib


def old_adjoint(lib, grad, t_f, n_fft, hop):
    batch, length = grad.shape
    sm_count = torch.cuda.get_device_properties(0).multi_processor_count
    tiles, per_tile, smem = old_plan(batch, t_f, n_fft, hop, sm_count)
    out = torch.empty(batch, t_f, n_fft // 2 + 1, dtype=torch.complex64, device=grad.device)
    err = lib.fused_istft_adjoint_launch(
        grad.data_ptr(), fused._kernel_tables(n_fft, grad.device).data_ptr(),
        envelope(t_f, n_fft, hop, grad.device).data_ptr(), torch.view_as_real(out).data_ptr(),
        batch, t_f, n_fft, hop, length, tiles, per_tile, smem,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"older adjoint launch failed: cudaError {err}")
    return out


def rel(a, b) -> float:
    a, b = torch.view_as_real(a), torch.view_as_real(b)
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("adjoint_ab: no CUDA device visible", file=sys.stderr)
        return 1
    chip_smoke.disable_tf32()
    card = chip_smoke.card_line()
    lib = load_old(Path(sys.argv[1]))
    rows = []
    for n_fft, hop, batch, t_f, length in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(n_fft + batch + t_f)
        grad = torch.randn(batch, length, generator=gen, device="cuda")
        ref = fused.istft_adjoint_plain(grad, t_f, n_fft, hop)
        new, old = (fused.istft_adjoint_kernel(grad, t_f, n_fft, hop),
                    old_adjoint(lib, grad, t_f, n_fft, hop))
        errs = dict(new_vs_plain=rel(new, ref), old_vs_plain=rel(old, ref))
        if max(errs.values()) > chip_smoke.ISTFT_TOL:
            raise AssertionError(f"({n_fft}, {hop}, {batch}, {t_f}): {errs}")
        fns = {"old": lambda: old_adjoint(lib, grad, t_f, n_fft, hop),
               "new": lambda: fused.istft_adjoint_kernel(grad, t_f, n_fft, hop)}
        rounds = {key: [] for key in fns}
        for key in ["old", "new", "new", "old"]:
            rounds[key].append(statistics.median(chip_smoke.device_ms(fns[key])))
        bytes_ms, ops_ms = chip_smoke.adjoint_bound_ms(n_fft, batch, t_f, length)
        bound = max(bytes_ms, ops_ms)
        row = dict(n_fft=n_fft, hop=hop, batch=batch, t_f=t_f, length=length, **errs,
                   old_ms=statistics.mean(rounds["old"]), new_ms=statistics.mean(rounds["new"]),
                   old_rounds_ms=rounds["old"], new_rounds_ms=rounds["new"],
                   spread_ms=max(max(v) - min(v) for v in rounds.values()), bound_ms=bound)
        row.update(speedup=row["old_ms"] / row["new_ms"], old_bound_share=bound / row["old_ms"],
                   new_bound_share=bound / row["new_ms"])
        rows.append(row)
        print("adjoint A/B " + json.dumps(row), flush=True)
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "adjoint_ab.json").write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
