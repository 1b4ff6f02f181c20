"""Fused iSTFT: the hand-written CUDA kernels `csrc/fused_istft.cu` and their
wrappers, the port of the Pallas TPU kernel in
`flow2gan_tpu/ops/pallas_istft.py` and of its custom VJP.

`FusedISTFT` is the differentiable iSTFT: for a CUDA tensor its forward
launches the fused kernel and its backward the adjoint kernel; for a CPU
tensor they are the plain versions, `istft_plain` (`ops.stft.istft`) and
`istft_adjoint_plain`. The iSTFT is linear, so the backward needs only the
shapes. `fused_istft` is what the model calls. Each launch adds 1 to the tracing
counter `istft.launches` or `istft.adjoint_launches` (`tracing.count`, while
its switch is on), so a run can show that its path went through them.

The kernels compute each frame's real DFT as an N/2-point complex FFT. What
they read besides the spectrogram or the gradient and the envelope comes from
here: the twiddle and window tables (`kernel_tables_np`) and the cut of the
work into blocks (`tile_plan`, `adjoint_plan`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.ops import cuda_build
from flow2gan_tpu_torch.ops.stft import (
    const_tensor,
    device_constant_cache,
    envelope,
    hann_window_np,
)
from flow2gan_tpu_torch.ops.stft import istft as istft_plain
from flow2gan_tpu_torch.ops.stft import istft_adjoint as istft_adjoint_plain

N_FFTS = (64, 128, 256, 512, 1024)
# The tile rule, tuned on an H100 at the six main-path shapes (PERF.md):
# aim at BLOCKS_PER_SM blocks for each of the card's SMs, so that one block's
# loads and barriers overlap others' arithmetic; give each tile at least
# HALO_ROWS * (k - 1) rows, so that halo frames add at most 1 / HALO_ROWS to
# the transforms; and keep a chunk of frames (two ping-pong buffers of N/2
# complex values, 8 * n_fft bytes per frame) within FRAME_BUFFER_BYTES.
BLOCKS_PER_SM = 4
HALO_ROWS = 3
FRAME_BUFFER_BYTES = 64 * 1024


def supported(n_fft: int, hop_length: int) -> bool:
    """The kernel takes every power-of-two n_fft from 64 to 1024 and any hop
    that divides it (the TPU kernel also needed 128-aligned hops, a lane
    limit Hopper does not have)."""
    return n_fft in N_FFTS and hop_length >= 1 and n_fft % hop_length == 0


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("fused_istft")
    lib.fused_istft_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    lib.fused_istft_launch.restype = ctypes.c_int
    lib.fused_istft_adjoint_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p
    ]
    lib.fused_istft_adjoint_launch.restype = ctypes.c_int
    return lib


def kernel_tables_np(n_fft: int):
    """(twiddles, window) as the kernel reads them, float32: twiddles
    (n_fft/2, 2) holds cos and sin of 2 pi j / n_fft for j < n_fft/2, and
    window (n_fft,) the periodic Hann window with the inverse DFT's 1/n_fft
    folded in. Both are computed in float64 and rounded once."""
    ang = 2.0 * np.pi * np.arange(n_fft // 2) / n_fft
    twiddles = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    window = (hann_window_np(n_fft).astype(np.float64) / n_fft).astype(np.float32)
    return twiddles, window


@device_constant_cache(maxsize=32)
def _kernel_tables(n_fft: int, device: torch.device) -> torch.Tensor:
    """The two tables back to back on `device`: 2 * n_fft float32."""
    return const_tensor(np.concatenate([t.ravel() for t in kernel_tables_np(n_fft)]), device)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """How the kernel cuts an iSTFT into blocks.

    The overlap-added signal, cut into hop-wide rows, has output sample idx
    at row (idx + n_fft/2) // hop. Block (b, tile) owns rows
    [t0, t0 + rows_per_tile) of batch entry b, t0 = t_lo + tile *
    rows_per_tile, and transforms the frames f in [t0 - k + 1, t0 +
    rows_per_tile) that exist, k - 1 halo frames included, in chunks of at
    most `frames_per_chunk`, the last frames first. It writes each output
    sample of its rows exactly once. The kernel computes this map itself;
    `tests/test_torch_port_ops.py` mirrors it."""

    n_fft: int
    hop: int
    t_f: int
    length: int
    rows_per_tile: int
    frames_per_chunk: int

    @property
    def k(self) -> int:
        return self.n_fft // self.hop

    @property
    def t_lo(self) -> int:
        """The row of output sample 0."""
        return self.n_fft // 2 // self.hop

    @property
    def rows(self) -> int:
        """Rows from output sample 0 to output sample length - 1."""
        return (self.n_fft // 2 + self.length - 1) // self.hop - self.t_lo + 1

    @property
    def tiles(self) -> int:
        return -(-self.rows // self.rows_per_tile)

    @property
    def smem_bytes(self) -> int:
        """The dynamic shared memory of one block, which the launcher in
        csrc/fused_istft.cu is given and the kernel carves: the twiddles, two
        frame buffers, the window, the tile's envelope slice and, where a
        tile takes several chunks, its partial sums."""
        chunked = self.rows_per_tile + self.k - 1 > self.frames_per_chunk
        return (8 * self.n_fft + 8 * self.frames_per_chunk * (self.n_fft + 1)
                + 4 * self.rows_per_tile * self.hop * (1 + chunked))


@functools.lru_cache(maxsize=256)
def tile_plan(batch: int, t_f: int, n_fft: int, hop_length: int, length: int,
              sm_count: int) -> TilePlan:
    """Rows per tile: as many as leave BLOCKS_PER_SM blocks for each of the
    card's `sm_count` SMs, but at least HALO_ROWS * (k - 1), and no more
    than one chunk of frames holds with its k - 1 halo frames. Halo frames
    are transformed by both tiles that need them, at (k - 1) /
    rows_per_tile extra work. Only where k alone overflows a chunk (k above
    8192 / n_fft, so hop below 128 at n_fft 1024) does a tile take its
    frames in several chunks."""
    max_frames = FRAME_BUFFER_BYTES // (8 * n_fft)
    plan = TilePlan(n_fft, hop_length, t_f, length, 1, 1)
    fit = max(max_frames - plan.k + 1, 1)
    target_blocks = BLOCKS_PER_SM * sm_count
    rows_per_tile = min(max(batch * plan.rows // target_blocks, HALO_ROWS * (plan.k - 1), 1),
                        fit, plan.rows)
    return dataclasses.replace(plan, rows_per_tile=rows_per_tile,
                               frames_per_chunk=min(max_frames, rows_per_tile + plan.k - 1))


@dataclasses.dataclass(frozen=True)
class AdjointPlan:
    """How the adjoint kernel cuts its work. A work item is (b, tile): frames
    [tile * frames_per_tile, (tile + 1) * frames_per_tile) of batch entry b,
    the last tile fewer, item index b * tiles + tile. `blocks` persistent
    blocks walk the items, block i taking items i, i + blocks, ...; each
    block's producer warp copies an item's span of the waveform's gradient,
    and the envelope's over the same samples, into one of `stages` ring
    slots, and its ADJOINT_WARPS consumer warps transform the item's frames
    in groups of `frames_per_warp`, group g of the block's running count
    going to warp g % ADJOINT_WARPS. Each bin is written by one warp once.
    `tests/test_torch_port_train.py` mirrors the kernel on this map."""

    n_fft: int
    hop: int
    t_f: int
    batch: int
    frames_per_tile: int
    blocks: int
    stages: int

    @property
    def m_pts(self) -> int:
        return self.n_fft // 2

    @property
    def lanes_per_frame(self) -> int:
        """Lanes that hold one frame's M-point FFT, ADJOINT_POINTS each."""
        return self.m_pts // ADJOINT_POINTS

    @property
    def frames_per_warp(self) -> int:
        return 32 // self.lanes_per_frame

    @property
    def tiles(self) -> int:
        return -(-self.t_f // self.frames_per_tile)

    @property
    def items(self) -> int:
        return self.batch * self.tiles

    @property
    def span(self) -> int:
        """Waveform samples a full tile reads: its frames overlap."""
        return (self.frames_per_tile - 1) * self.hop + self.n_fft

    @property
    def stage_floats(self) -> int:
        """One span in a ring slot, shifted by up to 3 samples so that it
        lies on device memory's 16-byte grid, in whole 16-byte units. A slot
        holds two: the gradient's and the envelope's."""
        return -(-(self.span + 3) // 4) * 4

    @property
    def smem_bytes(self) -> int:
        """The dynamic shared memory of one block (the layout at the top of
        `fused_istft_adjoint_kernel`): the ring's barriers, the twiddles,
        the window, each consumer warp's exchange buffer and the ring."""
        return _adjoint_fixed_bytes(self.n_fft) + 8 * self.stages * self.stage_floats


# The adjoint kernel's shape (csrc/fused_istft.cu): ADJOINT_WARPS consumer
# warps and one producer warp per block, ADJOINT_BLOCKS_PER_SM blocks per SM
# (shared memory is split between them; 8 warps a block keep the register
# file's four quarters even), ADJOINT_POINTS complex points of a frame in
# each lane's registers, and a ring of 2 to ADJOINT_MAX_STAGES slots.
ADJOINT_WARPS = 7
ADJOINT_BLOCKS_PER_SM = 2
ADJOINT_POINTS = 16
ADJOINT_MAX_STAGES = 3
SM_SHARED_BYTES = 228 * 1024  # an H100 SM's shared memory; each block keeps 1 KB of it


def _adjoint_fixed_bytes(n_fft: int) -> int:
    # two mbarriers a slot, two twiddle tables (M float2 each), the window
    # (N float), and per consumer warp 32 * ADJOINT_POINTS float2 with one
    # pad per 16 (bank spread)
    return (16 * ADJOINT_MAX_STAGES + 12 * n_fft
            + ADJOINT_WARPS * 8 * (32 * ADJOINT_POINTS * 17 // 16))


@functools.lru_cache(maxsize=256)
def adjoint_plan(batch: int, t_f: int, n_fft: int, hop_length: int, sm_count: int,
                 frames_per_tile: Optional[int] = None) -> AdjointPlan:
    """Frames per tile: one group for each consumer warp, so that a block
    takes an item in one step, or fewer where that leaves blocks idle (a
    small batch: then about one item for each block), evened out over the
    tiles of a batch entry, in whole warp groups, and no more than lets two
    ring slots fit; then as many slots as fit, up to ADJOINT_MAX_STAGES, and
    one persistent block per item up to ADJOINT_BLOCKS_PER_SM per SM.
    `frames_per_tile` overrides the rule (the tests' forced tile sizes). No
    frame is transformed twice: tiles share only what they read."""
    budget = SM_SHARED_BYTES // ADJOINT_BLOCKS_PER_SM - 1024
    plan = AdjointPlan(n_fft, hop_length, t_f, batch, 1, 1, 1)
    per_warp = plan.frames_per_warp
    ring = budget - _adjoint_fixed_bytes(n_fft)
    fit = (ring // 16 - 3 - n_fft) // hop_length + 1  # frames whose two spans fit twice
    if frames_per_tile is None:
        target_blocks = ADJOINT_BLOCKS_PER_SM * sm_count
        most = min(ADJOINT_WARPS * per_warp, fit // per_warp * per_warp,
                   max(-(-batch * t_f // target_blocks), per_warp))
        tiles = -(-t_f // most)
        frames_per_tile = -(-(-(-t_f // tiles)) // per_warp) * per_warp
    plan = dataclasses.replace(plan, frames_per_tile=frames_per_tile)
    stages = min(ADJOINT_MAX_STAGES, ring // (8 * plan.stage_floats))
    return dataclasses.replace(plan, blocks=min(plan.items, ADJOINT_BLOCKS_PER_SM * sm_count),
                               stages=max(stages, 2))


def _check_cuda(x: torch.Tensor, name: str, dtype: torch.dtype, n_fft: int, hop_length: int):
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got one on {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} takes {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    if not supported(n_fft, hop_length):
        raise NotImplementedError(f"fused iSTFT takes n_fft in {N_FFTS} with n_fft % hop == 0, "
                                  f"got ({n_fft}, {hop_length})")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}'s input is on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _launch_istft(spec: torch.Tensor, n_fft: int, hop_length: int, length: int) -> torch.Tensor:
    """Launch the fused iSTFT kernel: complex64 (B, T_f, n_fft//2+1) on the
    card -> float32 (B, length), the same function as `istft_plain`."""
    _check_cuda(spec, "fused_istft", torch.complex64, n_fft, hop_length)
    if spec.ndim != 3 or spec.shape[-1] != n_fft // 2 + 1:
        raise ValueError(f"expected (B, T_f, {n_fft // 2 + 1}), got {tuple(spec.shape)}")
    batch, t_f, n_freq = spec.shape
    if batch < 1 or t_f < 1 or length < 1:
        raise ValueError(f"empty iSTFT: batch {batch}, frames {t_f}, length {length}")
    sm_count = torch.cuda.get_device_properties(spec.device).multi_processor_count
    plan = tile_plan(batch, t_f, n_fft, hop_length, length, sm_count)
    tables = _kernel_tables(n_fft, spec.device)
    env = envelope(t_f, n_fft, hop_length, spec.device)
    out = torch.empty(batch, length, dtype=torch.float32, device=spec.device)
    err = _library().fused_istft_launch(
        torch.view_as_real(spec).data_ptr(), tables.data_ptr(), env.data_ptr(),
        out.data_ptr(), batch, t_f, n_fft, hop_length, length, plan.t_lo,
        plan.tiles, plan.rows_per_tile, plan.frames_per_chunk, plan.smem_bytes,
        torch.cuda.current_stream(spec.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_istft launch failed: cudaError {err}")
    tracing.count("istft.launches")
    return out


def istft_adjoint_kernel(grad: torch.Tensor, t_f: int, n_fft: int, hop_length: int) -> torch.Tensor:
    """Launch the adjoint kernel: float32 (B, length) on the card -> complex64
    (B, t_f, n_fft//2+1), the same function as `istft_adjoint_plain`."""
    _check_cuda(grad, "istft_adjoint_kernel", torch.float32, n_fft, hop_length)
    if grad.ndim != 2:
        raise ValueError(f"expected a (B, length) gradient, got {tuple(grad.shape)}")
    batch, length = grad.shape
    if batch < 1 or t_f < 1 or length < 1:
        raise ValueError(f"empty iSTFT adjoint: batch {batch}, frames {t_f}, length {length}")
    sm_count = torch.cuda.get_device_properties(grad.device).multi_processor_count
    plan = adjoint_plan(batch, t_f, n_fft, hop_length, sm_count)
    tables = _kernel_tables(n_fft, grad.device)
    env = envelope(t_f, n_fft, hop_length, grad.device)
    out = torch.empty(batch, t_f, n_fft // 2 + 1, dtype=torch.complex64, device=grad.device)
    err = _library().fused_istft_adjoint_launch(
        grad.data_ptr(), tables.data_ptr(), env.data_ptr(), torch.view_as_real(out).data_ptr(),
        batch, t_f, n_fft, hop_length, length, plan.frames_per_tile, plan.blocks, plan.stages,
        plan.stage_floats, plan.smem_bytes, torch.cuda.current_stream(grad.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_istft_adjoint launch failed: cudaError {err}")
    tracing.count("istft.adjoint_launches")
    return out


class FusedISTFT(torch.autograd.Function):
    """The differentiable iSTFT: the kernels for a CUDA tensor, the plain
    versions for a CPU one (there is no other route: a CUDA tensor that the
    kernels refuse raises). Saves only the geometry, as the iSTFT is linear
    (the JAX package's `_istft_pallas_diff_fwd` saves only the shape)."""

    @staticmethod
    def forward(ctx, spec: torch.Tensor, n_fft: int, hop_length: int,
                length: Optional[int]) -> torch.Tensor:
        t_f = spec.shape[-2]
        ctx.geometry = (t_f, n_fft, hop_length)
        if spec.device.type == "cpu":
            return istft_plain(spec, n_fft, hop_length, length=length)
        return _launch_istft(spec, n_fft, hop_length,
                             (t_f - 1) * hop_length if length is None else length)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        t_f, n_fft, hop_length = ctx.geometry
        if grad.device.type == "cpu":
            return istft_adjoint_plain(grad, t_f, n_fft, hop_length), None, None, None
        # the incoming gradient may be a strided view (a transpose, a slice)
        return istft_adjoint_kernel(grad.contiguous(), t_f, n_fft, hop_length), None, None, None


def fused_istft(
    spec: torch.Tensor, n_fft: int, hop_length: int, length: Optional[int] = None
) -> torch.Tensor:
    """The kernels for a CUDA tensor; the plain versions for a CPU tensor."""
    return FusedISTFT.apply(spec, n_fft, hop_length, length)
