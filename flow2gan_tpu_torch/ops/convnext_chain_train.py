"""The train form of a ConvNeXt block's chain: one autograd Function
(`TrainChain`) whose forward and backward run the hand-written CUDA kernels
of `csrc/convnext_chain_train.cu` (and `csrc/convnext_chain.cu`'s) around
the block's GEMMs, their wrappers and their plain versions.

`models/convnext.py ConvNeXtBlock` runs a block through it when grad is
enabled, the compute is float32 on a CUDA float32 input and no forward hook
watches the block. Forward:

    y = norm_film(x, mask, dwconv, BiasNorm, c, te, f)     # convnext_norm_film
    h1 = pwconv1(y)                                        # cuBLAS, bias in the GEMM
    p = prelu_out(h1, alpha)                               # convnext_prelu_fwd
    out = p @ W2^T + b2 + scale * x                        # cuBLAS, scaled_residual

keeping x, y and h1 (5 N floats for N = B * T * C) and the small inputs
for backward, through `ctx.save_for_backward` only (non-reentrant
`torch.utils.checkpoint` drops and recomputes what goes through it).
Backward, from the output's gradient g:

    dp = g @ W2                                            # cuBLAS
    prelu_bwd(dp, h1): dp := dh1, p recomputed             # convnext_prelu_bwd
    dW2 = g^T @ p; dy = dh1 @ W1; dW1 = dh1^T @ y          # cuBLAS
    dz, dc = norm_film_bwd(x, ..., dy)                      # convnext_norm_film_bwd
    dx = dwconv_bwd(dz, x, mask, w, g, scale)              # convnext_dwconv_bwd
    every parameter's gradient from the kernels' partials  # torch.sum, float64

The GEMMs take the layouts autograd gives `F.linear`'s backward, so cuBLAS
runs the same kernels. The limiters (`models/norms.py LimitParamValue`) act
on BiasNorm's log-scale and the residual scale before they enter the
Function, so their sign flips (and all-reduces) stay in autograd; no gate
enters a kernel.

For a CUDA tensor each wrapper launches its kernel, or raises on what the
kernel does not take; for a CPU tensor it runs its plain version, which
computes the same function in the tensor's dtype (float64 included), so
that the CPU tests can hold the Function against the eager block. The
kernels write per-block partial sums of the parameters' gradients into one
workspace (`_Sums`) whose regions torch's reductions add up in float64;
the plain versions return the sums themselves. Each launch adds 1 to the
tracing counter `convnext.prelu_fwd_launches`, `convnext.prelu_bwd_launches`,
`convnext.norm_film_bwd_launches` or `convnext.dwconv_bwd_launches` (while
its switch is on).

How the backward kernels cut their work comes from here (`prelu_bwd_plan`,
`segment_plan`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.ops import convnext_chain as chain
from flow2gan_tpu_torch.ops import cuda_build
from flow2gan_tpu_torch.ops.convnext_chain import (
    _check_cuda,
    _check_rows,
    _ptr,
    _sm_count,
    _stream,
)

ROW_THREADS = 256  # a block of `convnext_norm_film_bwd` holds a row: C / 4 threads
CONV_WARPS = 8  # (batch entry, segment) pairs a block of `convnext_dwconv_bwd`
# blocks of `convnext_norm_film_bwd` an SM, which the segments aim at
SEGMENT_BLOCKS_PER_SM = 4
MIN_SEGMENT_ROWS = 16  # a segment re-reads 6 halo rows
PRELU_BWD_BLOCKS_PER_SM = 4  # at most; fewer where a block's threads fill the SM
SM_THREADS = 2048


def prelu_bwd_plain(dp: torch.Tensor, h1: torch.Tensor,
                    alpha: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The function of `convnext_prelu_bwd`: from the gradient dp of p =
    prelu(h1), (dh1, p, dalpha, the sum of dh1 over rows), as autograd takes
    `torch.where(h1 >= 0, h1, alpha * h1)`'s."""
    pos = h1 >= 0
    dh1 = torch.where(pos, dp, alpha * dp)
    p = torch.where(pos, h1, alpha * h1)
    width = h1.shape[-1]
    dalpha = torch.where(pos, torch.zeros_like(dp), dp * h1).reshape(-1, width).sum(0)
    return dh1, p, dalpha, dh1.reshape(-1, width).sum(0)


def norm_film_bwd_plain(x: torch.Tensor, mask: Optional[torch.Tensor], dw_weight: torch.Tensor,
                        dw_bias: torch.Tensor, norm_bias: torch.Tensor, log_scale: torch.Tensor,
                        c: Optional[torch.Tensor], te: Optional[torch.Tensor], f: int,
                        dy: torch.Tensor) -> Tuple[Optional[torch.Tensor], ...]:
    """The function of `convnext_norm_film_bwd`: from the gradient dy of
    `norm_film_plain`'s output, (dz, dc, dnorm_bias, dlog_scale, dte), dz the
    gradient of the depthwise conv's output (bias included) and dc at the
    cond's own rate, c's rows past ceil(T / f) 0; dc and dte None without
    c."""
    if mask is not None:
        x = x * mask.to(x.dtype)
    batch, frames, channels = x.shape
    z = F.conv1d(x.transpose(1, 2), dw_weight, dw_bias, padding="same",
                 groups=channels).transpose(1, 2)
    d = z - norm_bias
    r = torch.rsqrt((d * d).mean(dim=-1, keepdim=True))
    s = r * torch.exp(log_scale)
    dc = dte = None
    dn = dy
    if c is not None:
        rows = -(-frames // f)
        rep = c.repeat_interleave(f, dim=1)[:, :frames]
        dte = (dy * (z * s + rep)).sum(1)
        dn = dy * (1.0 + te)[:, None, :]
        grouped = F.pad(dn, (0, 0, 0, rows * f - frames)).reshape(batch, rows, f, channels).sum(2)
        dc = torch.zeros_like(c)
        dc[:, :rows] = grouped
    ds = (dn * z).sum(-1, keepdim=True)
    coef = ds * s * r * r / channels
    dz = dn * s - coef * d
    return dz, dc, (coef * d).sum((0, 1)), (ds * s).sum(), dte


def dwconv_bwd_plain(dz: torch.Tensor, x: torch.Tensor, mask: Optional[torch.Tensor],
                     dw_weight: torch.Tensor, g: torch.Tensor,
                     scale: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The function of `convnext_dwconv_bwd`: from dz (as above) and the
    block's output gradient g, (dx, ddw_weight, ddw_bias, dscale, dbias2):
    the masked conv's input gradient plus the residual's, scale * g, and
    the depthwise weight's, its bias's, the residual scale's and pwconv2's
    bias's gradients."""
    channels, _, k = dw_weight.shape
    m = 1.0 if mask is None else mask.to(x.dtype)
    xm = x * m
    dxm = F.conv_transpose1d(dz.transpose(1, 2), dw_weight, padding=(k - 1) // 2,
                             groups=channels).transpose(1, 2)
    dx = dxm * m + (g if scale is None else g * scale)
    frames = x.shape[1]
    padded = F.pad(xm, (0, 0, (k - 1) // 2, k // 2))
    ddw = torch.stack([(dz * padded[:, i:i + frames]).sum((0, 1)) for i in range(k)], dim=-1)
    return (dx, ddw.reshape(channels, 1, k), dz.sum((0, 1)),
            None if scale is None else (g * x).sum((0, 1)), g.sum((0, 1)))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load("convnext_chain_train")
    ptr, num = ctypes.c_void_p, ctypes.c_int
    lib.convnext_prelu_fwd_launch.argtypes = [ptr] * 3 + [num] * 3 + [ptr]
    lib.convnext_prelu_bwd_launch.argtypes = [ptr] * 5 + [num] * 4 + [ptr]
    lib.convnext_norm_film_bwd_launch.argtypes = [ptr] * 13 + [num] * 8 + [ptr]
    lib.convnext_dwconv_bwd_launch.argtypes = [ptr] * 8 + [num] * 6 + [ptr]
    for fn in (lib.convnext_prelu_fwd_launch, lib.convnext_prelu_bwd_launch,
               lib.convnext_norm_film_bwd_launch, lib.convnext_dwconv_bwd_launch):
        fn.restype = ctypes.c_int
    return lib


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _launched(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    tracing.count(f"convnext.{name[len('convnext_'):]}_launches")


@functools.lru_cache(maxsize=256)
def prelu_bwd_plan(rows: int, width: int, sm_count: int) -> Tuple[int, int]:
    """(chunks, chunk_rows) of `convnext_prelu_bwd`: a block a chunk of rows,
    as many blocks as the SMs hold at once (width / 4 threads a block, at
    most PRELU_BWD_BLOCKS_PER_SM an SM), no chunk empty."""
    threads = _cdiv(width, 128) * 32
    blocks = sm_count * max(1, min(PRELU_BWD_BLOCKS_PER_SM, SM_THREADS // threads))
    chunk_rows = _cdiv(rows, min(blocks, rows))
    return _cdiv(rows, chunk_rows), chunk_rows


@functools.lru_cache(maxsize=256)
def segment_plan(batch: int, frames: int, f: int, sm_count: int) -> Tuple[int, int]:
    """(segs, seg_rows) of `convnext_norm_film_bwd` and `convnext_dwconv_bwd`:
    each batch entry's frames cut into segs segments of seg_rows rows (the
    last shorter), enough that batch * segs blocks give each SM
    SEGMENT_BLOCKS_PER_SM, none under MIN_SEGMENT_ROWS rows where the frames
    allow; seg_rows a multiple of f, so that a cond row's f rows lie in one
    segment."""
    segs = max(1, min(_cdiv(SEGMENT_BLOCKS_PER_SM * sm_count, batch), frames // MIN_SEGMENT_ROWS))
    seg_rows = _cdiv(_cdiv(frames, segs), f) * f
    return _cdiv(frames, seg_rows), seg_rows


class _Sums:
    """The block's parameter gradients from the backward kernels' partial
    sums, in one float32 workspace: each kernel writes its region, then
    `finish` adds each region's rows in float64 (`torch.sum`, a fixed order
    for a fixed shape, no atomics) and casts them into `out` at once.
    Regions: `prelu` (chunks, 6C: dalpha, pwconv1's bias), `norm`
    (batch * segs, C + 4: the norm's bias, its log-scale), `te` (segs,
    B * C), `conv` (ceil(batch * segs / 8), 10 C: the depthwise weight as
    (C, 7), its bias, the residual scale, pwconv2's bias)."""

    def __init__(self, batch: int, channels: int, hidden: int, k: int, conditioned: bool,
                 prelu_chunks: int, segs: int, device: torch.device):
        shapes = {"prelu": (prelu_chunks, 2 * hidden), "norm": (batch * segs, channels + 4),
                  "te": (segs, batch * channels if conditioned else 0),
                  "conv": (_cdiv(batch * segs, CONV_WARPS), channels * (k + 3))}
        sizes = [rows * width for rows, width in shapes.values()]
        total = sum(w for _, w in shapes.values())
        self.parts = torch.empty(sum(sizes), dtype=torch.float32, device=device)
        self.out = torch.empty(total, dtype=torch.float32, device=device)
        self.sums = torch.empty(total, dtype=torch.float64, device=device)
        self.regions, start, at = {}, 0, 0
        for (name, (rows, width)), size in zip(shapes.items(), sizes):
            self.regions[name] = (self.parts[start:start + size].view(rows, width),
                                  self.out[at:at + width], self.sums[at:at + width])
            start, at = start + size, at + width

    def part(self, name: str) -> torch.Tensor:
        return self.regions[name][0]

    def finish(self) -> dict:
        """Sums each region's rows; returns each region's (width,) view of
        `out`."""
        for parts, _, sums in self.regions.values():
            if parts.shape[1]:
                torch.sum(parts, 0, dtype=torch.float64, out=sums)
        self.out.copy_(self.sums)
        return {name: out for name, (_, out, _) in self.regions.items()}


def prelu_out(h: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """`chain.prelu_plain`'s function into a new tensor, h kept: for a CUDA
    tensor `convnext_prelu_fwd`, for a CPU one the plain version."""
    if h.device.type == "cpu":
        return chain.prelu_plain(h, alpha)
    return _launch_prelu_fwd(h, alpha)


def _launch_prelu_fwd(h: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    _check_cuda("convnext_prelu_fwd", h, alpha)
    _check_rows("convnext_prelu_fwd", h, alpha.numel())
    p = torch.empty_like(h)
    unroll = chain.stream_unroll(h.numel() // 4, _sm_count(h.device.index))
    _launched("convnext_prelu_fwd", _library().convnext_prelu_fwd_launch(
        h.data_ptr(), alpha.data_ptr(), p.data_ptr(), h.numel(), alpha.numel(), unroll,
        _stream(h)))
    return p


def _launch_prelu_bwd(dp: torch.Tensor, h1: torch.Tensor, alpha: torch.Tensor,
                      sums: _Sums) -> torch.Tensor:
    """dp := dh1 in place; returns p; dalpha and pwconv1's bias into
    `sums`' `prelu` region."""
    width = alpha.numel()
    if dp.shape != h1.shape or width > 4 * 1024:
        raise ValueError(f"convnext_prelu_bwd: dp {tuple(dp.shape)}, h1 {tuple(h1.shape)}, "
                         f"{width} channels (at most 4096)")
    _check_cuda("convnext_prelu_bwd", dp, h1, alpha)
    _check_rows("convnext_prelu_bwd", h1, width)
    rows = h1.numel() // width
    part = sums.part("prelu")
    chunks, chunk_rows = prelu_bwd_plan(rows, width, _sm_count(dp.device.index))
    if part.shape != (chunks, 2 * width):
        raise ValueError(f"convnext_prelu_bwd: partials {tuple(part.shape)}, expected "
                         f"{(chunks, 2 * width)}")
    p = torch.empty_like(h1)
    _launched("convnext_prelu_bwd", _library().convnext_prelu_bwd_launch(
        dp.data_ptr(), h1.data_ptr(), alpha.data_ptr(), p.data_ptr(), part.data_ptr(), rows,
        width, chunks, chunk_rows, _stream(dp)))
    return p


def _launch_norm_film_bwd(x, mask, dw_weight, dw_bias, norm_bias, log_scale, c, te, f, dy,
                          sums: _Sums, segs: int, seg_rows: int):
    """Returns (dz, dc); the norm's bias and log-scale and dte into `sums`."""
    batch, frames, channels = x.shape
    k = dw_weight.shape[-1]
    if k not in chain.KERNEL_SIZES or channels % 4 or not 4 <= channels <= 4 * ROW_THREADS:
        raise NotImplementedError(f"convnext_norm_film_bwd takes k in {chain.KERNEL_SIZES} and "
                                  f"channels a multiple of 4 up to {4 * ROW_THREADS}, got k {k}, "
                                  f"C {channels}")
    if (dy.shape != x.shape or dw_weight.shape != (channels, 1, k)
            or dw_bias.shape != (channels,) or norm_bias.shape != (channels,)
            or log_scale.numel() != 1):
        raise ValueError("convnext_norm_film_bwd: the gradient or the parameters do not match x")
    if mask is not None and mask.shape not in ((batch, frames), (batch, frames, 1)):
        raise ValueError(f"mask {tuple(mask.shape)} does not match the input {tuple(x.shape)}")
    if (c is None) != (te is None):
        raise ValueError("convnext_norm_film_bwd takes the cond and the time projection together")
    t_c, rows = 0, -(-frames // f)
    if c is not None:
        if c.ndim != 3 or c.shape[0] != batch or c.shape[2] != channels or c.shape[1] < rows:
            raise ValueError(f"cond {tuple(c.shape)} does not cover {tuple(x.shape)} at factor {f}")
        if te.shape != (batch, channels):
            raise ValueError(f"time projection {tuple(te.shape)}, expected {(batch, channels)}")
        t_c = c.shape[1]
    _check_cuda("convnext_norm_film_bwd", x, mask, dw_weight, dw_bias, norm_bias, log_scale, c, te,
                dy)
    _check_rows("convnext_norm_film_bwd", x, channels)
    dz = torch.empty_like(x)
    dc = None
    if c is not None:  # cond rows past the frames' get no gradient
        dc = torch.zeros_like(c) if t_c > rows else torch.empty_like(c)
    part_te = sums.part("te") if c is not None else None
    _launched("convnext_norm_film_bwd", _library().convnext_norm_film_bwd_launch(
        x.data_ptr(), _ptr(mask), dw_weight.data_ptr(), dw_bias.data_ptr(), norm_bias.data_ptr(),
        log_scale.data_ptr(), _ptr(c), _ptr(te), dy.data_ptr(), dz.data_ptr(), _ptr(dc),
        sums.part("norm").data_ptr(), _ptr(part_te), batch, frames, channels, k, f, t_c, segs,
        seg_rows, _stream(x)))
    return dz, dc


def _launch_dwconv_bwd(dz, x, mask, dw_weight, g, scale, sums: _Sums, segs: int,
                       seg_rows: int) -> torch.Tensor:
    """Returns dx; the depthwise weight's, its bias's, the scale's and
    pwconv2's bias's sums into `sums`."""
    batch, frames, channels = x.shape
    if dz.shape != x.shape or g.shape != x.shape or (scale is not None
                                                     and scale.shape != (channels,)):
        raise ValueError("convnext_dwconv_bwd: dz, g or the scale do not match x")
    _check_cuda("convnext_dwconv_bwd", dz, x, mask, dw_weight, g, scale)
    dx = torch.empty_like(x)
    _launched("convnext_dwconv_bwd", _library().convnext_dwconv_bwd_launch(
        dz.data_ptr(), x.data_ptr(), _ptr(mask), dw_weight.data_ptr(), g.data_ptr(), _ptr(scale),
        dx.data_ptr(), sums.part("conv").data_ptr(), batch, frames, channels,
        dw_weight.shape[-1], segs, seg_rows, _stream(x)))
    return dx


def _backward(x, mask, dw_weight, dw_bias, norm_bias, log_scale, c, te, w1, alpha, w2, scale, y,
              h1, g, f):
    """The gradients of `TrainChain.forward`'s inputs, from its output's
    gradient g: the kernels and `_Sums` for CUDA tensors, the plain versions
    for CPU ones."""
    channels, hidden = x.shape[-1], h1.shape[-1]
    g = g.contiguous()
    g2 = g.view(-1, channels)
    dp = g2.mm(w2)  # pwconv2's input gradient, as autograd takes F.linear's
    if x.device.type == "cpu":
        dh1, p, dalpha, db1 = prelu_bwd_plain(dp, h1.view(-1, hidden), alpha)
    else:
        sums = _Sums(x.shape[0], channels, hidden, dw_weight.shape[-1], c is not None,
                     prelu_bwd_plan(h1.numel() // hidden, hidden, _sm_count(x.device.index))[0],
                     segment_plan(x.shape[0], x.shape[1], f, _sm_count(x.device.index))[0],
                     x.device)
        p = _launch_prelu_bwd(dp, h1.view(-1, hidden), alpha, sums)
        dh1 = dp
    dw2 = g2.t().mm(p)
    del p
    dy = dh1.mm(w1).view(x.shape)
    dw1 = dh1.t().mm(y.reshape(-1, channels))  # the plain norm_film gives a strided y
    del dh1, dp
    if x.device.type == "cpu":
        dz, dc, dnb, dls, dte = norm_film_bwd_plain(x, mask, dw_weight, dw_bias, norm_bias,
                                                    log_scale, c, te, f, dy)
        dx, ddw, ddb, dscale, db2 = dwconv_bwd_plain(dz, x, mask, dw_weight, g, scale)
    else:
        segs, seg_rows = segment_plan(x.shape[0], x.shape[1], f, _sm_count(x.device.index))
        dz, dc = _launch_norm_film_bwd(x, mask, dw_weight, dw_bias, norm_bias, log_scale, c, te,
                                       f, dy, sums, segs, seg_rows)
        del dy
        dx = _launch_dwconv_bwd(dz, x, mask, dw_weight, g, scale, sums, segs, seg_rows)
        out = sums.finish()
        dalpha, db1 = out["prelu"][:hidden], out["prelu"][hidden:]
        dnb, dls = out["norm"][:channels], out["norm"][channels]
        dte = out["te"].view(x.shape[0], channels) if c is not None else None
        k = dw_weight.shape[-1]
        conv = out["conv"]
        ddw = conv[:channels * k].view(dw_weight.shape)
        ddb, dscale, db2 = conv[channels * k:].view(3, channels).unbind(0)
        if scale is None:
            dscale = None
    return (dx, None, ddw, ddb, dnb, dls.reshape(log_scale.shape), dc, dte, dw1, db1, dalpha,
            dw2, db2, dscale, None)


class TrainChain(torch.autograd.Function):
    """A ConvNeXt block's train form from its input x (B, T, C), its mask
    (B, T, 1) or None, the depthwise conv's weight and bias, BiasNorm's
    bias and log-scale (limited), the cond projection c (B, >= ceil(T / f),
    C) and time projection te (B, C) or both None, pwconv1's and pwconv2's
    weights and biases, PReLU's alpha, the residual scale (limited) or None,
    and the cond's factor f; see the module's docstring."""

    @staticmethod
    def forward(ctx, x, mask, dw_weight, dw_bias, norm_bias, log_scale, c, te, w1, b1, alpha, w2,
                b2, scale, f):
        y = chain.norm_film(x, mask, dw_weight, dw_bias, norm_bias, log_scale, c, te, f)
        h1 = F.linear(y, w1, b1)
        out = chain.linear_residual(prelu_out(h1, alpha), w2, b2, x, scale)
        ctx.f = f
        ctx.save_for_backward(x, mask, dw_weight, dw_bias, norm_bias, log_scale, c, te, w1, alpha,
                              w2, scale, y, h1)
        return out

    @staticmethod
    def backward(ctx, g):
        return _backward(*ctx.saved_tensors, g, ctx.f)

