"""The port's training path against the JAX package: the iSTFT's adjoint and
its autograd rule, the parameter limiter, branch dropout, the FM loss and its
parameter gradients.

Draws are passed in on both sides: t, x0 and the limiters' gates (the JAX
side's `_gate` patched to a constant), with branch dropout and mel noise
off on the JAX side. Gradients are compared with respect to real tensors
(the packed decoder output or the parameters), never a complex one: JAX and
PyTorch use conjugate conventions there. Tolerances, relative to the
reference's max |.| (or, for a gradient tensor, its norm): 5e-6 for the
adjoint against autograd and the kernel's mirror, 1e-5 for the iSTFT's
gradient against JAX's custom VJP and for the losses, 1e-4 for parameter
gradients (float32 through 2-3 branches of several ConvNeXt layers and
backward, summed in other orders).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow2gan_tpu.models import build_generator as j_build_generator
from flow2gan_tpu.models import norms as jnorms
from flow2gan_tpu.models.config import get_generator_config as j_get_config
from flow2gan_tpu.ops import mel as jmel
from flow2gan_tpu.ops import stft as jstft
from flow2gan_tpu.ops.pallas_istft import istft_pallas

from flow2gan_tpu_torch.compat.from_jax import jax_params_to_state_dict, load_jax_params
from flow2gan_tpu_torch.models import FMDraws, build_generator, get_generator_config, norms
from flow2gan_tpu_torch.models.generator import branch_dropout_weight
from flow2gan_tpu_torch.ops import fused_istft as fused
from flow2gan_tpu_torch.ops import mel as pmel
from flow2gan_tpu_torch.ops import stft as pstft

from .test_torch_port_ops import H100_SMS

ADJOINT_CASES = [  # (n_fft, hop, t_f, length)
    (512, 256, 20, None), (256, 128, 33, 5000), (128, 64, 33, 1000), (64, 32, 17, None),
    (1024, 256, 3, 900), (1024, 64, 12, 700), (128, 64, 1, 64), (512, 256, 2, 256),
]


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-12)


def _complex(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


# ------------------------------------------------------------ the adjoint


@pytest.mark.parametrize("n_fft,hop,t_f,length", ADJOINT_CASES)
def test_istft_adjoint_matches_autograd(n_fft, hop, t_f, length):
    rng = np.random.RandomState(t_f)
    spec = torch.from_numpy(_complex(rng, 2, t_f, n_fft // 2 + 1)).requires_grad_()
    y = pstft.istft(spec, n_fft, hop, length=length)
    g = torch.from_numpy(rng.randn(*y.shape).astype(np.float32))
    (y * g).sum().backward()
    ours = pstft.istft_adjoint(g, t_f, n_fft, hop)
    assert ours.dtype == torch.complex64 and ours.shape == spec.shape
    assert _rel_err(ours.numpy(), spec.grad.numpy()) < 5e-6 or not spec.grad.abs().max()


@pytest.mark.parametrize("n_fft,hop,t_f,length", ADJOINT_CASES)
def test_istft_adjoint_dot_product_identity(n_fft, hop, t_f, length):
    """<istft(s), g> = <s, istft_adjoint(g)>, with <s, G> = Re s . Re G +
    Im s . Im G over the spectrogram's real and imaginary parts."""
    rng = np.random.RandomState(t_f + 1)
    spec = _complex(rng, 3, t_f, n_fft // 2 + 1)
    y = pstft.istft(torch.from_numpy(spec), n_fft, hop, length=length).numpy().astype(np.float64)
    g = rng.randn(*y.shape)
    adj = pstft.istft_adjoint(torch.from_numpy(g.astype(np.float32)), t_f, n_fft, hop).numpy()
    lhs = (y * g).sum()
    rhs = (spec.real.astype(np.float64) * adj.real + spec.imag.astype(np.float64) * adj.imag).sum()
    assert abs(lhs - rhs) <= 1e-5 * (np.abs(y * g).sum() + 1e-12)


def _omega(e: int, radix: int, c16) -> np.complex64:
    """e^{-2 pi i e / radix} as the kernel builds it from the table's cos/sin
    of 2 pi / 16, 2 pi 2/16, 2 pi 3/16 (c16): quarter turns are exact."""
    q, r = divmod(e * 16 // radix, 4)
    c, s = [(np.float32(1), np.float32(0)), *c16][r]
    for _ in range(q % 4):
        c, s = -s, c
    return np.complex64(c - 1j * s)


def _dft(x: list, c16) -> list:
    """The kernel's in-register forward DFT of radix 2, 4, 8 or 16: radix 8
    and 16 as 2 x 4 and 4 x 4, inner radix 4 over x[n1 + r1 n2], the
    twiddle e^{-2 pi i n1 k2 / radix}, outer radix r1, out[k2 + 4 k1]."""
    radix = len(x)
    if radix == 2:
        return [x[0] + x[1], x[0] - x[1]]
    if radix == 4:
        a, b, c, d = x
        return [(a + c) + (b + d), (a - c) - 1j * (b - d), (a + c) - (b + d), (a - c) + 1j * (b - d)]
    r1 = radix // 4
    inner = [_dft([x[n1 + r1 * n2] for n2 in range(4)], c16) for n1 in range(r1)]
    out = [None] * radix
    for k2 in range(4):
        col = [inner[n1][k2] * _omega(n1 * k2, radix, c16) if n1 * k2 else inner[n1][k2]
               for n1 in range(r1)]
        for k1, v in enumerate(_dft(col, c16)):
            out[k2 + 4 * k1] = v
    return out


def _register_fft(z: np.ndarray, n_fft: int) -> np.ndarray:
    """The adjoint kernel's forward M-point FFT (M = n_fft/2) of each row of
    z, as a warp computes it: lane jl < L = M/16 of a frame holds z[jl + L p]
    in register p < 16. Stockham passes, radix 16 first, then the remainder
    radix (2, 4 or 8): a lane's butterflies t = jl + L i take registers
    i + k * 16/radix; output j, times e^{-2 pi i j base / M} (base = s (t div
    s), from the table), goes through the warp's exchange buffer to
    position radix * base + t mod s + j s, and is read back as z[jl + L p]."""
    twiddles, _ = fused.kernel_tables_np(n_fft)
    half = (twiddles[:, 0] + 1j * twiddles[:, 1]).astype(np.complex64)
    circle = np.concatenate([half, -half])  # e^{2 pi i x / N}, x < N
    c16 = [tuple(twiddles[e * n_fft // 16]) for e in (1, 2, 3)]
    m_pts, points = n_fft // 2, fused.ADJOINT_POINTS
    lanes = m_pts // points
    log2m = int(np.log2(m_pts))
    radices = [16] * (log2m // 4) + ([1 << log2m % 4] if log2m % 4 else [])
    jl = np.arange(lanes)
    regs = [z[..., jl + lanes * p] for p in range(points)]
    s = 1
    for radix in radices:
        per_lane = points // radix
        exchange = np.full_like(z, np.nan)
        for i in range(per_lane):
            t = jl + lanes * i
            base = s * (t // s)
            ys = _dft([regs[i + k * per_lane] for k in range(radix)], c16)
            for j, y in enumerate(ys):
                exchange[..., radix * base + t % s + j * s] = (
                    y if j == 0 else y * np.conj(circle[2 * j * base % n_fft]))
        regs = [exchange[..., jl + lanes * p] for p in range(points)]
        s *= radix
    assert s == m_pts and not np.isnan(exchange).any()
    return exchange


def _slot_span(first: int, idx0: int, count: int, out_len: int):
    """(q, lo, hi, bulk_lo, bulk_hi) of a span in a ring slot (the kernel's
    `slot_span`): slot[x] holds element idx0 + x - q of an array whose element
    0 sits at `first` on the 16-byte grid; [lo, hi) is the part inside [0,
    out_len), [bulk_lo, bulk_hi) its whole 16-byte units."""
    q = (first + idx0) % 4
    lo = max(idx0, 0) - idx0 + q
    hi = max(min(idx0 + count, out_len) - idx0 + q, lo)
    bulk_lo = min(-(-lo // 4) * 4, hi)
    bulk_hi = max(hi // 4 * 4, bulk_lo)
    assert bulk_lo == bulk_hi or bulk_lo % 4 == bulk_hi % 4 == 0
    assert bulk_lo - lo < 4 and hi - bulk_hi < 4
    return q, lo, hi, bulk_lo, bulk_hi


def _adjoint_form(g: np.ndarray, plan: fused.AdjointPlan, offset: int = 0) -> np.ndarray:
    """The adjoint kernel in numpy on its work map. Each block walks its
    items; the producer copies the item's in-range span of g, and the
    envelope's, into a ring slot, each shifted onto the 16-byte grid (a
    bulk copy of whole 16-byte units, a head and a tail of under 4; offset:
    g's first element's place on that grid); the consumer warps divide the
    span by the envelope there, each sample once, zero outside [0, out_len);
    they take the item's groups of frames_per_warp frames, group g of the
    block's running count to warp g % ADJOINT_WARPS, and pack each frame
    from the slot times the window (1/N in it), z[m] = u[2m] + i u[2m+1];
    then `_register_fft` and the Hermitian unpack in pairs: bins k and M - k
    (k < M/2) from Z[k] and Z[M - k], DC and Nyquist (real) from Z[0], and
    bin M/2. Every bin is written once."""
    n_fft, hop, m, t_f = plan.n_fft, plan.hop, plan.m_pts, plan.t_f
    twiddles, window = fused.kernel_tables_np(n_fft)
    batch, length = g.shape
    out_len = min(length, (t_f - 1) * hop)
    env = pstft._istft_envelope(t_f, n_fft, hop)
    flat = g.ravel()
    owner = np.full((batch, t_f), -1)
    u = np.zeros((batch, t_f, n_fft), np.float32)
    for block in range(plan.blocks):
        groups = 0
        for w in range(block, plan.items, plan.blocks):
            b, tile = divmod(w, plan.tiles)
            f0 = tile * plan.frames_per_tile
            nc = min(plan.frames_per_tile, t_f - f0)
            idx0, count = f0 * hop - m, (nc - 1) * hop + n_fft
            slots = []
            for first, src in [(offset + b * length, flat[b * length : (b + 1) * length]), (0, env)]:
                q, lo, hi, _, _ = _slot_span(first, idx0, count, out_len)
                slot = np.full(plan.stage_floats, np.nan, np.float32)
                slot[lo:hi] = src[idx0 - q + np.arange(lo, hi)]
                slots.append(slot[q : q + count])
            sig, envs = slots
            idx = idx0 + np.arange(count)
            ok = (idx >= 0) & (idx < out_len)
            assert not np.isnan(sig[ok]).any() and not np.isnan(envs[ok]).any()
            sig = np.where(ok, sig / np.where(ok, envs, 1), 0).astype(np.float32)
            for gi in range(-(-nc // plan.frames_per_warp)):
                warp = (groups + gi) % fused.ADJOINT_WARPS
                for lf in range(gi * plan.frames_per_warp, min((gi + 1) * plan.frames_per_warp, nc)):
                    assert owner[b, f0 + lf] == -1
                    owner[b, f0 + lf] = block * fused.ADJOINT_WARPS + warp
                    u[b, f0 + lf] = sig[lf * hop + np.arange(n_fft)] * window
            groups += -(-nc // plan.frames_per_warp)
    assert (owner >= 0).all()
    z = _register_fft((u[..., 0::2] + 1j * u[..., 1::2]).astype(np.complex64), n_fft)
    k = np.arange(1, m // 2 + 1)
    w = (twiddles[k, 0] - 1j * twiddles[k, 1]).astype(np.complex64)  # e^{-2 pi i k/N}
    a, c = z[..., k], np.conj(z[..., m - k])
    total, wd = a + c, w * (a - c)  # G[k] = total - i wd
    out = np.full((batch, t_f, m + 1), np.nan, np.complex64)
    out[..., k] = (total.real + wd.imag) + 1j * (total.imag - wd.real)
    # e^{-2 pi i (M-k)/N} = -conj w, so G[M - k] = conj(total) - i conj(wd)
    out[..., m - k[:-1]] = (total.real - wd.imag)[..., :-1] + 1j * (-total.imag - wd.real)[..., :-1]
    out[..., 0] = z[..., 0].real + z[..., 0].imag
    out[..., m] = z[..., 0].real - z[..., 0].imag
    return out


def test_register_fft_matches_numpy():
    """The in-register passes give the forward FFT at every supported N."""
    rng = np.random.RandomState(0)
    for n_fft in fused.N_FFTS:
        z = _complex(rng, 5, n_fft // 2)
        ref = np.fft.fft(z.astype(np.complex128))
        assert np.abs(_register_fft(z, n_fft) - ref).max() < 5e-6 * np.abs(ref).max()


@pytest.mark.parametrize("n_fft,hop,t_f,length", ADJOINT_CASES)
@pytest.mark.parametrize("frames_per_tile", [None, 1, 5])
def test_adjoint_kernel_formulation_matches_plain(n_fft, hop, t_f, length, frames_per_tile):
    """The adjoint kernel's work map, ring slots, register FFT and unpack
    reproduce the plain adjoint, at the card's plan and at forced tile sizes
    on one or two SMs (so that blocks walk many items and the ring wraps),
    with g off the 16-byte grid; DC and Nyquist come out real."""
    rng = np.random.RandomState(n_fft + t_f)
    length_ = (t_f - 1) * hop if length is None else length
    g = rng.randn(3, length_).astype(np.float32)
    sm_count = {None: H100_SMS, 1: 1, 5: 2}[frames_per_tile]
    plan = fused.adjoint_plan(3, t_f, n_fft, hop, sm_count, frames_per_tile)
    ours = _adjoint_form(g, plan, offset=t_f % 4)
    ref = pstft.istft_adjoint(torch.from_numpy(g), t_f, n_fft, hop).numpy()
    assert np.isfinite(ours).all()
    assert _rel_err(ours, ref) < 5e-6 or not np.abs(ref).max()
    assert not ours[..., [0, -1]].imag.any()


# (n_fft, hop, batch, t_f): the main path's shapes at batch 16, a training
# step's at the reference's FM batch per card (256), a GAN rollout step's at
# its fine-tuning batch (64)
PLAN_SHAPES = [
    (512, 256, 16, 95), (256, 128, 16, 189), (128, 64, 16, 377), (1024, 512, 16, 88),
    (512, 256, 16, 175), (256, 128, 16, 349),
    (512, 256, 256, 141), (256, 128, 256, 282), (128, 64, 256, 563),
    (512, 256, 64, 142), (256, 128, 64, 283), (128, 64, 64, 565),
]


@pytest.mark.parametrize("n_fft,hop,batch,t_f", PLAN_SHAPES)
def test_adjoint_plan_covers_every_frame_once(n_fft, hop, batch, t_f):
    """Every (b, frame) lies in exactly one work item, the persistent blocks
    are at most ADJOINT_BLOCKS_PER_SM per SM, each block takes 2 to
    ADJOINT_MAX_STAGES ring slots within the block limit, that many blocks
    fit on an SM, and a tile is at most one group for each consumer warp:
    the fewest tiles that allows where the work fills the blocks, smaller
    ones at a small batch."""
    plan = fused.adjoint_plan(batch, t_f, n_fft, hop, H100_SMS)
    seen = np.zeros((batch, t_f), int)
    for block in range(plan.blocks):
        for w in range(block, plan.items, plan.blocks):
            b, tile = divmod(w, plan.tiles)
            seen[b, tile * plan.frames_per_tile : (tile + 1) * plan.frames_per_tile] += 1
    assert (seen == 1).all()
    assert plan.blocks <= H100_SMS * fused.ADJOINT_BLOCKS_PER_SM
    assert plan.blocks == min(plan.items, H100_SMS * fused.ADJOINT_BLOCKS_PER_SM)
    assert 2 <= plan.stages <= fused.ADJOINT_MAX_STAGES
    assert plan.smem_bytes <= 227 * 1024
    assert fused.ADJOINT_BLOCKS_PER_SM * (plan.smem_bytes + 1024) <= fused.SM_SHARED_BYTES
    assert plan.frames_per_tile % plan.frames_per_warp == 0
    assert plan.frames_per_tile <= fused.ADJOINT_WARPS * plan.frames_per_warp
    most, capacity = fused.ADJOINT_WARPS * plan.frames_per_warp, H100_SMS * fused.ADJOINT_BLOCKS_PER_SM
    if batch * t_f >= most * capacity:  # enough work: a full group for each consumer warp
        assert plan.tiles == -(-t_f // most)
    else:  # a small batch: smaller tiles, so that most blocks have an item
        assert 2 * plan.items > capacity
    assert plan.frames_per_warp * plan.m_pts == 32 * fused.ADJOINT_POINTS


# --------------------------------------------------- the iSTFT's autograd


@pytest.mark.parametrize("n_fft,hop", [(512, 256), (256, 128), (1024, 256)])
@pytest.mark.parametrize("length", [None, "pad", "trim"])
def test_fused_istft_grad_matches_jax_pallas_vjp(n_fft, hop, length):
    """The gradient with respect to the packed real decoder output through
    `fused_istft` (the `FusedISTFT` rule) against `jax.grad` through the
    Pallas kernel in interpret mode (its custom VJP)."""
    rng = np.random.RandomState(n_fft + hop)
    t_f = 24
    x = rng.randn(2, t_f, n_fft + 2).astype(np.float32)
    default = (t_f - 1) * hop
    length = {None: None, "pad": default + 300, "trim": default - 500}[length]
    w = rng.randn(2, default if length is None else length).astype(np.float32)

    def j_loss(xj):
        return jnp.sum(istft_pallas(jstft.real_to_spec(xj), n_fft, hop, length, True) * w)

    ref = np.asarray(jax.grad(j_loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    out = fused.fused_istft(pstft.real_to_spec(xt), n_fft, hop, length=length)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "FusedISTFTBackward"
    (out * torch.from_numpy(w)).sum().backward()
    assert _rel_err(xt.grad.numpy(), ref) < 1e-5


def test_fused_istft_backward_saves_shapes_and_takes_strided_grads():
    """The rule saves no tensor (the iSTFT is linear), and a gradient that
    arrives strided (here through a transpose) gives what a contiguous one
    does."""
    rng = np.random.RandomState(0)
    spec = torch.from_numpy(_complex(rng, 3, 9, 129)).requires_grad_()
    out = fused.fused_istft(spec, 256, 128)
    assert out.grad_fn.saved_tensors == ()
    w = torch.from_numpy(rng.randn(out.shape[1], 3).astype(np.float32))
    (out.t() * w).sum().backward()
    ref = pstft.istft_adjoint(w.t().contiguous(), 9, 256, 128)
    torch.testing.assert_close(spec.grad, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        fused.istft_adjoint_kernel(w.t().contiguous(), 9, 256, 128)


# ------------------------------------------------------------ the limiter


@pytest.mark.parametrize("gate", [0.0, 1.0])
def test_limit_param_value_matches_jax(gate):
    """Identity forward; the gradient's sign flips below lo (positive
    gradients) and above hi (negative ones) only while the gate is on."""
    x = np.asarray([-2.0, -1.6, -1.5, 0.0, 1.4, 1.5, 1.7, 3.0] * 2, np.float32)
    g = np.asarray([1.0] * 8 + [-1.0] * 8, np.float32) * np.random.RandomState(1).rand(16).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jnorms._limit_value(v, jnp.float32(gate), -1.5, 1.5), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    y = norms.limit_param_value(xt, -1.5, 1.5, torch.tensor(gate))
    np.testing.assert_array_equal(y.detach().numpy(), x)
    y.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), ref)
    assert (xt.grad.numpy() != g).any() == bool(gate)
    assert norms.limit_param_value(xt, -1.5, 1.5, None) is xt


def test_linear_fbanks_match_jax():
    for args in [(513, 0.0, 12000.0, 256, 24000), (129, 0.0, 12000.0, 64, 24000),
                 (1025, 0.0, 22050.0, 256, 44100)]:
        np.testing.assert_array_equal(pmel.linear_fbanks(*args), jmel.linear_fbanks(*args))


def test_branch_dropout_weight():
    """The JAX package's weighting for given draws: for a dropped example,
    its chosen branch is zeroed and the others scaled by nb / (nb - 1); the
    fused output is the mean of the weighted branch outputs."""
    idx = torch.tensor([0, 2, 1, 2])
    drop = torch.tensor([[True], [False], [True], [True]])
    weight = branch_dropout_weight(idx, drop, 3).numpy()
    ref = np.ones((4, 3), np.float32)
    ref[np.arange(4), idx.numpy()] = 0.0
    ref = np.where(drop.numpy(), ref * 1.5, 1.0)
    np.testing.assert_array_equal(weight, ref)

    model = _pair("tiny")[2]
    rng = np.random.RandomState(3)
    x = torch.from_numpy((0.1 * rng.randn(2, 1280)).astype(np.float32))
    cond = model._encode_cond(torch.from_numpy(rng.randn(2, 20, 20).astype(np.float32)))
    t = torch.tensor([0.2, 0.7])
    w = branch_dropout_weight(torch.tensor([1, 0]), torch.tensor([[True], [True]]), 2)
    with torch.no_grad():
        branches = torch.stack([est(x, cond, t) for est in model.estimators], dim=1)
        fused_out = model.process_model(x, cond, t, branch_weight=w)
    torch.testing.assert_close(fused_out, (branches * w[..., None]).mean(dim=1), rtol=0, atol=0)
    torch.testing.assert_close(fused_out, branches[:, [0, 1], :][torch.arange(2), [0, 1]],
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------- the model and its loss


TINY = dict(get_generator_config("mel_24k_tiny"), branch_dropout=0.0)
# full width, one layer per stack
BASE_ONE_LAYER = dict(get_generator_config("mel_24k_base"), num_layers=(1, 1, 1),
                      cond_enc_num_layers=1, branch_dropout=0.0)
_CONFIGS = {"tiny": TINY, "base_one_layer": BASE_ONE_LAYER,
            "tiny_plain_loss": dict(TINY, spec_scaling_loss=False, pred_x1=False)}


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX module, params, port model, config). The params are perturbed
    from a numpy seed, and the limited ones pushed past their bounds here
    and there, so that the limiter has gradients to flip."""
    cfg = _CONFIGS[name]
    jcfg = j_get_config("mel_24k_base")
    jcfg.update(cfg)
    jm = j_build_generator(jcfg)
    init = jax.jit(lambda rngs, cond: jm.init(rngs, cond, n_timesteps=1, method="infer"))
    params = init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                  jnp.zeros((1, cfg["n_mels"], 8)))["params"]
    rng = np.random.RandomState(7)
    spread = {"scale": 0.3, "log_scale": 0.6}

    def perturb(path, p):
        name = getattr(path[-1], "key", "")
        return (np.asarray(p) + spread.get(name, 0.005) * rng.randn(*np.shape(p))).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    return jm, params, load_jax_params(build_generator(cfg), params), cfg


def _jax_fm_loss(module, cond, x0, x1, t, lens):
    """The JAX package's FM loss (`MelAudioGenerator.__call__` and
    `flow_matching_loss`) with t and x0 given instead of drawn."""
    cond = module._encode_cond(cond, True)
    x = (1.0 - t[:, None]) * x0 + t[:, None] * x1
    ref = x1 if module.pred_x1 else x1 - x0
    pred = module.process_model(x=x, cond=cond, t=t, audio_lens=lens, train=True)
    return module.compute_loss(pred=pred, ref=ref, audio_lens=lens, gt_audio=x1)


def _inputs(cfg, batch, frames, seed):
    rng = np.random.RandomState(seed)
    length = frames * cfg["mel_hop_length"]
    tt = np.arange(length) / cfg["sampling_rate"]
    x1 = (0.3 * np.sin(2 * np.pi * 220.0 * tt) + 0.05 * rng.randn(batch, length)).astype(np.float32)
    return dict(cond=rng.randn(batch, cfg["n_mels"], frames).astype(np.float32),
                x0=(0.1 * rng.randn(batch, length)).astype(np.float32), x1=x1,
                t=rng.rand(batch).astype(np.float32),
                lens=np.asarray([length, length - 300][:batch], np.int32))


@pytest.mark.parametrize("name,batch,frames,gate", [
    ("tiny", 2, 20, 0.0), ("tiny", 2, 20, 1.0), ("tiny_plain_loss", 2, 12, 1.0),
    ("base_one_layer", 2, 12, 1.0),
])
def test_fm_loss_and_param_grads_match_jax(monkeypatch, name, batch, frames, gate):
    jm, params, model, cfg = _pair(name)
    monkeypatch.setattr(jnorms, "_gate", lambda module, train, prob=0.6:
                        jnp.float32(gate) if train else None)
    inp = _inputs(cfg, batch, frames, seed=frames)
    jargs = [jnp.asarray(inp[k]) for k in ("cond", "x0", "x1", "t", "lens")]
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, *a: jm.apply({"params": p}, *a, method=_jax_fm_loss)))(params, *jargs)

    model.zero_grad()
    draws = FMDraws(torch.from_numpy(inp["x0"]), torch.from_numpy(inp["t"]),
                    gates=torch.full((model.num_limiters,), gate))
    loss = model(torch.from_numpy(inp["cond"]), torch.from_numpy(inp["x1"]),
                 torch.from_numpy(inp["lens"]), draws)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    ref = jax_params_to_state_dict(j_grads)
    ours = dict(model.named_parameters())
    assert set(ours) == set(ref)
    worst = max(float((ours[k].grad - ref[k]).norm() / (ref[k].norm() + 1e-30)) for k in ref)
    assert worst < 1e-4, worst


def test_gates_reach_every_limiter_and_matter():
    """`draw` gives one gate per limiter; flipping every gate changes the
    gradient of a limited parameter that lies past its bound, and of no
    other kind of parameter."""
    _, _, model, cfg = _pair("tiny")
    assert model.num_limiters == sum(isinstance(m, norms.LIMITERS) for m in model.modules())
    indices = sorted(m.gate_index for m in model.modules() if isinstance(m, norms.LIMITERS))
    assert indices == list(range(model.num_limiters))
    inp = _inputs(cfg, 2, 20, seed=1)
    grads = {}
    for gate in (0.0, 1.0):
        model.zero_grad()
        draws = FMDraws(torch.from_numpy(inp["x0"]), torch.from_numpy(inp["t"]),
                        gates=torch.full((model.num_limiters,), gate))
        model(torch.from_numpy(inp["cond"]), torch.from_numpy(inp["x1"]),
              torch.from_numpy(inp["lens"]), draws).backward()
        grads[gate] = {k: p.grad.clone() for k, p in model.named_parameters()}
    changed = {k for k in grads[0.0] if not torch.equal(grads[0.0][k], grads[1.0][k])}
    assert changed and all(k.endswith((".scale", ".log_scale")) for k in changed)

    gen = torch.Generator().manual_seed(0)
    audio = torch.from_numpy(inp["x1"])
    train = model.draw(audio, 20, gen)
    assert train.gates.shape == (model.num_limiters,) and set(train.gates.tolist()) <= {0.0, 1.0}
    assert train.x0.shape == audio.shape and train.t.shape == (2,)
    evald = model.draw(audio, 20, gen, train=False)
    assert evald.gates is None and evald.branch_weight is None and evald.cond_noise is None
    noisy = build_generator(dict(cfg, max_add_noise_scale=0.5, branch_dropout=1.0))
    d = noisy.draw(audio, 20, gen)
    assert d.cond_noise.shape == (2, 20, cfg["n_mels"]) and d.branch_weight.shape == (2, 2)
    assert sorted(d.branch_weight.sum(dim=1).tolist()) == [2.0, 2.0]


def test_flow_matching_loss_draws_t_when_not_given():
    _, _, model, cfg = _pair("tiny")
    inp = _inputs(cfg, 2, 20, seed=2)
    cond = model._encode_cond(torch.from_numpy(inp["cond"]))
    args = (torch.from_numpy(inp["x0"]), torch.from_numpy(inp["x1"]), cond,
            torch.from_numpy(inp["lens"]))
    with torch.no_grad():
        drawn = model.flow_matching_loss(*args, generator=torch.Generator().manual_seed(3))
        given = model.flow_matching_loss(*args, t=torch.rand(2, generator=torch.Generator().manual_seed(3)))
        other = model.flow_matching_loss(*args, generator=torch.Generator().manual_seed(4))
    assert drawn.item() == given.item() != other.item()


@pytest.mark.parametrize("spec_scaling", [True, False])
def test_compute_loss_matches_jax(spec_scaling):
    name = "tiny" if spec_scaling else "tiny_plain_loss"
    jm, params, model, cfg = _pair(name)
    rng = np.random.RandomState(4)
    L = 3000
    pred, ref = (0.2 * rng.randn(2, L)).astype(np.float32), (0.2 * rng.randn(2, L)).astype(np.float32)
    lens = np.asarray([L, 2111], np.int32)
    j = jm.apply({"params": params}, jnp.asarray(pred), jnp.asarray(ref), jnp.asarray(lens),
                 jnp.asarray(ref), method="compute_loss")
    ours = model.compute_loss(torch.from_numpy(pred), torch.from_numpy(ref), torch.from_numpy(lens),
                              gt_audio=torch.from_numpy(ref))
    assert abs(ours.item() - float(j)) <= 1e-5 * abs(float(j))
