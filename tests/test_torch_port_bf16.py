"""The port's bfloat16 compute (`compute_dtype="bfloat16"`) against the JAX
package's, on the CPU, on the same weights (`load_jax_params`) and inputs.

The JAX side is compiled with XLA's `xla_allow_excess_precision` off, so that
it rounds every bfloat16 value where its program casts it, as eager PyTorch
does; XLA's CPU compiler otherwise keeps some casts' values in float32.

Errors are root-mean-square over the output (for gradients, over all of
them). The rule: the port-bf16 vs JAX-bf16 error is at most 1/4 of the
JAX-bf16 vs JAX-f32 error on the same inputs. The modules, given the same
inputs, meet it with room: they read exactly 0. End to end (the served
slice, the FM loss and its gradients) the float32 parts upstream of a
bfloat16 cast differ by their rounding order (the STFT's DFT matmul: XLA's
and torch's GEMMs, 4e-7 apart), which flips some casts by one bfloat16 ulp,
and the network carries the flips on. JAX against itself with x0 moved by
one float32 ulp (`_ulp_floor`) reads 0.38 of its own bf16 error at 2 steps,
so there the limit is 1/4 of JAX-bf16 vs JAX-f32 plus twice that floor.
Measured on the CPU: mel_24k_base (full width, one layer) 0.31 and 0.64 of
JAX's bf16 error at 1 and 2 steps, against floors of 0.16 and 0.38; the
tiny model's FM gradients 0.24 (floor 0.14), its loss 0.04.
"""

import functools

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import jax
import jax.numpy as jnp

from flow2gan_tpu.models import build_generator as j_build_generator
from flow2gan_tpu.models import convnext as jconv
from flow2gan_tpu.models import norms as jnorms
from flow2gan_tpu.models.config import get_generator_config as j_get_config

from flow2gan_tpu_torch.compat.from_jax import jax_params_to_state_dict, load_jax_params
from flow2gan_tpu_torch.models import FMDraws, build_generator, convnext, get_generator_config

from .test_torch_port_train import _inputs, _jax_fm_loss
from .test_torch_port_train import _pair as _train_pair

# compile the JAX side so that each bfloat16 value is rounded where it is cast
_JIT = functools.partial(jax.jit, compiler_options={"xla_allow_excess_precision": False})
BF16 = torch.bfloat16


def _rms(a, b) -> float:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(d * d)))


def _perturbed(params, seed, scale=0.02):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda p: (np.asarray(p) + scale * rng.randn(*np.shape(p))).astype(np.float32), params)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


# ------------------------------------------------------------------ modules


def _module_case(kind, rng):
    """(JAX f32 module, JAX bf16 module, port bf16 module, inputs, whether the
    inputs arrive in bf16): each module as the model feeds it, the blocks with
    bf16 activations, the encoder and decoder with float32 ones."""
    if kind == "dwconv":
        x = rng.randn(2, 37, 48).astype(np.float32)
        return (jconv.DepthwiseConv1d(48, impl="conv"),
                jconv.DepthwiseConv1d(48, dtype=jnp.bfloat16, impl="conv"),
                convnext.DepthwiseConv1d(48, dtype=BF16), (x,), True)
    if kind.startswith("block"):
        factor = 2 if kind.endswith("2") else 1
        T, C = 37, 48
        x = rng.randn(2, T, C).astype(np.float32)
        cond = rng.randn(2, -(-T // factor), 32).astype(np.float32)
        temb = rng.randn(2, 16).astype(np.float32)
        mask = (np.arange(T)[None, :, None] < np.asarray([T, 25])[:, None, None]).astype(np.float32)
        kw = dict(use_cond=True, use_time=True, cond_upsample_factor=factor)
        return (jconv.ConvNeXtBlock(C, 3 * C, **kw),
                jconv.ConvNeXtBlock(C, 3 * C, dtype=jnp.bfloat16, **kw),
                convnext.ConvNeXtBlock(C, 3 * C, conditioned=True, cond_channels=32,
                                       time_embed_channels=16, cond_upsample_factor=factor,
                                       dtype=BF16),
                (x, cond, temb, mask), True)
    if kind == "encoder":
        x = rng.randn(2, 29, 20).astype(np.float32)
        kw = dict(cond_dim=20, channels=48, num_layers=2)
        return (jconv.CondEncoder(**kw), jconv.CondEncoder(**kw, dtype=jnp.bfloat16),
                convnext.CondEncoder(**kw, dtype=BF16), (x,), False)
    factor = 2 if kind.endswith("2") else 1
    T = 41
    x = rng.randn(2, T, 66).astype(np.float32)
    cond = rng.randn(2, -(-T // factor) + 1, 48).astype(np.float32)
    t = np.asarray([0.0, 0.5], np.float32)
    mask = (np.arange(T)[None, :, None] < np.asarray([T, 30])[:, None, None]).astype(np.float32)
    kw = dict(in_channels=66, out_channels=66, channels=64, cond_channels=48,
              time_embed_channels=32, num_layers=2, cond_upsample_factor=factor)
    return (jconv.ConvNeXtDecoder(**kw), jconv.ConvNeXtDecoder(**kw, dtype=jnp.bfloat16),
            convnext.ConvNeXtDecoder(**kw, dtype=BF16), (x, cond, t, mask), False)


@pytest.mark.parametrize("kind", ["dwconv", "block", "block_factor2", "encoder", "decoder",
                                  "decoder_factor2"])
def test_module_bf16_matches_jax(kind):
    j32, j16, pm, inputs, bf16_in = _module_case(kind, np.random.RandomState(len(kind)))
    if bf16_in:  # an activation, bf16 like the model's; the mask stays float32
        inputs = tuple(np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
                       if i < 3 else a for i, a in enumerate(inputs))
    params = _perturbed(j32.init(jax.random.PRNGKey(0), *inputs)["params"], 3)

    def run(module, cast):
        def f(p, *a):
            a = [x.astype(jnp.bfloat16) if cast and i < 3 else x for i, x in enumerate(a)]
            return module.apply({"params": p}, *a).astype(jnp.float32)
        return np.asarray(_JIT(f)(params, *inputs))

    ref32, ref16 = run(j32, False), run(j16, bf16_in)
    pm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    t_in = [torch.from_numpy(a) for a in inputs]
    if bf16_in:
        t_in = [a.to(BF16) if i < 3 else a for i, a in enumerate(t_in)]
    with torch.no_grad():
        ours = pm(*t_in)
    assert ours.dtype == (BF16 if kind in ("dwconv", "block", "block_factor2", "encoder")
                          else torch.float32)
    err, noise = _rms(_np(ours), ref16), _rms(ref16, ref32)
    assert noise > 0 and err <= noise / 4, (err, noise)


# ----------------------------------------------------------- the served slice


BASE_SHALLOW = dict(get_generator_config("mel_24k_base"), num_layers=(1, 1, 1),
                    cond_enc_num_layers=1)


@functools.lru_cache(maxsize=None)
def _base_pair():
    """JAX float32 and bf16 modules of full-width one-layer mel_24k_base, the
    perturbed params, and the port's bf16 model on them."""
    jcfg = j_get_config("mel_24k_base")
    jcfg.update(BASE_SHALLOW)
    j32, j16 = j_build_generator(jcfg), j_build_generator(dict(jcfg, compute_dtype="bfloat16"))
    init = jax.jit(lambda rngs, cond: j32.init(rngs, cond, n_timesteps=1, method="infer"))
    params = init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                  jnp.zeros((1, 100, 8)))["params"]
    params = _perturbed(params, 7, 0.005)
    pm = load_jax_params(build_generator(dict(BASE_SHALLOW, compute_dtype="bfloat16")), params)
    return j32, j16, params, pm.eval()


def _ulp_floor(fn, x0: np.ndarray, ref: np.ndarray) -> float:
    """How far JAX's bf16 result moves when x0 moves by one float32 ulp, up
    or down: the larger of the two."""
    return max(_rms(fn(np.nextafter(x0, np.float32(to)).astype(np.float32)), ref)
               for to in (np.inf, -np.inf))


@pytest.mark.parametrize("n_timesteps", [1, 2])
def test_infer_from_noise_bf16_matches_jax(n_timesteps):
    j32, j16, params, pm = _base_pair()
    assert all(p.dtype == torch.float32 for p in pm.parameters())
    rng = np.random.RandomState(n_timesteps)
    frames = 16
    cond = rng.randn(2, 100, frames).astype(np.float32)
    noise = (0.1 * rng.randn(2, frames * 256)).astype(np.float32)

    def jax_fn(module):
        f = _JIT(lambda p, x0, c: module.apply({"params": p}, x0, c, n_timesteps=n_timesteps,
                                               clamp_pred=False, method="infer_from_noise"))
        return lambda x0: np.asarray(f(params, x0, cond))

    f16 = jax_fn(j16)
    ref16, ref32 = f16(noise), jax_fn(j32)(noise)
    with torch.no_grad():
        ours = pm.infer_from_noise(torch.from_numpy(noise), torch.from_numpy(cond),
                                   n_timesteps=n_timesteps)
    assert ours.dtype == torch.float32
    err, noise_err, floor = _rms(_np(ours), ref16), _rms(ref16, ref32), _ulp_floor(f16, noise, ref16)
    assert err <= noise_err / 4 + 2 * floor, (err, noise_err, floor)


# ------------------------------------------------------- the FM loss, trained


@functools.lru_cache(maxsize=None)
def _tiny_pair():
    """JAX float32 and bf16 modules of mel_24k_tiny, the parameters of
    `test_torch_port_train.py` (limited ones pushed past their bounds here
    and there, so that the gates matter), and the port's bf16 model on them."""
    j32, params, _, cfg = _train_pair("tiny")
    jcfg = j_get_config("mel_24k_base")
    jcfg.update(cfg)
    j16 = j_build_generator(dict(jcfg, compute_dtype="bfloat16"))
    pm = load_jax_params(build_generator(dict(cfg, compute_dtype="bfloat16")), params)
    return j32, j16, params, pm, cfg


@pytest.mark.parametrize("gate", [0.0, 1.0])
def test_fm_loss_and_grads_bf16_match_jax(monkeypatch, gate):
    """The loss and every parameter's gradient, with t, x0, the gates and
    (no) branch dropout given as `FMDraws`."""
    j32, j16, params, pm, cfg = _tiny_pair()
    monkeypatch.setattr(jnorms, "_gate", lambda module, train, prob=0.6:
                        jnp.float32(gate) if train else None)
    inp = _inputs(cfg, 2, 20, seed=3)
    rest = [jnp.asarray(inp[k]) for k in ("cond", "x1", "t", "lens")]

    def jax_fn(module):
        f = _JIT(jax.value_and_grad(lambda p, cond, x0, x1, t, lens: module.apply(
            {"params": p}, cond, x0, x1, t, lens, method=_jax_fm_loss)))

        def run(x0):
            loss, grads = f(params, rest[0], jnp.asarray(x0), *rest[1:])
            sd = jax_params_to_state_dict(grads)
            return float(loss), np.concatenate([sd[k].numpy().ravel() for k in sorted(sd)])
        return run

    f16 = jax_fn(j16)
    (l16, g16), (l32, g32) = f16(inp["x0"]), jax_fn(j32)(inp["x0"])
    pm.zero_grad()
    draws = FMDraws(torch.from_numpy(inp["x0"]), torch.from_numpy(inp["t"]),
                    gates=torch.full((pm.num_limiters,), gate))
    loss = pm(torch.from_numpy(inp["cond"]), torch.from_numpy(inp["x1"]),
              torch.from_numpy(inp["lens"]), draws)
    loss.backward()
    grads = dict(pm.named_parameters())
    ours = np.concatenate([grads[k].grad.numpy().ravel() for k in sorted(grads)])
    floors = [f16(np.nextafter(inp["x0"], np.float32(to)).astype(np.float32))
              for to in (np.inf, -np.inf)]
    loss_floor = max(abs(l - l16) for l, _ in floors)
    grad_floor = max(_rms(g, g16) for _, g in floors)
    assert abs(loss.item() - l16) <= abs(l16 - l32) / 4 + 2 * loss_floor
    err, noise = _rms(ours, g16), _rms(g16, g32)
    assert noise > 0 and err <= noise / 4 + 2 * grad_floor, (err, noise, grad_floor)


# ------------------------------------------------------- where bf16 is used


class _Record(TorchFunctionMode):
    """The dtypes of every GEMM's operands, and of rsqrt's (BiasNorm's
    statistics), in what runs under it."""

    NAMES = {"linear": "linear", "conv1d": "conv1d", "matmul": "matmul",
             "__matmul__": "matmul", "rsqrt": "rsqrt"}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = self.NAMES.get(getattr(func, "__name__", ""))
        if name:
            self.seen.append((name, args[0].dtype, args[1].dtype if name != "rsqrt" else None))
        return func(*args, **(kwargs or {}))


def test_bf16_is_where_the_jax_package_puts_it():
    """Every GEMM of the encoder and the decoders takes bf16 operands; the
    STFT's DFT matmuls, BiasNorm's statistics, the iSTFT's input, the Euler
    state and the output stay float32; the parameters stay float32 (the
    counterpart of tests/test_generator.py's `test_compute_dtype_bf16_inside`)."""
    model = build_generator(dict(get_generator_config("mel_24k_tiny"), compute_dtype="bfloat16"))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    decoder_out, euler = [], []
    for est in model.estimators:  # the decoder's output is the iSTFT's input
        est.decoder.register_forward_hook(lambda m, i, out: decoder_out.append(out.dtype))
    process_model = model.process_model

    def recorded(x, *args, **kw):
        out = process_model(x, *args, **kw)
        euler.extend([x.dtype, out.dtype])
        return out

    model.process_model = recorded
    rng = np.random.RandomState(0)
    record = _Record()
    with torch.no_grad(), record:
        out = model.infer_from_noise(torch.from_numpy((0.1 * rng.randn(2, 640)).astype(np.float32)),
                                     torch.from_numpy(rng.randn(2, 20, 10).astype(np.float32)),
                                     n_timesteps=2)
    assert out.dtype == torch.float32
    assert decoder_out == [torch.float32] * 4 and set(euler) == {torch.float32}
    by = {}
    for name, a, b in record.seen:
        by.setdefault(name, set()).add((a, b))
    assert by["linear"] == {(BF16, BF16)}  # every pointwise conv, MLP and projection
    assert by["conv1d"] == {(BF16, BF16)}  # the encoder's k=3 conv and every depthwise conv
    assert by["matmul"] == {(torch.float32, torch.float32)}  # the STFT and the plain iSTFT
    assert by["rsqrt"] == {(torch.float32, None)}  # BiasNorm's statistics
    # every block and projection of the encoder and the two decoders
    n_linear = sum(isinstance(m, torch.nn.Linear) for m in model.cond_encoder.modules()) + 2 * sum(
        isinstance(m, torch.nn.Linear) for est in model.estimators for m in est.modules())
    assert sum(name == "linear" for name, _, _ in record.seen) == n_linear
