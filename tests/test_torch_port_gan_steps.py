"""The port's GAN steps against the JAX package's on the CPU: the train-form
Euler rollout and its parameter gradients, the D and G objectives of
`make_gan_loss_fns`, and one D step and one G step of `make_gan_steps`; then
port-only checks of the steps: per-step gates, which side each step moves,
the D step's rollout without a graph, and remat against plain.

Small sizes, as the JAX package's GAN tests use them: mel_24k_tiny (branch
dropout off) and `Discriminators(periods=(2, 3), fft_sizes=(256, 128))`, at
batch 2 x 4096. Draws are passed in on both sides: the JAX side's `_gate` is
patched to a constant, and its x0 is drawn as `infer` draws it, from the key
of `_rollout`'s "noise" stream (a test holds the reproduction against
JAX's own eval rollout). Tolerances, relative to the reference's max |.| (a
gradient tensor: its norm): 1e-4 for rollouts and gradients, 1e-5 for
losses, and 1e-4 of the delta's norm for one optimizer step's parameter
deltas.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow2gan_tpu.models import discriminators as jd
from flow2gan_tpu.models import gan as jgan
from flow2gan_tpu.models import norms as jnorms
from flow2gan_tpu.ops import mel as jmel
from flow2gan_tpu.training import gan_step as jgs
from flow2gan_tpu.training.optim import eden2_lr as j_eden2_lr
from flow2gan_tpu.training.optim import scaled_adam as j_scaled_adam

from flow2gan_tpu_torch.compat.from_jax import jax_params_to_state_dict, load_jax_params
from flow2gan_tpu_torch.models import RolloutDraws
from flow2gan_tpu_torch.models import discriminators as pd
from flow2gan_tpu_torch.models import gan as pgan
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram
from flow2gan_tpu_torch.training import gan_step as pgs
from flow2gan_tpu_torch.training.optim import ScaledAdam, eden2_lr

from .test_torch_port_gan import _audio, _perturbed
from .test_torch_port_train import _pair

B, L = 2, 4096
N_FRAMES = 1 + L // 64  # mel_24k_tiny's hop
LENS = np.asarray([L, L - 300], np.int32)
RECON = ((32, 64, 128, 256), (5, 10, 20, 40))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The full-width discriminators and the JAX compiles make this file one
    of the suite's heaviest: two intra-op threads let it share the CPU with
    the other test workers instead of oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rel_err(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-12)


def _patch_gate(monkeypatch, gate):
    monkeypatch.setattr(jnorms, "_gate", lambda module, train, prob=0.6:
                        jnp.float32(gate) if train else None)


@functools.lru_cache(maxsize=None)
def _setup():
    """JAX modules and params, and the port's, for the generator (the
    perturbed mel_24k_tiny of the training tests), the discriminators and
    the frontends; and one batch."""
    jm, params_g, model, cfg = _pair("tiny")
    jdisc = jd.Discriminators(periods=(2, 3), fft_sizes=(256, 128))
    zeros = jnp.zeros((B, L))
    params_d = _perturbed(jax.jit(jdisc.init)(jax.random.PRNGKey(2), zeros, zeros)["params"], 11)
    disc = load_jax_params(pd.Discriminators((2, 3), (256, 128)), params_d)
    j_mel = jmel.LogMelSpectrogram(sampling_rate=24000, n_fft=cfg["mel_n_fft"],
                                   hop_length=cfg["mel_hop_length"], n_mels=cfg["n_mels"])
    mel = LogMelSpectrogram(24000, cfg["mel_n_fft"], cfg["mel_hop_length"], cfg["n_mels"])
    audio = _audio(B, L, 21)
    return dict(jm=jm, params_g=params_g, model=model, jdisc=jdisc, params_d=params_d,
                disc=disc, j_mel=j_mel, mel=mel, j_recon=jgan.make_mel_recon_fns(24000, *RECON),
                recon=pgan.make_mel_recon_fns(24000, *RECON),
                j_batch={"audio": jnp.asarray(audio), "audio_lens": jnp.asarray(LENS)},
                batch={"audio": torch.from_numpy(audio), "audio_lens": torch.from_numpy(LENS)})


def _jax_x0(jm, params, cond, noise_key):
    """x0 as `infer` draws it under the "noise" key `noise_key`: the first
    draw of that stream at the top-level module (the cond encoder draws
    none when mel noise is off)."""
    def draw(module, cond):
        key = module.make_rng("noise")
        return jax.random.normal(key, (cond.shape[0], cond.shape[-1] * module.mel_hop_length),
                                 jnp.float32) * module.init_noise_scale

    return np.array(jm.apply({"params": params}, cond, method=draw, rngs={"noise": noise_key}))


def _rollout_x0(s, rng):
    """The x0 of `_rollout(..., rng)`: its "noise" stream is fold_in(rng, 0)."""
    cond = s["j_mel"](s["j_batch"]["audio"])
    return _jax_x0(s["jm"], s["params_g"], cond, jax.random.fold_in(rng, 0))


def _grad_errs(ours: dict, ref_tree):
    """(whole, worst): the relative error of a port gradient dict against a
    JAX gradient tree over all tensors together, and of the worst tensor."""
    ref = jax_params_to_state_dict(ref_tree)
    assert set(ours) == set(ref)
    whole = (sum(float((ours[k] - ref[k]).square().sum()) for k in ref)
             / sum(float(ref[k].square().sum()) for k in ref)) ** 0.5
    return whole, max(float((ours[k] - ref[k]).norm() / (ref[k].norm() + 1e-30)) for k in ref)


def _grad_err(ours: dict, ref_tree) -> float:
    """The worst tensor's relative error."""
    return _grad_errs(ours, ref_tree)[1]


def _grads(module) -> dict:
    return {k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in module.named_parameters()}


# ---------------------------------------------------------------- rollout


def test_x0_reproduction_and_the_eval_rollout_match_jax():
    """The reproduced x0 through JAX's `infer_from_noise` equals JAX's own
    eval `_rollout` (1 step), so the key is right; the port's eval rollout on
    it equals the port's `infer_from_noise` exactly and JAX within 1e-4."""
    s = _setup()
    rng = jax.random.PRNGKey(5)
    x0 = _rollout_x0(s, rng)
    cond = s["j_mel"](s["j_batch"]["audio"])
    ref, _ = jax.jit(lambda p, c: jgs._rollout(s["jm"], p, c, s["j_batch"]["audio_lens"], 1, rng,
                                               train=False, length=L))(s["params_g"], cond)
    again = jax.jit(lambda p, x, c: s["jm"].apply({"params": p}, x, c, s["j_batch"]["audio_lens"], 1,
                                                  method="infer_from_noise"))(
        s["params_g"], jnp.asarray(x0), cond)[..., :L]
    np.testing.assert_allclose(np.asarray(again), np.asarray(ref), rtol=0, atol=1e-6)
    model = s["model"]
    cond_t, lens = torch.from_numpy(np.array(cond)), s["batch"]["audio_lens"]
    with torch.no_grad():
        ours = model.rollout(cond_t, RolloutDraws(torch.from_numpy(x0)), lens, 1)
        served = model.infer_from_noise(torch.from_numpy(x0), cond_t, lens, 1)
    assert ours.shape == (B, N_FRAMES * 64)
    torch.testing.assert_close(ours, served, rtol=0, atol=0)
    assert _rel_err(ours[..., :L].numpy(), ref) < 1e-4


@pytest.mark.parametrize("n,gate", [(1, 0.0), (1, 1.0), (2, 0.0), (2, 1.0)])
def test_train_rollout_and_param_grads_match_jax(monkeypatch, n, gate):
    """The train-form rollout (gates on every limiter call all 0 or all 1)
    and the gradient of <fake, w> for every generator parameter."""
    s = _setup()
    _patch_gate(monkeypatch, gate)
    rng = jax.random.PRNGKey(7 + n)
    x0 = _rollout_x0(s, rng)
    w = np.random.RandomState(n).randn(B, L).astype(np.float32)
    cond = s["j_mel"](s["j_batch"]["audio"])

    def j_loss(p):
        fake, _ = jgs._rollout(s["jm"], p, cond, s["j_batch"]["audio_lens"], n, rng, train=True,
                               length=L)
        return jnp.sum(fake * w), fake

    (_, j_fake), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(s["params_g"])
    model = copy.deepcopy(s["model"])
    draws = RolloutDraws(torch.from_numpy(x0), torch.full((n, model.num_limiters), gate))
    fake = model.rollout(torch.from_numpy(np.array(cond)), draws, s["batch"]["audio_lens"], n)
    fake = fake[..., :L]
    (fake * torch.from_numpy(w)).sum().backward()
    assert _rel_err(fake.detach().numpy(), j_fake) < 1e-4
    assert _grad_err(_grads(model), j_grads) < 1e-4


# ------------------------------------------------------------- objectives


@pytest.mark.parametrize("side", ["d", "g"])
def test_gan_objectives_match_jax(monkeypatch, side):
    """`make_gan_loss_fns` at 2 steps: each objective's loss and metrics
    within 1e-5, and the gradients of its own side's parameters within
    1e-4 (the G side through the scanned rollout JAX differentiates).

    On the D side every score lies in the hinge's linear part, so a tensor's
    gradient is the fake side's mean dS/dtheta minus the real side's, and
    where the two nearly cancel float32 rounding of either shows at full
    size: the 256-window MRD's band-2 convs keep 1/20 of their terms' size
    and read 1.7e-3 (the fake input moves them by 4e-7, so the gap is
    rounding, not the rollout). There the whole gradient is held to 1e-4
    and each tensor to 1e-2, the card check's limit for the same effect."""
    s = _setup()
    _patch_gate(monkeypatch, 1.0)
    j_d, j_g = jgs.make_gan_loss_fns(s["jm"], s["jdisc"], s["j_mel"], s["j_recon"], n_timesteps=2)
    rng = jax.random.PRNGKey(13)
    x0 = torch.from_numpy(_rollout_x0(s, rng))
    model, disc = copy.deepcopy(s["model"]), copy.deepcopy(s["disc"])
    d_fn, g_fn = pgs.make_gan_loss_fns(model, disc, s["mel"], s["recon"], n_timesteps=2)
    if side == "d":
        (_, j_metrics), j_grads = jax.jit(jax.value_and_grad(j_d, has_aux=True))(
            s["params_d"], s["params_g"], s["j_batch"], rng)
        loss, metrics = d_fn(s["batch"], RolloutDraws(x0))
        own = disc
    else:
        (_, j_metrics), j_grads = jax.jit(jax.value_and_grad(j_g, has_aux=True))(
            s["params_g"], s["params_d"], s["j_batch"], rng)
        loss, metrics = g_fn(s["batch"], RolloutDraws(x0, torch.ones(2, model.num_limiters)))
        own = model
    loss.backward()
    assert set(metrics) == set(j_metrics)
    for k, v in metrics.items():
        assert abs(v.item() - float(j_metrics[k])) <= 1e-5 * abs(float(j_metrics[k])), k
    whole, worst = _grad_errs(_grads(own), j_grads)
    assert whole < 1e-4 and worst < (1e-2 if side == "d" else 1e-4), (whole, worst)


def _delta_err(before, after, j_before, j_after) -> float:
    """|port delta - JAX delta| / |JAX delta| over all tensors of a side."""
    jb, ja = jax_params_to_state_dict(j_before), jax_params_to_state_dict(j_after)
    num = sum(float(((after[k] - before[k]) - (ja[k] - jb[k])).square().sum()) for k in jb)
    den = sum(float((ja[k] - jb[k]).square().sum()) for k in jb)
    return (num / den) ** 0.5


def test_one_d_step_and_one_g_step_match_jax(monkeypatch):
    """`make_gan_steps` at 2 Euler steps: a D step (batch 0), then a G step
    (batch 1), each with its own ScaledAdam and Eden2 lr from its own update
    count; the parameter deltas within 1e-4 of their norm. A first ScaledAdam
    step moves each element by lr * rms * sign(grad), so an element whose
    gradient is within rounding of zero can flip: these seeds have none."""
    s = _setup()
    _patch_gate(monkeypatch, 1.0)
    opt_g, opt_d = j_scaled_adam(clipping_scale=2.0), j_scaled_adam(clipping_scale=2.0)
    lr_g = functools.partial(eden2_lr, 0.002, lr_batches=20000, warmup_start=0.1)
    lr_d = functools.partial(eden2_lr, 0.02, lr_batches=5000, warmup_start=0.1)
    j_d_step, j_g_step, _ = jgs.make_gan_steps(
        s["jm"], s["jdisc"], s["j_mel"], s["j_recon"], opt_g, opt_d,
        lr_g_fn=lambda b: j_eden2_lr(0.002, b, 20000, warmup_start=0.1),
        lr_d_fn=lambda b: j_eden2_lr(0.02, b, 5000, warmup_start=0.1),
        n_timesteps=2, donate=False)
    state0 = jgs.init_gan_train_state(s["params_g"], s["params_d"], opt_g, opt_d)
    step_rng = jax.random.PRNGKey(17)
    state1, _ = j_d_step(state0, s["j_batch"], step_rng)
    state2, _ = j_g_step(state1, s["j_batch"], step_rng)
    # each step folds its batch index into the key, then _rollout folds 0
    x0_d = _rollout_x0(s, jax.random.fold_in(step_rng, 0))
    x0_g = _rollout_x0(s, jax.random.fold_in(step_rng, 1))

    model, disc = copy.deepcopy(s["model"]), copy.deepcopy(s["disc"])
    before_g = {k: v.clone() for k, v in model.state_dict().items()}
    before_d = {k: v.clone() for k, v in disc.state_dict().items()}
    d_step, g_step, _ = pgs.make_gan_steps(
        model, disc, s["mel"], s["recon"], ScaledAdam(model.named_parameters(), clipping_scale=2.0),
        ScaledAdam(disc.named_parameters(), clipping_scale=2.0), lr_g, lr_d, n_timesteps=2)
    m_d = d_step(s["batch"], RolloutDraws(torch.from_numpy(x0_d)))
    m_g = g_step(s["batch"], RolloutDraws(torch.from_numpy(x0_g), torch.ones(2, model.num_limiters)))
    assert m_d["lr_d"] == pytest.approx(0.02 * 0.1) and m_g["lr_g"] == pytest.approx(0.002 * 0.1)
    assert _delta_err(before_d, disc.state_dict(), s["params_d"], state1.params_d) < 1e-4
    assert _delta_err(before_g, model.state_dict(), s["params_g"], state2.params_g) < 1e-4


# ------------------------------------------------------------- port only


def _steps(remat=False):
    s = _setup()
    model, disc = copy.deepcopy(s["model"]), copy.deepcopy(s["disc"])
    opt_g = ScaledAdam(model.named_parameters(), clipping_scale=2.0)
    opt_d = ScaledAdam(disc.named_parameters(), clipping_scale=2.0)
    steps = pgs.make_gan_steps(model, disc, s["mel"], s["recon"], opt_g, opt_d,
                               lambda b: 1e-3, lambda b: 1e-3, n_timesteps=2, remat_rollout=remat)
    return s, model, disc, opt_g, opt_d, steps


def test_each_gate_row_reaches_its_own_step():
    """Row s gates the branches' limiters at Euler step s only, and the cond
    encoder reads row 0: flipping row 1 at the branch limiters changes the
    gradient, flipping it at the cond encoder's does not, flipping row 0
    there does. All-0/all-1 gates cannot tell these apart."""
    s = _setup()
    model = copy.deepcopy(s["model"])
    cond = s["mel"](s["batch"]["audio"])
    x0 = model.draw_rollout(B, N_FRAMES, 2, torch.Generator().manual_seed(0)).x0
    enc = sorted(m.gate_index for m in model.cond_encoder.modules() if hasattr(m, "gate_index"))
    branch = [i for i in range(model.num_limiters) if i not in enc]

    def grads(gates):
        model.zero_grad()
        model.rollout(cond, RolloutDraws(x0, gates), s["batch"]["audio_lens"], 2).square().sum().backward()
        return torch.cat([p.grad.flatten() for p in model.parameters()])

    base = torch.ones(2, model.num_limiters)
    ref = grads(base)
    flips = {}
    for name, row, idx in (("row1_branch", 1, branch), ("row1_enc", 1, enc), ("row0_enc", 0, enc)):
        gates = base.clone()
        gates[row, idx] = 0.0
        flips[name] = not torch.equal(grads(gates), ref)
    assert flips == {"row1_branch": True, "row1_enc": False, "row0_enc": True}
    with pytest.raises(ValueError, match="gates hold 1 steps"):
        model.rollout(cond, RolloutDraws(x0, base[:1]), None, 2)
    d = model.draw_rollout(B, N_FRAMES, 4, torch.Generator().manual_seed(1))
    assert d.x0.shape == (B, N_FRAMES * 64) and d.gates.shape == (4, model.num_limiters)
    assert set(d.gates.unique().tolist()) == {0.0, 1.0} and not torch.equal(d.gates[0], d.gates[1])
    e = model.draw_rollout(B, N_FRAMES, 4, torch.Generator().manual_seed(1), train=False)
    assert e.gates is None and torch.equal(e.x0, d.x0)


def test_each_step_moves_its_own_side_only(monkeypatch):
    """The G step leaves the discriminators and their optimizer untouched,
    the D step the generator and its optimizer; the D step's rollout
    records no autograd graph, the G step's does."""
    s, model, disc, opt_g, opt_d, (d_step, g_step, eval_step) = _steps()
    outs = []
    rollout = model.rollout

    def spy(*args, **kwargs):
        out = rollout(*args, **kwargs)
        outs.append(out.grad_fn)
        return out

    monkeypatch.setattr(model, "rollout", spy)
    gen = torch.Generator().manual_seed(0)

    def snapshot():
        return ({k: v.clone() for k, v in model.state_dict().items()},
                {k: v.clone() for k, v in disc.state_dict().items()},
                (opt_g.step_count, opt_g.groups[0].exp_avg_sq.clone()),
                (opt_d.step_count, opt_d.groups[0].exp_avg_sq.clone()))

    def same(a, b):
        return all(torch.equal(v, b[k]) for k, v in a.items())

    g0, d0, og0, od0 = snapshot()
    d_step(s["batch"], model.draw_rollout(B, N_FRAMES, 2, gen, train=False))
    g1, d1, og1, od1 = snapshot()
    assert outs[-1] is None and same(g0, g1) and not same(d0, d1)
    assert og1[0] == 0 and torch.equal(og0[1], og1[1]) and od1[0] == 1
    assert all(p.grad is None for p in model.parameters())
    g_step(s["batch"], model.draw_rollout(B, N_FRAMES, 2, gen))
    g2, d2, og2, od2 = snapshot()
    assert outs[-1] is not None and same(d1, d2) and not same(g1, g2)
    assert od2[0] == 1 and torch.equal(od1[1], od2[1]) and og2[0] == 1
    assert all(p.grad is None for p in disc.parameters())
    m = eval_step(s["batch"], model.draw_rollout(B, N_FRAMES, 2, gen))
    assert outs[-1] is None and set(m) == {"loss_g", "gen_loss_mp", "gen_loss_mr",
                                           "feat_map_loss_mp", "feat_map_loss_mr",
                                           "mel_recon_loss"}
    assert same(g2, snapshot()[0]) and same(d2, snapshot()[1])


def test_remat_rollout_equals_plain():
    """`remat_rollout` recomputes each Euler step in backward: the same loss
    and gradients as keeping the activations."""
    s = _setup()
    x0 = s["model"].draw_rollout(B, N_FRAMES, 2, torch.Generator().manual_seed(3))
    out = {}
    for remat in (False, True):
        model, disc = copy.deepcopy(s["model"]), copy.deepcopy(s["disc"])
        _, g_fn = pgs.make_gan_loss_fns(model, disc, s["mel"], s["recon"], n_timesteps=2,
                                        remat_rollout=remat)
        loss, _ = g_fn(s["batch"], x0)
        loss.backward()
        out[remat] = (loss.item(), _grads(model))
    assert out[True][0] == pytest.approx(out[False][0], rel=1e-6)
    for k, g in out[False][1].items():
        assert float((out[True][1][k] - g).norm()) <= 1e-6 * float(g.norm()) + 1e-12, k
