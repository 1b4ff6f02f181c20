"""The port's token family against the JAX package on the CPU: the k-means
pseudo-codec (`ops/tokenizer.py`), `TokenAudioGenerator` serving in float32
and bf16, its FM loss and the GAN stage's rollout and G objective, and
`get_model` with a tokenizer.

Sizes: token_24k_tiny (vocab 64, embedding 24 wide, branch dropout off) and a
full-width token_24k_base with one layer per stack for one serving case.
Inputs come from numpy seeds; the JAX parameters are perturbed from a seed
and carried over with `load_jax_params`; the draws (x0, t, the limiters'
gates, the branch weights) are injected on both sides as in the mel tests.

Tolerances, relative to the reference's max |.| (a gradient tensor: its
norm): `kmeans_fit` bitwise; the tokenizer's log-mel 1e-5; tokens exact but
on frames whose best two scores lie within 1e-5 of max |score| of each other
(JAX and the port round the scores differently in the last bits), which
must be under 1% of the frames and are counted; serving, rollouts, losses
and gradients 1e-4; bf16 within 1/4 of JAX's own bf16 error plus twice its
one-ulp floor (`tests/test_torch_port_bf16.py`).
"""

import copy
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow2gan_tpu import api as j_api
from flow2gan_tpu.models import build_generator as j_build_generator
from flow2gan_tpu.models import config as j_config
from flow2gan_tpu.models import discriminators as jd
from flow2gan_tpu.models import gan as jgan
from flow2gan_tpu.models import norms as jnorms
from flow2gan_tpu.ops import tokenizer as jtok
from flow2gan_tpu.training import gan_step as jgs

from flow2gan_tpu_torch import api
from flow2gan_tpu_torch.compat.from_jax import jax_params_to_state_dict, load_jax_params
from flow2gan_tpu_torch.models import (
    FMDraws,
    RolloutDraws,
    TokenAudioGenerator,
    build_generator,
    get_generator_config,
)
from flow2gan_tpu_torch.models import config as p_config
from flow2gan_tpu_torch.models import discriminators as pd
from flow2gan_tpu_torch.models import gan as pgan
from flow2gan_tpu_torch.models.generator import branch_dropout_weight
from flow2gan_tpu_torch.ops import tokenizer as ptok
from flow2gan_tpu_torch.training import gan_step as pgs

from .test_torch_port_bf16 import _JIT, _rms
from .test_torch_port_gan import _audio
from .test_torch_port_gan import _perturbed as _biases_moved

TINY = dict(get_generator_config("token_24k_tiny"), branch_dropout=0.0)
BASE_SHALLOW = dict(get_generator_config("token_24k_base"), num_layers=(1, 1, 1),
                    cond_enc_num_layers=1, branch_dropout=0.0)
_CONFIGS = {"tiny": TINY, "base_shallow": BASE_SHALLOW}
RECON = ((32, 64, 128, 256), (5, 10, 20, 40))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """JAX compiles and a GAN objective: two intra-op threads let this file
    share the CPU with the other test workers."""
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


def _assert_tokens_agree(ours, ref, scores):
    """Token ids (B, T) equal but on near-ties: frames whose best two of the
    reference `scores` (B, T, K) lie within 1e-5 of max |score|; those are
    fewer than 1% of the frames, and counted."""
    ours, ref, scores = np.asarray(ours), np.asarray(ref), np.asarray(scores, np.float64)
    assert ours.shape == ref.shape
    two = np.sort(scores, axis=-1)[..., :2]
    tie = (two[..., 1] - two[..., 0]) <= 1e-5 * np.abs(scores).max()
    differ = ours != ref
    print(f"{int(tie.sum())} near-tie frames of {tie.size}, {int(differ.sum())} ids differ")
    assert not (differ & ~tie).any()
    assert tie.mean() < 0.01


@functools.lru_cache(maxsize=None)
def _codebook():
    """A token_24k_tiny codebook fit (numpy) on the JAX tokenizer frontend's
    frames of voiced audio, and (JAX tokenizer, port tokenizer) on it."""
    cfg = TINY
    frontend = (cfg["sampling_rate"], cfg["mel_n_fft"], cfg["mel_hop_length"], cfg["n_mels"])
    mel = jax.jit(jtok.MelKMeansTokenizer(np.zeros((1, cfg["n_mels"])), *frontend).mel_fn)
    frames = np.asarray(mel(jnp.asarray(_audio(4, 24000, 3)))).transpose(0, 2, 1).reshape(-1, cfg["n_mels"])
    centroids = ptok.kmeans_fit(frames, cfg["vocab_size"], iters=10, seed=1)
    return (centroids, jtok.MelKMeansTokenizer(centroids, *frontend),
            ptok.MelKMeansTokenizer(centroids, *frontend))


# ------------------------------------------------------------ the codec


def test_kmeans_fit_is_jax_bitwise_with_reseeds():
    """The same frames give the same centroids bit for bit, on a set where
    some start centroids coincide (so the reseed of empty clusters runs)."""
    rng = np.random.RandomState(0)
    distinct = rng.randn(30, 6).astype(np.float32)
    repeated = distinct[rng.randint(0, 30, 300)]  # 40 centroids from 30 points
    spread = np.concatenate([repeated, rng.randn(40, 6).astype(np.float32)])
    for frames, k, iters, seed in [(repeated, 40, 5, 0), (spread, 48, 6, 1), (spread, 8, 12, 3)]:
        ours = ptok.kmeans_fit(frames, k, iters=iters, seed=seed, chunk=100)
        np.testing.assert_array_equal(ours, jtok.kmeans_fit(frames, k, iters=iters, seed=seed,
                                                            chunk=100))
    with pytest.raises(ValueError, match="at least k=400"):
        ptok.kmeans_fit(spread, 400)


def test_tokenizer_mels_and_tokens_match_jax():
    _, jt, pt = _codebook()
    audio = _audio(3, 20000, 8)
    j_mel = np.asarray(jax.jit(jt.mel_fn)(jnp.asarray(audio)))
    with torch.no_grad():
        p_mel = pt.mel_fn(torch.from_numpy(audio)).numpy()
        ours = pt(torch.from_numpy(audio))
    assert _rel_err(p_mel, j_mel) < 1e-5
    ref = np.asarray(jax.jit(jt)(jnp.asarray(audio)))
    assert ours.dtype == torch.int64 and ref.dtype == np.int32
    frames = j_mel.transpose(0, 2, 1)
    c = np.asarray(jt.centroids, np.float64)
    _assert_tokens_agree(ours.numpy(), ref, -2.0 * frames @ c.T + (c * c).sum(1))
    # on the same mel the port's quantize is the nearest centroid
    with torch.no_grad():
        same = pt.quantize(torch.from_numpy(j_mel)).numpy()
    _assert_tokens_agree(same, ref, -2.0 * frames @ c.T + (c * c).sum(1))


def test_codebook_files_load_in_both_packages(tmp_path):
    centroids, jt, pt = _codebook()
    cfg = get_generator_config("token_24k_tiny")
    pt.save(tmp_path / "port.npz")
    jt.save(tmp_path / "jax.npz")
    back_j = jtok.MelKMeansTokenizer.from_file(tmp_path / "port.npz", expect_config=cfg)
    back_p = ptok.MelKMeansTokenizer.from_file(tmp_path / "jax.npz", expect_config=cfg)
    np.testing.assert_array_equal(np.asarray(back_j.centroids), centroids)
    np.testing.assert_array_equal(back_p.centroids.numpy(), centroids)
    assert (back_p.vocab_size, back_p.sampling_rate, back_p.n_fft, back_p.hop_length,
            back_p.n_mels) == (64, 24000, 256, 64, 20)
    for key, value in [("vocab_size", 65), ("n_mels", 21), ("mel_hop_length", 32),
                       ("mel_n_fft", 512), ("sampling_rate", 44100)]:
        with pytest.raises(ValueError, match=f"{key}="):
            ptok.MelKMeansTokenizer.from_file(tmp_path / "jax.npz",
                                              expect_config=dict(cfg, **{key: value}))
    assert ptok.load_token_frontend(get_generator_config("mel_24k_tiny"), None) is None
    with pytest.raises(ValueError, match="token-conditioned; pass --tokenizer"):
        ptok.load_token_frontend(cfg, None, "token_24k_tiny")


# ------------------------------------------------------------ the generator


@functools.lru_cache(maxsize=None)
def _pair(name):
    """(JAX module, params, port model, config), the params perturbed from a
    numpy seed and the limited ones pushed past their bounds here and there."""
    cfg = _CONFIGS[name]
    jm = j_build_generator(cfg)
    init = jax.jit(lambda rngs, tokens: jm.init(rngs, tokens, n_timesteps=1, method="infer"))
    params = init({"params": jax.random.PRNGKey(0), "noise": jax.random.PRNGKey(1)},
                  jnp.zeros((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(7)
    spread = {"scale": 0.3, "log_scale": 0.6}

    def perturb(path, p):
        key = getattr(path[-1], "key", "")
        return (np.asarray(p) + spread.get(key, 0.005) * rng.randn(*np.shape(p))).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, params)
    model = load_jax_params(build_generator(cfg), params)
    assert isinstance(model, TokenAudioGenerator)
    return jm, params, model, cfg


def _jax_infer_from_noise(module, noise, tokens, n_timesteps):
    """The JAX token generator's `infer` with x0 given (it has no
    `infer_from_noise`)."""
    return module.solve(noise=noise, cond=module._encode_cond(tokens, False),
                        n_timesteps=n_timesteps, clamp_pred=False)


def _ids(cfg, batch, frames, seed):
    return np.random.RandomState(seed).randint(0, cfg["vocab_size"], (batch, frames)).astype(np.int32)


@pytest.mark.parametrize("name,n_timesteps", [("tiny", 1), ("tiny", 2), ("tiny", 4),
                                              ("base_shallow", 1)])
def test_infer_from_noise_matches_jax(name, n_timesteps):
    jm, params, model, cfg = _pair(name)
    assert model.token_embed.weight.shape == (cfg["vocab_size"], cfg["cond_embed_dim"])
    frames = 12
    tokens = _ids(cfg, 2, frames, n_timesteps)
    noise = (0.1 * np.random.RandomState(1).randn(2, frames * cfg["mel_hop_length"])).astype(np.float32)
    ref = jax.jit(lambda p, x0, tok: jm.apply({"params": p}, x0, tok, n_timesteps,
                                              method=_jax_infer_from_noise))(params, noise, tokens)
    with torch.no_grad():
        ours = model.infer_from_noise(torch.from_numpy(noise), torch.from_numpy(tokens),
                                      n_timesteps=n_timesteps)
    assert _rel_err(ours.numpy(), ref) < 1e-4


def _jax_fm_loss(module, tokens, x0, x1, t, lens, weight):
    """The JAX token generator's FM loss with t, x0 and the branch weights
    given: `flow_matching_loss` with `process_model`'s weighted mean."""
    cond = module._encode_cond(tokens, True)
    x = (1.0 - t[:, None]) * x0 + t[:, None] * x1
    outs = jnp.stack([est(audio=x, cond=cond, t=t, audio_lens=lens, train=True)
                      for est in module.estimators], axis=1)
    pred = (outs * weight[..., None]).mean(axis=1)
    ref = x1 if module.pred_x1 else x1 - x0
    return module.compute_loss(pred=pred, ref=ref, audio_lens=lens, gt_audio=x1)


@pytest.mark.parametrize("gate", [0.0, 1.0])
def test_fm_loss_and_param_grads_match_jax(monkeypatch, gate):
    jm, params, model, cfg = _pair("tiny")
    _patch_gate(monkeypatch, gate)
    rng = np.random.RandomState(5)
    frames, hop = 16, cfg["mel_hop_length"]
    length = frames * hop
    tokens = _ids(cfg, 2, frames, 11)
    x1 = _audio(2, length, 4)
    x0 = (0.1 * rng.randn(2, length)).astype(np.float32)
    t = rng.rand(2).astype(np.float32)
    lens = np.asarray([length, length - 200], np.int32)
    weight = branch_dropout_weight(torch.tensor([1, 0]), torch.tensor([[True], [False]]), 2)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p, *a: jm.apply({"params": p}, *a, method=_jax_fm_loss)))(
        params, tokens, x0, x1, t, lens, weight.numpy())

    model.zero_grad()
    draws = FMDraws(torch.from_numpy(x0), torch.from_numpy(t),
                    gates=torch.full((model.num_limiters,), gate), branch_weight=weight)
    loss = model(torch.from_numpy(tokens), torch.from_numpy(x1), torch.from_numpy(lens), draws)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    ref = jax_params_to_state_dict(j_grads)
    ours = dict(model.named_parameters())
    assert set(ours) == set(ref) and "token_embed.weight" in ref
    worst = max(float((ours[k].grad - ref[k]).norm() / (ref[k].norm() + 1e-30)) for k in ref)
    assert worst < 1e-4, worst
    # the ids the batch names get gradient, the others none
    rows = ours["token_embed.weight"].grad.abs().sum(dim=1) > 0
    assert set(np.flatnonzero(rows.numpy())) == set(np.unique(tokens))


class _Narrowing(torch.overrides.TorchFunctionMode):
    """Records each torch function that takes a float64 tensor and returns
    a narrower floating one (the 0/1 masks and the cached float32
    constants are made from no float64 tensor, and widen where they meet
    one)."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        given = torch.utils._pytree.tree_leaves((args, kwargs))
        if any(torch.is_tensor(a) and a.dtype in (torch.float64, torch.complex128) for a in given):
            for o in torch.utils._pytree.tree_leaves(out):
                if torch.is_tensor(o) and o.dtype in (torch.float32, torch.bfloat16,
                                                      torch.float16, torch.complex64):
                    self.seen.append(getattr(func, "__name__", str(func)))
        return out


def test_fm_loss_in_float64_stays_float64():
    """The float64 reference of the FM gradient (`chip_smoke.py` phase 18c
    holds the card and the CPU against it): the model widened with
    `.double()` on float64 inputs computes every tensor of the forward and
    every gradient in float64, and its gradient lies within 1e-4 of the float32
    one per tensor."""
    model = api.init_weights(build_generator(TINY), torch.Generator().manual_seed(0))
    wide = copy.deepcopy(model).double()
    rng = np.random.RandomState(5)
    frames, hop = 16, TINY["mel_hop_length"]
    length = frames * hop
    tokens = torch.from_numpy(_ids(TINY, 2, frames, 11))
    x1, x0 = _audio(2, length, 4), (0.1 * rng.randn(2, length)).astype(np.float32)
    t, lens = rng.rand(2).astype(np.float32), torch.tensor([length, length - 200])
    weight = branch_dropout_weight(torch.tensor([1, 0]), torch.tensor([[True], [False]]), 2)
    grads = {}
    for name, m, dtype in (("f32", model, torch.float32), ("f64", wide, torch.float64)):
        draws = FMDraws(torch.from_numpy(x0).to(dtype), torch.from_numpy(t).to(dtype),
                        gates=torch.ones(m.num_limiters, dtype=dtype),
                        branch_weight=weight.to(dtype))
        with _Narrowing() as narrow:
            loss = m(tokens, torch.from_numpy(x1).to(dtype), lens, draws)
        loss.backward()
        grads[name] = {k: p.grad for k, p in m.named_parameters()}
    assert not narrow.seen, sorted(set(narrow.seen))
    assert all(g.dtype == torch.float64 for g in grads["f64"].values())
    worst = max(float((grads["f32"][k].double() - g).norm() / g.norm())
                for k, g in grads["f64"].items())
    assert worst < 1e-4, worst


def test_token_draws_hold_no_conditioning_noise():
    """`draw` never draws noise for tokens, whatever the config's mel noise."""
    model = build_generator(dict(TINY, max_add_noise_scale=0.5, branch_dropout=1.0))
    audio = torch.from_numpy(_audio(2, 16 * 64, 0))
    d = model.draw(audio, 16, torch.Generator().manual_seed(0))
    assert d.cond_noise is None and d.branch_weight.shape == (2, 2)
    r = model.draw_rollout(2, 16, 2, torch.Generator().manual_seed(0))
    assert r.x0.shape == (2, 16 * 64) and r.gates.shape == (2, model.num_limiters)


def _jax_x0(jm, params, tokens, noise_key):
    """x0 as the JAX token generator's `infer` draws it under `noise_key`:
    the first draw of its "noise" stream (the token path draws no other)."""
    def draw(module, tokens):
        key = module.make_rng("noise")
        return jax.random.normal(key, (tokens.shape[0], tokens.shape[-1] * module.token_hop_length),
                                 jnp.float32) * module.init_noise_scale

    return np.array(jm.apply({"params": params}, tokens, method=draw, rngs={"noise": noise_key}))


@pytest.mark.parametrize("n", [1, 2])
def test_train_rollout_and_param_grads_match_jax(monkeypatch, n):
    """The train-form rollout (every gate 1) and the gradient of <fake, w>
    for every generator parameter."""
    jm, params, model, cfg = _pair("tiny")
    _patch_gate(monkeypatch, 1.0)
    frames, length = 16, 16 * 64 - 100
    tokens = _ids(cfg, 2, frames, 20 + n)
    lens = np.asarray([length, length - 300], np.int32)
    rng = jax.random.PRNGKey(7 + n)
    x0 = _jax_x0(jm, params, tokens, jax.random.fold_in(rng, 0))
    w = np.random.RandomState(n).randn(2, length).astype(np.float32)

    def j_loss(p):
        fake, _ = jgs._rollout(jm, p, jnp.asarray(tokens), jnp.asarray(lens), n, rng, train=True,
                               length=length)
        return jnp.sum(fake * w), fake

    (_, j_fake), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(params)
    model.zero_grad()
    draws = RolloutDraws(torch.from_numpy(x0), torch.ones(n, model.num_limiters))
    fake = model.rollout(torch.from_numpy(tokens), draws, torch.from_numpy(lens), n)[..., :length]
    (fake * torch.from_numpy(w)).sum().backward()
    assert _rel_err(fake.detach().numpy(), j_fake) < 1e-4
    ref = jax_params_to_state_dict(j_grads)
    worst = max(float((p.grad - ref[k]).norm() / (ref[k].norm() + 1e-30))
                for k, p in model.named_parameters())
    assert worst < 1e-4, worst


def test_g_objective_on_tokens_matches_jax(monkeypatch):
    """`make_gan_loss_fns`' G objective at 2 steps with the tokenizer as the
    conditioning frontend and the mels for the reconstruction loss: loss and
    metrics within 1e-5, the whole generator gradient within 1e-4, and each
    tensor within 1e-4 of its norm plus twice how far JAX's own gradient of
    it moves when every parameter moves by one float32 ulp. That floor is
    what lets the cond encoder's input BiasNorm through: its log_scale's
    gradient nearly cancels (6e-7 against ~1e-2 for the others) and reads
    3.1e-3 here, where one ulp moves JAX's by 3.0e-3 (its bias: 4.1e-4 and
    4.0e-4); every other tensor meets 1e-4 alone."""
    jm, params_g, model, cfg = _pair("tiny")
    _, jt, pt = _codebook()
    _patch_gate(monkeypatch, 1.0)
    batch, length = 2, 4096
    jdisc = jd.Discriminators(periods=(2, 3), fft_sizes=(256, 128))
    zeros = jnp.zeros((batch, length))
    params_d = _biases_moved(jax.jit(jdisc.init)(jax.random.PRNGKey(2), zeros, zeros)["params"], 11)
    disc = load_jax_params(pd.Discriminators((2, 3), (256, 128)), params_d)
    audio = _audio(batch, length, 21)
    lens = np.asarray([length, length - 300], np.int32)
    rng = jax.random.PRNGKey(13)
    _, j_g = jgs.make_gan_loss_fns(jm, jdisc, jt, jgan.make_mel_recon_fns(24000, *RECON),
                                   n_timesteps=2)
    j_grad_fn = jax.jit(jax.value_and_grad(j_g, has_aux=True))
    j_batch = {"audio": jnp.asarray(audio), "audio_lens": jnp.asarray(lens)}
    (_, j_metrics), j_grads = j_grad_fn(params_g, params_d, j_batch, rng)
    ref = jax_params_to_state_dict(j_grads)
    floor = dict.fromkeys(ref, 0.0)
    for to in (np.inf, -np.inf):
        moved = jax.tree.map(lambda p: np.nextafter(np.asarray(p), np.float32(to)), params_g)
        other = jax_params_to_state_dict(j_grad_fn(moved, params_d, j_batch, rng)[1])
        for k in ref:
            floor[k] = max(floor[k], float((other[k] - ref[k]).norm() / (ref[k].norm() + 1e-30)))

    x0 = _jax_x0(jm, params_g, jt(jnp.asarray(audio)), jax.random.fold_in(rng, 0))
    model.zero_grad()
    _, g_fn = pgs.make_gan_loss_fns(model, disc, pt, pgan.make_mel_recon_fns(24000, *RECON),
                                    n_timesteps=2)
    loss, metrics = g_fn({"audio": torch.from_numpy(audio), "audio_lens": torch.from_numpy(lens)},
                         RolloutDraws(torch.from_numpy(x0), torch.ones(2, model.num_limiters)))
    loss.backward(inputs=list(model.parameters()))
    assert set(metrics) == set(j_metrics)
    for k, v in metrics.items():
        assert abs(v.item() - float(j_metrics[k])) <= 1e-5 * abs(float(j_metrics[k])), k
    ours = {k: p.grad for k, p in model.named_parameters()}
    whole = (sum(float((ours[k] - ref[k]).square().sum()) for k in ref)
             / sum(float(ref[k].square().sum()) for k in ref)) ** 0.5
    assert whole < 1e-4, whole
    over = {k: (err, floor[k]) for k in ref
            if (err := float((ours[k] - ref[k]).norm() / (ref[k].norm() + 1e-30)))
            > 1e-4 + 2 * floor[k]}
    assert not over, over


@pytest.mark.parametrize("n_timesteps", [1, 2])
def test_infer_from_noise_bf16_matches_jax(n_timesteps):
    jm32, params, _, cfg = _pair("tiny")
    jm16 = j_build_generator(dict(cfg, compute_dtype="bfloat16"))
    pm16 = load_jax_params(build_generator(dict(cfg, compute_dtype="bfloat16")), params).eval()
    assert pm16.token_embed.weight.dtype == torch.float32
    frames = 16
    tokens = _ids(cfg, 2, frames, 30 + n_timesteps)
    noise = (0.1 * np.random.RandomState(n_timesteps).randn(2, frames * 64)).astype(np.float32)

    def jax_fn(module):
        f = _JIT(lambda p, x0, tok: module.apply({"params": p}, x0, tok, n_timesteps,
                                                 method=_jax_infer_from_noise))
        return lambda x0: np.asarray(f(params, x0, tokens))

    f16 = jax_fn(jm16)
    ref16, ref32 = f16(noise), jax_fn(jm32)(noise)
    with torch.no_grad():
        ours = pm16.infer_from_noise(torch.from_numpy(noise), torch.from_numpy(tokens),
                                     n_timesteps=n_timesteps)
    assert ours.dtype == torch.float32
    floor = max(_rms(f16(np.nextafter(noise, np.float32(to)).astype(np.float32)), ref16)
                for to in (np.inf, -np.inf))
    err, noise_err = _rms(ours.numpy(), ref16), _rms(ref16, ref32)
    assert err <= noise_err / 4 + 2 * floor, (err, noise_err, floor)


# ------------------------------------------------------------------ the API


def test_get_model_tokens_reconstruct_and_infer_match_jax(monkeypatch, tmp_path):
    """`get_model("token_24k_tiny", tokenizer=<.npz>)` on the JAX model's
    (perturbed) params against the JAX package's `VocoderModel` on them,
    both with x0 = 0 (init_noise_scale 0), since the two packages draw other
    noise: `tokens` with the tie rule, `infer` on int32 ids within 1e-4, and
    `reconstruct` the port's `infer(tokens(audio))`."""
    _, params, _, cfg = _pair("tiny")
    monkeypatch.setitem(p_config._GENERATOR_CONFIGS, "token_24k_tiny",
                        dict(p_config._GENERATOR_CONFIGS["token_24k_tiny"], init_noise_scale=0.0))
    _, jt, _ = _codebook()
    jt.save(tmp_path / "codebook.npz")
    jcfg = dict(cfg, init_noise_scale=0.0)
    jvm = j_api.VocoderModel(module=j_build_generator(jcfg), variables={"params": params},
                             config=j_config.AttributeDict(jcfg), tokenizer=jt)
    vm = api.get_model("token_24k_tiny", tokenizer=tmp_path / "codebook.npz", device="cpu")
    load_jax_params(vm.module, params)
    audio = _audio(2, 9000, 17)
    ids = np.asarray(jvm.tokens(jnp.asarray(audio)))
    ours = vm.tokens(audio)
    frames = np.asarray(jax.jit(jt.mel_fn)(jnp.asarray(audio))).transpose(0, 2, 1)
    c = np.asarray(jt.centroids, np.float64)
    _assert_tokens_agree(ours.numpy(), ids, -2.0 * frames @ c.T + (c * c).sum(1))
    assert ids.dtype == np.int32
    ref = np.asarray(jvm.infer(ids, n_timesteps=2))
    got = vm.infer(ids, n_timesteps=2)
    assert got.shape == (2, ids.shape[1] * 64) and _rel_err(got.numpy(), ref) < 1e-4
    torch.testing.assert_close(vm.reconstruct(audio, n_timesteps=2), vm.infer(ours, n_timesteps=2),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="no tokenizer"):
        api.get_model("token_24k_tiny", device="cpu").tokens(audio)


@pytest.mark.parametrize("ids,match", [
    ([[0, 64, 3]], r"\[0, 64\); got ids in \[0, 64\]"),
    ([[-1, 5]], r"\[0, 64\); got ids in \[-1, 5\]"),
    (np.zeros((1, 4), np.float32), "integers"),
])
def test_out_of_range_ids_raise(ids, match):
    """The embedding would raise on the CPU and assert on the card; served
    ids are checked first."""
    vm = api.get_model("token_24k_tiny", device="cpu")
    with pytest.raises(ValueError, match=match):
        vm.infer(ids)
    assert vm.infer([[0, 63, 7]]).shape == (1, 3 * 64)
