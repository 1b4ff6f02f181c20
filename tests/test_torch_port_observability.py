"""The port's observability against the JAX package on the CPU: the
diagnostics tables (report lines on the same arrays, and on mel_24k_tiny the
forward, parameter and gradient tables and the PReLU histograms, with JAX's
parameters and the same draws), the localisation of a non-finite output,
`dominant_parameters`, Eve, the discriminators' embedding term, the event
writer read back by TensorBoard's and tensorboardX's readers, the run
provenance, and both trainers running each observability flag end to end.

Tolerances: the report lines are compared as strings; the accumulated
statistics at 1e-4 of the largest |value| of each (float32 activations summed
in other orders), the sums of values at 1e-4 of the largest sum of |values|
(they cancel), the counts of positive values up to the values that are zero
up to rounding, the Gram eigenvalues at 1e-4 of the largest; shares and
Eve's parameters within 1e-6; the discriminators' scores within 1e-5 of
their largest |value| (their embedding term to the same).
"""

import functools
import glob
import io
import logging
import struct
import wave

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flow2gan_tpu.models import discriminators as jd
from flow2gan_tpu.models import norms as jnorms
from flow2gan_tpu.training import diagnostics as jdiag
from flow2gan_tpu.training import hooks as jhooks
from flow2gan_tpu.training import optim as joptim

from flow2gan_tpu_torch import tracing, utils_tb
from flow2gan_tpu_torch.compat.from_jax import jax_params_to_state_dict, load_jax_params
from flow2gan_tpu_torch.models import FMDraws, build_generator
from flow2gan_tpu_torch.models import discriminators as pd
from flow2gan_tpu_torch.training import diagnostics as pdiag
from flow2gan_tpu_torch.training import hooks as phooks
from flow2gan_tpu_torch.training import optim as poptim
from flow2gan_tpu_torch.training.env import get_env_info
from flow2gan_tpu_torch.utils import MetricsTracker, plot_feature

from .test_torch_port_train import _inputs, _pair


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, so that this file shares the CPU with the other
    test workers instead of oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _close(ours, ref, tol):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return np.abs(ours - ref).max(initial=0.0) <= tol * (np.abs(ref).max(initial=0.0) + 1e-30)


# ------------------------------------------------------------ report lines


@pytest.mark.parametrize("shapes", [
    [(3, 4), (3, 4)],  # raw values: every dim <= 10
    [(4, 31, 8), (4, 31, 8)],  # 31 prints raw too
    [(600, 512)],  # 512 with eigs, 600 summarized without
    [(2, 12, 40), (2, 12, 40), (2, 12, 40)],
], ids=["small", "dim31", "dim512", "three_updates"])
def test_tensor_stats_report_lines_match_jax(shapes):
    rng = np.random.RandomState(len(shapes) + shapes[0][0])
    ours, theirs = pdiag.TensorStats(), jdiag.TensorStats()
    for shape in shapes:
        # a rank-1 part plus noise: a spread eigen-spectrum, full rank
        x = (rng.randn(*shape) + 0.5 * rng.randn(*shape[:-1], 1) * rng.randn(shape[-1])
             ).astype(np.float32)
        ours.update(torch.from_numpy(x))
        theirs.update(x)
    assert ours.summary() == theirs.summary()
    lines = ours.report_lines("t")
    assert lines == theirs.report_lines("t")
    kinds = {line.split(",")[3].split()[0] for line in lines}
    assert kinds >= {"abs", "positive", "value", "rms", "stddev", "max", "min", "rms-sort"}
    if shapes[0] == (600, 512):
        assert any(" eigs " in line and "dim=1" in line for line in lines)
        assert not any(" eigs " in line and "dim=0" in line for line in lines)


def test_scalar_diagnostic_matches_jax():
    rng = np.random.RandomState(3)
    ours, theirs = pdiag.ScalarDiagnostic(), jdiag.ScalarDiagnostic()
    for scale in (1.0, 1.7):  # the second batch exceeds the first's range
        v = (scale * rng.randn(4, 50, 24)).astype(np.float32)
        g = (rng.randn(4, 50, 24) * (v > 0)).astype(np.float32)
        ours.update(torch.from_numpy(v), torch.from_numpy(g))
        theirs.update(v, g)
    assert ours.summary() == theirs.summary()
    np.testing.assert_array_equal(ours.counts.numpy(), theirs.counts)
    np.testing.assert_allclose(ours.grad_sum.numpy(), theirs.grad_sum, rtol=1e-12, atol=1e-12)


# ------------------------------------------ the tables on mel_24k_tiny


def _jax_loss(train: bool):
    """The JAX package's FM loss with t and x0 given instead of drawn (as
    `_jax_fm_loss` in test_torch_port_train.py), eval or train form."""

    def loss(module, cond, x0, x1, t, lens):
        cond = module._encode_cond(cond, train)
        x = (1.0 - t[:, None]) * x0 + t[:, None] * x1
        pred = module.process_model(x=x, cond=cond, t=t, audio_lens=lens, train=train)
        return module.compute_loss(pred=pred, ref=x1, audio_lens=lens, gt_audio=x1)

    return loss


def _port_dims(jax_name: str, ndim: int):
    """The port's dim of each JAX dim: a flax kernel is laid out otherwise
    than the torch weight (`compat/from_jax.py`)."""
    leaf = jax_name.removesuffix(".param_grad").rsplit("/", 1)[-1]
    if not jax_name.startswith("param/") or leaf != "kernel":
        return list(range(ndim))
    return {2: [1, 0], 3: [2, 1, 0], 4: [2, 3, 1, 0]}[ndim]


def _zero_entries(a, b) -> np.ndarray:
    """The entries of a dim whose values are zero up to rounding on either
    side (the iSTFT ignores the imaginary parts at DC and Nyquist, so their
    gradients are exactly zero on one side and 1e-16 on the other)."""
    sa, sb = a.sum_abs.numpy(), b.sum_abs
    return (np.minimum(sa, sb) <= 1e-9 * sb.max()) & (np.abs(sa - sb) <= 1e-9 * sb.max())


def _same_stats(ours: pdiag.TensorStats, theirs: jdiag.TensorStats, name: str) -> None:
    assert ours.n == theirs.n and ours.count == theirs.count, name
    dims = _port_dims(name, len(theirs.dims))
    pairs = [(ours.dims[pd_], theirs.dims[jd_]) for jd_, pd_ in enumerate(dims)]
    # the sign of a value that is zero up to rounding is not defined: the
    # positive counts leave those entries out, and elsewhere may differ by
    # at most how many such values there are
    n_zero = max((int(_zero_entries(a, b).sum()) * a.count for a, b in pairs), default=0)
    for jd_, (a, b) in enumerate(pairs):
        assert a.size == b.size and a.count == b.count, (name, jd_)
        for key in ("sum_abs", "sum_sq", "max_v", "min_v", "rms_sort"):
            assert _close(getattr(a, key).numpy(), getattr(b, key), 1e-4), (name, jd_, key)
        keep = ~_zero_entries(a, b)
        err = np.abs(a.sum_pos.numpy() - b.sum_pos)[keep].max(initial=0.0)
        assert err <= 1e-4 * b.sum_pos.max() + n_zero, (name, jd_, "sum_pos", err, n_zero)
        # a sum of values cancels: its rounding scales with the sum of |values|
        err = np.abs(a.sum_val.numpy() - b.sum_val).max()
        assert err <= 1e-4 * b.sum_abs.max(), (name, jd_, "sum_val")
        assert (a.gram is None) == (b.gram is None), (name, jd_)
        if a.gram is not None:
            ea = np.linalg.eigvalsh(a.gram.numpy() / a.count)
            eb = np.linalg.eigvalsh(b.gram / b.count)
            assert np.abs(ea - eb).max() <= 1e-4 * np.abs(eb).max(), (name, jd_)


@functools.lru_cache(maxsize=None)
def _tables():
    """The JAX and port collectors and PReLU histograms after two batches of
    mel_24k_tiny with the same parameters and draws (the gates all on)."""
    jm, params, model, cfg = _pair("tiny")
    jdc, pdc = jdiag.DiagnosticsCollector(), pdiag.DiagnosticsCollector()
    jscalars, pscalars = {}, {}
    fwd = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=_jax_loss(False),
                                         capture_intermediates=True, mutable=["intermediates"]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnorms, "_gate", lambda module, train, prob=0.6:
                   jnp.float32(1.0) if train else None)
        train_loss = _jax_loss(True)

        def loss_fn(p, perts, *a, mutable=False):
            variables = {"params": p} if perts is None else {"params": p, "perturbations": perts}
            return jm.apply(variables, *a, method=train_loss,
                            **({"mutable": ["perturbations"]} if mutable else {}))

        for seed in (20, 21):
            inp = _inputs(cfg, 2, 20, seed=seed)
            jargs = [jnp.asarray(inp[k]) for k in ("cond", "x0", "x1", "t", "lens")]
            # JAX: the forward tables, params, and the backward tables
            jdc.collect_intermediates(fwd(params, *jargs)[1]["intermediates"])
            jdc.collect_params(params)
            backward = jdiag.BackwardTables(
                init_fn=lambda: loss_fn(params, None, *jargs, mutable=True)[1]["perturbations"],
                loss_fn=loss_fn)
            backward.collect(jdc, params, *jargs)
            # the port, with the same draws
            cond, x0, x1, t, lens = (torch.from_numpy(inp[k])
                                     for k in ("cond", "x0", "x1", "t", "lens"))
            with torch.no_grad(), pdc.outputs(model):
                model(cond, x1, lens, FMDraws(x0, t))
            pdc.collect_params(model.named_parameters())
            model.zero_grad()
            values = ({}, {})
            with pdc.output_grads(model, values):
                model(cond, x1, lens, FMDraws(x0, t, gates=torch.ones(model.num_limiters))).backward()
            pdc.collect_params(((n, p.grad) for n, p in model.named_parameters()),
                               suffix=".param_grad")
            model.zero_grad()
            pdiag.collect_scalar_diagnostics(pscalars, *values)
        # the PReLU histograms of the last batch, as the JAX trainer's pass
        with jnorms.diagnostic_perturbations():
            perts = jax.tree.map(jnp.zeros_like, jax.jit(lambda p, *a: jm.apply(
                {"params": p}, *a, method=train_loss, mutable=["perturbations"]))(
                    params, *jargs)[1]["perturbations"])

            def ploss(perts, p, *a):
                out, mut = jm.apply({"params": p, "perturbations": perts}, *a, method=train_loss,
                                    capture_intermediates=lambda m, _: type(m).__name__ == "PReLU",
                                    mutable=["intermediates"])
                return out, mut["intermediates"]

            (_, inter), pgrads = jax.jit(jax.value_and_grad(ploss, has_aux=True))(
                perts, params, *jargs)
        jdiag.collect_scalar_diagnostics(jscalars, inter, pgrads)
    return jdc, pdc, jscalars, pscalars, model


def test_diagnostics_tables_match_jax():
    """Every port table whose name maps to JAX holds JAX's statistics; the
    JAX tables without a port counterpart belong to no module the port
    has."""
    jdc, pdc, _, _, model = _tables()
    mapped = {pdiag.jax_table_name(n): n for n in pdc.stats}
    common = sorted(set(mapped) & set(jdc.stats))
    kinds = {"forward": 0, "param": 0, "param_grad": 0, "grad": 0}
    for name in common:
        _same_stats(pdc.stats[mapped[name]], jdc.stats[name], name)
        kind = ("param_grad" if name.endswith(".param_grad") else "param"
                if name.startswith("param/") else "grad" if name.endswith(".grad") else "forward")
        kinds[kind] += 1
    n_params = len(list(model.parameters()))
    assert kinds["param"] == kinds["param_grad"] == n_params, kinds
    assert kinds["forward"] >= 60 and kinds["grad"] >= 60, kinds
    modules = {"/".join(poptim.jax_scope(n)) for n, _ in model.named_modules()}
    unmatched = sorted(set(jdc.stats) - set(mapped))
    scopes = {n.removesuffix(".grad").rsplit("/__call__", 1)[0] for n in unmatched}
    assert not scopes & modules, sorted(scopes & modules)


def test_diagnostics_report_lines_match_jax_at_the_tables():
    """The printed tables: each matched forward table's lines, name for name
    but the module's (JAX's scope) name."""
    jdc, pdc, _, _, _ = _tables()
    name = "estimators.1.decoder.blocks.0.act"
    jname = pdiag.jax_table_name(name)
    assert jname == "estimators_1/decoder/blocks_0/act/__call__/0"
    ours = [line.replace(name, jname) for line in pdc.stats[name].report_lines(name)]
    theirs = jdc.stats[jname].report_lines(jname)
    assert len(ours) == len(theirs) and ours[0].split(",")[:4] == theirs[0].split(",")[:4]
    lines = []
    pdc.print_diagnostics(log=lines.append)
    assert sum(line.startswith("Diagnostics [") for line in lines) == len(pdc.stats)


def test_prelu_histogram_of_one_batch_matches_jax():
    """On one batch the port's histograms equal the JAX trainer's pass: the
    same limits, occupancies and mean |gradient| per bin."""
    jm, params, model, cfg = _pair("tiny")
    _, _, jscalars, _, _ = _tables()
    inp = _inputs(cfg, 2, 20, seed=21)
    cond, x0, x1, t, lens = (torch.from_numpy(inp[k]) for k in ("cond", "x0", "x1", "t", "lens"))
    values, stats = ({}, {}), {}
    with pdiag.DiagnosticsCollector().output_grads(model, values):
        model(cond, x1, lens, FMDraws(x0, t, gates=torch.ones(model.num_limiters))).backward()
    model.zero_grad()
    pdiag.collect_scalar_diagnostics(stats, *values)
    assert {"/".join(poptim.jax_scope(n)) for n in stats} == set(jscalars)
    assert len(stats) == 2 + 2 * 3  # the encoder's blocks, each branch's blocks and cond MLP
    for name, ours in stats.items():
        theirs = jscalars["/".join(poptim.jax_scope(name))]
        assert ours.limit == pytest.approx(theirs.limit, rel=1e-6), name
        counts = ours.counts.numpy()
        assert np.abs(counts - theirs.counts).sum() <= 2, name  # bin edges at float32 ties
        mean = ours.grad_abs.numpy() / np.maximum(counts, 1)
        ref = theirs.grad_abs / np.maximum(theirs.counts, 1)
        assert _close(mean, ref, 1e-3), name


# ----------------------------------------------------- non-finite outputs


def test_inf_born_in_a_module_is_named_first_as_jax_names_it():
    """An inf in one PReLU's alpha: its output is where the inf is born,
    the first the port names, and the first of JAX's deepest-first list."""
    jm, params, model, cfg = _pair("tiny")
    poisoned = jax.tree.map(np.array, params)
    poisoned["cond_encoder"]["blocks_0"]["act"]["alpha"][3] = np.inf
    inp = _inputs(cfg, 2, 20, seed=5)
    jargs = [jnp.asarray(inp[k]) for k in ("cond", "x0", "x1", "t", "lens")]
    _, inter = jax.jit(lambda p, *a: jm.apply({"params": p}, *a, method=_jax_loss(False),
                                              capture_intermediates=True,
                                              mutable=["intermediates"]))(poisoned, *jargs)
    theirs = jhooks.find_nonfinite_module_outputs(inter["intermediates"], limit=1000)
    port = load_jax_params(build_generator(cfg), poisoned)
    cond, x0, x1, t, lens = (torch.from_numpy(inp[k]) for k in ("cond", "x0", "x1", "t", "lens"))
    ours = phooks.find_nonfinite_module_outputs(port, lambda: port(cond, x1, lens, FMDraws(x0, t)),
                                                limit=1000)
    assert ours[0] == "cond_encoder.blocks.0.act"
    assert theirs[0] == "cond_encoder/blocks_0/act"
    assert "cond_encoder.blocks.0.pwconv1" not in ours  # upstream of the birth: finite
    # the same modules went non-finite (JAX's loss method is not a module call)
    assert {"/".join(poptim.jax_scope(n)) for n in ours if n != "<root>"} == set(theirs)


class _Inner(torch.nn.Module):
    def forward(self, x):
        return x / 0.0  # born here


class _Outer(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.ok_layer, self.bad_layer, self.after = (torch.nn.Linear(4, 4), _Inner(),
                                                     torch.nn.Linear(4, 4))

    def forward(self, x):
        return self.after(self.bad_layer(self.ok_layer(x)))


def test_nonfinite_module_localisation_and_limit():
    """The birth site first, before the modules that pass the inf on, the
    limit applied after that order; the hooks are gone afterwards."""
    model = _Outer()
    x = torch.ones(2, 4)
    bad = phooks.find_nonfinite_module_outputs(model, lambda: model(x))
    # the model's own inputs were finite too: it counts where the inf was
    # born, after the module inside it, and before the one that passed it on
    assert bad == ["bad_layer", "<root>", "after"]
    assert phooks.find_nonfinite_module_outputs(model, lambda: model(x), limit=1) == ["bad_layer"]
    assert not any(m._forward_hooks for m in model.modules())
    assert phooks.find_nonfinite_module_outputs(model, lambda: model(torch.zeros(0, 4))) == []


def test_guard_reports_parameters_and_module_outputs(caplog):
    """The JAX guard's arguments: non-finite parameters by name and the
    replay's modules; a failing replay is reported, never raised."""
    guard = phooks.NonfiniteLossGuard()
    state = {"a.w": torch.ones(2), "b.w": torch.tensor([1.0, float("nan")])}
    with caplog.at_level(logging.WARNING):
        guard.check(float("nan"), 0.0, 1, lambda s: None, params_tree=state,
                    intermediates_fn=lambda: ["mod"])
        guard.check(float("nan"), 0.0, 2, lambda s: None,
                    intermediates_fn=lambda: 1 / 0)
    messages = [r.getMessage() for r in caplog.records]
    assert "Non-finite params at: ['b.w']" in messages
    assert "The output of module mod is not finite" in messages
    assert any("inf-check forward replay failed" in m for m in messages)
    flags = phooks.finite_flags(state)
    assert not phooks.check_finite(flags, "params") and bool(flags["a"]) and not bool(flags["b"])
    theirs = jhooks.find_nonfinite_leaves({"a": {"w": np.ones(2)}, "b": {"w": np.array([1.0, np.nan])}})
    assert [n.replace("/", ".") for n in theirs] == phooks.find_nonfinite_leaves(state) == ["b.w"]


# ------------------------------------------------- optimizers' diagnostics


def test_dominant_parameters_match_jax():
    """The same gradients and RMS weights, two of them holding NaNs or infs:
    the same ranking (port names mapped to JAX's paths), shares within
    1e-6, rms alike."""
    jm, params, model, cfg = _pair("tiny")
    inp = _inputs(cfg, 2, 20, seed=9)
    jargs = [jnp.asarray(inp[k]) for k in ("cond", "x0", "x1", "t", "lens")]
    grads = jax.jit(jax.grad(lambda p, *a: jm.apply({"params": p}, *a,
                                                     method=_jax_loss(False))))(params, *jargs)
    grads = jax.tree.map(np.array, grads)
    grads["estimators_1"]["decoder"]["in_proj"]["kernel"][0, :3] = np.nan
    grads["cond_encoder"]["in_norm"]["bias"][1] = np.inf
    rms = jax.tree.map(lambda p: np.float32(0.0) if np.size(p) == 1
                       else np.sqrt(np.mean(np.square(np.asarray(p, np.float32)))), params)
    sd = jax_params_to_state_dict(grads)
    named = [(n, sd[n]) for n, _ in model.named_parameters()]
    rms_by_name = {}
    for n, _ in named:
        leaf = rms
        for key in poptim.jax_path(n):
            leaf = leaf[key]
        rms_by_name[n] = torch.tensor(leaf)
    for top_n in (5, 12):
        theirs = joptim.dominant_parameters(grads, param_rms=rms, top_n=top_n)
        ours = poptim.dominant_parameters(named, rms_by_name, top_n=top_n)
        assert ["/".join(poptim.jax_path(n)) for n, _, _ in ours] == [n for n, _, _ in theirs]
        for (_, share, grad_rms), (_, j_share, j_rms) in zip(ours, theirs):
            assert abs(share - j_share) <= 1e-6
            assert grad_rms == pytest.approx(j_rms, rel=1e-6)
    assert ours[0][2] == float("inf") and ours[1][2] == float("inf")


def test_named_param_rms_is_the_clipping_weight():
    model = torch.nn.Sequential(torch.nn.Linear(4, 3), torch.nn.Linear(3, 3))
    opt = poptim.ScaledAdam(model.named_parameters(), clipping_scale=2.0)
    rms = opt.named_param_rms()
    assert set(rms) == {n for n, _ in model.named_parameters()}
    for n, p in model.named_parameters():
        assert float(rms[n]) == pytest.approx(float(p.detach().square().mean().sqrt()), rel=1e-6)


def test_eve_matches_jax():
    """Five steps on tensors above and below the target rms (decay on and
    off) and a scalar (never decayed), with a float32 update as JAX's."""
    rng = np.random.RandomState(4)
    params = {"big": (0.5 * rng.randn(6, 5)).astype(np.float32),
              "small": (0.01 * rng.randn(7)).astype(np.float32),
              "scalar": np.float32(0.3)}
    jopt = joptim.Eve(lr=0.02)
    state = jopt.init(params)
    tensors = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    popt = poptim.Eve(tensors.values(), lr=0.02)
    jparams = params
    for step in range(5):
        grads = {k: (np.asarray(rng.randn(*np.shape(v))) * (1 + step)).astype(np.float32)
                 for k, v in params.items()}
        upd, state = jopt.update(grads, state, jparams)
        jparams = jax.tree.map(lambda p, u: np.asarray(p + u), jparams, upd)
        for k, p in tensors.items():
            p.grad = torch.tensor(grads[k])
        popt.step()
    for k, p in tensors.items():
        np.testing.assert_allclose(p.detach().numpy(), jparams[k], rtol=1e-6, atol=1e-6)
    # the big tensor was decayed, the small one not
    assert np.linalg.norm(params["big"]) > 0.1 * np.sqrt(30)
    assert np.linalg.norm(params["small"]) < 0.1 * np.sqrt(7)


# ------------------------------------------------------- discriminators


@pytest.mark.parametrize("kind", ["P", "R"])
def test_discriminator_embedding_term_matches_jax(kind):
    """num_embeddings with ids and a nonzero `emb`: the score gains
    sum(emb[id] * x) after conv_post, the feature maps do not."""
    length = 3000
    if kind == "P":
        jmod, port = (jd.DiscriminatorP(period=3, num_embeddings=4),
                      pd.DiscriminatorP(3, num_embeddings=4))
    else:
        jmod, port = (jd.DiscriminatorR(window_length=256, num_embeddings=4),
                      pd.DiscriminatorR(256, num_embeddings=4))
    x = jnp.asarray(np.random.RandomState(1).randn(2, length).astype(np.float32) * 0.3)
    ids = jnp.asarray([2, 0])
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), x, ids)["params"]
    assert not np.asarray(params["emb"]["embedding"]).any()  # zero-initialised
    params = dict(params, emb={"embedding": np.random.RandomState(2).randn(
        *params["emb"]["embedding"].shape).astype(np.float32) * 0.05})
    load_jax_params(port, params)
    j_score, j_fmap = jax.jit(jmod.apply)({"params": params}, x, ids)
    j_plain = jax.jit(jmod.apply)({"params": params}, x)[0]
    with torch.no_grad():
        score, fmap = port(torch.from_numpy(np.asarray(x)), torch.from_numpy(np.asarray(ids)))
        plain = port(torch.from_numpy(np.asarray(x)))[0]
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2) if np.ndim(a) == 4 else np.asarray(a)
    assert _close(score.numpy(), nchw(j_score), 1e-5)
    assert _close((score - plain).numpy(), nchw(j_score) - nchw(j_plain), 1e-5)
    assert np.abs(nchw(j_score) - nchw(j_plain)).max() > 1e-3  # the term is there
    assert _close(fmap[-1].numpy(), nchw(j_fmap[-1]), 1e-5)


def test_multi_discriminators_pass_the_bandwidth_id():
    torch.manual_seed(0)
    mpd = pd.MultiPeriodDiscriminator((2, 3), num_embeddings=3)
    for d in mpd.discriminators:
        torch.nn.init.normal_(d.emb.weight)
    y = torch.randn(2, 600)
    with torch.no_grad():
        with_id = mpd.judge(y, torch.tensor([1, 2]))[0]
        plain = mpd.judge(y)[0]
        direct = mpd.discriminators[1](y, torch.tensor([1, 2]))[0]
    assert torch.equal(with_id[1], direct) and not torch.equal(with_id[1], plain[1])
    mrd = pd.MultiResolutionDiscriminator((256,), num_embeddings=3)
    assert mrd.discriminators[0].emb.weight.shape == (3, 32)
    assert pd.Discriminators().discriminator_0.discriminators[0].emb is None


# ------------------------------------------------------- the event writer


def _write_events(tmp_path):
    rng = np.random.RandomState(0)
    wav = np.clip(0.5 * rng.randn(1000), -1.2, 1.2).astype(np.float32)
    image = plot_feature(rng.randn(20, 30))
    with utils_tb.SummaryWriter(tmp_path / "tb") as w:
        w.add_scalar("train/loss", 1.25, 3)
        w.add_scalar("train/loss", -0.5, 7)
        tracker = MetricsTracker()
        tracker["samples"] = 4
        tracker["loss"] = 10.0
        tracker.write_summary(w, "train/valid_", 7)
        w.add_audio("valid/a", wav, 7, 24000)
        w.add_image("valid/a_spec", image, 7, dataformats="HWC")
    return w.path, wav, image


def test_event_file_reads_back_through_tensorboard(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    path, wav, image = _write_events(tmp_path)
    assert path.name.startswith("events.out.tfevents.")
    acc = EventAccumulator(str(path), size_guidance={"scalars": 0, "images": 0, "audio": 0})
    acc.Reload()
    tags = acc.Tags()
    assert set(tags["scalars"]) == {"train/loss", "train/valid_loss"}
    assert tags["audio"] == ["valid/a"] and tags["images"] == ["valid/a_spec"]
    assert [(e.step, e.value) for e in acc.Scalars("train/loss")] == [(3, 1.25), (7, -0.5)]
    assert acc.Scalars("train/valid_loss")[0].value == 2.5
    audio = acc.Audio("valid/a")[0]
    assert (audio.step, audio.sample_rate, audio.length_frames) == (7, 24000, 1000)
    with wave.open(io.BytesIO(audio.encoded_audio_string)) as r:
        assert (r.getnchannels(), r.getsampwidth(), r.getframerate()) == (1, 2, 24000)
        pcm = np.frombuffer(r.readframes(r.getnframes()), "<i2") / 32767.0
    assert np.abs(pcm - np.clip(wav, -1, 1)).max() <= 1 / 32767
    img = acc.Images("valid/a_spec")[0]
    assert (img.width, img.height) == (30, 20)
    import matplotlib.image

    decoded = matplotlib.image.imread(io.BytesIO(img.encoded_image_string), format="png")
    np.testing.assert_array_equal(np.round(decoded[..., :3] * 255).astype(np.uint8), image)


def test_event_file_reads_back_through_tensorboardx(tmp_path):
    """The records' framing and CRCs by tensorboardX's CRC-32C, the events
    by its protobuf classes."""
    from tensorboardX.crc32c import crc32c
    from tensorboardX.proto.event_pb2 import Event

    path, _, _ = _write_events(tmp_path)
    data, events = path.read_bytes(), []
    masked = lambda b: (((crc32c(b) >> 15) | (crc32c(b) << 17)) + 0xA282EAD8) & 0xFFFFFFFF
    while data:
        header, data = data[:8], data[8:]
        (n,), (crc,) = struct.unpack("<Q", header), struct.unpack("<I", data[:4])
        assert crc == masked(header)
        body, (crc,) = data[4:4 + n], struct.unpack("<I", data[4 + n:8 + n])
        assert crc == masked(body)
        events.append(Event.FromString(body))
        data = data[8 + n:]
    assert events[0].file_version == "brain.Event:2"
    values = [(e.step, v.tag, v.WhichOneof("value")) for e in events[1:] for v in e.summary.value]
    assert values == [(3, "train/loss", "simple_value"), (7, "train/loss", "simple_value"),
                      (7, "train/valid_loss", "simple_value"), (7, "valid/a", "audio"),
                      (7, "valid/a_spec", "image")]
    assert events[2].summary.value[0].simple_value == -0.5
    assert utils_tb.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


def test_plot_feature_is_min_max_scaled_low_channels_at_the_bottom():
    x = np.zeros((4, 3))
    x[0] = 1.0  # the lowest channel is the brightest
    img = plot_feature(x)
    assert img.shape == (4, 3, 3) and img.dtype == np.uint8
    assert (img[-1] == (253, 231, 37)).all() and (img[0] == (68, 1, 84)).all()


def test_env_info_has_jax_keys_with_torch_versions():
    info = get_env_info(torch.device("cpu"))
    assert set(info) == {"git-sha1", "hostname", "python-version", "num-devices", "backend",
                         "torch-version", "cuda-version", "device-name"}
    assert info["backend"] == "cpu" and info["num-devices"] == "1"
    assert info["torch-version"] == torch.__version__ and info["device-name"] == "cpu"


# ------------------------------------------------------ the trainers


def _poison(step_fn, at: int):
    """`step_fn` with row 0 of the audio of its `at`-th call set to NaN."""
    calls = []

    def poisoned(*args, **kwargs):
        calls.append(1)
        batch = next(a for a in args if isinstance(a, dict))
        if len(calls) == at:
            batch["audio"][0] = float("nan")
        return step_fn(*args, **kwargs)

    return poisoned


def _log(exp):
    """The messages of a trainer's log file (the trainer sets up the root
    logger itself)."""
    (path,) = glob.glob(str(exp / "log" / "log-train-*"))
    lines = open(path).read().splitlines()
    return [line.split("] ", 1)[1] for line in lines if "] " in line]


def _tags(exp):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    (path,) = glob.glob(str(exp / "tensorboard" / "events.out.tfevents.*"))
    acc = EventAccumulator(path, size_guidance={"scalars": 0, "images": 0, "audio": 0})
    acc.Reload()
    return acc.Tags()


def test_pretrain_runs_every_observability_flag(tmp_path, monkeypatch):
    """mel_24k_tiny, 6 steps: TensorBoard with the test samples at 1 and 2
    steps, the profiled window (moved to batches 2-3), the best validation
    loss and env_info in the checkpoints, --inf-check on a poisoned batch;
    then --print-diagnostics."""
    import json

    from flow2gan_tpu_torch.bin import pretrain
    from flow2gan_tpu_torch.training import checkpoint as ckpt

    from .test_torch_port_trainer import _args, _corpus

    manifest = _corpus(tmp_path, n=12)
    exp = tmp_path / "exp"
    monkeypatch.setattr(pretrain, "PROFILED_BATCHES", (2, 3))
    monkeypatch.setattr(pretrain, "fm_train_step", _poison(pretrain.fm_train_step, at=4))
    history = pretrain.run(pretrain.get_parser().parse_args(_args(
        exp, manifest, "--num-epochs", "1", "--test-recordings", str(manifest),
        "--save-infer-steps", "1,2", "--profile-dir", str(tmp_path / "prof"),
        "--inf-check", "true", "--valid-interval", "3")))
    assert [h["clip_scale"] for h in history] == [1.0, 1.0, 1.0, 0.0, 1.0, 1.0]
    warned = _log(exp)
    assert any(w.startswith("Dominant grad: ") for w in warned)
    assert "The output of module cond_encoder.in_proj is not finite" in warned
    assert not any("replay failed" in w for w in warned)
    (trace,) = (tmp_path / "prof").glob("trace-batches-2-3-rank0.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert events
    # the window turned the program's tracing on: its spans mark the trace
    marks = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"fm.step", "fm.forward", "fm.backward", "optim.step", "branch"} <= marks
    assert not tracing.enabled()
    tags = _tags(exp)
    assert {"train/current_loss_0", "train/learning_rate", "train/tot_loss_0_loss",
            "train/valid_loss"} <= set(tags["scalars"])
    # 12 whole files: the first 8 are the test batch, ground truth once
    assert {f"valid/test_audio_{i}_{k}" for i in range(8) for k in ("gt", "step_1", "step_2")
            } == set(tags["audio"])
    assert set(tags["images"]) == {f"{t}_spec" for t in tags["audio"]}
    for name in ("epoch-0.pt", "epoch-1.pt", "checkpoint-6.pt"):
        saved = ckpt.load_checkpoint(exp / name)
        assert saved["env_info"]["backend"] == "cpu" and "git-sha1" in saved["env_info"]
    last = ckpt.load_checkpoint(exp / "epoch-1.pt")
    assert np.isfinite(last["best_valid_loss"]) and last["best_valid_epoch"] == 1

    history = pretrain.run(pretrain.get_parser().parse_args(_args(
        tmp_path / "diag", manifest, "--num-epochs", "1", "--print-diagnostics", "true",
        "--tensorboard", "false")))
    assert len(history) == 5
    lines = _log(tmp_path / "diag")
    tables = [line for line in lines if line.startswith("Diagnostics [")]
    assert {"Diagnostics [cond_encoder.in_proj]", "Diagnostics [cond_encoder.in_proj.grad]",
            "Diagnostics [param/cond_encoder.in_proj.weight]",
            "Diagnostics [param/cond_encoder.in_proj.weight.param_grad]"} <= {
                t.split(":")[0] for t in tables}
    assert sum(line.startswith("ScalarDiagnostics [") for line in lines) == 8
    assert lines[-1] == "Diagnostics done, exiting"
    assert not (tmp_path / "diag" / "epoch-1.pt").exists()


def test_finetune_runs_every_observability_flag(tmp_path, monkeypatch):
    """mel_24k_tiny at 2 Euler steps, narrow discriminators: TensorBoard
    (every metric of both sides, the test samples at 2 steps), the profiled
    window, --inf-check on a poisoned G step (the G side's dominant
    gradients); then --print-diagnostics through the G objective."""
    import json

    import flow2gan_tpu_torch
    from flow2gan_tpu_torch.bin import finetune
    from flow2gan_tpu_torch.bin import pretrain
    from flow2gan_tpu_torch.training import checkpoint as ckpt

    from .test_torch_port_gan import _ft_args
    from .test_torch_port_trainer import _corpus

    manifest = _corpus(tmp_path, n=12)
    init = tmp_path / "fm.pt"
    torch.save(flow2gan_tpu_torch.get_model("mel_24k_tiny", device="cpu", seed=9)
               .module.state_dict(), init)
    monkeypatch.setattr(pd.DiscriminatorP, "CHANNELS", (8, 16, 16, 32, 32))
    monkeypatch.setattr(finetune, "Discriminators", lambda: pd.Discriminators((2, 3), (256, 128)))
    monkeypatch.setattr(pretrain, "PROFILED_BATCHES", (3, 4))
    make_steps = finetune.make_gan_steps

    def steps(*args, **kwargs):
        d, g, e = make_steps(*args, **kwargs)
        return d, _poison(g, at=2), e

    monkeypatch.setattr(finetune, "make_gan_steps", steps)
    common = ("--generator-model-path", str(init), "--num-epochs", "1")
    exp = tmp_path / "exp"
    history = finetune.run(finetune.get_parser().parse_args(_ft_args(
        exp, manifest, *common, "--inf-check", "true", "--test-recordings", str(manifest),
        "--profile-dir", str(tmp_path / "prof"))))
    assert [(h["side"], h["clip_scale"]) for h in history] == [
        ("D", 1.0), ("D", 1.0), ("G", 1.0), ("D", 1.0), ("G", 0.0), ("D", 1.0)]
    warned = _log(exp)
    assert any(w.startswith("Dominant G grad: ") for w in warned)
    assert any(w.startswith("The output of module ") for w in warned)
    assert not any("replay failed" in w for w in warned)
    (trace,) = (tmp_path / "prof").glob("trace-batches-3-4-rank0.json")
    marks = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"solve.step", "branch", "optim.step"} <= marks
    assert not tracing.enabled()
    tags = _tags(exp)
    assert {"train/loss_d", "train/disc_loss_mp", "train/lr_d", "train/loss_g",
            "train/mel_recon_loss", "train/lr_g", "train/clip_scale", "train/valid_loss_g",
            "train/valid_mel_recon_loss"} <= set(tags["scalars"])
    assert {f"valid/test_audio_{i}_{k}" for i in range(8) for k in ("gt", "step_2")} == set(
        tags["audio"])
    assert ckpt.load_checkpoint(exp / "epoch-1.pt")["env_info"]["backend"] == "cpu"

    monkeypatch.setattr(finetune, "make_gan_steps", make_steps)

    history = finetune.run(finetune.get_parser().parse_args(_ft_args(
        tmp_path / "diag", manifest, *common, "--print-diagnostics", "true",
        "--tensorboard", "false")))
    assert len(history) == 5
    lines = _log(tmp_path / "diag")
    names = {line.split("]: ")[0] + "]" for line in lines if line.startswith("Diagnostics [")}
    # the rollout's second Euler step is tabled apart; the discriminators not
    assert {"Diagnostics [estimators.0[1]]", "Diagnostics [estimators.0[1].grad]",
            "Diagnostics [param/estimators.0.decoder.out_proj.weight.param_grad]"} <= names
    assert not any("discriminator" in n for n in names)
    assert sum(line.startswith("ScalarDiagnostics [") for line in lines) == 2 + 2 * 3 * 2
    assert lines[-1] == "Diagnostics done, exiting"


def test_nonfinite_outputs_of_a_token_model_with_integer_inputs():
    """The embedding's input is integer ids: it counts as finite, and the
    inf born in the first block's PReLU is named first."""
    from flow2gan_tpu_torch.api import init_weights
    from flow2gan_tpu_torch.models import get_generator_config

    model = init_weights(build_generator(get_generator_config("token_24k_tiny")),
                         torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.cond_encoder.blocks[0].act.alpha[2] = float("inf")
    ids = torch.randint(0, 8, (1, 12))
    bad = phooks.find_nonfinite_module_outputs(model, lambda: model.infer(ids))
    assert bad[0] == "cond_encoder.blocks.0.act" and "token_embed" not in bad
