"""The port's ScaledAdam, Eden schedules, checkpoint averaging and
non-finite-loss guard against the JAX package's.

Tolerances: the ScaledAdam trajectory within 2e-6 of max|param| per tensor
at every step (float32, reductions in another order), with per-parameter lr
scales and a frozen subtree too, and the clipping factor within 1e-5; the schedules within 1e-6 relative (JAX computes them in
float32, the port in float64); the float64 averages within 1e-12.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from flow2gan_tpu.training import checkpoint as jckpt
from flow2gan_tpu.training.optim import eden2_lr as j_eden2_lr
from flow2gan_tpu.training.optim import eden_lr as j_eden_lr
from flow2gan_tpu.training.optim import make_lr_scale_tree as j_make_lr_scale_tree
from flow2gan_tpu.training.optim import parse_lr_scale_rules as j_parse_lr_scale_rules
from flow2gan_tpu.training.optim import scaled_adam

from flow2gan_tpu_torch.training import checkpoint as ckpt
from flow2gan_tpu_torch.training.hooks import NonfiniteLossGuard
from flow2gan_tpu_torch.training.optim import (
    ScaledAdam,
    eden2_lr,
    eden_lr,
    jax_path,
    make_eden,
    make_eden2,
    make_lr_scales,
    parse_lr_scale_rules,
)

SHAPES = {
    "w1": (6, 5),
    "w2": (6, 5),  # the same shape as w1: one stacked group
    "b1": (6,),
    "scalar": (),
    "deep": (3, 4, 2),
}
N_STEPS = 300
NAN_STEPS = (3, 150)  # before the threshold is calibrated, and after
BASE_LR, LR_BATCHES = 0.045, 75.0


def _inputs():
    rng = np.random.RandomState(0)

    def randn(shape, scale=1.0):
        return np.asarray(rng.randn(*shape) * scale, np.float32).reshape(shape)

    params = {k: randn(s, 0.5) for k, s in SHAPES.items()}
    grads = []
    for i in range(N_STEPS):
        g = {k: randn(s) for k, s in SHAPES.items()}
        if i % 37 == 5:  # spikes that the clipping cuts
            g = {k: np.asarray(v * 25.0, np.float32).reshape(v.shape) for k, v in g.items()}
        if i in NAN_STEPS:
            g["w1"] = g["w1"].copy()
            g["w1"][0, 0] = np.nan
        grads.append(g)
    return params, grads


def test_scaled_adam_trajectory_matches_jax():
    params0, grads = _inputs()
    opt = scaled_adam(clipping_scale=2.0)
    jp = {k: jnp.asarray(v) for k, v in params0.items()}
    state = opt.init(jp)

    @jax.jit
    def jstep(p, s, g, lr):
        updates, s = opt.update(g, s, p, lr=lr)
        return optax.apply_updates(p, updates), s

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params0.items()}
    topt = ScaledAdam(list(tp.items()), clipping_scale=2.0)
    assert len(topt.groups) == 4  # w1 and w2 stacked
    clipped = 0
    for i, g in enumerate(grads):
        jp, state = jstep(jp, state, {k: jnp.asarray(v) for k, v in g.items()},
                          j_eden2_lr(BASE_LR, i, LR_BATCHES))
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        topt.step(eden2_lr(BASE_LR, i, LR_BATCHES))
        ours, ref = float(topt.clip_scale), float(state.clip_scale)
        assert abs(ours - ref) <= 1e-5, (i, ours, ref)
        if i in NAN_STEPS:
            assert ours == 0.0  # the update was zeroed
        clipped += 0.0 < ours < 1.0
        for k in tp:
            theirs = np.asarray(jp[k])
            err = np.abs(tp[k].detach().numpy() - theirs).max() / (np.abs(theirs).max() + 1e-8)
            assert err < 2e-6, (i, k, err)
    assert clipped >= 5
    assert all(np.isfinite(p.detach().numpy()).all() for p in tp.values())
    assert float(topt.model_norm_threshold) == pytest.approx(float(state.model_norm_threshold), rel=1e-5)
    assert int(topt.num_clipped) == int(state.num_clipped)


@pytest.mark.parametrize("rules,freeze", [
    (None, None), ("", ""), ("enc=0.5, dec/c=2.0", "cond_encoder, estimators_0"),
    ("estimators_0/blocks_0=0.1", None), (None, "cond_encoder"), ("a=1e-3,b=0", "a"),
])
def test_parse_lr_scale_rules_matches_jax(rules, freeze):
    assert parse_lr_scale_rules(rules, freeze) == j_parse_lr_scale_rules(rules, freeze)


def test_parse_lr_scale_rules_rejects_a_rule_without_a_scale():
    for parse in (parse_lr_scale_rules, j_parse_lr_scale_rules):
        with pytest.raises(ValueError, match="prefix=scale"):
            parse("enc0.5", None)


def test_lr_scales_match_jax_leaves_on_mel_24k_tiny():
    """Each port parameter of mel_24k_tiny (and of a pair of discriminators)
    gets the scale of its JAX leaf: `jax_path` names every leaf of the JAX
    tree once, and the rules compose by multiplication along the path."""
    from flow2gan_tpu.models import discriminators as jd
    from flow2gan_tpu_torch.models import discriminators as pd

    from .test_torch_port_train import _pair

    rules = j_parse_lr_scale_rules(
        "cond_encoder=0.5,estimators_0/decoder/blocks_0=0.1,estimators_0=3,"
        "estimators_1/decoder/blocks_1/dwconv/kernel=0.25,discriminator_1=0.2",
        "estimators_1/decoder/blocks_0,discriminator_0/discriminators_1/convs_2")
    jm, params, model, _ = _pair("tiny")
    zeros = jnp.zeros((1, 1024))
    jdisc = jd.Discriminators(periods=(2, 3), fft_sizes=(256, 128))
    disc_params = jax.jit(jdisc.init)(jax.random.PRNGKey(0), zeros, zeros)["params"]
    for tree, module in ((params, model), (disc_params, pd.Discriminators((2, 3), (256, 128)))):
        theirs = {tuple(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in
                  jax.tree_util.tree_flatten_with_path(j_make_lr_scale_tree(tree, rules))[0]}
        ours = {jax_path(name): scale
                for name, scale in make_lr_scales(module.named_parameters(), rules).items()}
        assert ours == theirs
        assert len(set(ours.values())) >= 3


def test_scaled_adam_with_lr_scales_and_a_frozen_subtree_matches_jax():
    """300 steps with per-parameter scales (composed along the path) and a
    frozen subtree: within 2e-6 of JAX's `lr_scale` trajectory, the clipping
    statistic equal. A frozen tensor keeps its value bit for bit while its
    second moment and the clipping norm still see its gradient."""
    params0, grads = _inputs()
    tree = lambda d: {"enc": {"w1": d["w1"], "sub": {"w2": d["w2"]}}, "b1": d["b1"],
                      "scalar": d["scalar"], "deep": d["deep"]}
    names = {"w1": "enc.w1", "w2": "enc.sub.w2", "b1": "b1", "scalar": "scalar", "deep": "deep"}
    rules = j_parse_lr_scale_rules("enc=0.5,enc/sub=0.2,scalar=3", "deep")
    opt = scaled_adam(clipping_scale=2.0)
    jp = tree({k: jnp.asarray(v) for k, v in params0.items()})
    lr_scale = j_make_lr_scale_tree(jp, rules)
    state = opt.init(jp)

    @jax.jit
    def jstep(p, s, g, lr):
        updates, s = opt.update(g, s, p, lr=lr, lr_scale=lr_scale)
        return optax.apply_updates(p, updates), s

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params0.items()}
    scales = make_lr_scales([(names[k], p) for k, p in tp.items()], rules)
    assert scales == {"enc.w1": 0.5, "enc.sub.w2": 0.5 * 0.2, "b1": 1.0, "scalar": 3.0,
                      "deep": 0.0}
    topt = ScaledAdam([(names[k], p) for k, p in tp.items()], clipping_scale=2.0,
                      lr_scales=scales)
    flat = lambda t: {"w1": t["enc"]["w1"], "w2": t["enc"]["sub"]["w2"], "b1": t["b1"],
                      "scalar": t["scalar"], "deep": t["deep"]}
    for i, g in enumerate(grads):
        jp, state = jstep(jp, state, tree({k: jnp.asarray(v) for k, v in g.items()}),
                          j_eden2_lr(BASE_LR, i, LR_BATCHES))
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        topt.step(eden2_lr(BASE_LR, i, LR_BATCHES))
        assert abs(float(topt.clip_scale) - float(state.clip_scale)) <= 1e-5, i
        ref = flat(jp)
        for k in tp:
            theirs = np.asarray(ref[k])
            err = np.abs(tp[k].detach().numpy() - theirs).max() / (np.abs(theirs).max() + 1e-8)
            assert err < 2e-6, (i, k, err)
    np.testing.assert_array_equal(tp["deep"].detach().numpy(), params0["deep"])
    deep_eas = [g.exp_avg_sq for g in topt.groups if g.names == ["deep"]][0][0]
    np.testing.assert_allclose(deep_eas.numpy(), np.asarray(state.exp_avg_sq["deep"]),
                               rtol=1e-5, atol=0)
    assert float(deep_eas.abs().max()) > 0
    assert float(topt.model_norm_threshold) == pytest.approx(float(state.model_norm_threshold),
                                                             rel=1e-5)
    assert int(topt.num_clipped) == int(state.num_clipped)


def test_scaled_adam_state_dict_round_trip():
    """A restored optimizer continues exactly where the saved one was."""
    params0, grads = _inputs()

    def fresh():
        tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params0.items()}
        return tp, ScaledAdam(list(tp.items()), clipping_scale=2.0)

    def run(tp, opt, steps):
        for i in steps:
            for k, p in tp.items():
                p.grad = torch.tensor(grads[i][k])
            opt.step(eden2_lr(BASE_LR, i, LR_BATCHES))

    tp, opt = fresh()
    run(tp, opt, range(45))
    saved = copy.deepcopy((opt.state_dict(), {k: p.detach() for k, p in tp.items()}))
    run(tp, opt, range(45, 60))
    tp2, opt2 = fresh()
    opt2.load_state_dict(saved[0])
    with torch.no_grad():
        for k, p in tp2.items():
            p.copy_(saved[1][k])
    run(tp2, opt2, range(45, 60))
    for k in tp:
        torch.testing.assert_close(tp2[k], tp[k], rtol=0, atol=0)
    with pytest.raises(KeyError):
        ScaledAdam([("other", torch.nn.Parameter(torch.zeros(2)))]).load_state_dict(saved[0])


def test_scaled_adam_zero_and_missing_grads_stay_finite():
    w = torch.nn.Parameter(torch.ones(4, 4))
    frozen = torch.nn.Parameter(torch.ones(3))
    opt = ScaledAdam([("w", w), ("frozen", frozen)], clipping_scale=2.0)
    for _ in range(5):
        w.grad = torch.zeros(4, 4)
        opt.step(0.01)
    assert torch.isfinite(w).all() and torch.equal(frozen, torch.ones(3))


@pytest.mark.parametrize("batch", [0, 1, 100, 499, 500, 501, 5000, 7500, 100000])
def test_eden_schedules_match_jax(batch):
    for kw in ({}, {"warmup_batches": 500.0, "warmup_start": 0.1}):
        ours, ref = eden2_lr(0.035, batch, 7500.0, **kw), float(j_eden2_lr(0.035, batch, 7500.0, **kw))
        assert abs(ours - ref) <= 1e-6 * ref
        for epoch in (0, 3, 40):
            ours = eden_lr(0.035, batch, epoch, 7500.0, 10.0, **kw)
            ref = float(j_eden_lr(0.035, batch, epoch, 7500.0, 10.0, **kw))
            assert abs(ours - ref) <= 1e-6 * ref


def test_scheduler_state_round_trip():
    s = make_eden2(0.035, 7500)
    for _ in range(10):
        s.step_batch()
    s2 = make_eden2(0.035, 7500)
    s2.load_state_dict(s.state_dict())
    assert s2.get_lr() == s.get_lr() == eden2_lr(0.035, 10, 7500)
    e = make_eden(0.035, 7500, 10)
    e.step_epoch(4)
    assert e.get_lr() == eden_lr(0.035, 0, 4, 7500, 10)


def _states(n, seed=0):
    rng = np.random.RandomState(seed)
    return [{"a.weight": rng.randn(4, 3).astype(np.float32), "a.bias": rng.randn(4).astype(np.float32),
             "s": np.asarray(rng.randn(), np.float32)} for _ in range(n)]


def _torch(state, dtype=torch.float32):
    return {k: torch.tensor(v, dtype=dtype) for k, v in state.items()}


def test_running_average_matches_jax():
    states = _states(5)
    javg = {k: np.asarray(v, np.float64) for k, v in states[0].items()}
    avg = _torch(states[0], torch.float64)
    for step, cur in enumerate(states[1:], start=1):
        javg = jckpt.update_averaged_model(javg, cur, 1, step + 1)
        avg = ckpt.update_averaged_model(avg, _torch(cur), 1, step + 1)
    for k in javg:
        assert avg[k].dtype == torch.float64
        np.testing.assert_allclose(avg[k].numpy(), javg[k], rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(avg["a.weight"].numpy(),
                               np.mean([s["a.weight"] for s in states], axis=0, dtype=np.float64),
                               rtol=1e-12, atol=1e-12)


def test_checkpoint_averages_match_jax(tmp_path):
    """A plain average of epoch checkpoints and the windowed average of their
    running averages, written both ways from the same values."""
    models, avgs = _states(3, seed=1), _states(3, seed=2)
    batches = [0, 40, 100]
    jfiles, files = [], []
    for e in range(3):
        jf, f = tmp_path / f"epoch-{e}.ckpt", tmp_path / f"epoch-{e}.pt"
        jckpt.save_checkpoint(jf, params=models[e], model_avg={k: np.asarray(v, np.float64)
                                                                  for k, v in avgs[e].items()},
                              train_params={"batch_idx_train": batches[e]})
        ckpt.save_checkpoint(f, model=_torch(models[e]), model_avg=_torch(avgs[e], torch.float64),
                             train_params={"batch_idx_train": batches[e]})
        jfiles.append(jf)
        files.append(f)
    plain, jplain = ckpt.average_checkpoints(files[1:]), jckpt.average_checkpoints(jfiles[1:])
    window = ckpt.average_checkpoints_with_averaged_model(files[0], files[2])
    jwindow = jckpt.average_checkpoints_with_averaged_model(jfiles[0], jfiles[2])
    for k in models[0]:
        assert plain[k].dtype == window[k].dtype == torch.float32
        np.testing.assert_allclose(plain[k].numpy(), jplain[k], rtol=1e-7, atol=1e-7)
        np.testing.assert_allclose(window[k].numpy(), jwindow[k], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="empty window"):
        ckpt.average_checkpoints_with_averaged_model(files[2], files[1])


def test_checkpoint_topk_and_reload(tmp_path):
    state = _torch(_states(1)[0])
    for n in (5, 100, 20, 7):
        ckpt.save_checkpoint_with_global_batch_idx(tmp_path, n, model=state,
                                                   train_params={"batch_idx_train": n})
    (tmp_path / "checkpoint-x.pt").write_bytes(b"")
    names = [p.rsplit("/", 1)[-1] for p in ckpt.find_checkpoints(tmp_path)]
    assert names == ["checkpoint-100.pt", "checkpoint-20.pt", "checkpoint-7.pt", "checkpoint-5.pt"]
    assert len(ckpt.find_checkpoints(tmp_path, iteration=-20)) == 2
    ckpt.remove_checkpoints(tmp_path, topk=2)
    assert len(ckpt.find_checkpoints(tmp_path)) == 2
    loaded = ckpt.load_checkpoint(tmp_path / "checkpoint-100.pt")
    assert loaded["batch_idx_train"] == 100 and loaded["optimizer"] is None
    for k, v in state.items():
        torch.testing.assert_close(loaded["model"][k], v, rtol=0, atol=0)
    assert not list(tmp_path.glob("*.tmp"))


def test_nonfinite_loss_guard():
    g = NonfiniteLossGuard(max_streak=3)
    dumps = []
    g.check(1.0, 1.0, 1, dumps.append)  # finite: no-op
    g.check(float("nan"), 0.0, 2, dumps.append)  # the update was zeroed: go on
    assert dumps == ["-first-nonfinite"]
    with pytest.raises(RuntimeError, match="non-finite at batch 3"):
        g.check(float("nan"), 1.0, 3, dumps.append)  # the update was applied: stop
    assert dumps == ["-first-nonfinite", ""]
    g2 = NonfiniteLossGuard(max_streak=2)
    g2.check(float("inf"), 0.0, 1, lambda s: None)
    with pytest.raises(RuntimeError):  # the streak limit, even when zeroed
        g2.check(float("nan"), 0.0, 2, lambda s: None)
