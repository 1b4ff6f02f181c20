"""The ConvNeXt blocks' train-form Function (`ops/convnext_chain_train.py`)
on the CPU.

- the Function's plain path (the dispatch forced on) against the eager
  block's autograd in float64: the output and the gradients of x, the cond,
  the time embedding and every parameter, with the limiters' gates all on,
  all off, mixed and absent and the parameters pushed past their limits so
  that the flips act; a ragged mask, cond factors 1, 2 and 4, an
  unconditioned (cond encoder) block, no residual scale; the same under
  non-reentrant `torch.utils.checkpoint`;
- each backward kernel's plain version against autograd of the forward it
  differentiates, in float64;
- what autograd keeps: the Function about 5 N floats a block, the eager
  chain about 12.8 N;
- the dispatch: bf16, hooked, CPU and no-grad blocks never reach the
  Function;
- the CUDA wrappers' arguments to the kernels (the library stubbed), the
  shapes they refuse, and the plans at the training cells' shapes.

The kernels themselves need the card: `chip_smoke.py` phase 24 holds them
against these plain versions there.
"""

import types

import pytest
import torch
import torch.utils.checkpoint

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.models import convnext
from flow2gan_tpu_torch.models.convnext import ConvNeXtBlock, takes_train_chain
from flow2gan_tpu_torch.models.norms import number_limiters
from flow2gan_tpu_torch.ops import convnext_chain as chain
from flow2gan_tpu_torch.ops import convnext_chain_train as tc
from flow2gan_tpu_torch.utils import make_valid_mask


@pytest.fixture(autouse=True)
def _fresh():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    tracing.disable()
    tracing.drain()
    yield
    tracing.disable()
    tracing.drain()
    torch.set_num_threads(threads)


def _block(channels=48, conditioned=True, f=1, residual_scale=True, seed=0):
    """A float64 block, every parameter drawn; BiasNorm's log-scale above
    its limit (1.5) and the residual scales on both sides of [0.5, 1], so
    that gated limiters flip."""
    block = ConvNeXtBlock(channels, 3 * channels, 7, conditioned=conditioned,
                          cond_channels=24 if conditioned else 0,
                          time_embed_channels=16 if conditioned else 0,
                          use_residual_scale=residual_scale, cond_upsample_factor=f)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in block.named_parameters():
            if name.endswith("log_scale"):
                p.fill_(1.6)
            elif name.endswith("residual_scale.scale"):
                p.copy_(0.3 + 0.9 * torch.rand(p.shape, generator=gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    number_limiters(block)
    return block.double()


def _inputs(block, batch=3, frames=37, ragged=True, seed=1):
    gen = torch.Generator().manual_seed(seed)
    channels, f = block.dwconv.weight.shape[0], block.cond_upsample_factor
    x = torch.randn(batch, frames, channels, generator=gen, dtype=torch.float64)
    cond = time_embed = mask = None
    if block.cond_proj is not None:
        cond = torch.randn(batch, -(-frames // f), 24, generator=gen, dtype=torch.float64)
        time_embed = torch.randn(batch, 16, generator=gen, dtype=torch.float64)
    if ragged:
        lens = torch.randint(1, frames + 1, (batch,), generator=gen)
        lens[0] = frames
        mask = make_valid_mask(lens, frames)[..., None].double()
    grad = torch.randn(batch, frames, channels, generator=gen, dtype=torch.float64)
    return x, cond, time_embed, mask, grad


def _gates(block, kind):
    n = sum(1 for m in (block.norm, block.residual_scale) if m is not None)
    return {"none": None, "on": torch.ones(n, dtype=torch.float64),
            "off": torch.zeros(n, dtype=torch.float64),
            "mixed": torch.tensor([1.0, 0.0][:n], dtype=torch.float64)}[kind]


def _forced(monkeypatch):
    """The train-form dispatch as on the card, for any device."""
    monkeypatch.setattr(convnext, "takes_train_chain",
                        lambda x, dtype: dtype is None and torch.is_grad_enabled())


def _run(block, x, cond, time_embed, mask, gates, grad, checkpointed=False):
    """The output and every gradient (x, cond, time embedding, parameters)."""
    block.zero_grad()
    leaves = {"x": x, "cond": cond, "time_embed": time_embed}
    leaves = {k: v.detach().requires_grad_() for k, v in leaves.items() if v is not None}
    args = (leaves["x"], leaves.get("cond"), leaves.get("time_embed"), mask, gates)
    if checkpointed:
        out = torch.utils.checkpoint.checkpoint(block, *args, use_reentrant=False)
    else:
        out = block(*args)
    (out * grad).sum().backward()
    grads = {k: v.grad for k, v in leaves.items()}
    grads.update({k: p.grad.clone() for k, p in block.named_parameters()})
    return out.detach(), grads


def _fused(monkeypatch, *args, **kwargs):
    with monkeypatch.context() as m:
        _forced(m)
        calls = []
        real = tc.TrainChain.apply
        m.setattr(tc.TrainChain, "apply", lambda *a: calls.append(1) or real(*a))
        result = _run(*args, **kwargs)
    assert calls, "the Function did not run"
    return result


def _assert_close(ours, ref, tol=1e-12):
    out, grads = ours
    ref_out, ref_grads = ref
    assert torch.allclose(out, ref_out, rtol=0, atol=tol * ref_out.abs().max())
    assert grads.keys() == ref_grads.keys()
    for name, g in ref_grads.items():
        err = (grads[name] - g).norm() / max(g.norm(), 1e-300)
        assert err <= tol, f"{name}: {err}"


@pytest.mark.parametrize("gates", ["none", "on", "off", "mixed"])
@pytest.mark.parametrize("conditioned,f", [(True, 1), (True, 2), (True, 4), (False, 1)],
                         ids=["f1", "f2", "f4", "cond_encoder"])
def test_function_equals_the_eager_block_in_float64(monkeypatch, conditioned, f, gates):
    block = _block(conditioned=conditioned, f=f, seed=f)
    x, cond, time_embed, mask, grad = _inputs(block, seed=f + 10)
    g = _gates(block, gates)
    _assert_close(_fused(monkeypatch, block, x, cond, time_embed, mask, g, grad),
                  _run(block, x, cond, time_embed, mask, g, grad))


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("residual_scale", [True, False], ids=["scale", "no_scale"])
def test_function_with_and_without_mask_and_residual_scale(monkeypatch, ragged, residual_scale):
    block = _block(residual_scale=residual_scale, f=2, seed=4)
    x, cond, time_embed, mask, grad = _inputs(block, frames=29, ragged=ragged, seed=5)
    g = _gates(block, "on")
    _assert_close(_fused(monkeypatch, block, x, cond, time_embed, mask, g, grad),
                  _run(block, x, cond, time_embed, mask, g, grad))


def test_the_limiters_flip_through_the_function(monkeypatch):
    """Past their limits, gated limiters change the log-scale's and the
    residual scale's gradients; the Function passes them through the same
    flips as the eager block."""
    block = _block(seed=7)
    x, cond, time_embed, mask, grad = _inputs(block, seed=8)
    off = _fused(monkeypatch, block, x, cond, time_embed, mask, _gates(block, "off"), grad)[1]
    if off["norm.log_scale"] > 0:  # above its limit, a negative gradient flips
        grad = -grad
    on = _fused(monkeypatch, block, x, cond, time_embed, mask, _gates(block, "on"), grad)[1]
    off = _fused(monkeypatch, block, x, cond, time_embed, mask, _gates(block, "off"), grad)[1]
    for name in ("norm.log_scale", "residual_scale.scale"):
        assert not torch.equal(on[name], off[name]), name
    assert torch.equal(on["pwconv1.weight"], off["pwconv1.weight"])


@pytest.mark.parametrize("conditioned,f", [(True, 4), (False, 1)], ids=["f4", "cond_encoder"])
def test_function_under_checkpoint_gives_the_same_gradients(monkeypatch, conditioned, f):
    block = _block(conditioned=conditioned, f=f, seed=9)
    x, cond, time_embed, mask, grad = _inputs(block, seed=10)
    g = _gates(block, "mixed")
    plain = _fused(monkeypatch, block, x, cond, time_embed, mask, g, grad)
    recomputed = _fused(monkeypatch, block, x, cond, time_embed, mask, g, grad, checkpointed=True)
    assert torch.equal(plain[0], recomputed[0])
    for name, value in plain[1].items():
        assert torch.equal(value, recomputed[1][name]), name


def _saved_floats(monkeypatch, fused: bool, f: int) -> float:
    """Floats of the activations autograd keeps for one conditioned block,
    in units of N = B * T * C (each tensor once; parameters and tensors
    smaller than a row a frame left out)."""
    block = _block(f=f, seed=11)
    x, cond, time_embed, mask, _ = _inputs(block, batch=2, frames=64, seed=12)
    params = {p.data_ptr() for p in block.parameters()}
    seen = {}

    def pack(t):
        if t.data_ptr() not in params and t.numel() >= x.shape[0] * x.shape[1]:
            seen[(t.data_ptr(), t.numel())] = t.numel()
        return t

    x = x.requires_grad_()
    with monkeypatch.context() as m:
        if fused:
            _forced(m)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            block(x, cond, time_embed, mask, _gates(block, "on"))
    return sum(seen.values()) / x.numel()


@pytest.mark.parametrize("f", [1, 4])
def test_the_function_keeps_5n_where_the_eager_chain_keeps_about_13n(monkeypatch, f):
    """x, y and h1 (5 N), the mask and the cond projection at its own rate
    (N / f), against the eager chain's masked x, conv output, norm input and
    output, FiLM sum, pwconv1's input, the 3C pre-activation, its mask and
    the PReLU output."""
    fused, eager = _saved_floats(monkeypatch, True, f), _saved_floats(monkeypatch, False, f)
    # beside x, y and h1: the cond (24 channels) and its projection (48) at
    # 1/f of the frames, which the eager chain keeps too, and the mask
    others = (24 + 48) / 48 / f + 1 / 48
    assert fused <= 5 + others + 1e-9
    assert eager >= 12.5 + others
    print(f"f {f}: the Function keeps {fused:.3f} N, the eager chain {eager:.3f} N")


def test_takes_train_chain_on_the_card_with_grad_at_float32_only():
    card = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    with torch.enable_grad():
        assert takes_train_chain(card, None)
        assert not takes_train_chain(card, torch.bfloat16)
        assert not takes_train_chain(types.SimpleNamespace(is_cuda=True, dtype=torch.float64),
                                     None)
        assert not takes_train_chain(torch.zeros(2, 3, 4), None)  # the CPU
    with torch.no_grad():
        assert not takes_train_chain(card, None)


def test_bf16_hooked_cpu_and_no_grad_blocks_never_reach_the_function(monkeypatch):
    """The card's predicate on CPU tensors (as if on the card): grad
    enabled at float32 reaches the Function; a bf16 compute dtype, a hooked
    module and no grad do not, nor does the CPU itself."""
    def refuse(*args):
        raise AssertionError("the Function ran")

    reached = []
    block = ConvNeXtBlock(48, 144, 7, conditioned=True, cond_channels=24, time_embed_channels=16)
    block_bf16 = ConvNeXtBlock(48, 144, 7, dtype=torch.bfloat16)
    x = torch.randn(2, 9, 48)
    cond, time_embed = torch.randn(2, 9, 24), torch.randn(2, 16)
    with monkeypatch.context() as m:
        m.setattr(tc.TrainChain, "apply", refuse)
        block(x, cond, time_embed, gates=torch.ones(2))  # the CPU: eager
        real = takes_train_chain
        m.setattr(convnext, "takes_train_chain", lambda t, dtype: real(
            types.SimpleNamespace(is_cuda=True, dtype=t.dtype), dtype))
        block_bf16(x, gates=torch.ones(2))
        with torch.no_grad():
            block(x, cond, time_embed, gates=torch.ones(2))
            block(x, cond, time_embed)  # the eval form: the chain's plain versions
        handle = block.pwconv1.register_forward_hook(lambda *a: reached.append("hook"))
        block(x, cond, time_embed, gates=torch.ones(2))
        handle.remove()
        m.setattr(tc.TrainChain, "apply", lambda *a: reached.append("function"))
        block(x, cond, time_embed, gates=torch.ones(2))
    assert reached == ["hook", "function"]
    assert not any(k.startswith("convnext.") for k in tracing.drain().counters)


def _grads_of(fn, inputs, grad_out):
    """Autograd's gradients of sum(fn(*inputs) * grad_out) in float64."""
    leaves = [t.detach().requires_grad_() if t is not None and t.is_floating_point() else t
              for t in inputs]
    out = fn(*leaves)
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    return torch.autograd.grad((out * grad_out).sum(), wanted)


def test_prelu_bwd_plain_is_autograd_of_prelu():
    gen = torch.Generator().manual_seed(13)
    h1 = torch.randn(5, 7, 24, generator=gen, dtype=torch.float64)
    h1[0, 0, :4] = 0.0  # the tie goes to the identity side, as in `prelu_plain`
    alpha = torch.randn(24, generator=gen, dtype=torch.float64)
    dp = torch.randn(5, 7, 24, generator=gen, dtype=torch.float64)
    dh1, p, dalpha, db = tc.prelu_bwd_plain(dp, h1, alpha)
    ref_dh1, ref_dalpha = _grads_of(chain.prelu_plain, (h1, alpha), dp)
    assert torch.equal(p, chain.prelu_plain(h1, alpha))
    assert torch.allclose(dh1, ref_dh1, rtol=1e-13, atol=0)
    assert torch.allclose(dalpha, ref_dalpha, rtol=1e-12, atol=1e-13)
    assert torch.allclose(db, dh1.sum((0, 1)), rtol=1e-13, atol=0)


@pytest.mark.parametrize("conditioned,f,extra", [(True, 1, 0), (True, 2, 3), (True, 4, 0),
                                                 (False, 1, 0)],
                         ids=["f1", "f2-longer-cond", "f4", "unconditioned"])
def test_norm_film_bwd_plain_is_autograd_of_norm_film(conditioned, f, extra):
    gen = torch.Generator().manual_seed(14 + f)
    batch, frames, channels = 3, 23, 32
    r = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)  # noqa: E731
    x, mask = r(batch, frames, channels), make_valid_mask(torch.tensor([23, 9, 1]), frames)
    mask = mask[..., None].double()
    w, b, nb, ls = r(channels, 1, 7) * 0.3, r(channels) * 0.1, r(channels) * 0.1, r(()) * 0.3
    c = r(batch, -(-frames // f) + extra, channels) if conditioned else None
    te = r(batch, channels) * 0.3 if conditioned else None
    dy = r(batch, frames, channels)
    dz, dc, dnb, dls, dte = tc.norm_film_bwd_plain(x, mask, w, b, nb, ls, c, te, f, dy)

    def forward(x, w, b, nb, ls, *cond):
        return chain.norm_film_plain(x, mask, w, b, nb, ls, *cond, f)

    refs = _grads_of(forward, (x, w, b, nb, ls, c, te), dy)
    ref_dx, ref_dw, ref_db, ref_dnb, ref_dls = refs[:5]
    # dz is the gradient of the conv's output: its transposed conv is dx
    ours_dx, ours_dw, ours_db, _, _ = tc.dwconv_bwd_plain(dz, x, mask, w, torch.zeros_like(x), None)
    for ours, ref in ((ours_dx, ref_dx), (ours_dw, ref_dw), (ours_db, ref_db), (dnb, ref_dnb),
                      (dls, ref_dls)):
        assert torch.allclose(ours, ref, rtol=1e-10, atol=1e-12)
    if conditioned:
        assert torch.allclose(dc, refs[5], rtol=1e-12, atol=1e-13)
        assert torch.allclose(dte, refs[6], rtol=1e-12, atol=1e-13)
        assert not dc[:, -(-frames // f):].any()
    else:
        assert dc is None and dte is None


@pytest.mark.parametrize("scaled", [True, False])
def test_dwconv_bwd_plain_adds_the_residual_path(scaled):
    gen = torch.Generator().manual_seed(15)
    r = lambda *s: torch.randn(*s, generator=gen, dtype=torch.float64)  # noqa: E731
    x, dz, g = r(2, 11, 16), r(2, 11, 16), r(2, 11, 16)
    mask = make_valid_mask(torch.tensor([11, 6]), 11)[..., None].double()
    w, scale = r(16, 1, 7), r(16) if scaled else None
    dx, _, _, dscale, db2 = tc.dwconv_bwd_plain(dz, x, mask, w, g, scale)
    conv_only = tc.dwconv_bwd_plain(dz, x, mask, w, torch.zeros_like(g), None)[0]
    assert torch.allclose(dx, conv_only + (g * scale if scaled else g), rtol=1e-13, atol=0)
    assert torch.allclose(db2, g.sum((0, 1)), rtol=1e-13, atol=0)
    if scaled:
        assert torch.allclose(dscale, (g * x).sum((0, 1)), rtol=1e-13, atol=0)
    else:
        assert dscale is None


class _Recorder:
    """A stand-in for the kernels' library: records each launch's arguments
    and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def launch(*args):
            self.calls.append((name, args))
            return 0
        return launch


@pytest.fixture
def recorded(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(tc, "_library", lambda: lib)
    monkeypatch.setattr(tc, "_check_cuda", lambda *args: None)
    monkeypatch.setattr(tc, "_sm_count", lambda index: 132)
    monkeypatch.setattr(tc, "_stream", lambda x: 7)
    tracing.enable()
    return lib


def _sums(batch, channels, frames, f, conditioned):
    hidden = 3 * channels
    return tc._Sums(batch, channels, hidden, 7, conditioned,
                    tc.prelu_bwd_plan(batch * frames, hidden, 132)[0],
                    tc.segment_plan(batch, frames, f, 132)[0], torch.device("cpu"))


@pytest.mark.parametrize("batch,frames,channels,f,conditioned", [
    (256, 141, 768, 1, True), (256, 282, 512, 2, True), (256, 563, 384, 4, True),
    (256, 141, 512, 1, False), (64, 141, 768, 1, True), (2, 5, 48, 4, True),
], ids=["fm-b0", "fm-b1", "fm-b2", "fm-cond-encoder", "gan-b0", "tiny"])
def test_backward_launch_arguments(recorded, batch, frames, channels, f, conditioned):
    hidden = 3 * channels
    rows = -(-frames // f)
    x, dy, g = (torch.randn(batch, frames, channels) for _ in range(3))
    mask = torch.ones(batch, frames, 1)
    w, b, nb, ls = torch.randn(channels, 1, 7), torch.randn(channels), torch.randn(channels), \
        torch.tensor(0.1)
    c = torch.randn(batch, rows, channels) if conditioned else None
    te = torch.randn(batch, channels) if conditioned else None
    scale, alpha = torch.randn(channels), torch.randn(hidden)
    h1, dp = torch.randn(batch * frames, hidden), torch.randn(batch * frames, hidden)
    sums = _sums(batch, channels, frames, f, conditioned)
    segs, seg_rows = tc.segment_plan(batch, frames, f, 132)
    chunks, chunk_rows = tc.prelu_bwd_plan(batch * frames, hidden, 132)
    p = tc._launch_prelu_bwd(dp, h1, alpha, sums)
    dz, dc = tc._launch_norm_film_bwd(x, mask, w, b, nb, ls, c, te, f, dy, sums, segs, seg_rows)
    dx = tc._launch_dwconv_bwd(dz, x, mask, w, g, scale, sums, segs, seg_rows)
    out = sums.finish()
    names = [name for name, _ in recorded.calls]
    assert names == ["convnext_prelu_bwd_launch", "convnext_norm_film_bwd_launch",
                     "convnext_dwconv_bwd_launch"]
    prelu, norm, conv = (args for _, args in recorded.calls)
    assert prelu == (dp.data_ptr(), h1.data_ptr(), alpha.data_ptr(), p.data_ptr(),
                     sums.part("prelu").data_ptr(), batch * frames, hidden, chunks, chunk_rows, 7)
    assert norm == (x.data_ptr(), mask.data_ptr(), w.data_ptr(), b.data_ptr(), nb.data_ptr(),
                    ls.data_ptr(), c.data_ptr() if conditioned else None,
                    te.data_ptr() if conditioned else None, dy.data_ptr(), dz.data_ptr(),
                    dc.data_ptr() if conditioned else None, sums.part("norm").data_ptr(),
                    sums.part("te").data_ptr() if conditioned else None, batch, frames, channels,
                    7, f, rows if conditioned else 0, segs, seg_rows, 7)
    assert conv == (dz.data_ptr(), x.data_ptr(), mask.data_ptr(), w.data_ptr(), g.data_ptr(),
                    scale.data_ptr(), dx.data_ptr(), sums.part("conv").data_ptr(), batch, frames,
                    channels, 7, segs, seg_rows, 7)
    assert {name: sums.part(name).shape for name in out} == {
        "prelu": (chunks, 2 * hidden), "norm": (batch * segs, channels + 4),
        "te": (segs, batch * channels if conditioned else 0),
        "conv": (-(-batch * segs // 8), 10 * channels)}
    assert {name: v.shape for name, v in out.items()} == {
        "prelu": (2 * hidden,), "norm": (channels + 4,),
        "te": (batch * channels if conditioned else 0,), "conv": (10 * channels,)}
    # the plans: no empty chunk or segment; segments hold whole cond rows;
    # the blocks fill the card at the training cells' shapes
    assert (chunks - 1) * chunk_rows < batch * frames <= chunks * chunk_rows
    assert (segs - 1) * seg_rows < frames <= segs * seg_rows and seg_rows % f == 0
    if batch >= 64:
        assert batch * segs >= 3 * 132 and chunks >= 132
    assert tracing.drain().counters == {
        "convnext.prelu_bwd_launches": 1, "convnext.norm_film_bwd_launches": 1,
        "convnext.dwconv_bwd_launches": 1}


def test_prelu_fwd_launch_arguments(recorded):
    h, alpha = torch.randn(16, 141, 2304), torch.randn(2304)
    small = torch.randn(1, 149, 2304)
    p = tc._launch_prelu_fwd(h, alpha)
    q = tc._launch_prelu_fwd(small, alpha)
    assert p.shape == h.shape and p.data_ptr() != h.data_ptr() and q.shape == small.shape
    assert recorded.calls == [
        ("convnext_prelu_fwd_launch", (h.data_ptr(), alpha.data_ptr(), p.data_ptr(), h.numel(),
                                       2304, 4, 7)),
        ("convnext_prelu_fwd_launch", (small.data_ptr(), alpha.data_ptr(), q.data_ptr(),
                                       small.numel(), 2304, 1, 7)),
    ]
    assert tracing.drain().counters == {"convnext.prelu_fwd_launches": 2}
    assert torch.equal(tc.prelu_out(h, alpha), chain.prelu_plain(h, alpha))  # the CPU: plain
    assert len(recorded.calls) == 2


def test_sums_lay_out_one_region_a_kernel():
    sums = _sums(4, 48, 37, 2, True)
    regions = {name: (part.shape, out.shape) for name, (part, out, _) in sums.regions.items()}
    segs = tc.segment_plan(4, 37, 2, 132)[0]
    assert regions == {"prelu": ((tc.prelu_bwd_plan(4 * 37, 144, 132)[0], 288), (288,)),
                       "norm": ((4 * segs, 52), (52,)), "te": ((segs, 4 * 48), (192,)),
                       "conv": ((-(-4 * segs // 8), 480), (480,))}
    parts = [part for part, _, _ in sums.regions.values()]
    assert sum(p.numel() for p in parts) == sums.parts.numel()
    assert all(p.data_ptr() % 16 == 0 for p in parts)


@pytest.mark.parametrize("conditioned", [True, False], ids=["decoder", "cond-encoder"])
def test_sums_add_each_region_in_float64(conditioned):
    tracing.enable()
    sums = _sums(4, 48, 37, 2, conditioned)
    sums.parts.copy_(torch.randn(sums.parts.shape, generator=torch.Generator().manual_seed(5))
                     * torch.logspace(-3, 3, sums.parts.numel()))
    out = sums.finish()
    for name, got in out.items():
        part = sums.part(name)
        assert got.dtype == torch.float32 and got.shape == (part.shape[1],)
        assert torch.equal(got, part.double().sum(0).float())
    again = {name: v.clone() for name, v in out.items()}
    assert all(torch.equal(v, sums.finish()[name]) for name, v in again.items())
    assert tracing.drain().counters == {}


@pytest.mark.parametrize("case", ["taps_5", "too_wide", "width_not_4", "cond_short",
                                  "cond_without_time", "mask_shape", "dy_shape"])
def test_norm_film_bwd_refuses_what_the_kernel_does_not_take(recorded, case):
    batch, frames, channels, f = 2, 9, 48, 2
    args = dict(x=torch.randn(batch, frames, channels), mask=None,
                w=torch.randn(channels, 1, 7), b=torch.randn(channels), nb=torch.randn(channels),
                ls=torch.tensor(0.1), c=torch.randn(batch, 5, channels),
                te=torch.randn(batch, channels), f=f, dy=torch.randn(batch, frames, channels))
    error = ValueError
    if case == "taps_5":
        args["w"], error = torch.randn(channels, 1, 5), NotImplementedError
    elif case in ("too_wide", "width_not_4"):
        width = 1028 if case == "too_wide" else 50
        args.update(x=torch.randn(batch, frames, width), dy=torch.randn(batch, frames, width))
        error = NotImplementedError
    elif case == "cond_short":
        args["c"] = torch.randn(batch, 4, channels)  # ceil(9 / 2) = 5 rows needed
    elif case == "cond_without_time":
        args["te"] = None
    elif case == "mask_shape":
        args["mask"] = torch.ones(batch, frames + 1, 1)
    else:
        args["dy"] = torch.randn(batch, frames + 1, channels)
    sums = _sums(batch, args["x"].shape[-1], frames, f, True)
    with pytest.raises(error):
        tc._launch_norm_film_bwd(*args.values(), sums, 1, 10)
    assert recorded.calls == []


def test_prelu_and_dwconv_bwd_refuse_mismatched_shapes(recorded):
    sums = _sums(2, 8, 5, 1, False)
    with pytest.raises(ValueError):
        tc._launch_prelu_bwd(torch.randn(10, 24), torch.randn(10, 20), torch.randn(24), sums)
    with pytest.raises(ValueError):  # partials planned for another width
        tc._launch_prelu_bwd(torch.randn(10, 48), torch.randn(10, 48), torch.randn(48), sums)
    x = torch.randn(2, 5, 8)
    with pytest.raises(ValueError):
        tc._launch_dwconv_bwd(torch.randn(2, 4, 8), x, None, torch.randn(8, 1, 7), x, None, sums,
                              1, 5)
    with pytest.raises(ValueError):
        tc._launch_dwconv_bwd(x, x, None, torch.randn(8, 1, 7), x, torch.randn(4), sums, 1, 5)
    with pytest.raises(ValueError):  # width not a multiple of 4
        tc._launch_prelu_fwd(torch.randn(3, 6), torch.randn(6))
    assert recorded.calls == []


def test_plans_at_the_edges():
    assert tc.segment_plan(256, 141, 1, 132) == (3, 47)
    assert tc.segment_plan(256, 563, 4, 132) == (3, 188)
    assert tc.segment_plan(64, 141, 1, 132) == (8, 18)
    assert tc.segment_plan(1, 1, 4, 132) == (1, 4)
    assert tc.segment_plan(3, 5, 2, 132) == (1, 6)
    assert tc.prelu_bwd_plan(1, 2304, 132) == (1, 1)
    # 576 threads a block: three blocks an SM
    assert tc.prelu_bwd_plan(256 * 141, 2304, 132) == (393, 92)
    assert tc.prelu_bwd_plan(256 * 563, 1152, 132) == (528, 273)
