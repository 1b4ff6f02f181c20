"""The ConvNeXt blocks' eval-form chain (`ops/convnext_chain.py`) on the CPU.

- the block's eval form through the chain's plain versions against the
  eager chain it ran before (`takes_chain` forced off), bit for bit:
  conditioned and unconditioned blocks, cond factors 1, 2 and 4, a ragged
  mask, fewer frames than taps and frame counts that no tile divides, tiny
  widths; the decoder and whole generators the same, a cond shorter than
  the frames need included;
- the dispatch predicate: the eval form at float32 takes the chain; gates,
  grad enabled, a bf16 compute dtype, a float64 input or a forward hook on
  one of the block's modules the eager chain, and the train form never
  reaches the chain's wrappers;
- the CUDA wrappers' arguments to the kernels (the library stubbed) and the
  shapes they refuse; the tile plan at the main path's shapes.

The kernels themselves need the card: `chip_smoke.py` phase 23 holds them
against these plain versions there.
"""

import pytest
import torch

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.api import init_weights
from flow2gan_tpu_torch.models import build_generator, convnext, get_generator_config
from flow2gan_tpu_torch.models.convnext import ConvNeXtBlock, ConvNeXtDecoder, takes_chain
from flow2gan_tpu_torch.ops import convnext_chain as chain
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


def _randomize(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter drawn, so no term of the chain is trivially zero."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("log_scale"):
                p.fill_(0.3)
            elif name.endswith("residual_scale.scale"):
                p.copy_(0.5 + 0.5 * torch.rand(p.shape, generator=gen))
            else:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return module


def _eager(monkeypatch, fn):
    """fn() with every block on the eager chain, as before the kernels."""
    with monkeypatch.context() as m:
        m.setattr(convnext, "takes_chain", lambda *args: False)
        return fn()


def _block_inputs(batch, frames, channels, f, conditioned, ragged, seed):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(batch, frames, channels, generator=gen)
    cond = time_embed = mask = None
    if conditioned:
        cond = torch.randn(batch, -(-frames // f), 24, generator=gen)
        time_embed = torch.randn(batch, 16, generator=gen)
    if ragged:
        lens = torch.randint(1, frames + 1, (batch,), generator=gen)
        lens[0] = frames
        mask = make_valid_mask(lens, frames)[..., None]
    return x, cond, time_embed, mask


@pytest.mark.parametrize("channels", [48, 64])
@pytest.mark.parametrize("frames", [3, 37])
@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("conditioned,f", [(False, 1), (True, 1), (True, 2), (True, 4)],
                         ids=["unconditioned", "f1", "f2", "f4"])
def test_block_eval_form_through_the_chain_equals_the_eager_chain(monkeypatch, channels, frames,
                                                                  ragged, conditioned, f):
    block = _randomize(ConvNeXtBlock(channels, 3 * channels, 7, conditioned=conditioned,
                                     cond_channels=24 if conditioned else 0,
                                     time_embed_channels=16 if conditioned else 0,
                                     cond_upsample_factor=f), seed=channels + frames)
    x, cond, time_embed, mask = _block_inputs(3, frames, channels, f, conditioned, ragged,
                                              seed=frames * f)
    with torch.no_grad():
        ours = block(x, cond, time_embed, mask)
        ref = _eager(monkeypatch, lambda: block(x, cond, time_embed, mask))
    assert torch.equal(ours, ref)
    assert torch.isfinite(ours).all()


@pytest.mark.parametrize("residual_scale", [True, False])
def test_block_without_a_residual_scale_and_on_a_strided_input(monkeypatch, residual_scale):
    """The chain on the cond encoder's first input, a transposed conv's
    view, and on a block with no residual scale."""
    block = _randomize(ConvNeXtBlock(64, 192, 7, use_residual_scale=residual_scale), seed=3)
    x = torch.randn(2, 64, 29).transpose(1, 2)  # (B, T, C), not contiguous
    with torch.no_grad():
        assert torch.equal(block(x), _eager(monkeypatch, lambda: block(x)))


@pytest.mark.parametrize("f,cond_frames", [(1, 55), (2, 12), (2, 40), (4, 5), (4, 13)],
                         ids=["f1-longer", "f2-shorter", "f2-longer", "f4-shorter", "f4-exact"])
def test_decoder_eval_form_equals_the_eager_chain_with_cond_of_any_length(monkeypatch, f,
                                                                          cond_frames):
    """The decoder pads a cond shorter than ceil(T / f) with zeros and trims
    a longer one before its blocks; the chain sees what the eager blocks
    saw."""
    dec = _randomize(ConvNeXtDecoder(18, 18, channels=48, cond_channels=24,
                                     time_embed_channels=16, num_layers=2,
                                     cond_upsample_factor=f), seed=f)
    gen = torch.Generator().manual_seed(cond_frames)
    x = torch.randn(2, 50, 18, generator=gen)
    cond = torch.randn(2, cond_frames, 24, generator=gen)
    t = torch.rand(2, generator=gen)
    mask = make_valid_mask(torch.tensor([50, 31]), 50)[..., None]
    with torch.no_grad():
        ours = dec(x, cond, t, mask)
        assert torch.equal(ours, _eager(monkeypatch, lambda: dec(x, cond, t, mask)))


@pytest.mark.parametrize("name", ["mel_24k_tiny", "token_24k_tiny"])
def test_generator_eval_form_equals_the_eager_chain(monkeypatch, name):
    cfg = get_generator_config(name)
    with torch.no_grad():
        gen = init_weights(build_generator(cfg), torch.Generator().manual_seed(0))
    frames = 23
    rng = torch.Generator().manual_seed(1)
    if cfg.get("conditioning") == "tokens":
        cond = torch.randint(0, cfg.vocab_size, (2, frames), generator=rng)
    else:
        cond = torch.randn(2, cfg.n_mels, frames, generator=rng)
    noise = torch.randn(2, frames * cfg.mel_hop_length, generator=rng) * 0.1
    lens = torch.tensor([frames, 15]) * cfg.mel_hop_length
    with torch.inference_mode():
        for audio_lens in (None, lens):
            ours = gen.infer_from_noise(noise, cond, audio_lens, 2)
            ref = _eager(monkeypatch, lambda: gen.infer_from_noise(noise, cond, audio_lens, 2))
            assert torch.equal(ours, ref)


def test_takes_chain_picks_the_eval_form_at_float32_only():
    x = torch.zeros(1, 3, 4)
    gates = torch.ones(2)
    with torch.no_grad():
        assert takes_chain(x, None, None)
        assert not takes_chain(x, gates, None)  # the train form
        assert not takes_chain(x, None, torch.bfloat16)
        assert not takes_chain(x.double(), None, None)  # a float64 reference run
    with torch.inference_mode():
        assert takes_chain(x, None, None)
    with torch.enable_grad():
        assert not takes_chain(x, None, None)


def test_train_form_grad_and_bf16_never_reach_the_chain(monkeypatch):
    """Gates, grad enabled or a bf16 compute dtype run the eager chain: the
    chain's wrappers raise if called. The eval form at float32 calls each
    once a block; on the CPU no block is counted, fused or eager."""
    def refuse(*args, **kwargs):
        raise AssertionError("the chain ran")

    calls = []
    block = _randomize(ConvNeXtBlock(48, 144, 7, conditioned=True, cond_channels=24,
                                     time_embed_channels=16), seed=5)
    block_bf16 = _randomize(ConvNeXtBlock(48, 144, 7, dtype=torch.bfloat16), seed=5)
    x, cond, time_embed, _ = _block_inputs(2, 9, 48, 1, True, False, seed=2)
    tracing.enable()
    with monkeypatch.context() as m:
        for fn in ("norm_film", "prelu_", "linear_residual"):
            m.setattr(chain, fn, refuse)
        block(x, cond, time_embed, gates=torch.ones(1))  # train form
        block(x, cond, time_embed)  # eval form, grad enabled
        with torch.no_grad():
            block(x, cond, time_embed, gates=torch.ones(1))
            block_bf16(x)
    with monkeypatch.context() as m:
        for fn in ("norm_film", "prelu_", "linear_residual"):
            real = getattr(chain, fn)
            m.setattr(chain, fn, lambda *a, _f=fn, _r=real: calls.append(_f) or _r(*a))
        with torch.no_grad():
            block(x, cond, time_embed)
    assert calls == ["norm_film", "prelu_", "linear_residual"]
    assert not any(k.startswith("convnext.") for k in tracing.drain().counters)


@pytest.mark.parametrize("child", ["dwconv", "norm", "act", "pwconv2", "residual_scale"])
@pytest.mark.parametrize("pre", [False, True], ids=["hook", "pre_hook"])
def test_a_hooked_block_runs_the_eager_chain_so_every_hook_fires(monkeypatch, child, pre):
    """The trainers' diagnostics and `--inf-check` hook every module; the
    chain would run past the block's own, so a watched block stays eager."""
    block = _randomize(ConvNeXtBlock(48, 144, 7, conditioned=True, cond_channels=24,
                                     time_embed_channels=16), seed=7)
    x, cond, time_embed, _ = _block_inputs(2, 11, 48, 1, True, False, seed=4)
    seen = []
    module = getattr(block, child)
    handle = (module.register_forward_pre_hook(lambda m, args: seen.append(child)) if pre else
              module.register_forward_hook(lambda m, args, out: seen.append(child)))
    with monkeypatch.context() as m:
        m.setattr(chain, "norm_film", lambda *a: pytest.fail("the chain ran"))
        with torch.no_grad():
            out = block(x, cond, time_embed)
    handle.remove()
    assert seen == [child]
    with torch.no_grad():
        assert torch.equal(out, block(x, cond, time_embed))  # unhooked: the chain


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
    monkeypatch.setattr(chain, "_library", lambda: lib)
    monkeypatch.setattr(chain, "_check_cuda", lambda *args: None)
    monkeypatch.setattr(chain, "_sm_count", lambda index: 132)
    monkeypatch.setattr(chain, "_stream", lambda x: 7)
    tracing.enable()
    return lib


def _chain_args(batch, frames, channels, f, conditioned, masked, cond_rows=None):
    x = torch.randn(batch, frames, channels)
    c = te = mask = None
    if conditioned:
        c = torch.randn(batch, -(-frames // f) if cond_rows is None else cond_rows, channels)
        te = torch.randn(batch, channels)
    if masked:
        mask = torch.ones(batch, frames, 1)
    return (x, mask, torch.randn(channels, 1, 7), torch.randn(channels), torch.randn(channels),
            torch.tensor(0.1), c, te, f)


@pytest.mark.parametrize("batch,frames,channels,f,plan", [
    (16, 873, 768, 1, (16, 2)), (16, 1745, 512, 2, (16, 2)), (16, 3489, 384, 4, (16, 2)),
    (16, 102, 768, 1, (8, 2)), (16, 101, 512, 1, (8, 2)),
    (1, 149, 768, 1, (1, 1)), (1, 297, 512, 2, (2, 1)), (1, 593, 384, 4, (4, 1)),
    (1, 148, 512, 1, (1, 1)), (3, 4, 48, 4, (1, 1)),
], ids=["bulk-b0", "bulk-b1", "bulk-b2", "bulk-short-b0", "bulk-short-cond-encoder",
        "stream-b0", "stream-b1", "stream-b2", "stream-cond-encoder", "tiny"])
def test_norm_film_launch_arguments_and_plan(recorded, batch, frames, channels, f, plan):
    args = _chain_args(batch, frames, channels, f, conditioned=f > 1 or channels != 512,
                       masked=batch == 3)
    out = chain._launch_norm_film(*args)
    assert out.shape == (batch, frames, channels) and out.is_contiguous()
    (name, got), = recorded.calls
    x, mask, w, b, nb, ls, c, te, _ = args
    assert name == "convnext_norm_film_launch"
    assert got[:9] == (x.data_ptr(), None if mask is None else mask.data_ptr(), w.data_ptr(),
                       b.data_ptr(), nb.data_ptr(), ls.data_ptr(),
                       None if c is None else c.data_ptr(), None if te is None else te.data_ptr(),
                       out.data_ptr())
    assert got[9:] == (batch, frames, channels, 7, f, 0 if c is None else c.shape[1], *plan, 7)
    rows, per_warp = plan
    # every SM gets a block where the shape has enough rows; shared memory fits
    assert batch * -(-frames // rows) >= min(132, batch * frames)
    assert (rows + 13) * channels * 4 <= 227 * 1024 and (rows // per_warp) * 32 <= 256
    assert tracing.drain().counters == {"convnext.norm_film_launches": 1}


def test_stream_kernels_launch_arguments(recorded):
    h, alpha = torch.randn(16, 873, 2304), torch.randn(2304)
    assert chain._launch_prelu(h, alpha) is h
    small = torch.randn(1, 149, 2304)
    chain._launch_prelu(small, alpha)
    res, scale, bias = torch.randn(1, 149, 768), torch.randn(768), torch.randn(768)
    out = torch.randn(1, 149, 768)
    assert chain._launch_residual(out, res, scale, bias) is out
    chain._launch_residual(out, res, None, None)
    assert recorded.calls == [
        ("prelu_inplace_launch", (h.data_ptr(), alpha.data_ptr(), h.numel(), 2304, 4, 7)),
        ("prelu_inplace_launch", (small.data_ptr(), alpha.data_ptr(), small.numel(), 2304, 1, 7)),
        ("scaled_residual_launch", (out.data_ptr(), res.data_ptr(), scale.data_ptr(),
                                    bias.data_ptr(), out.numel(), 768, 1, 7)),
        ("scaled_residual_launch", (out.data_ptr(), res.data_ptr(), None, None, out.numel(),
                                    768, 1, 7)),
    ]
    assert tracing.drain().counters == {"convnext.prelu_launches": 2,
                                        "convnext.residual_launches": 2}


@pytest.mark.parametrize("case", ["cond_short", "cond_without_time", "width_not_4", "too_wide",
                                  "taps_5", "mask_shape", "empty"])
def test_norm_film_launch_refuses_what_the_kernel_does_not_take(recorded, case):
    batch, frames, channels, f = 2, 9, 48, 2
    args = list(_chain_args(batch, frames, channels, f, True, False))
    error = ValueError
    if case == "cond_short":
        args[6] = torch.randn(batch, 4, channels)  # ceil(9 / 2) = 5 rows needed
    elif case == "cond_without_time":
        args[7] = None
    elif case in ("width_not_4", "too_wide"):
        c = 50 if case == "width_not_4" else 1028
        args = list(_chain_args(batch, frames, c, f, True, False))
        error = NotImplementedError
    elif case == "taps_5":
        args[2] = torch.randn(channels, 1, 5)
        error = NotImplementedError
    elif case == "mask_shape":
        args[1] = torch.ones(batch, frames + 1, 1)
    else:
        args[0] = torch.randn(batch, 0, channels)
    with pytest.raises(error):
        chain._launch_norm_film(*args)
    assert recorded.calls == []


def test_stream_kernels_refuse_mismatched_shapes(recorded):
    with pytest.raises(ValueError):
        chain._launch_prelu(torch.randn(2, 5, 6), torch.randn(6))  # width not a multiple of 4
    with pytest.raises(ValueError):
        chain._launch_residual(torch.randn(2, 5, 8), torch.randn(2, 4, 8), None, None)
    with pytest.raises(ValueError):
        chain._launch_residual(torch.randn(2, 5, 8), torch.randn(2, 5, 8), torch.randn(4), None)
    with pytest.raises(ValueError):
        chain._launch_residual(torch.randn(2, 5, 8), torch.randn(2, 5, 8), None, torch.randn(6))
    assert recorded.calls == []


def test_wrappers_refuse_a_cpu_tensor_on_the_kernel_path():
    with pytest.raises(ValueError, match="CUDA"):
        chain._check_cuda("convnext_norm_film", torch.randn(2, 5, 8))


def test_plans_at_the_edges():
    assert chain.norm_film_plan(16, 3489, 132) == (16, 2)
    assert chain.norm_film_plan(1, 1, 132) == (1, 1)
    assert chain.norm_film_plan(200, 1, 132) == (1, 1)
    assert chain.norm_film_plan(4, 300, 132) == (8, 2)
    # four float4 a thread once that leaves 2 x 132 blocks of 1024
    assert chain.stream_unroll((2 * 132 - 1) * 1024 + 1, 132) == 4
    assert chain.stream_unroll((2 * 132 - 1) * 1024, 132) == 1
