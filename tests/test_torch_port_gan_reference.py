"""The port's GAN stage against the benchmark's plain reference
(`portbench/reference/gan.py`, plain PyTorch, which imports nothing of the
port) on the CPU, at a small size with seeded random weights: mel_24k_tiny
without branch dropout, the discriminators at their full widths with
periods (2, 3) and windows (256, 128), the mel loss at four scales, batch
2 x 6000 samples (one row shorter), 2 Euler steps. The weights are the
benchmark's draws (`portbench/weights.py`, `portbench/weights_gan.py`), so
one set loads into both by name.
The mel loss stops at 256 points here: with the 1024- and 2048-point scales
the float32 G gradient hangs on their near-empty lowest bins (7% between
the port's float32 and float64 on the CPU), where the benchmark's cell
judges the G gradient by its residual scales alone.

Tolerances, each with its reason:
- the discriminators' scores and feature maps, and each loss term, 1e-5 of
  the reference's largest magnitude: the port takes the MRD's and the mel
  losses' STFTs as float32 matmuls against DFT matrices and the reference
  with `torch.stft`, which round differently (~1e-6 here);
- a whole step, the benchmark's own numbers (`reference/check.py
  training_numbers`): the loss 1e-5 relative; each parameter's gradient
  norm, against the larger of its norm and the median's, 1e-3: on the G
  side the port's float32 is itself 3.2e-4 from its float64 evaluation
  (the reference 8e-5; the reference's gates of step 0 used at every step
  read 3.4e-3, no limiter flips 6.3e-2); on the D side the hinge's real
  and fake halves nearly cancel in the first conv's bias, whose gradient
  moves by 1.3e-4 with the order of the sum over rows alone; the change
  after ScaledAdam 1e-2 (Adam's first step is about the gradient's sign,
  which flips wherever a gradient element is at rounding level);
- the reference in blocks of one row against the whole batch, float32's
  summation order alone: the loss 1e-6; gradient norms and changes 1e-3,
  as the D side's cancelling halves lift a bias's gap to 1.3e-4 (the G
  side's 7e-6).
"""

import pytest
import torch

from portbench import traffic
from portbench.reference import check, gan as rg, model as ref
from portbench.weights import make_weights
from portbench.weights_gan import make_disc_weights

from flow2gan_tpu_torch.models import RolloutDraws, build_generator, get_generator_config
from flow2gan_tpu_torch.models import gan as pgan
from flow2gan_tpu_torch.models.discriminators import Discriminators
from flow2gan_tpu_torch.models.gan import make_mel_recon_fns
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram
from flow2gan_tpu_torch.training.gan_step import GANLossScales, make_gan_steps
from flow2gan_tpu_torch.training.optim import ScaledAdam, eden2_lr
from flow2gan_tpu_torch.utils import AttributeDict

CPU = torch.device("cpu")
GAN = {"mpd_periods": [2, 3], "mrd_fft_sizes": [256, 128], "mrd_channels": 32,
       "mrd_hop_factor": 0.25,
       "mrd_bands": [[0.0, 0.1], [0.1, 0.25], [0.25, 0.5], [0.5, 0.75], [0.75, 1.0]],
       "loss_scales": {"disc_mp": 1.0, "disc_mr": 0.1, "gen_mp": 1.0, "gen_mr": 0.1,
                       "fmap_mp": 1.0, "fmap_mr": 0.1, "mel_recon": 45.0},
       "mel_recon_n_ffts": [32, 64, 128, 256], "mel_recon_n_mels": [5, 10, 20, 40]}
CFG = dict(get_generator_config("mel_24k_tiny"), branch_dropout=0.0, gan=GAN)
OPT = {"clipping_scale": 2.0, "lr_g": 0.002, "lr_d": 0.02, "lr_batches_g": 20000,
       "lr_batches_d": 5000, "warmup_batches": 500, "warmup_start": 0.1}
B, L, STEPS = 2, 6000, 2
HOP = CFG["mel_hop_length"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The full-width discriminators make these steps heavy: two intra-op
    threads let the file share the CPU with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _weights(seed=3):
    return (make_weights(ref.param_specs(CFG), seed, CPU),
            make_disc_weights(rg.disc_param_specs(GAN), seed + 1, CPU))


def _batch(seed=5):
    audio = traffic.voiced(seed, B, L, 24000, CPU)
    return {"audio": audio, "audio_lens": torch.tensor([L, L - 700])}


def _draws(seed, n_limiters, n_timesteps=STEPS):
    gen = torch.Generator().manual_seed(seed)
    x0 = torch.randn(B, (1 + L // HOP) * HOP, generator=gen) * CFG["init_noise_scale"]
    gates = (torch.rand(n_timesteps, n_limiters, generator=gen) < 0.6).float()
    return x0, gates


def _port_discriminators(dw):
    disc = Discriminators(GAN["mpd_periods"], GAN["mrd_fft_sizes"])
    disc.load_state_dict(dw, strict=True)
    return disc


def _reference_discriminators(dw):
    disc = rg.Discriminators(GAN)
    disc.load_state_dict(dw, strict=True)
    return disc


def _close(ours, theirs, tol=1e-5):
    assert ours.shape == theirs.shape
    gap, scale = float((ours - theirs).abs().max()), float(theirs.abs().max())
    assert gap <= tol * scale, (gap, scale)


def test_discriminators_match_the_reference():
    _, dw = _weights()
    port, theirs = _port_discriminators(dw), _reference_discriminators(dw)
    assert [(n, p.shape) for n, p in port.named_parameters()] == \
        [(n, p.shape) for n, p in theirs.named_parameters()]
    x = _batch()["audio"]
    with torch.no_grad():
        ours, refs = port.judge(x), theirs(x)
    for (o_scores, o_fmaps), (r_scores, r_fmaps), maps in zip(ours, refs, (5, 21)):
        for o, r in zip(o_scores, r_scores):
            _close(o, r)
        for o, r in zip(o_fmaps, r_fmaps):
            assert len(o) == len(r) == maps
            for a, b in zip(o, r):
                _close(a, b)


def test_loss_terms_match_the_reference():
    _, dw = _weights()
    real, fake = _batch(5)["audio"], _batch(6)["audio"]
    disc = _reference_discriminators(dw)
    with torch.no_grad():
        (rmp, rmr), (fmp, fmr) = disc(real), disc(fake)
    recon = make_mel_recon_fns(24000, GAN["mel_recon_n_ffts"], GAN["mel_recon_n_mels"])
    pairs = [
        (pgan.discriminator_loss(rmp[0], fmp[0]), rg.hinge_d(rmp[0], fmp[0])),
        (pgan.discriminator_loss(rmr[0], fmr[0]), rg.hinge_d(rmr[0], fmr[0])),
        (pgan.generator_loss(fmp[0]), rg.hinge_g(fmp[0])),
        (pgan.generator_loss(fmr[0]), rg.hinge_g(fmr[0])),
        (pgan.feature_matching_loss(rmp[1], fmp[1]), rg.feature_matching(rmp[1], fmp[1])),
        (pgan.feature_matching_loss(rmr[1], fmr[1]), rg.feature_matching(rmr[1], fmr[1])),
        (pgan.mel_recon_loss(real, fake, recon), rg.mel_recon(real, fake, GAN, 24000)),
    ]
    for ours, theirs in pairs:
        assert float(theirs) > 0
        assert abs(float(ours) - float(theirs)) <= 1e-5 * abs(float(theirs))


def _port_steps(gw, dw, remat, n_timesteps=STEPS):
    gen = build_generator(AttributeDict(CFG))
    gen.load_state_dict(gw, strict=True)
    disc = _port_discriminators(dw)
    opt_g = ScaledAdam(gen.named_parameters(), clipping_scale=OPT["clipping_scale"])
    opt_d = ScaledAdam(disc.named_parameters(), clipping_scale=OPT["clipping_scale"])

    def lr(side):
        return lambda b: eden2_lr(OPT[f"lr_{side}"], b, OPT[f"lr_batches_{side}"],
                                  warmup_batches=OPT["warmup_batches"],
                                  warmup_start=OPT["warmup_start"])

    mel = LogMelSpectrogram(24000, CFG["mel_n_fft"], HOP, CFG["n_mels"])
    recon = make_mel_recon_fns(24000, GAN["mel_recon_n_ffts"], GAN["mel_recon_n_mels"])
    d_step, g_step, _ = make_gan_steps(gen, disc, mel, recon, opt_g, opt_d, lr("g"), lr("d"),
                                       n_timesteps=n_timesteps,
                                       scales=GANLossScales(**GAN["loss_scales"]),
                                       remat_rollout=remat)
    return gen, disc, opt_g, opt_d, d_step, g_step


def _port_d_then_g(remat, seed=7):
    """The port's first D step and first G step on one batch: each side's
    loss, first gradient norms (from ScaledAdam's state) and change."""
    gw, dw = _weights()
    gen, disc, opt_g, opt_d, d_step, g_step = _port_steps(gw, dw, remat)
    batch = _batch()
    x0, gates = _draws(seed, gen.num_limiters)
    out = {}
    for side, step, module, opt, draws in (("d", d_step, disc, opt_d, RolloutDraws(x0)),
                                           ("g", g_step, gen, opt_g, RolloutDraws(x0, gates))):
        start = {n: p.detach().clone() for n, p in module.named_parameters()}
        loss = float(step(batch, draws)[f"loss_{side}"])
        out[side] = {"losses": [loss], "grad_norms": check.first_grad_norms(opt),
                     "change_norms": rg.change_norms(module, start)}
    return out


def _reference_d_then_g(rows, seed=7):
    gw, dw = _weights()
    steps = rg.GANSteps(CFG, gw, dw, OPT, STEPS, CPU, rows=rows)
    batch = _batch()
    x0, gates = _draws(seed, steps.n_limiters)
    return {"d": steps.step("d", batch["audio"], batch["audio_lens"], x0),
            "g": steps.step("g", batch["audio"], batch["audio_lens"], x0, gates)}


@pytest.fixture(scope="module")
def reference_steps():
    return _reference_d_then_g(rows=1)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_one_d_step_and_one_g_step_match_the_reference(reference_steps, remat):
    ours = _port_d_then_g(remat)
    for side in ("d", "g"):
        got = check.training_numbers(ours[side], reference_steps[side], 1)
        assert got["loss_rel_err"] <= 1e-5, (side, got)
        assert got["grad_norm_gap"] <= 1e-3, (side, got)
        assert got["change_norm_gap"] <= 1e-2, (side, got)


def test_reference_in_row_blocks_equals_the_whole_batch(reference_steps):
    whole = _reference_d_then_g(rows=B)
    for side in ("d", "g"):
        got = check.training_numbers(reference_steps[side], whole[side], 1)
        assert got["loss_rel_err"] <= 1e-6, (side, got)
        assert got["grad_norm_gap"] <= 1e-3 and got["change_norm_gap"] <= 1e-3, (side, got)
