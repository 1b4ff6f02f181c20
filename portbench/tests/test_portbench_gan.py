"""The GAN cell on the CPU at a tiny size, past the look for a card: a
sound run comes out correct under the cell's limits, each planted fault
that reaches the GAN path fails at least one of them, a traced run drains
the program's spans and counters; the cell's arithmetic and readers
against hand counts."""

import pytest
import torch

from portbench import run as bench_run, traffic, yardstick, yardstick_gan
from portbench.tests.tiny import TINY, drive

GAN = {"mpd_periods": [2, 3], "mrd_fft_sizes": [256, 128], "mrd_channels": 32,
       "mrd_hop_factor": 0.25,
       "mrd_bands": [[0.0, 0.1], [0.1, 0.25], [0.25, 0.5], [0.5, 0.75], [0.75, 1.0]],
       "loss_scales": {"disc_mp": 1.0, "disc_mr": 0.1, "gen_mp": 1.0, "gen_mr": 0.1,
                       "fmap_mp": 1.0, "fmap_mr": 0.1, "mel_recon": 45.0},
       "mel_recon_n_ffts": [32, 64, 128, 256], "mel_recon_n_mels": [5, 10, 20, 40]}
CFG = dict(TINY, branch_dropout=0.0, gan=GAN)
# 2 batches an epoch, so that set-up's 3 steps cross an epoch; two blocks
# of one row in the reference; the cell's 4 Euler steps, so that the
# recompute's gates matter at 3 of them
MIX = dict(batch=2, crop_s=0.25, n_timesteps=4, utterances=2, utterance_s=0.5, manifest_repeats=2,
           num_workers=2, reference_rows=1, trace_steps=2)
CELL = "gan-24k-4step-b64"


def gan_run(fault=None, trace=False, seed=2**31 + 4242):
    torch.set_num_threads(2)
    return bench_run.make_run(bench_run.load_benchmark(), CELL, seed, 0.5, trace,
                              torch.device("cpu"), fault=fault, cfg_override=dict(CFG),
                              mix_override=MIX)


@pytest.mark.parametrize("fault,correct", [(None, True), ("frozen_step", False),
                                           ("no_mrd_fmap", False), ("mrd_batch_peak", False),
                                           ("remat_gates", False), ("no_limiter_flips", False)])
def test_correct_decides(fault, correct):
    line = drive(gan_run(fault))
    assert line["correct"] is correct, line["checks"]
    assert set(line["checks"]) == {"d_loss_rel_err", "d_grad_norm_gap", "d_change_norm_gap",
                                   "g_loss_rel_err", "g_residual_scale_gap",
                                   "g_change_norm_gap"}
    assert set(line["metrics"]) == {"train_audio_s_per_s", "peak_mem_gib", "setup_s"}


def test_traced_run_drains_the_programs_spans_and_counters(monkeypatch):
    from flow2gan_tpu_torch import tracing
    from flow2gan_tpu_torch.ops import fused_istft
    from portbench.drivers import gan

    # the iSTFTs that run while the program's tracing is on: the traced steps
    runs = {"forward": 0, "backward": 0}
    for way in runs:
        def counted(ctx, *args, _way=way, _inner=getattr(fused_istft.FusedISTFT, way)):
            runs[_way] += tracing.enabled()
            return _inner(ctx, *args)

        monkeypatch.setattr(fused_istft.FusedISTFT, way, staticmethod(counted))
    res = gan.run(gan_run(trace=True))
    obs = res.obs
    assert (len(obs["istft_bound_s"]), len(obs["adjoint_bound_s"])) == (runs["forward"],
                                                                          runs["backward"])
    counters = obs["program"]["counters"]
    # the traced steps continue the alternation after a G step: D, then G
    assert counters["gan.d_steps"] == 1 and counters["gan.g_steps"] == 1
    assert counters["solve.recomputed_steps"] == MIX["n_timesteps"]
    assert len(obs["program"]["device_ms"]["gan.judge"]) == 8
    length = int(MIX["crop_s"] * CFG["sampling_rate"])
    assert obs["flop"] == (yardstick_gan.d_step_flop(CFG, 2, length, MIX["n_timesteps"])
                           + yardstick_gan.g_step_flop(CFG, 2, length, MIX["n_timesteps"]))
    # a branch's iSTFT an Euler step in D and in G, again in G's recompute
    # but the last branch's; its adjoint an Euler step in G
    per_step = MIX["n_timesteps"] * len(CFG["n_ffts"])
    assert len(obs["istft_bound_s"]) == 3 * per_step - MIX["n_timesteps"]
    assert len(obs["adjoint_bound_s"]) == per_step
    # the CPU has no device time: every reader finds nothing
    for m in ("d_step_ms.gan", "g_step_ms.gan", "judge_ms_per_step.gan", "idle_share.gan",
              "mfu.gan"):
        assert bench_run.reader(m)(obs) is None, m


def test_readers_on_a_traced_window():
    obs = {"kernels": 10, "window_s": 4.0, "busy_s": 3.8, "flop": 7e13,
           "program": {"device_ms": {"gan.d_step": [1000.0, 1200.0], "gan.g_step": [1500.0],
                                     "gan.judge": [100.0] * 12},
                       "counters": {"gan.d_steps": 2, "gan.g_steps": 1}}}
    read = {m: bench_run.reader(m)(obs) for m in ("d_step_ms.gan", "g_step_ms.gan",
                                                  "judge_ms_per_step.gan", "idle_share.gan",
                                                  "mfu.gan")}
    assert read == pytest.approx({"d_step_ms.gan": 1100.0, "g_step_ms.gan": 1500.0,
                                  "judge_ms_per_step.gan": 400.0, "idle_share.gan": 5.0,
                                  "mfu.gan": 100.0 * 7e13 / (4.0 * 67e12)})
    # the parent program has no GAN spans or counters: nothing to read but
    # the window's idle share
    bare = {k: v for k, v in obs.items() if k not in ("program", "flop")}
    assert {m: bench_run.reader(m)(bare) for m in read} == pytest.approx(
        {m: 5.0 if m == "idle_share.gan" else None for m in read})


def test_discriminator_operations_by_hand():
    # one period 2 on 12 samples, batch 1: heights 6 -> 2 -> 1 -> 1 -> 1 -> 1
    h, c = [2, 1, 1, 1, 1], (1, 32, 128, 512, 1024, 1024)
    want = sum(2 * h[i] * 2 * c[i + 1] * c[i] * 5 for i in range(5)) + 2 * 1 * 2 * 1024 * 3
    assert yardstick_gan.mpd_flop([2], 1, 12) == want
    # one window 16 (hop 4, 9 bins) on 16 samples: 5 frames; bands of 0, 2, 2, 2, 3 bins
    bands = GAN["mrd_bands"]
    widths = [int(hi * 9) - int(lo * 9) for lo, hi in bands]
    assert widths == [0, 2, 2, 2, 3]
    total = 5 * (yardstick.fft_flop(16) + 16)
    outs = []
    for w in widths:
        total += 2 * 5 * w * 32 * 2 * 27
        for _ in range(3):
            w = (w + 8 - 9) // 2 + 1
            total += 2 * 5 * w * 32 * 32 * 27
        total += 2 * 5 * w * 32 * 32 * 9
        outs.append(w)
    total += 2 * 5 * sum(outs) * 32 * 9
    assert yardstick_gan.mrd_flop([16], 32, 0.25, bands, 1, 16) == pytest.approx(total, rel=1e-12)


def test_the_driver_is_found_by_name():
    mix = traffic.load("gan-b64-4step")
    assert mix["driver"] == "gan" and mix["batch"] * mix["crop_s"] == 96.0
    assert mix["utterances"] * mix["manifest_repeats"] // mix["batch"] == 128
