"""Tiny settings for the CPU tests: mel_24k_tiny in place of the cells'
configurations, and each mix cut to a few short requests or crops."""

import torch

from portbench import run as bench_run

TINY = {
    "sampling_rate": 24000, "n_mels": 20, "mel_n_fft": 256, "mel_hop_length": 64,
    "n_ffts": [128, 64], "hop_lengths": [64, 32], "channels": [64, 48],
    "time_embed_channels": 32, "hidden_factor": 3, "conv_kernel_sizes": [7, 7],
    "num_layers": [2, 2], "use_cond_encoder": True, "cond_enc_channels": 48,
    "cond_enc_hidden_factor": 3, "cond_enc_conv_kernel_size": 7, "cond_enc_num_layers": 2,
    "use_residual_scale": True, "init_noise_scale": 0.1, "pred_x1": True,
    "branch_reduction": "mean", "spec_scaling_loss": True, "loss_n_filters": 64,
    "loss_n_fft": 256, "loss_hop_length": 64, "loss_power": 0.5, "loss_eps": 1e-7,
    "loss_scale_min": 1e-2, "loss_scale_max": 1e2, "branch_dropout": 0.05,
    "max_add_noise_scale": 0.0, "compute_dtype": None,
}

MIXES = {
    "serve-24k-bulk": dict(batch=2, lengths=3, min_s=0.2, max_s=0.6, trace_requests=3,
                           check_requests=3, n_timesteps=2),
    "stream-44k-chunk": dict(chunk_frames=10, lengths=2, min_s=0.3, max_s=0.8, trace_chunks=4,
                             check_streams=2),
    "fm-24k-b256": dict(batch=4, crop_s=0.5, utterances=8, utterance_s=1.0, manifest_repeats=2,
                        num_workers=2, reference_rows=2, trace_steps=2),
    "fm-24k-dp4": dict(world=2, batch=4, crop_s=0.5, utterances=8, utterance_s=1.0,
                       manifest_repeats=2, num_workers=2, reference_rows=2, trace_steps=2),
}


def tiny_run(workload: str, seed: int = 2**31 + 12345, trace: bool = False, fault=None,
             seconds: float = 0.5):
    """The cell's run description at the tiny size, on the CPU."""
    torch.set_num_threads(2)
    return bench_run.make_run(bench_run.load_benchmark(), workload, seed, seconds, trace,
                              torch.device("cpu"), fault=fault, cfg_override=dict(TINY),
                              mix_override=MIXES[workload])


def drive(r):
    """The rest of a run after its look for a card: the driver, then the
    result line (with `setup_s` a placeholder)."""
    import importlib

    bench = bench_run.load_benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == r.workload)
    driver = importlib.import_module("portbench.drivers." + bench_run._driver(cell))
    res = driver.run(r)
    return bench_run.result_line(bench, r, res, 0.0, "cpu", 1)
