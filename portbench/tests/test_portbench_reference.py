"""The plain reference against the port at mel_24k_tiny on the CPU: a
serving call, one FM step, the limiters' gate order and the loader's
crops. These hold the reference to the program where both are right; the
card's comparisons hold the program to the reference."""

import numpy as np
import pytest
import torch

from portbench import traffic, weights
from portbench.reference import check, data, model as ref
from portbench.tests.tiny import TINY, drive, tiny_run

from flow2gan_tpu_torch.api import VocoderModel
from flow2gan_tpu_torch.data.dataset import build_data_loader, read_recording_manifest
from flow2gan_tpu_torch.models import build_generator
from flow2gan_tpu_torch.utils import AttributeDict

CPU = torch.device("cpu")


def _port(w):
    module = build_generator(AttributeDict(TINY))
    module.load_state_dict(w, strict=True)
    return module


def test_serving_matches_the_port():
    torch.set_num_threads(2)
    w = weights.make_weights(ref.param_specs(TINY), 5, CPU)
    vm = VocoderModel(_port(w), AttributeDict(TINY), CPU)
    mel = traffic.mels(11, 0, TINY, 2, 37, CPU)
    for steps in (1, 4):
        ours = vm.infer(mel, n_timesteps=steps, seed=2**40 + 3).numpy()
        theirs = check.Reference(TINY, w, CPU).synth(mel, steps, 2**40 + 3)
        assert check.rel_err(ours, theirs) < 2e-6
        assert 0 < np.abs(theirs).max() < 1  # no clamping hides a difference


def test_limiters_in_the_ports_gate_order():
    w = weights.make_weights(ref.param_specs(TINY), 5, CPU)
    port = _port(w)
    ours = [n for n, m in port.named_modules() if type(m).__name__ in ("BiasNorm", "ChannelScale")]
    theirs = [n for n, m in ref.build(TINY, w).named_modules()
              if isinstance(m, (ref.BiasNorm, ref.ChannelScale))]
    assert ours == theirs and len(ours) == port.num_limiters


def test_loader_batches_are_read_again(tmp_path):
    mix = {"utterances": 6, "utterance_s": 1.0, "manifest_repeats": 2}
    paths = traffic.write_corpus(tmp_path, 3, mix, 24000, CPU)
    loader = build_data_loader(read_recording_manifest(tmp_path / "train.jsonl"),
                               sampling_rate=24000, batch_size=3, num_workers=2, train=True,
                               duration=0.5, max_load_times=3, seed=77, drop_last=True)
    loader.process_index, loader.process_count = 1, 2  # rank 1 of 2
    loader.set_epoch(2)
    assert len(loader) == 2
    for pos, batch in enumerate(loader):
        audio, lens = data.batch(paths, 24000, 77, 2, pos, 3, 1, 2, 0.5, 3)
        assert np.array_equal(audio, batch["audio"]) and np.array_equal(lens, batch["audio_lens"])


@pytest.mark.parametrize("workload", ["fm-24k-b256", "fm-24k-dp4"])
def test_fm_steps_match_the_port(workload):
    line = drive(tiny_run(workload))
    checks = {k: v["value"] for k, v in line["checks"].items()}
    assert checks["loss_rel_err"] < 1e-5
    assert checks["grad_norm_gap"] < 1e-4
    assert checks["change_norm_gap"] < 1e-2
