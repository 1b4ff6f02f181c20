"""The traffic generator: every seed gives the same set of lengths, in a
seeded order, with seeded content."""

import collections
import itertools

import numpy as np
import torch

from portbench import traffic
from portbench.tests.tiny import TINY

BIG_SEED = 2**31 + 987654321


def test_lengths_are_the_mid_quantiles():
    mix = {"min_s": 1.0, "max_s": 10.0, "lengths": 16, "log_uniform": True}
    frames = traffic.lengths_frames(mix, {"sampling_rate": 24000, "mel_hop_length": 256})
    assert len(frames) == 16 and frames == sorted(frames)
    assert 94 <= frames[0] and frames[-1] <= 938
    assert frames[0] == round(10 ** (0.5 / 16) * 24000 / 256)
    lin = traffic.lengths_frames({"min_s": 10.0, "max_s": 30.0, "lengths": 8, "log_uniform": False},
                                 {"sampling_rate": 44100, "mel_hop_length": 512})
    assert lin == [round((10 + 20 * (i + 0.5) / 8) * 44100 / 512) for i in range(8)]


def test_order_is_deterministic_and_holds_every_length_each_cycle():
    def take(seed, n):
        return list(itertools.islice(traffic.order(seed, 16), n))

    a = take(BIG_SEED, 80)
    assert a == take(BIG_SEED, 80)
    assert a != take(BIG_SEED + 1, 80)
    for seed in (0, 7, BIG_SEED):
        for c in np.reshape(take(seed, 80), (5, 16)):
            assert sorted(c) == list(range(16))
    # the multiset of lengths over whole cycles is the same for every seed
    counts = {s: collections.Counter(take(s, 48)) for s in (1, 2, BIG_SEED)}
    assert len({tuple(sorted(c.items())) for c in counts.values()}) == 1


def test_content_is_deterministic_per_seed():
    cpu = torch.device("cpu")
    a = traffic.mels(BIG_SEED, 3, TINY, 2, 20, cpu)
    assert a.shape == (2, TINY["n_mels"], 20) and np.isfinite(a).all()
    assert np.array_equal(a, traffic.mels(BIG_SEED, 3, TINY, 2, 20, cpu))
    assert not np.array_equal(a, traffic.mels(BIG_SEED, 4, TINY, 2, 20, cpu))
    assert not np.array_equal(a, traffic.mels(BIG_SEED + 1, 3, TINY, 2, 20, cpu))


def test_corpus_is_deterministic_per_seed(tmp_path):
    mix = {"utterances": 3, "utterance_s": 0.5, "manifest_repeats": 2}
    paths = traffic.write_corpus(tmp_path / "a", BIG_SEED, mix, 24000, torch.device("cpu"))
    again = traffic.write_corpus(tmp_path / "b", BIG_SEED, mix, 24000, torch.device("cpu"))
    other = traffic.write_corpus(tmp_path / "c", BIG_SEED + 1, mix, 24000, torch.device("cpu"))
    assert len(paths) == 6 and paths[:3] == paths[3:]
    for p, q, o in zip(paths[:3], again[:3], other[:3]):
        with open(p, "rb") as f, open(q, "rb") as g, open(o, "rb") as h:
            a, b, c = f.read(), g.read(), h.read()
        assert a == b and a != c
    assert (tmp_path / "a" / "train.jsonl").read_text().count("\n") == 6
