"""Mid-epoch resume and the trainers' shared options on the CPU, against the
JAX package's loader and sampler:

- the loader's `state_dict` round trip: a resumed loader continues the
  stream, a following epoch starts fresh, a pass to the end replays, an
  eval loader is not resumable (as `tests/test_dataset.py` holds the JAX
  loader), and its batches equal the JAX loader's;
- the sampler snapshot through a `.pt` checkpoint, and the
  `--train-dls-weights` choice sequence against JAX's;
- `bin/pretrain.py --resume-from checkpoint-<n>.pt` (mid-epoch, two
  weighted manifests, --freeze-modules and --lr-scale-rules on) ends where
  an uninterrupted run ends, bit for bit; the same for `bin/finetune.py`,
  with its D/G alternation restored, and a frozen module unchanged.

mel_24k_tiny; the fine-tuner's discriminators are few and narrow (the
trainer's logic is what is tested here).
"""

import random
import shutil

import numpy as np
import pytest
import torch

from flow2gan_tpu.bin import pretrain as j_pretrain
from flow2gan_tpu.data import dataset as j_dataset
from flow2gan_tpu.utils import to_float_tuple

import flow2gan_tpu_torch
from flow2gan_tpu_torch.bin import finetune, pretrain, train_tokenizer
from flow2gan_tpu_torch.data import dataset
from flow2gan_tpu_torch.models import discriminators as pd
from flow2gan_tpu_torch.training import checkpoint as ckpt

from .test_torch_port_trainer import _corpus


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _loader(recs, **kw):
    return dataset.build_data_loader(recs, sampling_rate=24000, batch_size=1, train=True,
                                     duration=0.2, seed=3, num_workers=2, **kw)


def _names(loader):
    return [b["file_names"] for b in loader]


# ---------------------------------------------------------------- loader


def test_mid_epoch_resume_continues_the_stream(tmp_path):
    recs = dataset.read_recording_manifest(_corpus(tmp_path))
    loader = _loader(recs)
    loader.set_epoch(2)
    full = _names(loader)
    assert len(full) == 6 and loader.state_dict() == {"epoch": 2, "consumed": 0}
    loader.set_epoch(2)
    it = iter(loader)
    consumed = [next(it)["file_names"], next(it)["file_names"]]
    snap = loader.state_dict()
    it.close()
    assert snap == {"epoch": 2, "consumed": 2} and consumed == full[:2]
    resumed = _loader(recs)
    resumed.load_state_dict(snap)
    assert _names(resumed) == full[2:]
    resumed.set_epoch(3)
    assert resumed.state_dict() == {"epoch": 3, "consumed": 0}
    assert len(_names(resumed)) == len(full)


def test_a_pass_to_the_end_replays_and_eval_loaders_do_not_resume(tmp_path):
    recs = dataset.read_recording_manifest(_corpus(tmp_path))
    loader = _loader(recs)
    first = _names(loader)
    assert _names(loader) == first  # replay, not empty
    evals = dataset.build_data_loader(recs, batch_size=1, train=False, duration=0.2,
                                      num_workers=2)
    assert not evals.resumable
    it = iter(evals)
    peeked = next(it)["file_names"]
    it.close()
    full = _names(evals)
    assert full[0] == peeked and _names(evals) == full


def test_resumed_batches_equal_the_jax_loaders(tmp_path):
    """The same state through both packages' loaders: the same batches."""
    recs = dataset.read_recording_manifest(_corpus(tmp_path))
    ours = _loader(recs)
    theirs = j_dataset.build_data_loader(
        [j_dataset.Recording(**vars(r)) for r in recs], sampling_rate=24000, batch_size=1,
        train=True, duration=0.2, seed=3, num_workers=2)
    theirs.process_index, theirs.process_count = 0, 1
    for loader in (ours, theirs):
        loader.load_state_dict({"epoch": 4, "consumed": 3})
    a, b = list(ours), list(theirs)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_allclose(x["audio"], y["audio"], rtol=0, atol=1e-7)
        assert x["file_names"] == y["file_names"]
    assert ours.state_dict() == theirs.state_dict() == {"epoch": 4, "consumed": 0}


def test_sampler_snapshot_round_trips_through_a_checkpoint(tmp_path):
    """The port's snapshot holds what the JAX package's holds, survives
    `save_checkpoint`/`load_checkpoint`, and restores the loaders and the
    RNG exactly."""
    recs = dataset.read_recording_manifest(_corpus(tmp_path))
    dl = _loader(recs)
    dl.set_epoch(4)
    it = iter(dl)
    next(it)
    it.close()
    rng_py = random.Random(123)
    rng_py.random()
    snap = ckpt.sampler_state_snapshot(4, [dl], rng_py)
    assert snap == j_pretrain.sampler_state_snapshot(4, [dl], rng_py)
    expected = rng_py.random()
    path = tmp_path / "c.pt"
    ckpt.save_checkpoint(path, model={"w": torch.zeros(1)}, sampler_state=snap)
    fresh = _loader(recs)
    epoch, rng2 = ckpt.restore_sampler_state(ckpt.load_checkpoint(path)["sampler"], [fresh])
    assert epoch == 4 and fresh.state_dict() == {"epoch": 4, "consumed": 1}
    assert rng2.random() == expected
    with pytest.raises(ValueError, match="holds 1 training loaders"):
        ckpt.restore_sampler_state(snap, [fresh, fresh])


# ---------------------------------------------------------------- trainers


def _two_manifests(root):
    """The 6-recording corpus as two manifests of 4 and 2."""
    recs = dataset.read_recording_manifest(_corpus(root))
    paths = []
    for i, part in enumerate((recs[:4], recs[4:])):
        paths.append(root / f"part{i}.jsonl.gz")
        dataset.write_recording_manifest(part, paths[-1])
    return ",".join(str(p) for p in paths)


def _jax_choices(seed: int, epoch: int, weights: str, lengths) -> list:
    """The loader indices the JAX trainers' epoch loop draws (`rng_py.choices`
    over the weights of `to_float_tuple`), up to the first draw of an
    exhausted loader, which ends the epoch."""
    rng_py = random.Random(seed + epoch)
    left, out = list(lengths), []
    while True:
        i = rng_py.choices(range(len(left)), weights=list(to_float_tuple(weights)), k=1)[0]
        if not left[i]:
            return out
        left[i] -= 1
        out.append(i)


COMMON = ["--model-name", "mel_24k_tiny", "--device", "cpu", "--batch-size", "1",
          "--duration", "0.25", "--num-workers", "1", "--num-epochs", "2", "--seed", "4",
          "--save-every-n", "1", "--keep-last-k", "20", "--average-period", "1",
          "--valid-interval", "0", "--train-dls-weights", "1,3"]


def _resumed_equals_straight(module, root, extra, resume_at):
    """Run straight for 2 epochs, then again from a copy of
    checkpoint-<resume_at>.pt with --resume-from; returns both histories and
    both final checkpoints."""
    manifests = _two_manifests(root)
    straight = root / "straight"
    args = COMMON + ["--train-recordings", manifests, *extra]
    runs = {"straight": module.run(module.get_parser().parse_args(
        args + ["--exp-dir", str(straight)]))}
    resumed = root / "resumed"
    resumed.mkdir()
    shutil.copy(straight / f"checkpoint-{resume_at}.pt", resumed / "from.pt")
    runs["resumed"] = module.run(module.get_parser().parse_args(
        args + ["--exp-dir", str(resumed), "--resume-from", str(resumed / "from.pt")]))
    return runs, ckpt.load_checkpoint(straight / "epoch-2.pt"), ckpt.load_checkpoint(
        resumed / "epoch-2.pt")


def _equal(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(v, b[k]) for k, v in a.items())


def _codebook(root) -> str:
    """A token_24k_tiny codebook fit on the corpus by bin/train_tokenizer."""
    return str(train_tokenizer.main([
        "--model-name", "token_24k_tiny", "--recordings", str(_corpus(root / "codebook")),
        "--output", str(root / "codebook.npz"), "--iters", "4", "--device", "cpu"]))


def _pretrain_resumed(root, extra):
    """Mid-epoch (epoch 2, after its first batch), with two weighted
    manifests: the resumed run draws the same loaders and losses as the
    straight run's tail, and ends with the same parameters, running average
    and optimizer state, bit for bit; the loader choice equals JAX's.
    Returns both final checkpoints and the first."""
    # 4 and 2 recordings at batch 1: an epoch ends at the first draw of an
    # exhausted loader
    epochs = [_jax_choices(4, e, "1,3", (4, 2)) for e in (1, 2)]
    assert len(epochs[1]) >= 2  # so that checkpoint n1 + 1 lies inside epoch 2
    n1 = len(epochs[0])
    runs, a, b = _resumed_equals_straight(pretrain, root, extra, resume_at=n1 + 1)
    straight, resumed = runs["straight"], runs["resumed"]
    assert [h["dl"] for h in straight] == epochs[0] + epochs[1]
    assert [h["batch_idx_train"] for h in resumed] == list(range(n1 + 2, len(straight) + 1))
    assert [(h["dl"], h["loss"]) for h in resumed] == [(h["dl"], h["loss"])
                                                       for h in straight[n1 + 1:]]
    assert _equal(a["model"], b["model"]) and _equal(a["model_avg"], b["model_avg"])
    for key in ("model_norms", "model_norm_threshold", "clip_scale"):
        assert torch.equal(a["optimizer"][key], b["optimizer"][key])
    return a, b, ckpt.load_checkpoint(root / "straight" / "epoch-0.pt")["model"]


def test_pretrain_resume_from_reproduces_the_uninterrupted_run(tmp_path):
    """`_pretrain_resumed` on mel_24k_tiny; the frozen cond encoder never
    moves; the scaled branch moves."""
    extra = ["--freeze-modules", "cond_encoder", "--lr-scale-rules", "estimators_1=0.5"]
    a, b, first = _pretrain_resumed(tmp_path, extra)
    frozen = [k for k in first if k.startswith("cond_encoder.")]
    assert frozen and all(torch.equal(a["model"][k], first[k]) for k in frozen)
    assert all(not torch.equal(a["model"][k], first[k])
               for k in first if k.startswith("estimators.1.") and k.endswith("weight"))


def test_pretrain_resume_from_reproduces_the_uninterrupted_run_on_tokens(tmp_path):
    """`_pretrain_resumed` on token_24k_tiny with a codebook: the embedding
    table trains and resumes bit for bit with the rest."""
    a, b, first = _pretrain_resumed(tmp_path, ["--model-name", "token_24k_tiny",
                                               "--tokenizer", _codebook(tmp_path)])
    assert a["model"]["token_embed.weight"].shape == (64, 24)
    assert not torch.equal(a["model"]["token_embed.weight"], first["token_embed.weight"])


def test_finetune_resume_from_reproduces_the_uninterrupted_run(tmp_path, monkeypatch):
    _finetune_resumed(tmp_path, monkeypatch, "mel_24k_tiny")


def test_finetune_resume_from_reproduces_the_uninterrupted_run_on_tokens(tmp_path, monkeypatch):
    _finetune_resumed(tmp_path, monkeypatch, "token_24k_tiny")


def _finetune_resumed(tmp_path, monkeypatch, model):
    """Mid-epoch, inside the D/G alternation: the resumed run continues the
    alternation, the loaders and the losses, and ends with both sides'
    parameters and both optimizers' step counts equal to the straight
    run's; --freeze-modules cond_encoder leaves the generator's cond encoder
    bitwise unchanged while the rest of it trains (the token config's
    embedding table among it)."""
    monkeypatch.setattr(pd.DiscriminatorP, "CHANNELS", (8, 16, 16, 32, 32))
    monkeypatch.setattr(finetune, "Discriminators", lambda: pd.Discriminators((2, 3), (256, 128)))
    init = tmp_path / "fm.pt"
    torch.save(flow2gan_tpu_torch.get_model(model, device="cpu", seed=9)
               .module.state_dict(), init)
    extra = ["--generator-model-path", str(init), "--n-timesteps", "2",
             "--gen-start-batch-idx", "2", "--freeze-modules", "cond_encoder"]
    if model.startswith("token"):
        extra += ["--model-name", model, "--tokenizer", _codebook(tmp_path)]
    runs, a, b = _resumed_equals_straight(finetune, tmp_path, extra, resume_at=4)
    straight, resumed = runs["straight"], runs["resumed"]
    assert [h["side"] for h in straight[:4]] == ["D", "D", "G", "D"]
    assert ckpt.load_checkpoint(tmp_path / "resumed" / "from.pt")["train_disc"] is False
    assert [(h["side"], h["dl"], h["loss"]) for h in resumed] == [
        (h["side"], h["dl"], h["loss"]) for h in straight[4:]]
    for side in ("generator", "discriminator"):
        assert _equal(a["model"][side], b["model"][side]), side
    assert a["train_disc"] == b["train_disc"]
    for side in ("g", "d"):
        assert a["optimizer"][side]["step"] == b["optimizer"][side]["step"] > 0
    init_sd = torch.load(init, weights_only=True)
    gen = a["model"]["generator"]
    assert all(torch.equal(gen[k], v) for k, v in init_sd.items() if k.startswith("cond_encoder."))
    assert not all(torch.equal(gen[k], v) for k, v in init_sd.items())
