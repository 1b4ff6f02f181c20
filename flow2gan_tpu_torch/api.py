"""Public model API of the port: `get_model` builds a named config's
generator and returns a `VocoderModel` that serves mel -> waveform synthesis,
or tokens -> waveform for the token family; counterpart of
`flow2gan_tpu/api.py`.

A bfloat16 model is built as the JAX package builds one: a config with
`compute_dtype="bfloat16"`, `build_generator`, then `VocoderModel`:

    cfg = get_generator_config("mel_24k_base")
    cfg["compute_dtype"] = "bfloat16"
    module = init_weights(build_generator(cfg), torch.Generator().manual_seed(0))
    model = VocoderModel(module.to("cuda"), cfg, torch.device("cuda"))

On a CUDA device, `VocoderModel.infer` replays a call's whole device work as
one CUDA graph when the call repeats the previous call's key (`GraphRule`),
as every chunk of a stream does; on the CPU every call runs eager.
"""

from __future__ import annotations

import functools
import logging
import threading
from pathlib import Path
from typing import Callable, Hashable, Optional, Tuple, Union

import torch
from torch import nn

from flow2gan_tpu_torch import tracing
from flow2gan_tpu_torch.compat.from_reference import load_weights
from flow2gan_tpu_torch.models import BaseAudioGenerator, build_generator, get_generator_config
from flow2gan_tpu_torch.models.config import (
    HF_MODEL_NAMES,
    HF_REPO,
    generator_config_for_hf_model,
)
from flow2gan_tpu_torch.models.convnext import DepthwiseConv1d
from flow2gan_tpu_torch.models.norms import BiasNorm
from flow2gan_tpu_torch.ops import stft
from flow2gan_tpu_torch.ops.mel import LogMelSpectrogram
from flow2gan_tpu_torch.ops.tokenizer import MelKMeansTokenizer, is_token_config
from flow2gan_tpu_torch.utils import AttributeDict, disable_tf32


def check_token_ids(ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """`ids` as they are if they are integers in [0, vocab_size), else a
    ValueError that names the range. The embedding would raise on the CPU
    and trip a device-side assert on the card, which poisons the CUDA
    context."""
    if ids.dtype.is_floating_point or ids.dtype.is_complex or ids.dtype == torch.bool:
        raise ValueError(f"token ids must be integers, got {ids.dtype}")
    if ids.numel() and not bool(((ids >= 0) & (ids < vocab_size)).all()):
        raise ValueError(f"token ids must lie in [0, {vocab_size}); got ids in "
                         f"[{int(ids.min())}, {int(ids.max())}]")
    return ids


class InferGraph:
    """One `infer` call's device work captured as a CUDA graph: the cond
    encoder, every Euler step with its three branches and fused iSTFT
    launches, and the clamp, from static conditioning and x0 buffers to a
    static waveform.

    `capture` first runs the call eagerly on the model's capture stream
    (`CaptureSpace`), which builds the cached constants and that stream's
    cuBLAS workspace outside the graph and gives the capturing call its
    output; then it captures on that stream, into the memory pool of the
    model's previous graph. The graph holds the cached
    device constants it reads (`stft.holding`). The capture launches
    nothing, so its counts are dropped (`tracing.uncounted`); a replay
    launches nothing from the host and counts nothing, so `istft.launches`
    counts the host's launches and the profiler sees the kernels a replay
    runs."""

    def __init__(self, graph: torch.cuda.CUDAGraph, cond: torch.Tensor, x0: torch.Tensor,
                 out: torch.Tensor, constants: list):
        self.graph, self.cond, self.x0, self.out = graph, cond, x0, out
        self.constants = constants

    @classmethod
    def capture(cls, module: BaseAudioGenerator, space: "CaptureSpace", n_timesteps: int,
                clamp_pred: bool, cond: torch.Tensor,
                x0: torch.Tensor) -> Tuple["InferGraph", torch.Tensor]:
        """The graph of `module.infer_from_noise` on `cond` and `x0`, captured
        in `space`, and that call's output."""
        caller = torch.cuda.current_stream(cond.device)
        cond, x0 = cond.clone(), x0.clone()
        space.stream.wait_stream(caller)
        graph = torch.cuda.CUDAGraph()
        # the outer context gives the caller's stream back even where a
        # failed capture's end raises
        with torch.cuda.stream(space.stream):
            first = module.infer_from_noise(x0, cond, None, n_timesteps, clamp_pred)
            with stft.holding() as constants, tracing.uncounted():
                # not `torch.cuda.graph`, whose entry empties the allocator's
                # cache, which every later eager call would then fill again;
                # thread-local, so CUDA work of other threads goes on
                graph.capture_begin(space.pool(), capture_error_mode="thread_local")
                try:
                    out = module.infer_from_noise(x0, cond, None, n_timesteps, clamp_pred)
                finally:
                    graph.capture_end()
        space.last = graph
        caller.wait_stream(space.stream)
        first.record_stream(caller)
        return cls(graph, cond, x0, out, constants), first

    def __call__(self, cond: torch.Tensor, x0: torch.Tensor) -> torch.Tensor:
        """The graph on `cond` and `x0`, replayed on the current stream; a
        copy of its output, which the next replay leaves alone."""
        self.cond.copy_(cond)
        self.x0.copy_(x0)
        self.graph.replay()
        return self.out.clone()


class CaptureSpace:
    """Where one model's captures run: one stream, and one memory pool that
    each graph shares with the one before, so that the allocator's cache
    does not grow with the number of captures. `last`, the latest graph,
    keeps the pool alive after `GraphRule` has dropped it (a pool that no
    graph holds is freed, and cannot be shared); it is never replayed again
    once a capture shares its pool."""

    def __init__(self, device: torch.device):
        with torch.cuda.device(device):
            self.stream = torch.cuda.Stream()
        self.last: Optional[torch.cuda.CUDAGraph] = None

    def pool(self):
        """The pool for the next capture: the last graph's, or a new one."""
        return self.last.pool() if self.last is not None else None


class GraphRule:
    """Which way an `infer` call runs, decided from its key alone.

    On a CUDA device (`cuda`) a call whose key equals the previous call's
    replays that key's graph, capturing it first if there is none (the
    capturing call returns the output of the capture's eager warm-up). A
    call with another key runs eager, becomes the previous key, and drops
    the graph held for the old one, so that at most one graph is alive (its
    memory lies in the model's one capture pool, which the next graph
    reuses). On any other device every call runs eager. A key whose
    capture raised runs eager from then on, and the failure is logged once.
    A replay or capture holds the rule's lock, since it shares the graph's
    static buffers; eager calls run side by side.

    The spans `infer.graph_capture` and `infer.graph_replay` and the
    counters `infer.graph_captures`, `infer.graph_replays` and
    `infer.eager_calls` say which way each call ran."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.key: Optional[Hashable] = None  # the previous call's key
        self.graph: Optional[Callable[..., torch.Tensor]] = None  # its graph, once captured
        self.failed: set = set()
        self.lock = threading.Lock()

    def __call__(self, key: Hashable, eager: Callable[[], torch.Tensor],
                 capture: Callable[..., Tuple[Callable[..., torch.Tensor], torch.Tensor]],
                 inputs: Callable[[], tuple]) -> torch.Tensor:
        """The call's output: `eager()`, or a graph's on `inputs()`, where
        `capture(*inputs())` gives the graph and the capturing call's
        output."""
        with self.lock:
            if self.cuda and key == self.key and self.graph is not None:
                with tracing.span("infer.graph_replay"):
                    tracing.count("infer.graph_replays")
                    return self.graph(*inputs())
            if self.cuda and key == self.key and key not in self.failed:
                try:
                    with tracing.span("infer.graph_capture"):
                        self.graph, out = capture(*inputs())
                except RuntimeError as err:
                    self.failed.add(key)
                    logging.warning(f"CUDA graph capture failed for the infer key {key!r}; calls "
                                    f"with this key run eager: {err}")
                else:
                    tracing.count("infer.graph_captures")
                    return out
            self.key, self.graph = key, None
        tracing.count("infer.eager_calls")
        return eager()


class VocoderModel:
    """A generator and its frontends on one device.

    `infer(cond)` takes (B, n_mels, frames) log-mels, or (B, frames) integer
    token ids for a token config, and returns (B, frames * hop) waveforms;
    `mel(audio)` takes (B, L) and returns (B, n_mels, frames); `tokens(audio)`
    returns (B, frames) int64 ids through the `tokenizer` (token configs);
    `cond(audio)` is whichever of the two the config takes, and
    `reconstruct(audio)` is `infer` of it.
    Inputs may be numpy arrays or tensors; outputs are tensors on the model's
    device. `n_timesteps` is the Euler step count a call uses when it names
    none (a released model's own, from `get_model`).

    On a CUDA device a call that repeats the previous call's conditioning
    shape, strides and dtype, step count, clamp and parameter dtype replays the
    previous call's CUDA graph (`GraphRule`, `InferGraph`), with the same
    output bit for bit; its x0 is still drawn from `seed` on every call. The
    graph reads the module's parameters where they lie: change them in place
    (`load_state_dict`), not by replacing them. Calls from several threads
    are safe: replays and captures take turns, eager calls do not wait.
    """

    def __init__(self, module: BaseAudioGenerator, config: AttributeDict, device: torch.device,
                 n_timesteps: int = 1, tokenizer: Optional[MelKMeansTokenizer] = None):
        self.module = module.eval()
        self.config = config
        self.device = device
        self.n_timesteps = n_timesteps
        self.is_token = is_token_config(config)
        self.mel_fn = LogMelSpectrogram(
            sampling_rate=config.sampling_rate,
            n_fft=config.mel_n_fft,
            hop_length=config.mel_hop_length,
            n_mels=config.n_mels,
        ).to(device)
        self.tokenizer = tokenizer.to(device) if tokenizer is not None else None
        self.graphs = GraphRule(device.type == "cuda")
        self.capture_space = CaptureSpace(device) if device.type == "cuda" else None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _on_device(self, cond) -> torch.Tensor:
        """The conditioning on the device: float32 mels, or token ids kept
        integer and checked against the vocabulary where they lie, so that
        ids from the host are checked before the copy, with no wait on the
        card."""
        if not self.is_token:
            return self._tensor(cond)
        return check_token_ids(torch.as_tensor(cond), self.config.vocab_size).to(self.device)

    @torch.inference_mode()
    def mel(self, audio) -> torch.Tensor:
        return self.mel_fn(self._tensor(audio))

    @torch.inference_mode()
    def tokens(self, audio) -> torch.Tensor:
        """(B, L) audio -> (B, frames) int64 pseudo-codec token ids."""
        if self.tokenizer is None:
            raise ValueError("this model has no tokenizer; pass tokenizer=<codebook.npz> "
                             "to get_model for token_* configs")
        return self.tokenizer(self._tensor(audio))

    @torch.inference_mode()
    def infer(self, cond, n_timesteps: Optional[int] = None, clamp_pred: bool = True,
              seed: int = 0) -> torch.Tensor:
        with tracing.span("api.infer", root=True):
            n = n_timesteps if n_timesteps is not None else self.n_timesteps
            cond = self._on_device(cond)
            # a size-1 axis's stride addresses nothing, and host copies differ in it
            strides = tuple(st for st, size in zip(cond.stride(), cond.shape) if size != 1)
            key = (tuple(cond.shape), strides, cond.dtype, n, clamp_pred,
                   next(self.module.parameters()).dtype)
            return self.graphs(
                key,
                eager=lambda: self.module.infer(cond, n_timesteps=n, clamp_pred=clamp_pred,
                                                generator=self._generator(seed)),
                capture=functools.partial(InferGraph.capture, self.module, self.capture_space, n,
                                          clamp_pred),
                inputs=lambda: (cond, self.module.draw_x0(cond, self._generator(seed))))

    def _generator(self, seed: int) -> torch.Generator:
        """A fresh generator for x0: the eager path that follows a failed
        capture draws the x0 that the capture drew."""
        return torch.Generator(device=self.device).manual_seed(seed)

    def cond(self, audio) -> torch.Tensor:
        """(B, L) audio -> the config's conditioning: `tokens` for a token
        config, else `mel`."""
        return self.tokens(audio) if self.is_token else self.mel(audio)

    def reconstruct(self, audio, n_timesteps: Optional[int] = None) -> torch.Tensor:
        return self.infer(self.cond(audio), n_timesteps=n_timesteps)


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init of the JAX package's scheme, drawn from `generator`:
    truncated-normal (std 0.015, cut at 2 std) conv/linear weights with zero
    biases, BiasNorm biases N(0, 1e-2^2) and embedding tables N(0, 0.02^2)
    (flax's `Embed(embedding_init=normal(0.02))`). The other parameters keep
    the constant init their modules give them."""
    for module in model.modules():
        if isinstance(module, nn.Embedding):
            module.weight.copy_(torch.randn(module.weight.shape, generator=generator) * 0.02)
        elif isinstance(module, BiasNorm):
            module.bias.copy_(torch.randn(module.bias.shape, generator=generator) * 1e-2)
        elif isinstance(module, (nn.Linear, nn.Conv1d, DepthwiseConv1d)):
            nn.init.trunc_normal_(module.weight, std=0.015, a=-0.03, b=0.03, generator=generator)
            nn.init.zeros_(module.bias)
    return model


def get_model(
    model_name: Optional[str] = None,
    checkpoint: Optional[Union[str, Path]] = None,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    hf_model_name: Optional[str] = None,
    tokenizer: Optional[Union[str, Path, MelKMeansTokenizer]] = None,
) -> VocoderModel:
    """Build a vocoder from a named config (default mel_24k_base).

    With `checkpoint=None` the weights are a random init drawn from `seed`;
    otherwise `checkpoint` is a `.pt` file: the port's own `state_dict`, a
    trainer checkpoint, or a checkpoint in the reference's naming (a released
    model), told apart by their names (`compat.from_reference`); or a `.ckpt`
    file the JAX package wrote: its params, a trainer checkpoint, or a GAN
    checkpoint, whose generator is taken. Every file loads strictly.
    `hf_model_name` names a released model: it picks the config and the
    n_timesteps the model was tuned for, and needs the file itself as
    `checkpoint`, since the port downloads nothing. `device` defaults to
    "cuda", and there is no fallback: with no card this raises unless the
    caller passes `device="cpu"`. On the card it turns TF32 off for the
    process (`utils.disable_tf32`), so every inference call runs in IEEE
    float32. `tokenizer` (a codebook `.npz` or a `MelKMeansTokenizer`) gives
    a token config its `tokens` and `reconstruct`; it is checked against the
    config, and a mismatch raises ValueError.
    """
    n_timesteps = 1
    if hf_model_name is not None:
        if hf_model_name not in HF_MODEL_NAMES:
            raise ValueError(f"Unknown released model {hf_model_name!r}; available: "
                             f"{sorted(HF_MODEL_NAMES)}")
        if checkpoint is None:
            raise FileNotFoundError(
                f"{hf_model_name!r} needs its checkpoint: the port downloads nothing, so fetch "
                f"{hf_model_name}.pt from {HF_REPO} and pass checkpoint=<its path>")
        n_timesteps = HF_MODEL_NAMES[hf_model_name]
        model_name = model_name or generator_config_for_hf_model(hf_model_name)
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    if device.type == "cuda":
        disable_tf32()
    cfg = get_generator_config(model_name or "mel_24k_base")
    module = build_generator(cfg)
    if checkpoint is None:
        init_weights(module, torch.Generator().manual_seed(seed))
    else:
        load_weights(module, checkpoint)
    if tokenizer is not None and not isinstance(tokenizer, MelKMeansTokenizer):
        tokenizer = MelKMeansTokenizer.from_file(tokenizer, expect_config=cfg)
    elif tokenizer is not None:
        tokenizer.check_config(cfg)
    return VocoderModel(module.to(device), cfg, device, n_timesteps, tokenizer)
