"""ScaledAdam and the Eden learning-rate schedules, counterpart of
`flow2gan_tpu/training/optim.py` (the reference optimizer of the Zipformer
lineage):

- each tensor's update is scaled by its RMS, and its size is learned
  separately, updated every `size_update_period` steps;
- the gradient is clipped to `clipping_scale` times the median of the last
  `clipping_update_period` steps' RMS-weighted gradient norms, recalibrated
  at steps 10, 20 and 40 (with a 2x margin) and then every period;
- scalars get `scalar_lr_scale` and a +-`scalar_max` clamp;
- a non-finite gradient zeroes the update at every step, before the
  threshold is calibrated too (the JAX package's rule);
- per-parameter lr scales (`lr_scales`, from `--lr-scale-rules` and
  `--freeze-modules` through `make_lr_scales`) multiply the update's lr and
  the size update's, not the clipping statistic. A frozen parameter has
  scale 0: it keeps its gradient, its place in the clipping norm and its
  second moment, as in the JAX package, and its update is zero.

Speed: mel_24k_base has 425 parameter tensors of 29 shapes, so a loop over
tensors would launch thousands of small kernels per step. Like the
reference's `BatchedOptimizer`, the optimizer stacks the tensors of one shape
into one (k, *shape) tensor and keeps its state stacked, so a step costs a
few dozen ops per shape. The clipping statistic, its history and the
threshold stay on the device; the step count is a Python int, so the
schedule branches on the host and `step` never waits for the device.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass
class _Group:
    """Parameters of one shape, and their stacked state."""

    names: List[str]
    params: List[torch.Tensor]
    exp_avg_sq: torch.Tensor  # (k, *shape)
    delta: torch.Tensor  # (k, *shape), the momentum of the update
    param_rms: torch.Tensor  # (k,)
    scale_grads: torch.Tensor  # (k, size_update_period)
    scale_exp_avg_sq: torch.Tensor  # (k,)
    lr_scale: Optional[torch.Tensor] = None  # (k,); None: all 1

    @property
    def is_scalar(self) -> bool:
        return self.params[0].numel() == 1

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """(k,) -> (k, 1, ...) to broadcast over the stack."""
        return x.reshape(-1, *([1] * self.params[0].dim()))


_STATE_KEYS = ("exp_avg_sq", "delta", "param_rms", "scale_grads", "scale_exp_avg_sq")


class ScaledAdam:
    """ScaledAdam over named parameters (a model's `named_parameters()`).

    `step(lr)` reads each parameter's `.grad` (None counts as zero) and
    updates the parameters in place. `clip_scale` is the last step's clipping
    factor on the device: 0 where the gradient was not finite. `lr_scales`
    maps parameter names to lr multipliers (`make_lr_scales`; a name it does
    not hold keeps 1); they are not part of `state_dict`, as the JAX
    package's checkpoints do not hold them.
    """

    def __init__(
        self,
        named_params: Iterable[Tuple[str, torch.Tensor]],
        clipping_scale: Optional[float] = None,
        betas: Tuple[float, float] = (0.9, 0.98),
        scalar_lr_scale: float = 0.1,
        eps: float = 1e-8,
        param_min_rms: float = 1e-5,
        param_max_rms: float = 3.0,
        scalar_max: float = 10.0,
        size_update_period: int = 4,
        clipping_update_period: int = 100,
        lr_scales: Optional[Mapping[str, float]] = None,
    ):
        self.clipping_scale = clipping_scale
        self.betas = betas
        self.scalar_lr_scale = scalar_lr_scale
        self.eps = eps
        self.param_min_rms = param_min_rms
        self.param_max_rms = param_max_rms
        self.scalar_max = scalar_max
        self.size_update_period = size_update_period
        self.clipping_update_period = clipping_update_period
        by_shape: Dict[Tuple[int, ...], List[Tuple[str, torch.Tensor]]] = {}
        for name, p in named_params:
            if p.requires_grad:
                by_shape.setdefault(tuple(p.shape), []).append((name, p))
        if not by_shape:
            raise ValueError("ScaledAdam got no parameters")
        self.groups = [self._new_group(items) for items in by_shape.values()]
        dev = self.groups[0].params[0].device
        if lr_scales:
            for g in self.groups:
                scales = [float(lr_scales.get(n, 1.0)) for n in g.names]
                if any(x != 1.0 for x in scales):
                    g.lr_scale = torch.tensor(scales, device=dev)
        self.step_count = 0
        self.model_norms = torch.zeros(clipping_update_period, device=dev)
        self.model_norm_threshold = torch.tensor(float("inf"), device=dev)
        self.num_clipped = torch.zeros((), dtype=torch.int32, device=dev)
        self.clip_scale = torch.ones((), device=dev)

    def _new_group(self, items: Sequence[Tuple[str, torch.Tensor]]) -> _Group:
        names = [n for n, _ in items]
        params = [p for _, p in items]
        with torch.no_grad():
            stacked = torch.stack([p.detach().float() for p in params])
            k = len(params)
            rms = (stacked.reshape(k, -1).square().mean(dim=1).sqrt() if params[0].numel() > 1
                   else torch.zeros(k, device=stacked.device))
        return _Group(names, params, torch.zeros_like(stacked), torch.zeros_like(stacked), rms,
                      torch.zeros(k, self.size_update_period, device=stacked.device),
                      torch.zeros(k, device=stacked.device))

    @staticmethod
    def _grads(group: _Group) -> torch.Tensor:
        return torch.stack([torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                            else p.grad.float() for p in group.params])

    def zero_grad(self) -> None:
        for group in self.groups:
            for p in group.params:
                p.grad = None

    def _clipping(self, sumsq: torch.Tensor) -> torch.Tensor:
        """The clipping factor from the total weighted squared norm (the JAX
        package's `_clipping_scale`); updates the history, threshold and
        count on the device."""
        step, period = self.step_count, self.clipping_update_period
        tot_norm = sumsq.sqrt()
        if step >= 1:
            self.model_norms[step % period] = tot_norm
        recalibrate = [s for s in (10, 20, 40) if s < period and step == s]
        if recalibrate or (step % period == 0 and step > 0):
            sorted_norms = torch.sort(self.model_norms).values

            def median_of_last(n: int) -> torch.Tensor:
                return sorted_norms[period - n + min(n - 1, (n // 4) * 2)]

            if recalibrate:
                self.model_norm_threshold = 2.0 * self.clipping_scale * median_of_last(step)
            if step % period == 0 and step > 0:
                self.model_norm_threshold = self.clipping_scale * median_of_last(period)
        if step in (10, 20, 40) or (step % period == 0 and step > 0):
            self.num_clipped = torch.zeros_like(self.num_clipped)
        threshold = self.model_norm_threshold
        ans = torch.clamp(threshold / (tot_norm + 1e-20), max=1.0)
        # inf threshold: not calibrated yet, no clipping; NaN threshold (too
        # many non-finite norms in the history): zero the update
        ans = torch.where(torch.isposinf(threshold), torch.ones_like(ans), ans)
        ans = torch.where(torch.isnan(threshold) | torch.isnan(ans), torch.zeros_like(ans), ans)
        if step == 0:
            ans = torch.ones_like(ans)
        ans = torch.where(torch.isfinite(tot_norm), ans, torch.zeros_like(ans))
        self.num_clipped = self.num_clipped + (ans < 1.0).int()
        return ans

    @torch.no_grad()
    def step(self, lr: float) -> None:
        beta1, beta2 = self.betas
        period_t = self.size_update_period
        step = self.step_count
        grads = [self._grads(g) for g in self.groups]

        if self.clipping_scale is not None:
            # sum over tensors of |g|^2 weighted by the parameter's RMS^2
            # (scalar_lr_scale^2 for scalars), with the RMS before this step
            sumsq = sum((gr.reshape(len(g.params), -1).square().sum(dim=1)
                         * (self.scalar_lr_scale ** 2 if g.is_scalar else g.param_rms.square())).sum()
                        for g, gr in zip(self.groups, grads))
            clip = self._clipping(sumsq)
        else:
            clip = torch.ones_like(self.clip_scale)
        self.clip_scale = clip

        bc2 = 1.0 - beta2 ** (step + 1)
        is_rms_step = step % period_t == period_t - 1
        beta2_corr = beta2 ** period_t
        bc2_size = 1.0 - beta2_corr ** ((step + 1) // period_t)
        do_size_update = is_rms_step and step > 0
        for g, gr in zip(self.groups, grads):
            k = len(g.params)
            # clip == 0 zeroes the gradient, NaNs included (NaN * 0 is NaN)
            gr = torch.where(clip > 0.0, gr * clip, torch.zeros_like(gr))
            p32 = torch.stack([p.detach().float() for p in g.params])
            g.exp_avg_sq.mul_(beta2).addcmul_(gr, gr, value=1.0 - beta2)
            eas = g.exp_avg_sq / bc2 if bc2 < 0.99 else g.exp_avg_sq
            d = gr / (eas.sqrt() + self.eps)
            if g.lr_scale is not None:
                d = d * g.rows(g.lr_scale)
            if g.is_scalar:
                d = d * (-lr * self.scalar_lr_scale)
            else:
                d = d * -lr
                g.scale_grads[:, step % period_t] = (p32 * gr).reshape(k, -1).sum(dim=1)
                if is_rms_step:
                    g.param_rms = p32.reshape(k, -1).square().mean(dim=1).sqrt()
                d = d * g.rows(torch.clamp(g.param_rms, min=self.param_min_rms))
                if do_size_update:
                    # the learned size update (reference optim.py:196-239)
                    size_lr = lr * self.scalar_lr_scale
                    sg = g.scale_grads
                    seas = beta2_corr * g.scale_exp_avg_sq + (1.0 - beta2_corr) * sg.square().mean(dim=1)
                    scale_step = -size_lr * bc2_size ** 0.5 * sg.sum(dim=1) / (seas.sqrt() + self.eps)
                    if g.lr_scale is not None:
                        scale_step = scale_step * g.lr_scale
                    scale_step = torch.where(g.param_rms < self.param_min_rms,
                                             torch.zeros_like(scale_step), scale_step)
                    scale_step = torch.clamp(scale_step, -0.1, 0.1)
                    scale_step = torch.minimum(scale_step,
                                               (self.param_max_rms - g.param_rms) / g.param_rms)
                    d = d + p32 * g.rows(scale_step)
                    g.scale_exp_avg_sq = seas
            g.delta.mul_(beta1).add_(d, alpha=1.0 - beta1)
            new_p = p32 + g.delta
            if g.is_scalar:
                new_p = torch.clamp(new_p, -self.scalar_max, self.scalar_max)
            torch._foreach_copy_(g.params, list(new_p.to(g.params[0].dtype).unbind(0)))
        self.step_count += 1

    def state_dict(self) -> dict:
        """The state, by reference (the next step changes it): save it or
        copy it."""
        return {
            "step": self.step_count,
            "model_norms": self.model_norms,
            "model_norm_threshold": self.model_norm_threshold,
            "num_clipped": self.num_clipped,
            "clip_scale": self.clip_scale,
            "groups": [{"names": g.names, **{key: getattr(g, key) for key in _STATE_KEYS}}
                       for g in self.groups],
        }

    def named_param_rms(self) -> Dict[str, torch.Tensor]:
        """Each parameter's RMS as the clipping norm weights it (0 for
        scalars): its row of its shape group's `param_rms`, on the device."""
        return {n: g.param_rms[i] for g in self.groups for i, n in enumerate(g.names)}

    def load_state_dict(self, state: dict) -> None:
        """Restore a copy of `state_dict()` onto the same parameters (by
        name)."""
        mine = {tuple(g.names): g for g in self.groups}
        saved = {tuple(s["names"]): s for s in state["groups"]}
        if set(mine) != set(saved):
            raise KeyError("optimizer state does not hold these parameters")
        for names, g in mine.items():
            for key in _STATE_KEYS:
                value = saved[names][key]
                setattr(g, key, value.to(getattr(g, key).device, copy=True))
        dev = self.model_norms.device
        self.step_count = int(state["step"])
        for key in ("model_norms", "model_norm_threshold", "num_clipped", "clip_scale"):
            setattr(self, key, state[key].to(dev, copy=True))


# -------------------------------------------------- per-parameter lr scaling

_LIST_NAMES = ("blocks", "estimators", "discriminators", "convs", "band_convs")
_EMBEDDINGS = ("token_embed", "emb")  # flax `Embed`s: their `weight` is `embedding`


def jax_scope(name: str) -> Tuple[str, ...]:
    """The JAX package's scope path of a port module name, the inverse of
    `compat/from_jax.py`'s renaming: `estimators.0.blocks.3.dwconv` ->
    (`estimators_0`, `blocks_3`, `dwconv`); `band_convs.<b>.<i>` ->
    `band_convs_<b>_<i>`."""
    parts = name.split(".") if name else []
    out: List[str] = []
    i = 0
    while i < len(parts):
        part = parts[i]
        n = 2 if part == "band_convs" else 1
        if part in _LIST_NAMES and all(re.fullmatch(r"\d+", x) for x in parts[i + 1:i + 1 + n]):
            out.append("_".join(parts[i:i + 1 + n]))
            i += 1 + n
        else:
            out.append(part)
            i += 1
    return tuple(out)


def jax_path(name: str) -> Tuple[str, ...]:
    """The JAX package's parameter path of a port parameter name
    (`jax_scope`, and a Linear or Conv `weight` is flax's `kernel`, an
    Embedding's its `embedding`)."""
    out = jax_scope(name)
    if out[-1] == "weight":
        out = (*out[:-1], "embedding" if len(out) > 1 and out[-2] in _EMBEDDINGS else "kernel")
    return out


def make_lr_scales(named_params: Iterable[Tuple[str, torch.Tensor]],
                   rules: Optional[Mapping[str, float]] = None,
                   default: float = 1.0) -> Dict[str, float]:
    """Each parameter's lr multiplier from path-prefix rules in the JAX
    package's syntax (`make_lr_scale_tree`): a rule "estimators_0/blocks_0"
    matches every parameter under that prefix of its JAX path (`jax_path`),
    and rules compose by multiplication along the path. 0 freezes."""
    rules = rules or {}
    scales = {}
    for name, _ in named_params:
        parts = jax_path(name)
        scale = default
        for i in range(1, len(parts) + 1):
            prefix = "/".join(parts[:i])
            if prefix in rules:
                scale *= rules[prefix]
        scales[name] = scale
    return scales


def parse_lr_scale_rules(lr_scale_rules: Optional[str] = None,
                         freeze_modules: Optional[str] = None) -> Optional[Dict[str, float]]:
    """The trainers' flags as `make_lr_scales` rules: `lr_scale_rules`
    "prefix=scale,prefix=scale" (e.g. "cond_encoder=0.5,
    estimators_0/blocks_0=0.1"), `freeze_modules` a CSV of prefixes that get
    0. None when both are empty."""
    rules = {}
    for item in (lr_scale_rules or "").split(","):
        item = item.strip()
        if not item:
            continue
        prefix, sep, scale = item.partition("=")
        if not sep:
            raise ValueError(f"bad lr-scale rule {item!r}; want prefix=scale")
        rules[prefix.strip()] = float(scale)
    for prefix in (freeze_modules or "").split(","):
        prefix = prefix.strip()
        if prefix:
            rules[prefix] = 0.0
    return rules or None


# ----------------------------------------------------------------- schedules


def eden2_lr(base_lr: float, batch: float, lr_batches: float, warmup_batches: float = 500.0,
             warmup_start: float = 0.5) -> float:
    """Eden2: base * ((batch^2 + B^2) / B^2)^-0.5 * warmup (reference
    optim.py:904-951); the warmup rises linearly from `warmup_start`."""
    factor = ((batch**2 + lr_batches**2) / lr_batches**2) ** -0.5
    warmup = 1.0 if batch >= warmup_batches else (
        warmup_start + (1.0 - warmup_start) * (batch / warmup_batches))
    return base_lr * factor * warmup


def eden_lr(base_lr: float, batch: float, epoch: float, lr_batches: float, lr_epochs: float,
            warmup_batches: float = 500.0, warmup_start: float = 0.5) -> float:
    """Eden, epoch-aware (reference optim.py:842-901)."""
    factor = (((batch**2 + lr_batches**2) / lr_batches**2) ** -0.25
              * ((epoch**2 + lr_epochs**2) / lr_epochs**2) ** -0.25)
    warmup = 1.0 if batch >= warmup_batches else (
        warmup_start + (1.0 - warmup_start) * (batch / warmup_batches))
    return base_lr * factor * warmup


@dataclasses.dataclass
class LRScheduler:
    """Stateful batch/epoch scheduler wrapper (reference optim.py:743-840)."""

    lr_fn: Callable[..., float]
    batch: int = 0
    epoch: int = 0

    def step_batch(self, batch: Optional[int] = None):
        self.batch = batch if batch is not None else self.batch + 1

    def step_epoch(self, epoch: Optional[int] = None):
        self.epoch = epoch if epoch is not None else self.epoch + 1

    def get_lr(self) -> float:
        return float(self.lr_fn(batch=self.batch, epoch=self.epoch))

    def state_dict(self):
        return {"batch": self.batch, "epoch": self.epoch}

    def load_state_dict(self, d):
        self.batch = int(d["batch"])
        self.epoch = int(d["epoch"])


def make_eden2(base_lr: float, lr_batches: float, warmup_batches: float = 500.0,
               warmup_start: float = 0.5) -> LRScheduler:
    return LRScheduler(
        lr_fn=lambda batch, epoch: eden2_lr(base_lr, batch, lr_batches, warmup_batches, warmup_start)
    )


def make_eden(base_lr: float, lr_batches: float, lr_epochs: float,
              warmup_batches: float = 500.0, warmup_start: float = 0.5) -> LRScheduler:
    return LRScheduler(
        lr_fn=lambda batch, epoch: eden_lr(base_lr, batch, epoch, lr_batches, lr_epochs,
                                           warmup_batches, warmup_start)
    )


# ------------------------------------------------------------- Eve (baseline)


class Eve(torch.optim.Optimizer):
    """AdamW with target-rms-conditional weight decay, the reference's
    baseline optimizer, counterpart of the JAX package's `Eve`: the decay
    (not scaled by the lr) applies only while a non-scalar parameter's norm
    exceeds `target_rms * sqrt(numel)`. The moments are float32; the
    parameter moves by the float32 difference of its old and new values.
    Neither trainer uses it."""

    def __init__(self, params, lr: float = 1e-3, betas: Tuple[float, float] = (0.9, 0.98),
                 eps: float = 1e-8, weight_decay: float = 1e-3, target_rms: float = 0.1):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      target_rms=target_rms))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            beta1, beta2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p, dtype=torch.float32)
                    state["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                state["step"] += 1
                step = state["step"]
                g = p.grad.float()
                p32 = p.float()
                m, v = state["exp_avg"], state["exp_avg_sq"]
                m.mul_(beta1).add_(g, alpha=1.0 - beta1)
                v.mul_(beta2).addcmul_(g, g, value=1.0 - beta2)
                denom = v.sqrt() * (1.0 - beta2 ** step) ** -0.5 + group["eps"]
                new_p = p32
                if p.numel() > 1:
                    above = p32.norm() > group["target_rms"] * p.numel() ** 0.5
                    new_p = new_p * (1.0 - group["weight_decay"] * above.float())
                new_p = new_p - group["lr"] / (1.0 - beta1 ** step) * m / denom
                p.add_((new_p - p32).to(p.dtype))
        return loss


def dominant_parameters(named_grads: Iterable[Tuple[str, torch.Tensor]],
                        param_rms: Optional[Mapping[str, torch.Tensor]] = None,
                        top_n: int = 5) -> List[Tuple[str, float, float]]:
    """Rank parameters by their share of the RMS-weighted squared gradient
    norm, the reference's `show_dominant_parameters` and the JAX package's
    `dominant_parameters`: (name, share, grad rms), largest share first.

    `param_rms` (`ScaledAdam.named_param_rms`) weights each gradient as the
    clipping norm does; without it the raw gradients are ranked. A gradient
    holding non-finite values sorts first, by their count, with its share
    taken over its finite part and its rms reported as inf. The statistics
    are float64 on the gradients' device, fetched once."""
    names, rows = [], []
    for name, g in named_grads:
        g = g.float()
        w = g if param_rms is None else g * param_rms[name].float()
        w64 = w.double()
        finite = torch.isfinite(w64)
        g64 = g.double()
        names.append(name)
        rows.append(torch.stack([
            torch.where(finite, w64, torch.zeros_like(w64)).square().sum(),
            g64.square().mean() if g.numel() else g64.new_zeros(()),
            (~torch.isfinite(g)).sum().double()]))
    if not rows:
        return []
    stats = torch.stack(rows).tolist()
    tot = sum(s[0] for s in stats) or 1.0
    entries = [(n, sumsq, math.inf if n_bad else mean_sq ** 0.5, n_bad)
               for n, (sumsq, mean_sq, n_bad) in zip(names, stats)]
    entries.sort(key=lambda e: (-e[3], -e[1]))
    return [(n, s / tot, r) for n, s, r, _ in entries[:top_n]]
