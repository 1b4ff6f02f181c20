"""A frozen copy of the training recipe's optimizer and schedule, for the
reference: ScaledAdam (the Zipformer lineage's optimizer, copied from
flow2gan_tpu_torch/training/optim.py without the per-parameter lr scales,
which the benchmark does not use), the Eden2 schedule, and the per-step
seed rule of the trainer's random draws. A later change to the program's
optimizer is held against this copy."""

from __future__ import annotations

from typing import Iterable, List, Tuple

import torch


def eden2_lr(base_lr: float, batch: float, lr_batches: float, warmup_batches: float,
             warmup_start: float) -> float:
    factor = ((batch**2 + lr_batches**2) / lr_batches**2) ** -0.5
    warmup = 1.0 if batch >= warmup_batches else (
        warmup_start + (1.0 - warmup_start) * (batch / warmup_batches))
    return base_lr * factor * warmup


def step_seed(seed: int, batch_idx: int) -> int:
    """The seed of the generator of batch `batch_idx`'s draws."""
    return (seed * 1_000_003 + batch_idx) % 2**63


class ScaledAdam:
    """ScaledAdam over named parameters, stacked by shape; `step(lr)` reads
    each parameter's `.grad`."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]], clipping_scale: float,
                 betas=(0.9, 0.98), scalar_lr_scale=0.1, eps=1e-8, param_min_rms=1e-5,
                 param_max_rms=3.0, scalar_max=10.0, size_update_period=4,
                 clipping_update_period=100):
        self.clipping_scale, self.betas, self.scalar_lr_scale = clipping_scale, betas, scalar_lr_scale
        self.eps, self.param_min_rms, self.param_max_rms = eps, param_min_rms, param_max_rms
        self.scalar_max, self.period_t, self.period_c = (scalar_max, size_update_period,
                                                          clipping_update_period)
        by_shape = {}
        for name, p in named_params:
            by_shape.setdefault(tuple(p.shape), []).append((name, p))
        self.groups: List[dict] = []
        for items in by_shape.values():
            params = [p for _, p in items]
            with torch.no_grad():
                st = torch.stack([p.detach().float() for p in params])
                k = len(params)
                rms = (st.reshape(k, -1).square().mean(1).sqrt() if params[0].numel() > 1
                       else torch.zeros(k, device=st.device))
            self.groups.append(dict(params=params, eas=torch.zeros_like(st),
                                    delta=torch.zeros_like(st), rms=rms,
                                    sg=torch.zeros(k, self.period_t, device=st.device),
                                    seas=torch.zeros(k, device=st.device)))
        dev = self.groups[0]["params"][0].device
        self.step_count = 0
        self.model_norms = torch.zeros(self.period_c, device=dev)
        self.threshold = torch.tensor(float("inf"), device=dev)

    def _clip(self, sumsq):
        step, period = self.step_count, self.period_c
        tot = sumsq.sqrt()
        if step >= 1:
            self.model_norms[step % period] = tot
        recal = [s for s in (10, 20, 40) if s < period and step == s]
        if recal or (step % period == 0 and step > 0):
            srt = torch.sort(self.model_norms).values

            def median_of_last(n):
                return srt[period - n + min(n - 1, (n // 4) * 2)]

            if recal:
                self.threshold = 2.0 * self.clipping_scale * median_of_last(step)
            if step % period == 0 and step > 0:
                self.threshold = self.clipping_scale * median_of_last(period)
        ans = torch.clamp(self.threshold / (tot + 1e-20), max=1.0)
        ans = torch.where(torch.isposinf(self.threshold), torch.ones_like(ans), ans)
        ans = torch.where(torch.isnan(self.threshold) | torch.isnan(ans), torch.zeros_like(ans), ans)
        if step == 0:
            ans = torch.ones_like(ans)
        return torch.where(torch.isfinite(tot), ans, torch.zeros_like(ans))

    @torch.no_grad()
    def step(self, lr: float) -> None:
        beta1, beta2 = self.betas
        pt, step = self.period_t, self.step_count
        grads = [torch.stack([torch.zeros_like(p) if p.grad is None else p.grad.float()
                              for p in g["params"]]) for g in self.groups]

        def scalar(g):
            return g["params"][0].numel() == 1

        sumsq = sum((gr.reshape(len(g["params"]), -1).square().sum(1)
                     * (self.scalar_lr_scale ** 2 if scalar(g) else g["rms"].square())).sum()
                    for g, gr in zip(self.groups, grads))
        clip = self._clip(sumsq)
        bc2 = 1.0 - beta2 ** (step + 1)
        is_rms_step = step % pt == pt - 1
        beta2_corr = beta2 ** pt
        bc2_size = 1.0 - beta2_corr ** ((step + 1) // pt)
        for g, gr in zip(self.groups, grads):
            k = len(g["params"])
            rows = (k,) + (1,) * g["params"][0].dim()
            gr = torch.where(clip > 0.0, gr * clip, torch.zeros_like(gr))
            p32 = torch.stack([p.detach().float() for p in g["params"]])
            g["eas"].mul_(beta2).addcmul_(gr, gr, value=1.0 - beta2)
            eas = g["eas"] / bc2 if bc2 < 0.99 else g["eas"]
            d = gr / (eas.sqrt() + self.eps)
            if scalar(g):
                d = d * (-lr * self.scalar_lr_scale)
            else:
                d = d * -lr
                g["sg"][:, step % pt] = (p32 * gr).reshape(k, -1).sum(1)
                if is_rms_step:
                    g["rms"] = p32.reshape(k, -1).square().mean(1).sqrt()
                d = d * torch.clamp(g["rms"], min=self.param_min_rms).reshape(rows)
                if is_rms_step and step > 0:
                    sg = g["sg"]
                    seas = beta2_corr * g["seas"] + (1.0 - beta2_corr) * sg.square().mean(1)
                    ss = (-lr * self.scalar_lr_scale * bc2_size ** 0.5 * sg.sum(1)
                          / (seas.sqrt() + self.eps))
                    ss = torch.where(g["rms"] < self.param_min_rms, torch.zeros_like(ss), ss)
                    ss = torch.minimum(torch.clamp(ss, -0.1, 0.1),
                                       (self.param_max_rms - g["rms"]) / g["rms"])
                    d = d + p32 * ss.reshape(rows)
                    g["seas"] = seas
            g["delta"].mul_(beta1).add_(d, alpha=1.0 - beta1)
            new = p32 + g["delta"]
            if scalar(g):
                new = torch.clamp(new, -self.scalar_max, self.scalar_max)
            for p, v in zip(g["params"], new.unbind(0)):
                p.copy_(v)
        self.step_count += 1
