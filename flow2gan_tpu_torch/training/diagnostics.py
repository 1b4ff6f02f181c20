"""Activation, parameter and gradient diagnostics for `--print-diagnostics`,
counterpart of `flow2gan_tpu/training/diagnostics.py` (the reference's
TensorDiagnostic tables), with the same report lines.

For every dimension of every tagged tensor the tables accumulate the abs,
positive, value, rms, max and min element statistics, an 11-point summary of
the per-position rms ("rms-sort"), the centered rms ("stddev") and, for a
dimension of size <= 512, the Gram matrix, whose eigen-spectrum is printed
(the collapse and explosion signal of the Zipformer lineage). The
accumulators are float64 tensors on the tagged tensor's device; only the
report fetches them.

The tables are filled by hooks, which are removed when the pass that needs
them ends, so the model's graph is untouched:

- `outputs(model)`: a forward hook on every module tags its output under the
  module's dotted path (`<root>` for the model itself; the k-th call of a
  module in one pass, k >= 1, as `path[k]`);
- `output_grads(model)`: the forward hooks register a tensor hook on each
  output, which tags dLoss/d(output) as `{module}.grad` in backward (a
  module's full backward hook would wrap its outputs, and the limiter's
  autograd Function and the fused iSTFT's inside it); with `scalars`, the
  PReLU outputs and their gradients are kept for `collect_scalar_diagnostics`;
- `collect_params`: parameters (`param/<name>`) and their gradients
  (`param/<name>.param_grad`).

One backward of the train-form loss under `output_grads` fills both
gradient tables. `jax_table_name` maps a table's name to the JAX package's.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from flow2gan_tpu_torch.models.norms import PReLU
from flow2gan_tpu_torch.training.hooks import ROOT, module_name
from flow2gan_tpu_torch.training.optim import jax_path, jax_scope

MAX_EIG_DIM = 512  # the reference's TensorDiagnosticOptions.max_eig_dim


def _dim_is_summarized(size: int) -> bool:
    """Small dims print their raw values (the reference's rule)."""
    return size > 10 and size != 31


def _percentile_str(values: np.ndarray, num: int = 10) -> str:
    """11 order statistics, as the reference prints them."""
    v = np.sort(values.ravel())
    n = v.size
    pts = [v[(i * (n - 1)) // num] for i in range(num + 1)]
    return "[" + " ".join("%.2g" % p for p in pts) + "]"


class DimStats:
    """Accumulators for one (tensor, dim) pair, float64 on the tensor's
    device."""

    def __init__(self, size: int, with_eigs: bool, device: torch.device):
        self.size = size
        self.count = 0  # positions summed per element
        z = lambda *shape: torch.zeros(shape, dtype=torch.float64, device=device)
        self.sum_abs, self.sum_val, self.sum_sq, self.sum_pos = z(size), z(size), z(size), z(size)
        self.max_v = torch.full((size,), -np.inf, dtype=torch.float64, device=device)
        self.min_v = torch.full((size,), np.inf, dtype=torch.float64, device=device)
        self.rms_sort = z(11)
        self.rms_sort_count = 0
        self.gram = z(size, size) if with_eigs else None
        self.eigs: Optional[np.ndarray] = None  # sqrt |eigenvalues| of gram / count, once asked
        self.variable = False  # the dim's size changed across batches

    @torch.no_grad()
    def update(self, x: torch.Tensor, dim: int) -> None:
        if x.shape[dim] != self.size:
            # a ragged dim across batches: keep what was accumulated (the
            # trainers use fixed crops)
            self.variable = True
            return
        m = x.float().movedim(dim, -1).reshape(-1, self.size)
        m64 = m.double()
        self.count += m.shape[0]
        self.sum_abs += m64.abs().sum(dim=0)
        self.sum_val += m64.sum(dim=0)
        self.sum_sq += m64.square().sum(dim=0)
        self.sum_pos += (m > 0).sum(dim=0).double()
        self.max_v = torch.maximum(self.max_v, m64.amax(dim=0))
        self.min_v = torch.minimum(self.min_v, m64.amin(dim=0))
        # the rms over this dim at each position, its 11 order statistics,
        # averaged over the updates
        rms = m64.square().mean(dim=1).sqrt().sort().values
        n = rms.numel()
        idx = torch.clamp(torch.arange(11, device=rms.device) * n // 10, max=n - 1)
        self.rms_sort += rms[idx]
        self.rms_sort_count += 1
        if self.gram is not None:
            self.gram += m64.T @ m64

    def report_lines(self, name: str, dim: int) -> List[str]:
        if self.count == 0:
            return []
        cnt = self.count
        host = lambda t: t.cpu().numpy()
        sum_sq, sum_val = host(self.sum_sq), host(self.sum_val)
        kinds = {
            "abs": host(self.sum_abs) / cnt,
            "positive": host(self.sum_pos) / cnt,
            "value": sum_val / cnt,
            "rms": np.sqrt(sum_sq / cnt),
            "stddev": np.sqrt(np.maximum(sum_sq / cnt - (sum_val / cnt) ** 2, 0.0)),
            "max": host(self.max_v),
            "min": host(self.min_v),
        }
        if self.gram is not None:
            if self.eigs is None:
                _eigenvalues([self])
            if self.eigs is not None:
                kinds["eigs"] = self.eigs
        lines = []
        for kind, stats in kinds.items():
            if _dim_is_summarized(stats.size):
                body = f"percentiles: {_percentile_str(stats)}"
            else:
                body = "[" + " ".join("%.2g" % v for v in stats) + "]"
            if kind in ("value", "rms", "stddev", "eigs"):
                body += f", norm={np.sqrt((stats ** 2).sum()):.2g}"
            body += f", mean={stats.mean():.3g}, rms={np.sqrt((stats ** 2).mean()):.3g}"
            lines.append(f"module={name}, dim={dim}, size={self.size}, {kind} {body}")
        if self.rms_sort_count:
            rs = host(self.rms_sort) / self.rms_sort_count
            lines.append(
                f"module={name}, dim={dim}, size={self.size}, rms-sort "
                "[" + " ".join("%.2g" % v for v in rs) + "]"
                f", mean={rs.mean():.3g}, rms={np.sqrt((rs ** 2).mean()):.3g}"
            )
        return lines


def _eigenvalues(dims: List[DimStats], chunk: int = 64) -> None:
    """Fill `eigs` (the eigen-spectrum's magnitudes) of each DimStats with a
    Gram matrix, batched by size on the Gram's device: at full width there
    are hundreds of them, up to 512 x 512. A batch that fails to converge
    (a non-finite Gram) is done one by one, and a failing one prints no
    eigs, as in the JAX package."""
    groups: Dict[Tuple[int, torch.device], List[DimStats]] = {}
    for d in dims:
        if d.gram is not None and d.count and d.eigs is None:
            groups.setdefault((d.size, d.gram.device), []).append(d)
    for group in groups.values():
        for i in range(0, len(group), chunk):
            part = group[i:i + chunk]
            try:
                eigs = torch.linalg.eigvalsh(torch.stack([d.gram / d.count for d in part]))
            except torch.linalg.LinAlgError:
                if len(part) > 1:
                    for d in part:
                        _eigenvalues([d])
                continue
            for d, e in zip(part, eigs.abs().sqrt().cpu().numpy()):
                d.eigs = e


class TensorStats:
    """The statistics of one tagged tensor over the batches: a whole-tensor
    summary and the per-dimension `DimStats`."""

    def __init__(self, max_eig_dim: int = MAX_EIG_DIM):
        self.max_eig_dim = max_eig_dim
        self.count = 0
        self.n = 0
        self.totals: Optional[torch.Tensor] = None  # sum |x|, sum x^2, max |x|, positives
        self.dims: Dict[int, DimStats] = {}

    @torch.no_grad()
    def update(self, x) -> None:
        x = torch.as_tensor(x).detach().float()
        x64 = x.double()
        totals = torch.stack([x64.abs().sum(), x64.square().sum(),
                              x64.abs().amax() if x.numel() else x64.new_zeros(()),
                              (x > 0).sum().double()])
        if self.totals is None:
            self.totals = totals
        else:
            self.totals = torch.cat([self.totals[:2] + totals[:2],
                                     torch.maximum(self.totals[2:3], totals[2:3]),
                                     self.totals[3:] + totals[3:]])
        self.count += 1
        self.n += x.numel()
        for d in range(x.ndim):
            if d not in self.dims:
                self.dims[d] = DimStats(x.shape[d], x.shape[d] <= self.max_eig_dim, x.device)
            self.dims[d].update(x, d)

    def summary(self) -> str:
        if self.n == 0:
            return "empty"
        sum_abs, sum_sq, max_abs, pos = self.totals.tolist()
        return (f"abs-mean={sum_abs / self.n:.3g} rms={(sum_sq / self.n) ** 0.5:.3g} "
                f"max-abs={max_abs:.3g} pos-frac={pos / self.n:.2f}")

    def report_lines(self, name: str) -> List[str]:
        return [line for d in sorted(self.dims) for line in self.dims[d].report_lines(name, d)]


class DiagnosticsCollector:
    """Module-output, parameter and gradient statistics over several
    batches, by table name."""

    def __init__(self):
        self.stats: Dict[str, TensorStats] = {}

    def tag(self, name: str, x: torch.Tensor) -> None:
        self.stats.setdefault(name, TensorStats()).update(x)

    def collect_params(self, named: Iterable[Tuple[str, torch.Tensor]], prefix: str = "param/",
                       suffix: str = "") -> None:
        """Tag each (name, tensor) as `{prefix}{name}{suffix}`: parameters,
        or their gradients with suffix ".param_grad" (a None gradient is
        skipped)."""
        for name, t in named:
            if t is not None:
                self.tag(prefix + name + suffix, t)

    @contextlib.contextmanager
    def outputs(self, model: nn.Module) -> Iterator[None]:
        """Tag every module output of the passes run inside."""
        with _output_hooks(model, lambda name, module, out: self.tag(name, out)):
            yield

    @contextlib.contextmanager
    def output_grads(self, model: nn.Module, scalars: Optional[Tuple[dict, dict]] = None
                     ) -> Iterator[None]:
        """Tag dLoss/d(output) of every module output that needs a gradient,
        as `{module}.grad`, in the backward of the passes run inside.
        `scalars` = (values, grads): dicts that receive each PReLU's output
        and its gradient, by table name."""

        def on_output(name, module, out):
            if not out.requires_grad:
                return
            keep = scalars is not None and isinstance(module, PReLU)
            if keep:
                scalars[0][name] = out.detach()

            def on_grad(g, name=name, keep=keep):
                self.tag(name + ".grad", g)
                if keep:
                    scalars[1][name] = g.detach()

            out.register_hook(on_grad)

        with _output_hooks(model, on_output):
            yield

    def print_diagnostics(self, log=logging.info) -> None:
        _eigenvalues([d for st in self.stats.values() for d in st.dims.values()])
        for name in sorted(self.stats):
            log(f"Diagnostics [{name}]: {self.stats[name].summary()}")
            for line in self.stats[name].report_lines(name):
                log(line)


@contextlib.contextmanager
def _output_hooks(model: nn.Module, fn) -> Iterator[None]:
    """A forward hook on every module of `model` that calls fn(table name,
    module, output) for each floating tensor output; removed on exit."""
    calls: Dict[str, int] = {}

    def hook(path):
        def on_forward(module, args, output):
            if not (isinstance(output, torch.Tensor) and output.is_floating_point()):
                return
            k = calls.get(path, 0)
            calls[path] = k + 1
            fn(path if k == 0 else f"{path}[{k}]", module, output)
        return on_forward

    handles = [m.register_forward_hook(hook(module_name(n))) for n, m in model.named_modules()]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def jax_table_name(name: str) -> Optional[str]:
    """The JAX package's name of a port table: `param/<path>[.param_grad]`
    by `jax_path`, a module output by its scope and `__call__/<k>`, a
    gradient `{scope}.grad`. None for the output gradient of a module's
    second or later call, which JAX sums into the first's."""
    if name.startswith("param/"):
        suffix = ".param_grad" if name.endswith(".param_grad") else ""
        return "param/" + "/".join(jax_path(name[len("param/"):len(name) - len(suffix)])) + suffix
    grad = name.endswith(".grad")
    base = name[:-len(".grad")] if grad else name
    path, _, index = base.partition("[")
    k = int(index.rstrip("]")) if index else 0
    if grad:
        if k:
            return None
        return ROOT + ".grad" if path == ROOT else "/".join(jax_scope(path)) + ".grad"
    scope = "" if path == ROOT else "/".join(jax_scope(path))
    return f"{scope}/__call__/{k}".lstrip("/")


class ScalarDiagnostic:
    """Activation value against gradient histogram of one nonlinearity, in
    20 bins over ±the first batch's abs-max; later batches fill the same
    bins (the reference's ScalarDiagnostic)."""

    N_BINS = 20

    def __init__(self):
        self.limit: Optional[float] = None
        self.counts = self.grad_abs = self.grad_sum = None

    @torch.no_grad()
    def update(self, value, grad) -> None:
        v = torch.as_tensor(value).float().reshape(-1)
        g = torch.as_tensor(grad).float().reshape(-1)
        if self.limit is None:
            self.limit = float(v.abs().nan_to_num(0.0, 0.0, 0.0).amax()) if v.numel() else 0.0
            self.limit = self.limit or 1.0
            z = lambda dtype: torch.zeros(self.N_BINS, dtype=dtype, device=v.device)
            self.counts, self.grad_abs, self.grad_sum = z(torch.int64), z(torch.float64), z(torch.float64)
        finite = torch.isfinite(v)  # a non-finite value falls in no bin
        v, g = v[finite], g[finite]
        limit = torch.tensor(self.limit, dtype=torch.float32, device=v.device)
        idx = torch.clamp(((v / limit) * 0.5 + 0.5) * self.N_BINS, 0, self.N_BINS - 1).long()
        n = self.N_BINS
        self.counts += torch.bincount(idx, minlength=n)
        self.grad_abs += torch.bincount(idx, weights=g.abs().double(), minlength=n)
        self.grad_sum += torch.bincount(idx, weights=g.double(), minlength=n)

    def summary(self) -> str:
        if self.limit is None:
            return "empty"
        counts, grad_abs = self.counts.cpu().numpy(), self.grad_abs.cpu().numpy()
        if counts.sum() == 0:
            return "empty"
        occ = counts / counts.sum()
        mean_abs_grad = grad_abs / np.maximum(counts, 1)
        top = np.argsort(-occ)[:4]
        edges = np.linspace(-self.limit, self.limit, self.N_BINS + 1)
        cells = ", ".join(f"[{edges[i]:.2g},{edges[i+1]:.2g}): occ={occ[i]:.2f} "
                          f"|g|={mean_abs_grad[i]:.3g}" for i in sorted(top))
        return f"range=±{self.limit:.3g} top-bins: {cells}"


def collect_scalar_diagnostics(stats: Dict[str, ScalarDiagnostic], values: Dict[str, torch.Tensor],
                               grads: Dict[str, torch.Tensor]) -> None:
    """Pair the nonlinearity outputs with their gradients by name (the
    `scalars` dicts of `DiagnosticsCollector.output_grads`) and update
    `stats` in place."""
    for name, v in values.items():
        g = grads.get(name)
        if g is not None and v.shape == g.shape:
            stats.setdefault(name, ScalarDiagnostic()).update(v, g)


def print_scalar_diagnostics(stats: Dict[str, ScalarDiagnostic], log=logging.info) -> None:
    for name in sorted(stats):
        log(f"ScalarDiagnostics [{name}]: {stats[name].summary()}")
