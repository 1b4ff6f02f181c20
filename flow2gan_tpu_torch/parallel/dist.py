"""Multi-process data parallelism over `torch.distributed`, counterpart of
`flow2gan_tpu/parallel/mesh.py`.

The JAX package jits each step over a mesh with the batch sharded on a
"data" axis, so one program sees the global batch and XLA inserts the
gradient all-reduce. The port runs one process per card (torchrun's
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR`, `MASTER_PORT`), each on
its share of the global batch, and reproduces that program explicitly:

- every rank draws the step's randomness for the global batch from the same
  generator and takes its own rows (`Shard`);
- each rank's loss is its part of the global loss (a masked sum over the
  all-reduced global count, or its mean over the world size), so the
  gradients are summed over the ranks (`all_reduce_sum_`) after backward,
  and only those of the side the step moves;
- every rank then applies the same optimizer step to the same parameters,
  which stay bitwise equal (`assert_replicas_equal` checks it at the start).

Not the `DistributedDataParallel` wrapper: its reducer is set up in
`forward()`, and the GAN steps run `rollout` and ask backward for one side's
gradients only. With one process every helper here is a no-op.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Sequence, Union

import torch
import torch.distributed as dist

from flow2gan_tpu_torch import tracing


class Shard(NamedTuple):
    """This process's rows of a global batch: rows [index * n, (index + 1) *
    n) of `count * n`, in rank order, as JAX assembles a global array from
    the processes' local batches."""

    index: int = 0
    count: int = 1

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This shard's rows of a global-batch tensor (dim 0)."""
        if self.count == 1:
            return x
        n = x.shape[0] // self.count
        return x[self.index * n:(self.index + 1) * n]


def env_world_size() -> int:
    """The world size torchrun's environment announces (1 without it)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def shard() -> Shard:
    return Shard(rank(), world_size())


def init_distributed(device: Union[str, torch.device]) -> torch.device:
    """Join the process group torchrun describes and return this rank's
    device; a single process (no `WORLD_SIZE` > 1) does nothing.

    On the card each rank takes card `LOCAL_RANK` over NCCL. NCCL refuses two
    ranks on one card, so when the caller names a card (`cuda:0`) every rank
    sits on it and the ranks talk over gloo. On the CPU, gloo. A group that
    the caller has already initialised is used as it is. A rank never moves
    to the CPU: a card that is missing raises.
    """
    device = torch.device(device)
    world = env_world_size()
    if world <= 1 and not dist.is_initialized():
        return device
    local_rank = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0")))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --device cpu to train on the CPU")
        if device.index is None:
            if local_rank >= torch.cuda.device_count():
                raise RuntimeError(
                    f"local rank {local_rank} has no card of its own ({torch.cuda.device_count()} "
                    "visible); name one card (--device cuda:0) to put every rank on it")
            device = torch.device("cuda", local_rank)
            backend = "nccl"
        else:
            backend = "gloo"
        torch.cuda.set_device(device)
    else:
        backend = "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://", rank=int(os.environ["RANK"]),
                                world_size=world)
    return device


def describe(device: torch.device) -> str:
    """"rank r of n: backend b, device d" for the log."""
    backend = dist.get_backend() if dist.is_initialized() else "none"
    return f"rank {rank()} of {world_size()}: backend {backend}, device {device}"


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


BUCKET_BYTES = 64 << 20


def all_reduce_sum_(tensors: Sequence[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place: the tensors are packed into
    flat buckets of one dtype (at most `BUCKET_BYTES` each, a tensor larger
    than that alone), one all-reduce per bucket. A no-op without a process
    group (a group of one rank still runs its collectives)."""
    if not dist.is_initialized() or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault((t.dtype, t.device), []).append(t)
    for group in by_dtype.values():
        bucket: List[torch.Tensor] = []
        size = 0
        for t in group + [None]:
            if t is None or (bucket and size + t.numel() * t.element_size() > BUCKET_BYTES):
                flat = torch.cat([b.reshape(-1) for b in bucket])
                with tracing.span("dist.all_reduce", device=flat.device):
                    dist.all_reduce(flat)
                tracing.count("collectives")
                tracing.count("collective_bytes", flat.numel() * flat.element_size())
                for b, part in zip(bucket, flat.split([b.numel() for b in bucket])):
                    b.copy_(part.view_as(b))
                bucket, size = [], 0
            if t is not None:
                bucket.append(t)
                size += t.numel() * t.element_size()


def all_reduce_grads_(params: Sequence[torch.Tensor], extra: Sequence[torch.Tensor] = ()) -> None:
    """Sum the gradients of `params` (a missing one counts as zero) and the
    tensors of `extra` over the ranks, in one pass of buckets."""
    if not dist.is_initialized():
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_sum_([p.grad for p in params] + list(extra))


@torch.no_grad()
def assert_replicas_equal(tensors: Sequence[torch.Tensor], what: str = "parameters") -> None:
    """Raise on every rank unless each tensor equals rank 0's bit for bit:
    the trainers draw their initial weights from `--seed` on every rank."""
    if world_size() == 1:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    differ = torch.tensor([float(not torch.equal(flat, ref))], device=flat.device)
    dist.all_reduce(differ)
    if differ.item():
        raise RuntimeError(f"the ranks start from different {what}: "
                           f"{int(differ.item())} of {world_size()} differ from rank 0's")
