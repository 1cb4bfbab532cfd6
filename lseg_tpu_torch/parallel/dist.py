"""Data-parallel process groups (torch port of `lseg_tpu/parallel/mesh.py`).

The JAX package shards the batch over a `data` mesh axis and lets XLA
insert the collectives. The port runs one process per GPU (the
reference's `accelerator="ddp"`, `sync_batchnorm=True`, utils.py:20-34)
and names each collective:

- `init_distributed` joins the processes (torchrun's `RANK`,
  `WORLD_SIZE`, `LOCAL_RANK`, `MASTER_ADDR` / `MASTER_PORT`, or explicit
  arguments); `create_mesh` returns the data group. A `group` of `None`
  everywhere in the port means one process and no collective at all;
- `rank_rows` / `batch_shard`: the rows of a global batch that a rank
  owns (`batch_sharding`). With gradient accumulation, rank r owns its
  `m / W` rows of each global micro-batch of `m` rows, so that the local
  micro-batches of all ranks together are the global ones;
- `broadcast_module`: rank 0's parameters and buffers on every rank
  (`replicated` / `shard_state` for data parallelism);
- `all_gather_rows`, `all_reduce_sum` (differentiable: its backward sums
  the gradients across the ranks, as JAX's global view does) and
  `all_reduce_` (in place, bucketed; gradients and metric sums);
- `sync_batchnorm_`: the BatchNorms of a model take their batch
  statistics over the group (`models.layers.BatchNorm`).

Routes. NCCL runs every collective on CUDA tensors. PyTorch's backend
table lists only broadcast, all_reduce and barrier for gloo on CUDA
tensors, but gloo in torch 2.11 on an H100 also ran all_gather,
all_gather_into_tensor, reduce_scatter_tensor and all_to_all_single on
them, so no helper stages a tensor through host memory: each runs one
collective on the tensor where it lies, under either backend (phase 10
of `chip_smoke.py` gathers CUDA tensors over gloo). Tensor parallelism
(`n_model > 1`, the JAX package's `_TP_RULES`) is not ported.
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, List, Optional

import torch
import torch.distributed as dist
from torch import nn

BUCKET_BYTES = 64 << 20


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None):
    """Join the process group; returns it, or None for one process.

    Arguments left out are read from torchrun's environment (`WORLD_SIZE`,
    `RANK`, `MASTER_ADDR` and `MASTER_PORT`). With neither a coordinator
    nor more than one process this is a no-op, as `mesh.py`'s is. The
    coordinator is `host:port` (TCP) or an init URL (`tcp://...`,
    `file://...`). Where there is a card, the rank's device becomes
    `cuda:LOCAL_RANK`, or LOCAL_RANK modulo the cards where the ranks of
    a host outnumber them. `backend` defaults to NCCL where every local
    rank has a card of its own, else to gloo (the CPU, or ranks that
    share a card: rank 0 then warns on stderr, as gloo carries CUDA
    tensors through host memory, many times slower than NCCL)."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator is None and (num_processes or 1) == 1:
        return None
    if dist.is_initialized():
        return dist.group.WORLD
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    process_id = process_id or 0
    local_rank = int(env.get("LOCAL_RANK", process_id))
    local_size = int(env.get("LOCAL_WORLD_SIZE", num_processes or 1))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards:
        torch.cuda.set_device(local_rank % cards)
    if backend is None:
        backend = "nccl" if cards >= local_size else "gloo"
        if cards and backend == "gloo" and process_id == 0:
            print(f"warning: {local_size} ranks on this host share "
                  f"{cards} card(s), so they run over gloo through host "
                  f"memory, many times slower than NCCL with a card a "
                  f"rank",
                  file=sys.stderr, flush=True)
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)
    return dist.group.WORLD


def create_mesh(n_data: Optional[int] = None, n_model: int = 1):
    """The data group of `n_data` ranks (all of them by default), or None
    for one process. Tensor parallelism is not ported."""
    if n_model > 1:
        raise NotImplementedError(
            "tensor parallelism (n_model > 1) is not ported: ROADMAP A10b")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is not None and n_data != world:
        raise ValueError(f"n_data {n_data} must equal the number of "
                         f"processes {world}")
    return dist.group.WORLD if dist.is_initialized() else None


def collective_device(group) -> torch.device:
    """Where a tensor of host values goes for a collective: the current
    card under NCCL, else the CPU."""
    if group is not None and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def rank_rows(n: int, rank: int, world: int, accumulate: int = 1
              ) -> torch.Tensor:
    """Indices of the rows of a global batch of `n` that `rank` of
    `world` owns: its `m / world` rows of each global micro-batch of
    `m = n / accumulate` rows, micro-batch by micro-batch (with one
    micro-batch, the contiguous block `batch_sharding` gives it)."""
    if n % (accumulate * world):
        raise ValueError(f"batch {n} must divide into {accumulate} "
                         f"micro-batches over {world} ranks")
    m = n // accumulate
    per = m // world
    return torch.cat([torch.arange(i * m + rank * per, i * m + (rank + 1)
                                   * per) for i in range(accumulate)])


def batch_shard(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous block of the rows of the global batch `x`;
    `x` itself for one process."""
    w = size(group)
    if w == 1:
        return x
    n = x.shape[0]
    if n % w:
        raise ValueError(f"batch {n} must divide the data group size {w}")
    per = n // w
    return x[rank(group) * per:(rank(group) + 1) * per]


def barrier(group) -> None:
    if size(group) > 1:
        dist.barrier(group=group)


@torch.no_grad()
def broadcast_module(module: nn.Module, group) -> nn.Module:
    """Every parameter and buffer of `module` from rank 0."""
    if size(group) > 1:
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, 0, group=group)
    return module


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The ranks' `x` (equal shapes) concatenated along dim 0 in rank
    order; `x` for one process. Not differentiable."""
    w = size(group)
    if w == 1:
        return x
    src = x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(w)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its backward is the same sum of the
    incoming gradients (`torch.distributed.nn.functional.all_reduce`,
    which PyTorch 2.13 deprecates, computes the same)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of `x` over the ranks; `x` for one process."""
    if size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


@torch.no_grad()
def all_reduce_(tensors: Iterable[torch.Tensor], group) -> None:
    """Sum each tensor over the ranks, in place: tensors of one dtype and
    device are flattened into buckets of up to BUCKET_BYTES, one
    all_reduce each."""
    if size(group) == 1:
        return
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.dtype, t.device), []).append(t)
    for ts in groups.values():
        buckets: List[List[torch.Tensor]] = [[]]
        nbytes = 0
        for t in ts:
            b = t.numel() * t.element_size()
            if buckets[-1] and nbytes + b > BUCKET_BYTES:
                buckets.append([])
                nbytes = 0
            buckets[-1].append(t)
            nbytes += b
        for bucket in buckets:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            dist.all_reduce(flat, group=group)
            offset = 0
            for t in bucket:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()


def sync_batchnorm_(module: nn.Module, group) -> nn.Module:
    """Make every `models.layers.BatchNorm` of `module` take its
    train-mode statistics over `group` (None: its own batch)."""
    from lseg_tpu_torch.models.layers import BatchNorm

    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.group = group
    return module
