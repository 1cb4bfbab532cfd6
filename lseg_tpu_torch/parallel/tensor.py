"""Tensor parallelism over the model group of a `dist.Mesh` (torch port
of `lseg_tpu/parallel/mesh.py`'s `_TP_RULES`, `param_shardings` and
`shard_state`).

The JAX package shards the float ViT blocks and the CLIP text blocks over
its `model` mesh axis and lets GSPMD insert the collectives. The port
names them, in Megatron's layout:

- `copy_to_model`: identity forward, sum over the model group backward;
  it takes the input of each attention or MLP half;
- `reduce_from_model`: sum over the model group forward, identity
  backward; it takes the row-parallel layer's partial product, whose bias
  is added once, after the sum (`row_parallel`);
- column-parallel layers (`qkv`, `fc1`, `in_proj`, `c_fc`) keep the rows
  of their (out, in) weight and bias that give this rank's outputs: for
  `qkv` and `in_proj` the rank's heads [m H/n, (m+1) H/n) within each of
  q, k and v of the (3, H, hd) column order, so attention is head-local;
- row-parallel layers (`proj`, `fc2`, `out_proj`, `c_proj`) keep the
  matching input columns of their weight; their bias stays whole.

The JAX package's flat-layout rule cuts qkv's 3D output columns into n
contiguous ranges (rank 0 would hold all of q for n = 2) and GSPMD
re-lays them out around the head reshape; the port cuts by heads in
both layouts, which computes the same function. Int8 layers
(`StaticQuantDense`, `QuantDense`) stay whole, as the JAX rules match
`kernel` leaves only, and everything else (patch embedding, LayerNorms,
the decoder, BatchNorm, the heads) is replicated: the ranks of a model
group compute it redundantly on the same rows.

`shard_module_` slices a full model in place, `gather_module` rebuilds
the full `state_dict` on every rank (`gather_grads` the gradients), `param_shardings` reports each
parameter's split as the JAX package's specs do, over the port's
(out, in) weight layout.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from lseg_tpu_torch.parallel.dist import Mesh, broadcast_, model_group, size

# how each sharded parameter is cut: "heads" (column-parallel, the rank's
# heads of each of q, k, v), "rows" (column-parallel, a contiguous range
# of outputs), "cols" (row-parallel, a contiguous range of inputs)
_SPLITS = {"heads": ("model", None), "rows": ("model", None),
           "cols": (None, "model")}


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group, taken in fp32 and returned in
    `x`'s dtype."""
    out = x.float().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, group=group)
    return out.to(x.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """`x` itself; its gradient summed over the model group."""
    return x if size(group) == 1 else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' `x` over the model group; the gradient
    passes through unchanged."""
    return x if size(group) == 1 else _ReduceFromModel.apply(x, group)


def row_parallel(dense: nn.Module, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel `models.layers.Dense` on this rank's input columns:
    the partial products summed over the group, then the bias, once, with
    the rounding points of `Dense.forward`; `dense(x)` itself (a float or
    an int8 layer) without a model group."""
    if size(group) == 1:
        return dense(x)
    dt = dense.dtype
    y = reduce_from_model(F.linear(x.to(dt), dense.weight.to(dt)), group)
    return y + dense.bias.to(dt)


def _head_rows(width: int, n: int, m: int) -> torch.Tensor:
    """Rows of a fused (3 * width)-output projection holding rank m's
    heads of each of q, k and v."""
    per = width // n
    return torch.cat([torch.arange(c * width + m * per,
                                   c * width + (m + 1) * per)
                      for c in range(3)])


@torch.no_grad()
def _cut(param: nn.Parameter, kind: str, n: int, m: int) -> None:
    """Keep this rank's part of `param` in place (same Parameter)."""
    t = param.data
    if kind == "heads":
        idx = _head_rows(t.shape[0] // 3, n, m).to(t.device)
        part = t.index_select(0, idx)
    elif kind == "rows":
        per = t.shape[0] // n
        part = t[m * per:(m + 1) * per]
    else:
        per = t.shape[1] // n
        part = t[:, m * per:(m + 1) * per]
    param.data = part.contiguous()


def _halves(model: nn.Module):
    """(module, {dense attribute: split}, heads attribute) of every half
    block of the ViT and the CLIP text tower whose projections are float
    `Dense` layers."""
    from lseg_tpu_torch.models.clip_text import CausalSelfAttention, TextBlock
    from lseg_tpu_torch.models.layers import Dense
    from lseg_tpu_torch.models.vit import Attention, Mlp

    plans = ((Attention, {"qkv": "heads", "proj": "cols"}, "num_heads"),
             (Mlp, {"fc1": "rows", "fc2": "cols"}, None),
             (CausalSelfAttention, {"in_proj": "heads", "out_proj": "cols"},
              "heads"),
             (TextBlock, {"c_fc": "rows", "c_proj": "cols"}, None))
    for name, mod in model.named_modules():
        for cls, plan, heads in plans:
            if isinstance(mod, cls) and all(
                    type(getattr(mod, a)) is Dense for a in plan):
                yield name, mod, plan, heads


def _leaves(name: str, plan: dict):
    """(parameter name, attribute, leaf, split) of each cut parameter of a
    half block: a column-parallel layer cuts its weight and bias, a
    row-parallel one its weight alone."""
    for attr, kind in plan.items():
        for leaf in ("weight",) if kind == "cols" else ("weight", "bias"):
            yield ".".join(p for p in (name, attr, leaf) if p), attr, leaf, kind


def _splits(model: nn.Module) -> Dict[str, str]:
    return {full: kind for name, _, plan, _ in _halves(model)
            for full, _, _, kind in _leaves(name, plan)}


def shard_module_(model: nn.Module, mesh) -> nn.Module:
    """Cut the float projections of every ViT and CLIP text block of a
    full `model` to this rank's part of the model group, in place, and
    set each attention's local head count to H / n_model. A no-op without
    a model group or on a model already cut; H must divide by n_model."""
    group = model_group(mesh)
    if size(group) == 1 or getattr(model, "tp_splits", None) is not None:
        return model
    n, m = mesh.n_model, mesh.coord[1]
    splits = _splits(model)
    for name, mod, plan, heads in _halves(model):
        if heads is not None and getattr(mod, heads) % n:
            raise ValueError(f"{name}: {getattr(mod, heads)} heads do not "
                             f"divide over {n} ranks")
        for _, attr, leaf, kind in _leaves(name, plan):
            _cut(getattr(getattr(mod, attr), leaf), kind, n, m)
        mod.shard(group, n)
    model.tp_splits = splits
    model.tp_mesh = mesh
    return model


def param_shardings(model: nn.Module, mesh) -> Dict[str, Tuple]:
    """{parameter name: spec} of a full `model` under `mesh`: the mesh
    axis that splits each dimension of the port's tensor ((out, in) for a
    weight), or () where it is replicated, as the JAX package's
    `param_shardings` gives its `PartitionSpec`s."""
    splits = _splits(model) if mesh.n_model > 1 else {}
    out = {}
    for name, p in model.named_parameters():
        kind = splits.get(name)
        out[name] = () if kind is None else _SPLITS[kind][:p.dim()]
    return out


@torch.no_grad()
def _gather(named: Dict[str, torch.Tensor], model: nn.Module
            ) -> Dict[str, torch.Tensor]:
    """`named` (entries of a cut model) with each cut entry replaced by
    the whole tensor, its parts gathered over the model group."""
    mesh: Mesh = model.tp_mesh
    group, n = model_group(mesh), mesh.n_model
    out = {}
    for name, t in named.items():
        kind = model.tp_splits.get(name)
        if kind is None:
            out[name] = t
            continue
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=group)
        if kind == "heads":
            per = t.shape[0] // 3
            out[name] = torch.cat([p.reshape(3, per, *t.shape[1:])
                                   for p in parts], dim=1).reshape(
                3 * per * n, *t.shape[1:])
        else:
            out[name] = torch.cat(parts, dim=0 if kind == "rows" else 1)
    return out


def gather_module(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The full `state_dict` of a cut model on every rank of its model
    group (the model's own `state_dict` for an uncut one); the order and
    the names are those of the full model's."""
    state = model.state_dict()
    if getattr(model, "tp_splits", None) is None:
        return state
    return _gather(state, model)


def gather_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """{parameter name: whole gradient} of a cut model on every rank of
    its model group, for the parameters that hold a gradient (the
    gradients themselves for an uncut model)."""
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    if getattr(model, "tp_splits", None) is None:
        return grads
    return _gather(grads, model)


@torch.no_grad()
def sync_replicated_(model: nn.Module) -> None:
    """Give every rank of a cut model's group the gradients and buffers of
    its replicated parameters from the group's first rank: the ranks
    compute them redundantly, and a card's nondeterministic kernels (its
    atomics) may round them apart."""
    splits = getattr(model, "tp_splits", None)
    if splits is None:
        return
    tensors = [p.grad for name, p in model.named_parameters()
               if name not in splits and p.grad is not None]
    tensors += [b for b in model.buffers() if b.is_floating_point()]
    broadcast_(tensors, model_group(model.tp_mesh))
