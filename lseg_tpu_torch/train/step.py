"""Train and eval steps (torch port of `lseg_tpu/train/step.py` and of
the state of `lseg_tpu/train/state.py`).

`TrainState` holds the model (fp32 master parameters and the BatchNorm
running statistics), the optimizer with its schedule, and the step
count. The step runs eagerly and updates the state in place:

- the model in train mode (BatchNorm on batch statistics, updating its
  running statistics) returns full-resolution fp32 logits;
- with `accumulate > 1` the batch is cut into that many micro-batches,
  their gradients are summed and divided by `accumulate`, and each
  micro-batch's BatchNorm update starts from the previous one's, as the
  reference's scan over micro-batches carries its `batch_stats`;
- the metrics are `loss` (mean over micro-batches), `correct`,
  `labeled`, `inter` and `union` (`ops.metrics.seg_update`), left on the
  device so that nothing waits for them until they are read.

Data parallel (`group` of more than one rank, one process each): every
rank holds the same model and steps on its rows of the global batch
(`parallel.dist.rank_rows`: with accumulation, its part of each global
micro-batch, so the local micro-batch i of all ranks together is the
global micro-batch i). On its first call with a model the step
broadcasts rank 0's parameters and buffers and syncs its BatchNorms over
the group (global batch statistics and running-statistics updates). The
loss of a micro-batch is each rank's CE sum over the group's valid-pixel
count (`ops.losses.cross_entropy` with the group), so the gradients are
SUMMED over the ranks (one bucketed all_reduce after the last
micro-batch) to give the gradient of the global loss, even where the
ranks differ in their ignored pixels. The metrics are summed over the
ranks and the loss is the global one; the optimizer then steps
identically on every rank.

Tensor parallel (`group` a `parallel.dist.Mesh` with `n_model > 1`): on
its first call with a full model the step broadcasts rank 0's model to
every rank and cuts it over the model group
(`parallel.tensor.shard_module_`; a model already cut is broadcast over
its data group only). The ranks of a model group step on the same rows
(their data group's), so the batch, the loss, BatchNorm and the
gradient sum above all run over the data group; a gradient of a cut
parameter is this rank's part. The replicated parameters' gradients and
the buffers then come from the model group's first rank, so the ranks of
a model group keep them equal bit for bit.
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass
from typing import Callable, Dict

import torch
import torch.distributed as dist
from torch import nn

from lseg_tpu_torch.ops.losses import cross_entropy, segmentation_loss
from lseg_tpu_torch.ops.metrics import seg_update
from lseg_tpu_torch.parallel.dist import (
    all_reduce_,
    broadcast_module,
    data_group,
    model_group,
    size,
    sync_batchnorm_,
)
from lseg_tpu_torch.parallel.tensor import shard_module_, sync_replicated_
from lseg_tpu_torch.train.optim import Optimizer

# leaves of the int8 serving layers, never trained
FROZEN_LEAVES = ("weight_q", "scale", "act_scale")


def enable_grads(model: nn.Module) -> nn.Module:
    """Make every floating-point parameter require grad, except the int8
    codes and the quantization scales (`FROZEN_LEAVES`)."""
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        p.requires_grad_(p.is_floating_point() and leaf not in FROZEN_LEAVES)
    return model


@dataclass
class TrainState:
    model: nn.Module
    optimizer: Optimizer
    step: int = 0


def _metrics(out, tgt, ignore_index):
    with torch.no_grad():
        return seg_update(out, tgt, out.shape[-1], ignore_index)


def make_train_step(ignore_index: int = -1, accumulate: int = 1,
                    group=None) -> Callable:
    """train_step(state, batch, text_features) -> (state, metrics);
    `batch` is {'image': (N, H, W, 3) fp32, 'target': (N, H, W) int} on
    the model's device, N divisible by `accumulate`: with a `group` of
    more than one rank, this rank's rows of the global batch (of its data
    group's, for a `Mesh`)."""
    dgroup, mgroup = data_group(group), model_group(group)
    parallel = size(dgroup) > 1 or size(mgroup) > 1
    joined = weakref.WeakSet()

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   text_features: torch.Tensor):
        model = state.model
        if parallel and model not in joined:
            if size(mgroup) > 1 and getattr(model, "tp_splits",
                                            None) is None:
                broadcast_module(model, dist.group.WORLD)
                shard_module_(model, group)
            else:
                broadcast_module(model, dgroup)
            sync_batchnorm_(model, dgroup)
            joined.add(model)
        model.train()
        img, tgt = batch["image"], batch["target"]
        n = img.shape[0]
        if n % accumulate:
            raise ValueError(f"batch {n} is not divisible by accumulate "
                             f"{accumulate}")
        m = n // accumulate
        model.zero_grad(set_to_none=True)
        losses, sums = [], None
        for i in range(accumulate):
            mi, mt = img[i * m:(i + 1) * m], tgt[i * m:(i + 1) * m]
            out = model(mi, text_features)
            loss = cross_entropy(out, mt, ignore_index, dgroup)
            loss.backward()
            losses.append(loss.detach())
            part = _metrics(out.detach(), mt, ignore_index)
            sums = part if sums is None else tuple(
                a + b for a, b in zip(sums, part))
            del out, loss
        losses = torch.stack(losses)
        all_reduce_([p.grad for p in model.parameters()
                     if p.grad is not None], dgroup)
        all_reduce_([losses, *sums], dgroup)
        sync_replicated_(model)
        if accumulate > 1:
            for p in model.parameters():
                if p.grad is not None:
                    p.grad.div_(accumulate)
        state.optimizer.step(state.step)
        state.step += 1
        correct, labeled, inter, union = sums
        return state, {"loss": losses.mean(),
                       "correct": correct, "labeled": labeled,
                       "inter": inter, "union": union}

    return train_step


def make_eval_step(ignore_index: int = -1) -> Callable:
    """eval_step(state, batch, text_features) -> metrics, the model in
    eval mode (running statistics), no gradients."""

    @torch.no_grad()
    def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
                  text_features: torch.Tensor):
        model = state.model
        model.eval()
        out = model(batch["image"], text_features)
        loss = segmentation_loss(out, batch["target"],
                                 ignore_index=ignore_index)
        correct, labeled, inter, union = seg_update(
            out, batch["target"], out.shape[-1], ignore_index)
        return {"loss": loss, "correct": correct, "labeled": labeled,
                "inter": inter, "union": union}

    return eval_step
