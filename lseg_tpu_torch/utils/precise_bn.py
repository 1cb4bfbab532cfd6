"""Precise BN: re-estimate the BatchNorm running statistics on training
data before evaluation (torch port of `lseg_tpu/utils/precise_bn.py`;
the reference's --acc-bn path, test_lseg.py:281-303, through
encoding.utils.precise_bn.update_bn_stats): the equal-weighted mean of
the per-batch moments, not the running average.

The port's `BatchNorm` (`models.layers`) updates its running statistics
as flax does, `r' = m r + (1 - m) batch` with m = 0.9 and the biased
batch variance; each batch's moments are recovered from that update as
`(r' - m r) / (1 - m)` in float64. Every batch starts from the model's
statistics as they were before the call, as the JAX package applies each
forward to the same variables.
"""

from __future__ import annotations

from typing import Iterable

import torch
from torch import nn

from lseg_tpu_torch.models.layers import BatchNorm


@torch.no_grad()
def update_bn_stats(model: nn.Module, batches: Iterable,
                    max_batches: int = 200) -> nn.Module:
    """Run train-mode forwards `model(batch, None)` over up to
    `max_batches` image batches and write the mean of their moments into
    every `BatchNorm`'s running statistics, in place; returns the model
    (in the mode it was in)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    if not bns:
        return model
    old = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]
    acc = [[torch.zeros_like(t, dtype=torch.float64) for t in pair]
           for pair in old]
    was_training = model.training
    model.train()
    n = 0
    try:
        for batch in batches:
            if n >= max_batches:
                break
            for bn, (mean, var) in zip(bns, old):
                bn.running_mean.copy_(mean)
                bn.running_var.copy_(var)
            model(batch, None)
            for bn, pair, sums in zip(bns, old, acc):
                m = bn.MOMENTUM
                for new, o, s in zip((bn.running_mean, bn.running_var),
                                     pair, sums):
                    s += (new.double() - m * o.double()) / (1.0 - m)
            n += 1
    finally:
        model.train(was_training)
    for bn, pair, sums in zip(bns, old, acc):
        for buf, o, s in zip((bn.running_mean, bn.running_var), pair, sums):
            buf.copy_(s / n if n else o)
    return model
