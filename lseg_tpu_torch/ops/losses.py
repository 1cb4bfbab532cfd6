"""Segmentation losses (torch port of `lseg_tpu/ops/losses.py`).

Masked means over the valid (non-ignore) pixels, in fp32, as the
reference's `SegmentationLosses`: cross-entropy with `ignore_index`, an
optional auxiliary-head CE at `aux_weight` and an optional per-image
class-presence BCE ("SE loss") at `se_weight`. LSeg trains with plain CE.

With a data `group` of more than one rank, `cross_entropy` is a rank's
share of the CE of the global batch: its own pixels' sum over the valid
pixels of every rank (the JAX package's mean over the global batch), so
that the gradients of the ranks' shares SUM to the gradient of the
global loss.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from lseg_tpu_torch.parallel.dist import all_reduce_


def cross_entropy(logits: torch.Tensor, target: torch.Tensor,
                  ignore_index: int = -1, group=None) -> torch.Tensor:
    """Mean softmax cross-entropy of (N, H, W, K) logits over the pixels
    of the (N, H, W) integer target that are not `ignore_index`; with a
    `group`, this rank's CE sum over the valid-pixel count of the whole
    group (one all_reduce of the count)."""
    valid = target != ignore_index
    tgt = torch.where(valid, target, 0).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, tgt.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, logz - picked, 0.0)
    count = valid.sum()
    all_reduce_([count], group)
    return nll.sum() / count.clamp_min(1)


def se_loss(logits_se: torch.Tensor, target: torch.Tensor, nclass: int,
            ignore_index: int = -1) -> torch.Tensor:
    """BCE-with-logits of (N, K) class-presence logits against "class k
    appears in the image"."""
    valid = target != ignore_index
    tgt = torch.where(valid, target, nclass).long()
    onehot = F.one_hot(tgt, nclass + 1)[..., :nclass]
    present = (onehot.sum(dim=(1, 2)) > 0).float()
    x = logits_se.float()
    return (torch.clamp(x, min=0) - x * present
            + torch.log1p(torch.exp(-x.abs()))).mean()


def segmentation_loss(logits: torch.Tensor, target: torch.Tensor,
                      ignore_index: int = -1,
                      aux_logits: Optional[torch.Tensor] = None,
                      aux_weight: float = 0.2,
                      se_logits: Optional[torch.Tensor] = None,
                      se_weight: float = 0.2,
                      nclass: Optional[int] = None) -> torch.Tensor:
    """CE + aux_weight * CE(aux) + se_weight * SE."""
    loss = cross_entropy(logits, target, ignore_index)
    if aux_logits is not None:
        loss = loss + aux_weight * cross_entropy(aux_logits, target,
                                                 ignore_index)
    if se_logits is not None:
        loss = loss + se_weight * se_loss(
            se_logits, target, nclass or logits.shape[-1], ignore_index)
    return loss
