"""Segmentation metrics (torch port of `lseg_tpu/ops/metrics.py`:
`seg_update` and `SegmentationMetric`).

PyTorch-Encoding semantics: pixels whose target is `ignore_index` are
dropped; pixAcc = correct / labeled; IoU_k = inter_k / union_k and mIoU
is the mean over ALL classes, eps-guarded. The per-class areas are
weighted bincounts, so no (N, H, W, K) one-hot is built.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _area(ids: torch.Tensor, w: torch.Tensor, nclass: int) -> torch.Tensor:
    """Weighted bincount of ids into `nclass` bins; ids outside
    [0, nclass) are dropped, as `jax.ops.segment_sum` drops them."""
    inside = (ids >= 0) & (ids < nclass)
    ids = torch.where(inside, ids, nclass)
    return torch.bincount(ids, weights=w, minlength=nclass + 1)[:nclass]


def seg_update(logits: torch.Tensor, target: torch.Tensor, nclass: int,
               ignore_index: int = -1
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """One batch's (correct, labeled, inter[K], union[K]) from (N, H, W, K)
    logits and the (N, H, W) integer target; counts are int64, areas
    fp32, all on the logits' device."""
    pred = torch.argmax(logits, dim=-1)
    valid = target != ignore_index
    tgt = torch.where(valid, target, 0).long()
    labeled = valid.sum()
    correct = ((pred == tgt) & valid).sum()
    w = valid.reshape(-1).float()
    pf = pred.reshape(-1)
    tf = tgt.reshape(-1)
    area_pred = _area(pf, w, nclass)
    area_tgt = _area(tf, w, nclass)
    inter = _area(tf, w * (pf == tf).float(), nclass)
    return correct, labeled, inter, area_pred + area_tgt - inter


class SegmentationMetric:
    """Streaming pixAcc / mIoU accumulator on the host (float64)."""

    def __init__(self, nclass: int, ignore_index: int = -1):
        self.nclass = nclass
        self.ignore_index = ignore_index
        self.reset()

    def reset(self):
        self.total_correct = 0.0
        self.total_label = 0.0
        self.total_inter = np.zeros(self.nclass, dtype=np.float64)
        self.total_union = np.zeros(self.nclass, dtype=np.float64)

    def add(self, correct, labeled, inter, union):
        """Accumulate one batch's `seg_update` output."""
        self.total_correct += float(correct)
        self.total_label += float(labeled)
        self.total_inter += np.asarray(torch.as_tensor(inter).cpu(),
                                       dtype=np.float64)
        self.total_union += np.asarray(torch.as_tensor(union).cpu(),
                                       dtype=np.float64)

    def update(self, logits, target):
        with torch.no_grad():
            self.add(*seg_update(logits, target, self.nclass,
                                 self.ignore_index))

    def get(self) -> Tuple[float, float]:
        eps = np.spacing(1.0)
        pix_acc = self.total_correct / (eps + self.total_label)
        iou = self.total_inter / (eps + self.total_union)
        return float(pix_acc), float(np.mean(iou))
