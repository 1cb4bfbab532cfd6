"""Segmentation metrics (torch port of `lseg_tpu/ops/metrics.py`:
`seg_update` and `SegmentationMetric` with its per-class IoU, and the
few-shot `episode_inter_union` and `AverageMeter`).

PyTorch-Encoding semantics: pixels whose target is `ignore_index` are
dropped; pixAcc = correct / labeled; IoU_k = inter_k / union_k and mIoU
is the mean over ALL classes, eps-guarded. The per-class areas are
weighted bincounts, so no (N, H, W, K) one-hot is built.

Few-shot episodes (the reference's fewshot_data/common/evaluation.py and
logger.py): per-episode {bg, fg} areas of binary masks with the query's
ignore region folded into agreement, accumulated per class id in float64;
mIoU is the mean of the foreground IoUs over the classes of interest and
FB-IoU the ratio of sums per {bg, fg} row, not a mean of ratios.
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

    def per_class_iou(self) -> np.ndarray:
        eps = np.spacing(1.0)
        return self.total_inter / (eps + self.total_union)


def episode_inter_union(pred: torch.Tensor, target: torch.Tensor,
                        ignore_mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-episode (area_inter (N, 2), area_union (N, 2)) fp32 over {bg,
    fg} of the (N, H, W) binary prediction and target; pixels where the
    (N, H, W) bool `ignore_mask` holds count for neither (the reference
    sets both to 255 there and histograms the other bins)."""
    valid = ~ignore_mask
    pf = (pred == 1) & valid
    tf = (target == 1) & valid
    pb = (pred == 0) & valid
    tb = (target == 0) & valid

    def area(m):
        return m.sum(dim=(1, 2)).float()

    inter = torch.stack([area(pb & tb), area(pf & tf)], dim=1)
    area_p = torch.stack([area(pb), area(pf)], dim=1)
    area_t = torch.stack([area(tb), area(tf)], dim=1)
    return inter, area_p + area_t - inter


class AverageMeter:
    """Per-class {bg, fg} intersection and union buffers (float64) and
    the two few-shot metrics over `class_ids`."""

    def __init__(self, class_ids):
        self.class_ids = list(class_ids)
        n = int(max(self.class_ids)) + 1 if self.class_ids else 1
        self.inter = np.zeros((2, n), dtype=np.float64)
        self.union = np.zeros((2, n), dtype=np.float64)
        self.loss_sum = 0.0
        self.count = 0

    def update(self, inter, union, class_id, loss=None):
        """Add each episode's (2,) areas to its class's column."""
        inter = np.asarray(inter, dtype=np.float64)  # (N, 2)
        union = np.asarray(union, dtype=np.float64)
        cid = np.asarray(class_id, dtype=np.int64).reshape(-1)
        for j, c in enumerate(cid):
            self.inter[:, c] += inter[j]
            self.union[:, c] += union[j]
        if loss is not None:
            self.loss_sum += float(loss)
            self.count += 1

    def compute_iou(self) -> Tuple[float, float]:
        """(mIoU, FB-IoU) in percent."""
        sel = np.asarray(self.class_ids, dtype=np.int64)
        iou = self.inter[:, sel] / np.maximum(self.union[:, sel], 1.0)
        miou = float(np.mean(iou[1]) * 100)
        # FB-IoU: sum inter and union over the classes first, divide,
        # then mean the two row ratios (fewshot_data/common/logger.py:
        # 41-43)
        fb = (self.inter[:, sel].sum(axis=1)
              / np.maximum(self.union[:, sel].sum(axis=1), 1e-9))
        return miou, float(np.mean(fb) * 100)
