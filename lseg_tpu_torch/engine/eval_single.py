"""Single-scale batched evaluator (torch port of
`lseg_tpu/engine/eval_single.py`).

Images are batched at a fixed crop size and each batch is one forward of
the caller's `apply_fn` (`engine.serve.make_logits_fn`), optionally with
the horizontal-flip TTA: a second forward on the W-flipped batch whose
logits are flipped back and added in fp32. The metrics update on the
device (`ops.metrics.seg_update`); only their sums leave it. One process
drives one card (no mesh: multi-GPU evaluation is not ported).
"""

from __future__ import annotations

from typing import Callable

import torch

from lseg_tpu_torch.ops.metrics import seg_update


class SingleScaleEvaluator:
    """`__call__(images, text_features)` -> (B, H, W) int32 labels;
    `metrics(images, targets, text_features)` -> the device tuple
    (correct, labeled, inter, union) for `SegmentationMetric.add`;
    `logits(images, text_features)` -> the (B, H, W, K) logits both
    derive from (flip-merged in fp32 with `flip`)."""

    def __init__(self, apply_fn: Callable, num_classes: int,
                 flip: bool = False, ignore_index: int = -1):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.flip = flip
        self._apply = apply_fn

    @torch.inference_mode()
    def logits(self, images, text_features) -> torch.Tensor:
        out = self._apply(images, text_features)
        if self.flip:
            images = torch.as_tensor(images, dtype=torch.float32,
                                     device=out.device)
            flipped = self._apply(images.flip(2), text_features)
            out = out.float() + flipped.float().flip(2)
        return out

    def __call__(self, images, text_features) -> torch.Tensor:
        logits = self.logits(images, text_features)
        return torch.argmax(logits, dim=-1).to(torch.int32)

    @torch.inference_mode()
    def metrics(self, images, targets, text_features):
        logits = self.logits(images, text_features)
        targets = torch.as_tensor(targets, device=logits.device)
        return seg_update(logits, targets, self.num_classes,
                          self.ignore_index)
