"""Episodic (zero- / few-shot) training (torch port of
`lseg_tpu/train/episodic.py`): the reference's LSegModuleZS path
(modules/lsegmentation_module_zs.py:86-145, 338-343), a binary
['others', <class>] cross-entropy on the query image, batched over the
episodes instead of looped (lseg_net_zs.py:198-210).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from lseg_tpu_torch.engine.episodic import pair_logits
from lseg_tpu_torch.ops.losses import cross_entropy
from lseg_tpu_torch.ops.metrics import episode_inter_union
from lseg_tpu_torch.ops.resize import upsample2x
from lseg_tpu_torch.train.step import TrainState


def episodic_logits(model, images: torch.Tensor, txt_pairs: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """(B, H, W, 3) images and (B, 2, C) pair embeddings -> (B, H, W, 2)
    fp32 logits, with the model in the mode its caller set (train mode
    updates the BatchNorm running statistics)."""
    logits = pair_logits(model(images, None), txt_pairs, scale)
    return upsample2x(logits, align_corners=True)


def make_episodic_train_step(logit_scale: float,
                             ignore_index: int = 255) -> Callable:
    """train_step(state, batch, txt_pairs) -> (state, metrics), in place.

    batch: {'query_img': (B, H, W, 3), 'query_mask': (B, H, W) {0, 1},
    'query_ignore': (B, H, W) bool} on the model's device; txt_pairs:
    (B, 2, C). The model runs in train mode; the loss is the binary CE
    with `ignore_index` where `query_ignore` holds (the reference feeds
    mask == 255 to CE as its ignore index). The metrics are `loss` and
    the episodes' `inter` / `union` ((B, 2), `episode_inter_union` of the
    step's argmax), left on the device."""

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
                   txt_pairs: torch.Tensor):
        model = state.model
        model.train()
        model.zero_grad(set_to_none=True)
        logits = episodic_logits(model, batch["query_img"], txt_pairs,
                                 logit_scale)
        tgt = torch.where(batch["query_ignore"], ignore_index,
                          batch["query_mask"]).long()
        loss = cross_entropy(logits, tgt, ignore_index=ignore_index)
        loss.backward()
        state.optimizer.step(state.step)
        state.step += 1
        with torch.no_grad():
            inter, union = episode_inter_union(
                torch.argmax(logits.detach(), dim=-1), batch["query_mask"],
                batch["query_ignore"])
        return state, {"loss": loss.detach(), "inter": inter,
                       "union": union}

    return train_step
