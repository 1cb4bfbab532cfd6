"""Episodic (zero-shot / few-shot) inference (torch port of
`lseg_tpu/engine/episodic.py`): the LSegNetZS path.

The reference's zero-shot forward takes a class id per image, embeds the
['others', <class>] text pair and computes binary per-pixel logits in a
Python loop over the batch (modules/models/lseg_net_zs.py:169-214). Here
the pair embeddings come pre-gathered as a (B, K, C) tensor and the
correlation is one batched product: the pixel embeddings of
`LSegNet(x, None)` and the pairs, each L2-normalised in fp32, times the
logit scale, then the x2 align-corners upsample in fp32 and the argmax
over K (the first index on a tie, 'others'). The reference computes this
head outside any kernel of its own, and so does the port.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from lseg_tpu_torch.ops.correlation import l2_normalize
from lseg_tpu_torch.ops.metrics import AverageMeter, episode_inter_union
from lseg_tpu_torch.ops.resize import upsample2x


def pair_logits(emb: torch.Tensor, txt_pairs: torch.Tensor,
                scale: float) -> torch.Tensor:
    """(B, h, w, C) pixel embeddings and (B, K, C) per-image label
    embeddings -> (B, h, w, K) fp32 logits, each image against its own
    labels."""
    img = l2_normalize(emb.float())
    txt = l2_normalize(txt_pairs.float())
    return scale * torch.einsum("nhwc,nkc->nhwk", img, txt)


def make_episodic_predictor(model) -> Callable:
    """(images (B, H, W, 3), txt_pairs (B, K, C)) -> (B, H, W) int32 on
    the model's device: the argmax over each image's label set (K = 2 for
    the binary episode head). The model holds its weights already."""
    model.eval()
    scale = model.cfg.logit_scale
    device = next(model.parameters()).device

    @torch.inference_mode()
    def predict(images, txt_pairs):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        txt_pairs = torch.as_tensor(txt_pairs, device=device)
        logits = pair_logits(model(images, None), txt_pairs, scale)
        up = upsample2x(logits, align_corners=True)
        return torch.argmax(up, dim=-1).to(torch.int32)

    return predict


class EpisodicEvaluator:
    """The 1000-episode protocol (the reference's test_lseg_zs.py:290-316):
    per-episode binary prediction -> inter/union with the ignore region
    folded in -> `AverageMeter` -> mIoU / FB-IoU. Episodes stay on the
    predictor's device until their areas reach the meter."""

    def __init__(self, predict_fn, class_ids: Sequence[int],
                 visualizer=None):
        self.predict = predict_fn
        self.meter = AverageMeter(class_ids)
        # optional utils.fewshot_vis.EpisodeVisualizer: support / pred /
        # gt composites per episode (the reference's
        # fewshot_data/common/vis.py Visualizer)
        self.visualizer = visualizer

    def run(self, dataset, pair_features_fn, batch_size: int = 8,
            log=print, log_every: int = 50):
        """pair_features_fn(class_id) -> (2, C) ['others', label]
        embeddings (cached per class by TextFeatureCache)."""
        n = len(dataset)
        for start in range(0, n, batch_size):
            idxs = range(start, min(start + batch_size, n))
            eps = [dataset[i] for i in idxs]
            imgs = torch.from_numpy(np.stack([e["query_img"] for e in eps]))
            pairs = torch.stack([
                torch.as_tensor(pair_features_fn(int(e["class_id"])))
                for e in eps])
            pred = self.predict(imgs, pairs)
            tgt = torch.from_numpy(np.stack(
                [e["query_mask"] for e in eps])).to(pred.device)
            ign = torch.from_numpy(np.stack(
                [e["query_ignore"] for e in eps])).to(pred.device)
            inter, union = (t.cpu().numpy() for t in episode_inter_union(
                pred, tgt, ign))
            self.meter.update(inter, union,
                              np.asarray([e["class_id"] for e in eps]))
            if self.visualizer is not None:
                fg_iou = inter[:, 1] / np.maximum(union[:, 1], 1e-7)
                self.visualizer.batch(
                    {k: np.stack([e[k] for e in eps])
                     for k in ("support_imgs", "support_masks",
                               "query_img", "query_mask")},
                    pred.cpu().numpy(),
                    [int(e["class_id"]) for e in eps],
                    start // batch_size, ious=fg_iou,
                )
            if (start // batch_size) % log_every == 0:
                miou, fb = self.meter.compute_iou()
                log(f"[{start + len(eps)}/{n}] mIoU {miou:.2f} "
                    f"FB-IoU {fb:.2f}")
        return self.meter.compute_iou()
