"""Few-shot episode visualizer — support/query/prediction composites
(the reference's fewshot_data/common/vis.py:11-108 Visualizer,
re-done functionally for NHWC numpy episodes).

Per episode it renders, left to right: each support image with its mask
alpha-blended in blue, the query image with the PREDICTED mask in red,
and the query image with the ground-truth mask in red, merged
horizontally into one JPEG named
`{batch}_{sample}_class-{id}_iou-{iou:.2f}.jpg`.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image

SUPPORT_COLOR = (102, 140, 255)  # blue (reference vis.py:19)
QUERY_COLOR = (255, 50, 50)      # red


def unnormalize(img: np.ndarray, mean, std) -> np.ndarray:
    """(H, W, 3) normalized float -> uint8 RGB."""
    arr = img.astype(np.float32) * np.asarray(std) + np.asarray(mean)
    return np.clip(arr * 255.0, 0, 255).astype(np.uint8)


def apply_mask(image: np.ndarray, mask: np.ndarray, color,
               alpha: float = 0.5) -> np.ndarray:
    """Alpha-blend `color` where mask==1 (reference vis.py:97-104)."""
    img = image.astype(np.float32).copy()
    m = (mask == 1)[..., None]
    tint = img * (1 - alpha) + alpha * np.asarray(color, np.float32)
    return np.where(m, tint, img).astype(np.uint8)


def merge_horizontal(images: Sequence[np.ndarray]) -> Image.Image:
    """Left-to-right composite on a black canvas (vis.py:82-94)."""
    width = sum(im.shape[1] for im in images)
    height = max(im.shape[0] for im in images)
    canvas = Image.new("RGB", (width, height))
    x = 0
    for im in images:
        canvas.paste(Image.fromarray(im), (x, 0))
        x += im.shape[1]
    return canvas


class EpisodeVisualizer:
    """Saves one composite JPEG per visualized episode.

    mean/std must match the dataset normalization (0.5/0.5 for LSeg
    episodes, imagenet stats for the HSNet RN101 path —
    reference dataset.py:19-26).
    """

    def __init__(self, vis_path: str = "./vis",
                 mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5)):
        self.vis_path = vis_path
        self.mean, self.std = mean, std
        os.makedirs(vis_path, exist_ok=True)

    def episode(
        self,
        support_imgs: np.ndarray,   # (S, H, W, 3) normalized
        support_masks: np.ndarray,  # (S, H, W) {0,1}
        query_img: np.ndarray,      # (H, W, 3) normalized
        query_mask: np.ndarray,     # (H, W) {0,1} ground truth
        pred_mask: np.ndarray,      # (H, W) {0,1} prediction
        class_id: int,
        batch_idx: int,
        sample_idx: int = 0,
        iou: Optional[float] = None,
    ) -> str:
        panels = [
            apply_mask(unnormalize(si, self.mean, self.std), sm,
                       SUPPORT_COLOR)
            for si, sm in zip(support_imgs, support_masks)
        ]
        q = unnormalize(query_img, self.mean, self.std)
        panels.append(apply_mask(q, pred_mask, QUERY_COLOR))
        panels.append(apply_mask(q, query_mask, QUERY_COLOR))
        out = os.path.join(
            self.vis_path,
            "%d_%d_class-%d_iou-%.2f.jpg"
            % (batch_idx, sample_idx, int(class_id),
               0.0 if iou is None else float(iou)),
        )
        merge_horizontal(panels).save(out)
        return out

    def batch(self, batch, pred_masks, class_ids, batch_idx,
              ious=None) -> list:
        """Visualize a stacked episode batch (the dict layout produced
        by lseg_tpu.data.fewshot datasets)."""
        out = []
        n = len(class_ids)
        for i in range(n):
            out.append(self.episode(
                np.asarray(batch["support_imgs"][i]),
                np.asarray(batch["support_masks"][i]),
                np.asarray(batch["query_img"][i]),
                np.asarray(batch["query_mask"][i]),
                np.asarray(pred_masks[i]),
                class_ids[i], batch_idx, i,
                None if ious is None else ious[i],
            ))
        return out
