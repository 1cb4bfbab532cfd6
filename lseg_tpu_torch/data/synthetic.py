"""Synthetic segmentation dataset — deterministic colored-shapes images
with exactly recoverable masks, for end-to-end train/eval tests without
real data (SURVEY.md §4 'tiny fake dataset')."""

from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticSegDataset:
    """Images contain axis-aligned rectangles of per-class colors on a
    class-0 background; the mask is the class id per pixel. Learnable by
    a tiny model in a few steps (color -> class is pointwise)."""

    def __init__(self, n: int = 16, size: int = 64, num_classes: int = 4,
                 seed: int = 0):
        self.n = n
        self.size = size
        self.num_classes = num_classes
        self.seed = seed
        rng = np.random.RandomState(seed)
        # distinct, well-separated class colors
        self.colors = rng.uniform(-1, 1, (num_classes, 3)).astype(np.float32)

    def __len__(self) -> int:
        return self.n

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState(self.seed * 10007 + idx)
        s = self.size
        mask = np.zeros((s, s), np.int32)
        img = np.broadcast_to(self.colors[0], (s, s, 3)).copy()
        for c in range(1, self.num_classes):
            y0, x0 = rng.randint(0, s // 2, 2)
            hh, ww = rng.randint(s // 8, s // 2, 2)
            mask[y0: y0 + hh, x0: x0 + ww] = c
            img[y0: y0 + hh, x0: x0 + ww] = self.colors[c]
        img = img + rng.normal(0, 0.02, (s, s, 3)).astype(np.float32)
        return {"image": img.astype(np.float32), "target": mask}
