"""ADE20K (SceneParse150) dataset reader.

The reference delegates to PyTorch-Encoding's ADE20KSegmentation
(reference: data/__init__.py:11-24). Same on-disk layout
(`ADEChallengeData2016/images/{training,validation}/*.jpg` +
`annotations/.../*.png`) and label convention: annotation value 0 is
void -> ignore_index, classes 1..150 -> targets 0..149.

Modes: 'train' (random-scale aug), 'val' (center crop), 'testval'
(original size, for the multi-scale TTA protocol).
"""

from __future__ import annotations

import os
import random
from typing import Dict, List

import numpy as np
from PIL import Image

from lseg_tpu_torch.data import transforms as T

NUM_CLASSES = 150


class ADE20KSegmentation:
    def __init__(
        self,
        root: str,
        split: str = "train",
        mode: str | None = None,
        base_size: int = 520,
        crop_size: int = 480,
        ignore_index: int = -1,
        mean=T.DEFAULT_MEAN,
        std=T.DEFAULT_STD,
        seed: int = 0,
    ):
        self.root = os.path.join(root, "ADEChallengeData2016")
        self.split = split
        self.mode = mode or split
        self.base_size = base_size
        self.crop_size = crop_size
        self.ignore_index = ignore_index
        self.mean, self.std = mean, std
        self.num_classes = NUM_CLASSES
        self.seed = seed
        self._epoch = 0

        sub = "training" if split == "train" else "validation"
        img_dir = os.path.join(self.root, "images", sub)
        ann_dir = os.path.join(self.root, "annotations", sub)
        if not os.path.isdir(img_dir):
            raise FileNotFoundError(
                f"ADE20K not found under {self.root!r}; expected "
                f"images/{sub}. Download ADEChallengeData2016 "
                "(see reference prepare_ade20k.py)."
            )
        self.images: List[str] = sorted(
            os.path.join(img_dir, f)
            for f in os.listdir(img_dir)
            if f.endswith(".jpg")
        )
        self.masks: List[str] = [
            os.path.join(ann_dir, os.path.basename(f)[:-4] + ".png")
            for f in self.images
        ]

    def __len__(self) -> int:
        return len(self.images)

    def set_epoch(self, epoch: int) -> None:
        """Deterministic augmentation stream: the per-sample RNG mixes
        (seed, epoch, idx), so runs reproduce exactly and resumed
        epochs see fresh augmentations (sampler-style hook, called by
        the DataLoader)."""
        self._epoch = int(epoch)

    def _mask_to_target(self, mask: np.ndarray) -> np.ndarray:
        """0=void -> ignore; 1..150 -> 0..149 (encoding convention)."""
        m = mask.astype(np.int32) - 1
        m[m == -1] = self.ignore_index
        return m

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img = Image.open(self.images[idx]).convert("RGB")
        mask = Image.open(self.masks[idx])
        if self.mode == "train":
            arr, m = T.train_transform(
                img, mask, self.base_size, self.crop_size,
                rng=random.Random(
                    (self.seed * 1_000_003 + self._epoch) * 2_654_435_761
                    + idx
                ),
                mean=self.mean, std=self.std,
                ignore_index=0,  # pad with void BEFORE the -1 shift
            )
            m = self._mask_to_target(m)
        elif self.mode == "val":
            arr, m = T.val_transform(
                img, mask, self.crop_size, mean=self.mean, std=self.std
            )
            m = self._mask_to_target(m)
        else:  # testval: original size
            arr = T.normalize(
                np.asarray(img, dtype=np.uint8), self.mean, self.std
            )
            m = self._mask_to_target(np.asarray(mask, dtype=np.int32))
        return {"image": arr.astype(np.float32), "target": m}
