"""Cityscapes (fine annotations) dataset reader.

The reference delegates to PyTorch-Encoding's CitySegmentation
(reference: data/__init__.py:11-24, 'citys'); protocol constants:
base_size 2048 / crop 768 (reference: modules/lseg_module.py:29-34),
eval scales [0.75..2.25] (reference: test_lseg.py:308-312).

On-disk layout (official Cityscapes package):
    leftImg8bit/{train,val,test}/<city>/<id>_leftImg8bit.png
    gtFine/{train,val,test}/<city>/<id>_gtFine_labelIds.png

Labels: the 19 standard train classes; every other labelId (void,
ego-vehicle, license plate, rail track, ...) maps to `ignore_index` —
the same trainId reduction PyTorch-Encoding applies.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List

import numpy as np
from PIL import Image

from lseg_tpu_torch.data import transforms as T

NUM_CLASSES = 19

# labelId -> trainId for the 19 eval classes (official cityscapes
# labels table; everything absent here is ignored).
_LABEL_TO_TRAIN = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8,
    22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16,
    32: 17, 33: 18,
}


def _build_lut(ignore_index: int) -> np.ndarray:
    lut = np.full(256, ignore_index, np.int32)
    for k, v in _LABEL_TO_TRAIN.items():
        lut[k] = v
    return lut


class CitySegmentation:
    def __init__(
        self,
        root: str,
        split: str = "train",
        mode: str | None = None,
        base_size: int = 2048,
        crop_size: int = 768,
        ignore_index: int = -1,
        mean=T.DEFAULT_MEAN,
        std=T.DEFAULT_STD,
        seed: int = 0,
    ):
        self.root = os.path.join(root, "cityscapes")
        if not os.path.isdir(self.root):
            # also accept the dataset dir itself as root
            if os.path.isdir(os.path.join(root, "leftImg8bit")):
                self.root = root
        self.split = split
        self.mode = mode or split
        self.base_size = base_size
        self.crop_size = crop_size
        self.ignore_index = ignore_index
        self.mean, self.std = mean, std
        self.num_classes = NUM_CLASSES
        self.seed = seed
        self._epoch = 0
        self._lut = _build_lut(ignore_index)

        img_root = os.path.join(self.root, "leftImg8bit", split)
        ann_root = os.path.join(self.root, "gtFine", split)
        if not os.path.isdir(img_root):
            raise FileNotFoundError(
                f"Cityscapes not found under {self.root!r}; expected "
                f"leftImg8bit/{split}/<city>/*_leftImg8bit.png"
            )
        self.images: List[str] = sorted(
            os.path.join(img_root, city, f)
            for city in os.listdir(img_root)
            for f in os.listdir(os.path.join(img_root, city))
            if f.endswith("_leftImg8bit.png")
        )
        self.masks: List[str] = [
            os.path.join(
                ann_root,
                os.path.basename(os.path.dirname(f)),
                os.path.basename(f).replace(
                    "_leftImg8bit.png", "_gtFine_labelIds.png"),
            )
            for f in self.images
        ]

    def __len__(self) -> int:
        return len(self.images)

    def set_epoch(self, epoch: int) -> None:
        """Same deterministic augmentation-stream hook as the ADE20K
        reader (seed, epoch, idx) -> per-sample RNG."""
        self._epoch = int(epoch)

    def _mask_to_target(self, mask: np.ndarray) -> np.ndarray:
        return self._lut[np.clip(mask, 0, 255).astype(np.int64)]

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
                # pad with a void labelId (0 is unlabeled in cityscapes)
                ignore_index=0,
            )
            m = self._mask_to_target(m)
        elif self.mode == "val":
            arr, m = T.val_transform(
                img, mask, self.crop_size, mean=self.mean, std=self.std
            )
            m = self._mask_to_target(m)
        else:  # testval: original size (multi-scale TTA protocol)
            arr = T.normalize(
                np.asarray(img, dtype=np.uint8), self.mean, self.std
            )
            m = self._mask_to_target(np.asarray(mask, dtype=np.int32))
        return {"image": arr.astype(np.float32), "target": m}
