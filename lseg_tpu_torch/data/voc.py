"""PASCAL VOC family readers — the remaining `get_dataset` names the
reference exposes through PyTorch-Encoding (reference:
data/__init__.py:11-24: pascal_voc, pascal_aug, pcontext).

- `VOCSegmentation` (pascal_voc): VOC2012 layout
  (VOCdevkit/VOC2012/{JPEGImages,SegmentationClass,ImageSets/
  Segmentation}); 21 classes (0 = background), boundary 255 -> ignore.
- `VOCAugSegmentation` (pascal_aug): SBD "trainaug" layout
  (VOCaug/dataset/{img,cls,*.txt}); masks are MATLAB .mat files
  (GTcls.Segmentation), 21 classes.
- `PContextSegmentation` (pcontext): PASCAL-Context 59-class task.
  PyTorch-Encoding decodes the raw annotations through the `detail`
  C extension; TPU-native equivalent consumes the standard
  pre-converted `SegmentationClassContext/*.png` label maps (value 0 =
  background -> ignore, 1..59 -> classes 0..58) next to a VOC2010
  tree — the layout produced by the usual PASCAL-Context converters.

All three share the ADE20K reader's transform pipeline (train random
scale/crop/flip, val center crop, testval original size) and emit
NHWC float32 images + int32 targets with ignore_index outside labels.
"""

from __future__ import annotations

import os
import random
from typing import Dict, List, Tuple

import numpy as np
from PIL import Image

from lseg_tpu_torch.data import transforms as T


class _VOCBase:
    num_classes: int = 21

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
        self.split = split
        self.mode = mode or split
        self.base_size = base_size
        self.crop_size = crop_size
        self.ignore_index = ignore_index
        self.mean, self.std = mean, std
        self.seed = seed
        self._epoch = 0
        self.images, self.masks = self._index(root, split)
        if not self.images:
            raise FileNotFoundError(
                f"{type(self).__name__}: no images for split "
                f"{split!r} under {root!r}")

    def _index(self, root: str, split: str) -> Tuple[List[str], List[str]]:
        raise NotImplementedError

    def _read_mask(self, path: str) -> np.ndarray:
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.images)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        img = Image.open(self.images[idx]).convert("RGB")
        mask_arr = self._read_mask(self.masks[idx])
        mask = Image.fromarray(mask_arr.astype(np.uint8))
        if self.mode == "train":
            arr, m = T.train_transform(
                img, mask, self.base_size, self.crop_size,
                rng=random.Random(
                    (self.seed * 1_000_003 + self._epoch) * 2_654_435_761
                    + idx
                ),
                mean=self.mean, std=self.std,
                ignore_index=255,  # pad with the void value pre-shift
            )
            m = self._mask_to_target(np.asarray(m))
        elif self.mode == "val":
            arr, m = T.val_transform(
                img, mask, self.crop_size, mean=self.mean, std=self.std
            )
            m = self._mask_to_target(np.asarray(m))
        else:  # testval
            arr = T.normalize(
                np.asarray(img, dtype=np.uint8), self.mean, self.std
            )
            m = self._mask_to_target(mask_arr)
        return {"image": arr.astype(np.float32), "target": m}

    def _mask_to_target(self, mask: np.ndarray) -> np.ndarray:
        m = mask.astype(np.int32)
        m[m == 255] = self.ignore_index
        return m


class VOCSegmentation(_VOCBase):
    """pascal_voc: VOC2012, 21 classes (0=background), 255 -> ignore
    (PyTorch-Encoding VOCSegmentation semantics)."""

    num_classes = 21

    def _index(self, root, split):
        voc = os.path.join(root, "VOCdevkit", "VOC2012")
        if not os.path.isdir(voc):
            voc = root  # accept the VOC2012 dir itself
        lst = os.path.join(voc, "ImageSets", "Segmentation",
                           f"{split}.txt")
        if not os.path.exists(lst):
            return [], []
        with open(lst) as f:
            ids = [line.strip() for line in f if line.strip()]
        imgs = [os.path.join(voc, "JPEGImages", f"{i}.jpg") for i in ids]
        masks = [os.path.join(voc, "SegmentationClass", f"{i}.png")
                 for i in ids]
        return imgs, masks

    def _read_mask(self, path):
        return np.asarray(Image.open(path), dtype=np.int32)


class VOCAugSegmentation(_VOCBase):
    """pascal_aug: SBD augmented VOC (trainaug). Masks are .mat
    (GTcls.Segmentation), values 0..20 (PyTorch-Encoding
    VOCAugSegmentation semantics)."""

    num_classes = 21

    def _index(self, root, split):
        aug = os.path.join(root, "VOCaug", "dataset")
        if not os.path.isdir(aug):
            aug = root
        lst = os.path.join(aug, f"{split}.txt")
        if not os.path.exists(lst):
            return [], []
        with open(lst) as f:
            ids = [line.strip() for line in f if line.strip()]
        imgs = [os.path.join(aug, "img", f"{i}.jpg") for i in ids]
        masks = [os.path.join(aug, "cls", f"{i}.mat") for i in ids]
        return imgs, masks

    def _read_mask(self, path):
        from scipy.io import loadmat

        mat = loadmat(path, mat_dtype=True, squeeze_me=True,
                      struct_as_record=False)
        return np.asarray(mat["GTcls"].Segmentation, dtype=np.int32)


class PContextSegmentation(_VOCBase):
    """pcontext: PASCAL-Context 59-class task over pre-converted
    label PNGs (SegmentationClassContext). PNG value 0 = background ->
    ignore, 1..59 -> classes 0..58 (the 59-class protocol PyTorch-
    Encoding implements through the `detail` API)."""

    num_classes = 59

    def _index(self, root, split):
        voc = os.path.join(root, "VOCdevkit", "VOC2010")
        if not os.path.isdir(voc):
            voc = root
        lst = os.path.join(voc, "ImageSets", "SegmentationContext",
                           f"{split}.txt")
        if not os.path.exists(lst):
            return [], []
        with open(lst) as f:
            ids = [line.strip() for line in f if line.strip()]
        imgs = [os.path.join(voc, "JPEGImages", f"{i}.jpg") for i in ids]
        masks = [os.path.join(voc, "SegmentationClassContext",
                              f"{i}.png") for i in ids]
        return imgs, masks

    def _read_mask(self, path):
        return np.asarray(Image.open(path), dtype=np.int32)

    def _mask_to_target(self, mask: np.ndarray) -> np.ndarray:
        m = mask.astype(np.int32) - 1  # background 0 -> -1
        m[m < 0] = self.ignore_index
        m[m > 58] = self.ignore_index
        return m

    def __getitem__(self, idx):
        # background must pad as 0 pre-shift, not 255
        img = Image.open(self.images[idx]).convert("RGB")
        mask_arr = self._read_mask_raw(idx)
        mask = Image.fromarray(mask_arr.astype(np.uint8))
        if self.mode == "train":
            arr, m = T.train_transform(
                img, mask, self.base_size, self.crop_size,
                rng=random.Random(
                    (self.seed * 1_000_003 + self._epoch) * 2_654_435_761
                    + idx
                ),
                mean=self.mean, std=self.std, ignore_index=0,
            )
            m = self._mask_to_target(np.asarray(m))
        elif self.mode == "val":
            arr, m = T.val_transform(
                img, mask, self.crop_size, mean=self.mean, std=self.std
            )
            m = self._mask_to_target(np.asarray(m))
        else:
            arr = T.normalize(
                np.asarray(img, dtype=np.uint8), self.mean, self.std
            )
            m = self._mask_to_target(mask_arr)
        return {"image": arr.astype(np.float32), "target": m}

    def _read_mask_raw(self, idx):
        return np.asarray(Image.open(self.masks[idx]), dtype=np.int32)
