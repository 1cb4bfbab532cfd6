"""MS-COCO semantic segmentation reader — the reference's `coco`
get_dataset name (reference: data/__init__.py:11-24, delegating to
PyTorch-Encoding's COCOSegmentation, which builds 21-VOC-class masks
from instance annotations via pycocotools).

pycocotools is not in this image, so the mask pipeline is
self-contained:
- compressed / uncompressed COCO RLE decoding in numpy (exact);
- polygon rasterization via PIL (scanline fill; boundary pixels may
  differ from pycocotools' rasterizer by <=1px — annotation-level
  jitter far below protocol noise);
- encoding's first-wins class painting over the 21-category VOC subset
  (background 0 + 20 classes, CAT_LIST order).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List

import numpy as np
from PIL import Image, ImageDraw

from lseg_tpu_torch.data import transforms as T

# encoding COCOSegmentation.CAT_LIST: COCO category id at VOC index
CAT_LIST = [0, 5, 2, 16, 9, 44, 6, 3, 17, 62, 21, 67, 18, 19, 4, 1, 64,
            20, 63, 7, 72]
NUM_CLASSES = 21


def decode_rle(rle: Dict) -> np.ndarray:
    """COCO RLE -> (h, w) uint8 mask. Handles uncompressed (counts =
    list of run lengths, column-major starting with 0s) and compressed
    (counts = LEB128-style byte string with delta coding) forms."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        if isinstance(counts, str):
            counts = counts.encode("ascii")
        runs: List[int] = []
        i = 0
        while i < len(counts):
            x = 0
            k = 0
            more = True
            while more:
                c = counts[i] - 48
                x |= (c & 0x1F) << (5 * k)
                more = bool(c & 0x20)
                i += 1
                k += 1
                if not more and (c & 0x10):
                    x |= -1 << (5 * k)
            if len(runs) > 2:
                x += runs[-2]
            runs.append(x)
    else:
        runs = list(counts)
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for run in runs:
        if val:
            flat[pos: pos + run] = 1
        pos += run
        val ^= 1
    # COCO RLE is column-major
    return flat.reshape(w, h).T


def _segmentation_mask(seg, h: int, w: int) -> np.ndarray:
    """One annotation's segmentation -> binary (h, w) mask."""
    if isinstance(seg, dict):
        return decode_rle(seg)
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for poly in seg:
        pts = [(poly[i], poly[i + 1]) for i in range(0, len(poly), 2)]
        if len(pts) >= 3:
            draw.polygon(pts, outline=1, fill=1)
    return np.asarray(img, np.uint8)


class COCOSegmentation:
    """21-class semantic masks from COCO instance annotations
    (PyTorch-Encoding COCOSegmentation semantics: first-wins painting
    over CAT_LIST; images with <1000 labeled pixels dropped)."""

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
        year: str = "2017",
        min_pixels: int = 1000,
    ):
        self.split = split
        self.mode = mode or split
        self.base_size = base_size
        self.crop_size = crop_size
        self.ignore_index = ignore_index
        self.mean, self.std = mean, std
        self.seed = seed
        self._epoch = 0
        self.num_classes = NUM_CLASSES

        coco_root = os.path.join(root, "coco")
        if not os.path.isdir(coco_root):
            coco_root = root
        ann_file = os.path.join(
            coco_root, "annotations", f"instances_{split}{year}.json")
        if not os.path.exists(ann_file):
            raise FileNotFoundError(
                f"COCO annotations not found: {ann_file}")
        with open(ann_file) as f:
            data = json.load(f)

        self._img_dir = os.path.join(coco_root, f"{split}{year}")
        imgs = {im["id"]: im for im in data["images"]}
        cat_ok = set(CAT_LIST[1:])
        by_img: Dict[int, List] = {}
        for ann in data["annotations"]:
            if ann["category_id"] in cat_ok:
                by_img.setdefault(ann["image_id"], []).append(ann)
        # The min_pixels filter needs a full mask rasterization per
        # image — minutes of CPU on train2017. Cache the surviving id
        # list in a sidecar keyed on (ann_file, min_pixels), the same
        # reason PyTorch-Encoding caches its preprocessed ids
        # (reference: fewshot_data/data/coco.py mask caching).
        cache = f"{ann_file}.lseg_ids_min{min_pixels}.npy"
        kept: List[int] | None = None
        if (os.path.exists(cache)
                and os.path.getmtime(cache) >= os.path.getmtime(ann_file)):
            try:
                kept = [int(i) for i in np.load(cache)]
            except Exception:
                kept = None  # truncated/corrupt sidecar: recompute
        if kept is None:
            kept = []
            for iid, anns in sorted(by_img.items()):
                im = imgs[iid]
                mask = self._build_mask(anns, im["height"], im["width"])
                if (mask > 0).sum() >= min_pixels:
                    kept.append(iid)
            try:
                # atomic publish: concurrent constructors (multi-host
                # ranks, xdist workers) and mid-write kills must never
                # leave a half-written cache at the final path
                tmp = f"{cache}.tmp{os.getpid()}.npy"
                np.save(tmp, np.asarray(kept, np.int64))
                os.replace(tmp, cache)
            except OSError:
                pass  # read-only dataset dir: just skip the cache
        self.items = []
        for iid in kept:
            im = imgs[iid]
            self.items.append((im["file_name"],
                               im["height"], im["width"], by_img[iid]))

    @staticmethod
    def _build_mask(anns, h: int, w: int) -> np.ndarray:
        mask = np.zeros((h, w), np.uint8)
        for ann in anns:
            c = CAT_LIST.index(ann["category_id"])
            m = _segmentation_mask(ann["segmentation"], h, w)
            # first-wins painting (encoding coco.py _gen_seg_mask)
            mask += ((mask == 0) & (m > 0)).astype(np.uint8) * c
        return mask

    def __len__(self) -> int:
        return len(self.items)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        fname, h, w, anns = self.items[idx]
        img = Image.open(
            os.path.join(self._img_dir, fname)).convert("RGB")
        mask = Image.fromarray(self._build_mask(anns, h, w))
        if self.mode == "train":
            arr, m = T.train_transform(
                img, mask, self.base_size, self.crop_size,
                rng=random.Random(
                    (self.seed * 1_000_003 + self._epoch) * 2_654_435_761
                    + idx
                ),
                mean=self.mean, std=self.std, ignore_index=0,
            )
            m = np.asarray(m, np.int32)
        elif self.mode == "val":
            arr, m = T.val_transform(
                img, mask, self.crop_size, mean=self.mean, std=self.std
            )
            m = np.asarray(m, np.int32)
        else:
            arr = T.normalize(
                np.asarray(img, dtype=np.uint8), self.mean, self.std
            )
            m = np.asarray(mask, np.int32)
        return {"image": arr.astype(np.float32), "target": m}
