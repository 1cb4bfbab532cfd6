"""Few-shot segmentation benchmarks: PASCAL-5i, COCO-20i, FSS-1000.

Reimplements the reference's episodic loaders
(reference: fewshot_data/data/{pascal.py,coco.py,fss.py,dataset.py})
torch-free (PIL + NumPy). Semantics preserved:

- PASCAL-5i: 4 folds × 5 classes; val classes = fold*5..fold*5+4
  (pascal.py:111-120); metadata from `splits/pascal/<split>/fold<k>.txt`
  lines 'name__classid' with class made 0-based (pascal.py:122-131);
  val length clamped to 1000 episodes, idx wraps (pascal.py:29-33);
  ignore boundary = pixels valued 255, i.e. floor(mask/255)
  (pascal.py:73-78); binary mask = (mask == class_id+1).
- COCO-20i: folds interleaved class_ids = fold + 4*v (coco.py:62-68);
  metadata from `splits/coco/<split>/fold<k>.pkl` classwise dict
  (coco.py:70-73); episodes sampled RANDOMLY each __getitem__
  (coco.py:32-35,86-114) — made seed-stable here: episode idx i uses an
  RNG derived from (seed, i), so the 1000-episode protocol is exactly
  reproducible (the reference relies on a globally-seeded stream, which
  is fixed but not portable).
- FSS-1000: categories from `splits/fss/<split>.txt`, sorted; class ids
  offset +520 (val) / +760 (test) (fss.py:93-98,118-124); test 1-shot
  support is always image '1.jpg' (fss.py:100-108); masks binarized at
  128 (fss.py:86-90).
- Images resized to (img_size, img_size) bilinear + normalized
  (mean/std = 0.5 or ImageNet for RN101, dataset.py:19-33); masks
  nearest-resized when not use_original_imgsize.

Support sampling rejects the query image and is seed-stable per episode.
Split files are data, not code — point `splits_dir` at the reference's
`fewshot_data/data/splits` (or your own copies).
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from lseg_tpu_torch.data import transforms as T


def _episode_rng(seed: int, idx: int) -> np.random.RandomState:
    return np.random.RandomState((seed * 1_000_003 + idx) % (2 ** 31 - 1))


def _resize_mask(mask: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbor mask resize matching F.interpolate(mode='nearest')
    (source index = floor(dst * scale))."""
    h, w = mask.shape
    ys = (np.arange(size) * (h / size)).astype(np.int64)
    xs = (np.arange(size) * (w / size)).astype(np.int64)
    return mask[ys][:, xs]


class _FewshotBase:
    """Shared episode assembly: transform images, binarize masks, build
    the batch dict the evaluator consumes."""

    def __init__(self, img_size: int, shot: int, seed: int,
                 imagenet_norm: bool, use_original_imgsize: bool):
        self.img_size = img_size
        self.shot = shot
        self.seed = seed
        self.use_original_imgsize = use_original_imgsize
        self.mean = T.IMAGENET_MEAN if imagenet_norm else T.DEFAULT_MEAN
        self.std = T.IMAGENET_STD if imagenet_norm else T.DEFAULT_STD

    def _img(self, img) -> np.ndarray:
        """PIL image or file path -> (S, S, 3) normalized fp32. Paths go
        through the native C decode+resize+normalize pipeline when the
        library is available (lseg_tpu/data/native.py)."""
        if isinstance(img, str):
            from lseg_tpu_torch.data import native

            out = native.load_image_f32(
                img, (self.img_size, self.img_size), self.mean, self.std
            )
            if out is not None:
                return out
            img = Image.open(img).convert("RGB")
        return T.resize_square(
            img, self.img_size, mean=self.mean, std=self.std
        ).astype(np.float32)

    def _assemble(self, qimg, qmask, qignore, simgs, smasks, cid,
                  name: str) -> Dict:
        if not self.use_original_imgsize:
            qmask = _resize_mask(qmask, self.img_size)
            qignore = _resize_mask(qignore, self.img_size)
        batch = {
            "query_img": self._img(qimg),
            "query_mask": qmask.astype(np.int32),
            "query_ignore": qignore.astype(bool),
            "class_id": np.int32(cid),
            "query_name": name,
        }
        if self.shot:
            batch["support_imgs"] = np.stack(
                [self._img(im) for im in simgs]
            )
            batch["support_masks"] = np.stack(
                [_resize_mask(m, self.img_size) for m in smasks]
            ).astype(np.int32)
        return batch


class DatasetPASCAL(_FewshotBase):
    def __init__(self, datapath: str, fold: int, split: str, shot: int,
                 splits_dir: str, img_size: int = 480,
                 imagenet_norm: bool = False,
                 use_original_imgsize: bool = False, seed: int = 0):
        super().__init__(img_size, shot, seed, imagenet_norm,
                         use_original_imgsize)
        self.split = "val" if split in ("val", "test") else "trn"
        self.fold = fold
        self.nclass, self.nfolds = 20, 4
        self.img_path = os.path.join(datapath, "VOC2012/JPEGImages")
        self.ann_path = os.path.join(
            datapath, "VOC2012/SegmentationClassAug"
        )

        def read_fold(fold_id):
            path = os.path.join(
                splits_dir, "pascal", self.split, f"fold{fold_id}.txt"
            )
            with open(path) as f:
                lines = [l for l in f.read().split("\n") if l]
            return [
                (l.split("__")[0], int(l.split("__")[1]) - 1)
                for l in lines
            ]

        if self.split == "trn":
            self.img_metadata = [
                m for fid in range(self.nfolds) if fid != fold
                for m in read_fold(fid)
            ]
        else:
            self.img_metadata = read_fold(fold)
        self.class_ids = (
            [fold * 5 + i for i in range(5)]
            if self.split == "val"
            else [c for c in range(20) if c // 5 != fold]
        )
        self.classwise: Dict[int, List[str]] = {
            c: [] for c in range(self.nclass)
        }
        for name, c in self.img_metadata:
            self.classwise[c].append(name)

    def __len__(self):
        return len(self.img_metadata) if self.split == "trn" else 1000

    def __getitem__(self, idx: int) -> Dict:
        rng = _episode_rng(self.seed, idx)
        name, cid = self.img_metadata[idx % len(self.img_metadata)]
        supports: List[str] = []
        while len(supports) < self.shot:
            s = self.classwise[cid][rng.randint(len(self.classwise[cid]))]
            if s != name:
                supports.append(s)

        qimg = os.path.join(self.img_path, name + ".jpg")
        raw = np.asarray(
            Image.open(os.path.join(self.ann_path, name + ".png"))
        )
        qignore = raw == 255
        qmask = (raw == cid + 1).astype(np.int32)
        simgs, smasks = [], []
        for s in supports:
            simgs.append(os.path.join(self.img_path, s + ".jpg"))
            sraw = np.asarray(
                Image.open(os.path.join(self.ann_path, s + ".png"))
            )
            smasks.append((sraw == cid + 1).astype(np.int32))
        return self._assemble(qimg, qmask, qignore, simgs, smasks, cid,
                              name)


class DatasetCOCO(_FewshotBase):
    def __init__(self, datapath: str, fold: int, split: str, shot: int,
                 splits_dir: str, img_size: int = 480,
                 imagenet_norm: bool = False,
                 use_original_imgsize: bool = False, seed: int = 0):
        super().__init__(img_size, shot, seed, imagenet_norm,
                         use_original_imgsize)
        self.split = "val" if split in ("val", "test") else "trn"
        self.fold = fold
        self.nclass, self.nfolds = 80, 4
        # names in the split pkl carry the split subdir
        # ('val2014/COCO_val2014_....jpg'), so base is the COCO2014 root
        # (reference coco.py:20-23)
        self.base_path = os.path.join(datapath, "COCO2014")
        with open(os.path.join(
            splits_dir, "coco", self.split, f"fold{fold}.pkl"
        ), "rb") as f:
            self.classwise = pickle.load(f)
        self.class_ids = (
            [fold + 4 * v for v in range(20)]
            if self.split == "val"
            else [c for c in range(80) if (c % 4) != fold]
        )
        self.img_metadata = sorted({
            n for k in self.classwise for n in self.classwise[k]
        })

    def __len__(self):
        return len(self.img_metadata) if self.split == "trn" else 1000

    def __getitem__(self, idx: int) -> Dict:
        rng = _episode_rng(self.seed, idx)
        cid = self.class_ids[rng.randint(len(self.class_ids))]
        pool = self.classwise[cid]
        name = pool[rng.randint(len(pool))]
        supports: List[str] = []
        while len(supports) < self.shot:
            s = pool[rng.randint(len(pool))]
            if s != name:
                supports.append(s)

        def mask_of(n):
            # reference coco.py:83-86: annotations/<name>.png
            p = os.path.join(self.base_path, "annotations", n)
            p = p[: p.index(".jpg")] + ".png"
            return np.asarray(Image.open(p))

        qimg = os.path.join(self.base_path, name)
        raw = mask_of(name)
        qmask = (raw == cid + 1).astype(np.int32)
        qignore = np.zeros_like(qmask, dtype=bool)  # COCO has no 255 rim
        simgs, smasks = [], []
        for s in supports:
            simgs.append(os.path.join(self.base_path, s))
            smasks.append((mask_of(s) == cid + 1).astype(np.int32))
        return self._assemble(qimg, qmask, qignore, simgs, smasks, cid,
                              name)


class DatasetFSS(_FewshotBase):
    def __init__(self, datapath: str, fold: int, split: str, shot: int,
                 splits_dir: str, img_size: int = 480,
                 imagenet_norm: bool = False,
                 use_original_imgsize: bool = False, seed: int = 0):
        super().__init__(img_size, shot, seed, imagenet_norm,
                         use_original_imgsize)
        self.split = split if split in ("trn", "val", "test") else "test"
        self.base_path = os.path.join(datapath, "FSS-1000")
        with open(os.path.join(
            splits_dir, "fss", f"{self.split}.txt"
        )) as f:
            self.categories = sorted([l for l in f.read().split("\n") if l])
        self.class_offset = {"trn": 0, "val": 520, "test": 760}[self.split]
        self.class_ids = list(range(
            self.class_offset, self.class_offset + len(self.categories)
        ))
        self.img_metadata: List[str] = []
        for cat in self.categories:
            paths = sorted(glob.glob(
                os.path.join(self.base_path, cat, "*")
            ))
            jpgs = [p for p in paths
                    if os.path.basename(p).split(".")[-1] == "jpg"]
            if self.split == "test" and shot == 1:
                # query iterates images 2..N; support is always 1.jpg
                jpgs = [p for p in jpgs
                        if os.path.basename(p) != "1.jpg"]
            self.img_metadata.extend(jpgs)

    def __len__(self):
        return len(self.img_metadata)

    def __getitem__(self, idx: int) -> Dict:
        rng = _episode_rng(self.seed, idx)
        qpath = self.img_metadata[idx]
        cat = os.path.basename(os.path.dirname(qpath))
        cid = self.categories.index(cat) + self.class_offset

        supports: List[str] = []
        if self.split == "test" and self.shot == 1:
            supports = [os.path.join(os.path.dirname(qpath), "1.jpg")]
        else:
            while len(supports) < self.shot:
                s = os.path.join(
                    os.path.dirname(qpath), f"{rng.randint(1, 11)}.jpg"
                )
                if s != qpath:
                    supports.append(s)

        def mask_of(p):
            m = np.asarray(Image.open(
                p.rsplit(".", 1)[0] + ".png"
            ).convert("L"))
            return (m >= 128).astype(np.int32)

        qimg = qpath
        qmask = mask_of(qpath)
        qignore = np.zeros_like(qmask, dtype=bool)
        simgs = list(supports)
        smasks = [mask_of(s) for s in supports]
        return self._assemble(qimg, qmask, qignore, simgs, smasks, cid,
                              os.path.relpath(qpath, self.base_path))


BENCHMARKS = {
    "pascal": DatasetPASCAL,
    "coco": DatasetCOCO,
    "fss": DatasetFSS,
}


def build_fewshot_dataset(
    benchmark: str, datapath: str, fold: int, split: str, shot: int,
    splits_dir: str, img_size: int = 480, imagenet_norm: bool = False,
    use_original_imgsize: bool = False, seed: int = 0,
):
    """Factory matching the reference's FSSDataset.build_dataloader
    surface (fewshot_data/data/dataset.py:10-42)."""
    return BENCHMARKS[benchmark](
        datapath=datapath, fold=fold, split=split, shot=shot,
        splits_dir=splits_dir, img_size=img_size,
        imagenet_norm=imagenet_norm,
        use_original_imgsize=use_original_imgsize, seed=seed,
    )
