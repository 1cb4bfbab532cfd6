"""Host-side image/mask preprocessing.

Replaces the reference's torchvision/cv2 transform stack
(reference: modules/lseg_module.py:37-53 — ToTensor + Normalize(0.5,0.5);
training augmentation comes from PyTorch-Encoding's BaseDataset sync
transforms; fewshot_data/data/dataset.py:31-33 — Resize(480,480)+norm).

All functions are NumPy/PIL only (no torch): they run in loader worker
threads and feed fixed-shape fp32 NHWC batches to the device. The
augmentation recipe matches the encoding-package semantics the reference
trains with:

    train: random hflip; random long-side scale in [0.5, 2.0]*base_size
           (aspect preserved); pad to >= crop (image: 0 pre-norm, mask:
           ignore); random crop to crop×crop
    val:   center-crop protocol — resize short side to crop, center crop
    testval: original size, mask only shifted (label 0 -> ignore)
"""

from __future__ import annotations

import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image

DEFAULT_MEAN = (0.5, 0.5, 0.5)
DEFAULT_STD = (0.5, 0.5, 0.5)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize(
    img: np.ndarray,
    mean: Tuple[float, float, float] = DEFAULT_MEAN,
    std: Tuple[float, float, float] = DEFAULT_STD,
) -> np.ndarray:
    """uint8/float (H,W,3) -> normalized fp32: (x/255 - mean)/std."""
    x = img.astype(np.float32)
    if img.dtype == np.uint8:
        x = x / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def pil_resize(
    img: Image.Image, size_hw: Tuple[int, int], is_mask: bool
) -> Image.Image:
    return img.resize(
        (size_hw[1], size_hw[0]),
        Image.NEAREST if is_mask else Image.BILINEAR,
    )


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) INTER_AREA operator for one axis, replicating
    cv2's construction exactly (resize.cpp): shrink rows are the
    pixel-area coverage of the output box [i*s, (i+1)*s) with cv2's
    1e-3 partial-cell threshold; zoom rows are cv2's two-tap
    (1-fx, fx) form — including its floating-point boundary behavior
    (scale computed as 1/inv_scale, ties floored). cv2-oracle-tested
    to the uint8 rounding ulp in tests/test_utils_misc.py."""
    inv = n_out / n_in
    s = 1.0 / inv
    w = np.zeros((n_out, n_in), np.float64)
    if n_out >= n_in:  # zoom (or identity): cv2's area-upscale taps
        for i in range(n_out):
            sx = int(np.floor(i * s))
            fx = (i + 1) - (sx + 1) * inv
            fx = 0.0 if fx <= 0 else fx - np.floor(fx)
            sx = min(sx, n_in - 1)
            w[i, sx] += 1.0 - fx
            w[i, min(sx + 1, n_in - 1)] += fx
        return w
    for i in range(n_out):  # shrink: exact area cells
        fsx1 = i * s
        fsx2 = fsx1 + s
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        if sx1 - fsx1 > 1e-3 and sx1 >= 1:
            w[i, sx1 - 1] = sx1 - fsx1
        for j in range(sx1, min(sx2, n_in)):
            w[i, j] = 1.0
        if fsx2 - sx2 > 1e-3 and sx2 < n_in:
            w[i, sx2] = fsx2 - sx2
        w[i] /= w[i].sum()
    return w


def area_resize(arr: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """cv2.INTER_AREA-equivalent resize of an (H, W[, C]) array via
    separable area-coverage matmuls (reference default interpolation
    of the DPT Resize util: utils.py:211,332). Matches cv2 bit-for-bit
    up to its fixed-point rounding (+-1 for uint8) when both axes
    scale the same direction — the keep-aspect regime the reference
    uses it in; mixed shrink/zoom axes deviate from cv2 (which
    special-cases them) and are handled upstream."""
    ih, iw = arr.shape[:2]
    out = np.einsum("oi,i...->o...", _area_weights(ih, oh),
                    arr.astype(np.float64))          # (oh, iw, ...)
    out = np.einsum("pj,oj...->op...", _area_weights(iw, ow),
                    out)                             # (oh, ow, ...)
    if arr.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(arr.dtype)


def train_transform(
    img: Image.Image,
    mask: Image.Image,
    base_size: int,
    crop_size: int,
    *,
    rng: Optional[random.Random] = None,
    mean=DEFAULT_MEAN,
    std=DEFAULT_STD,
    ignore_index: int = -1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synchronized random-scale/flip/crop augmentation -> fixed
    (crop, crop, 3) fp32 + (crop, crop) int32."""
    rng = rng or random
    if rng.random() < 0.5:
        img = img.transpose(Image.FLIP_LEFT_RIGHT)
        mask = mask.transpose(Image.FLIP_LEFT_RIGHT)

    w, h = img.size
    long_size = int(base_size * (0.5 + rng.random() * 1.5))  # [0.5, 2.0)
    if h > w:
        oh, ow = long_size, max(1, int(w * long_size / h + 0.5))
    else:
        ow, oh = long_size, max(1, int(h * long_size / w + 0.5))
    img = pil_resize(img, (oh, ow), is_mask=False)
    mask = pil_resize(mask, (oh, ow), is_mask=True)

    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    m = np.asarray(mask, dtype=np.int32)

    ph, pw = max(crop_size - oh, 0), max(crop_size - ow, 0)
    if ph or pw:
        arr = np.pad(arr, ((0, ph), (0, pw), (0, 0)))
        m = np.pad(m, ((0, ph), (0, pw)), constant_values=ignore_index)

    hh, ww = arr.shape[:2]
    y0 = rng.randint(0, hh - crop_size) if hh > crop_size else 0
    x0 = rng.randint(0, ww - crop_size) if ww > crop_size else 0
    arr = arr[y0: y0 + crop_size, x0: x0 + crop_size]
    m = m[y0: y0 + crop_size, x0: x0 + crop_size]
    return normalize(arr, mean, std), m


def val_transform(
    img: Image.Image,
    mask: Image.Image,
    crop_size: int,
    *,
    mean=DEFAULT_MEAN,
    std=DEFAULT_STD,
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic: resize short side to crop, center crop."""
    w, h = img.size
    if w > h:
        oh, ow = crop_size, int(w * crop_size / h + 0.5)
    else:
        ow, oh = crop_size, int(h * crop_size / w + 0.5)
    img = pil_resize(img, (oh, ow), is_mask=False)
    mask = pil_resize(mask, (oh, ow), is_mask=True)
    y0, x0 = (oh - crop_size) // 2, (ow - crop_size) // 2
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = arr[y0: y0 + crop_size, x0: x0 + crop_size]
    m = np.asarray(mask, dtype=np.int32)[
        y0: y0 + crop_size, x0: x0 + crop_size
    ]
    return normalize(arr, mean, std), m


def resize_square(
    img: Image.Image,
    size: int,
    *,
    mean=DEFAULT_MEAN,
    std=DEFAULT_STD,
) -> np.ndarray:
    """The few-shot pipeline's Resize((size, size)) + normalize
    (reference: fewshot_data/data/dataset.py:31-33)."""
    arr = np.asarray(pil_resize(img, (size, size), is_mask=False),
                     dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    return normalize(arr, mean, std)


class KeepAspectResize:
    """DPT-style host resize policy (reference: utils.py:200-368): target
    (width, height) with keep-aspect option, size constrained to a
    multiple of `ensure_multiple_of`, and 'lower_bound' / 'upper_bound' /
    'minimal' resize methods."""

    def __init__(self, width: int, height: int, keep_aspect: bool = True,
                 ensure_multiple_of: int = 32,
                 resize_method: str = "lower_bound",
                 letter_box: bool = False,
                 interpolation: str = "area"):
        self.w, self.h = width, height
        self.keep_aspect = keep_aspect
        self.m = ensure_multiple_of
        self.method = resize_method
        self.letter_box = letter_box
        if interpolation not in ("area", "bilinear"):
            raise ValueError(interpolation)
        self.interpolation = interpolation

    def _letter_box(self, arr: np.ndarray) -> np.ndarray:
        """Zero-pad symmetrically toward (self.h, self.w) (reference:
        utils.py:315-321 make_letter_box). Each side gets
        (target - current) // 2, so an odd difference leaves the
        result one pixel short of the target — the reference quirk is
        kept exactly."""
        # clamp at 0: with resize_method='lower_bound' the resized
        # image EXCEEDS the target, so there is nothing to pad (the
        # reference's cv2.copyMakeBorder would reject negative borders
        # — letterbox is meant for the upper_bound/minimal methods)
        top = max(0, (self.h - arr.shape[0]) // 2)
        left = max(0, (self.w - arr.shape[1]) // 2)
        pad = [(top, top), (left, left)] + [(0, 0)] * (arr.ndim - 2)
        return np.pad(arr, pad, mode="constant")

    def _mult(self, x: float, min_val: int = 0, max_val=None) -> int:
        y = int(np.round(x / self.m) * self.m)
        if max_val is not None and y > max_val:
            y = int(np.floor(x / self.m) * self.m)
        if y < min_val:
            y = int(np.ceil(x / self.m) * self.m)
        return y

    def get_size(self, width: int, height: int) -> Tuple[int, int]:
        sw, sh = self.w / width, self.h / height
        if self.keep_aspect:
            if self.method == "lower_bound":
                s = max(sw, sh)
            elif self.method == "upper_bound":
                s = min(sw, sh)
            elif self.method == "minimal":
                s = sh if abs(1 - sh) < abs(1 - sw) else sw
            else:
                raise ValueError(self.method)
            sw = sh = s
        if self.method == "lower_bound":
            oh = self._mult(sh * height, min_val=self.h)
            ow = self._mult(sw * width, min_val=self.w)
        elif self.method == "upper_bound":
            oh = self._mult(sh * height, max_val=self.h)
            ow = self._mult(sw * width, max_val=self.w)
        else:
            oh = self._mult(sh * height)
            ow = self._mult(sw * width)
        return ow, oh

    def __call__(self, img: Image.Image) -> Image.Image:
        ow, oh = self.get_size(*img.size)
        iw, ih = img.size
        same_dir = (oh <= ih) == (ow <= iw)
        if self.interpolation == "area" and same_dir:
            # the reference's cv2.INTER_AREA default (utils.py:211,332)
            out = Image.fromarray(area_resize(np.asarray(img), oh, ow))
        else:
            # mixed shrink/zoom axes (cv2 special-cases these; cannot
            # happen with keep_aspect) or explicit 'bilinear': PIL path
            out = pil_resize(img, (oh, ow), is_mask=False)
        if self.letter_box:
            out = Image.fromarray(self._letter_box(np.asarray(out)))
        return out
