"""Label-map visualization: color palettes and overlays.

Equivalent of the reference's `get_new_pallete` / `get_new_mask_pallete`
(reference: lseg_app.py:48-80): the VOC-style palette where each class
color is built from the bits of its index, an indexed-color mask image,
and an alpha overlay for the demo/app surfaces.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def class_palette(num_classes: int) -> np.ndarray:
    """(K, 3) uint8 palette — bit-reversal color coding (each class id's
    bits spread across RGB channel MSBs), the PASCAL VOC convention."""
    pal = np.zeros((num_classes, 3), np.uint8)
    for cid in range(num_classes):
        c = cid
        r = g = b = 0
        for shift in range(8):
            r |= ((c >> 0) & 1) << (7 - shift)
            g |= ((c >> 1) & 1) << (7 - shift)
            b |= ((c >> 2) & 1) << (7 - shift)
            c >>= 3
        pal[cid] = (r, g, b)
    return pal


def colorize(mask: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """(H, W) int labels -> (H, W, 3) uint8 colors."""
    return palette[np.clip(mask, 0, len(palette) - 1)]


def overlay(
    image_u8: np.ndarray, mask: np.ndarray, palette: np.ndarray,
    alpha: float = 0.5,
) -> np.ndarray:
    """Blend the colorized mask over the RGB image."""
    colors = colorize(mask, palette).astype(np.float32)
    out = (1 - alpha) * image_u8.astype(np.float32) + alpha * colors
    return np.clip(out, 0, 255).astype(np.uint8)


def legend_patches(
    mask: np.ndarray, labels: Sequence[str], palette: np.ndarray
) -> List[Tuple[str, Tuple[int, int, int]]]:
    """(label, color) pairs for the classes present in `mask` — feeds
    the matplotlib legend in the app (reference: lseg_app.py:66-78)."""
    out = []
    for cid in np.unique(mask):
        if 0 <= cid < len(labels):
            out.append((labels[cid], tuple(int(v) for v in palette[cid])))
    return out
