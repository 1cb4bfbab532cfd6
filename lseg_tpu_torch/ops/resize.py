"""Bilinear resize as separable interpolation matmuls (torch port of
`lseg_tpu/ops/resize.py`).

The same dense 1-D operators as the reference, applied over H then W:

    out = A_h @ x @ A_w^T        (per image and channel)

`align_corners=True` serves the fusion-block and output-head x2
upsamples; `align_corners=False` (half-pixel centres) the position-
embedding grid resize. Tensors are NHWC, as in the reference.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _interp_matrix(in_size: int, out_size: int,
                   align_corners: bool) -> np.ndarray:
    """Dense (out_size, in_size) 1-D linear interpolation operator
    matching torch.nn.functional.interpolate(mode='bilinear')."""
    a = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        a[:, 0] = 1.0
        return a
    if align_corners:
        if out_size == 1:
            a[0, 0] = 1.0
            return a
        src = (np.arange(out_size, dtype=np.float64) * (in_size - 1)
               / (out_size - 1))
    else:
        src = ((np.arange(out_size, dtype=np.float64) + 0.5) * in_size
               / out_size - 0.5)
        src = np.clip(src, 0.0, in_size - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, in_size - 2)
    frac = src - lo
    a[np.arange(out_size), lo] = (1.0 - frac).astype(np.float32)
    a[np.arange(out_size), lo + 1] = frac.astype(np.float32)
    return a


def interp_matrix(in_size: int, out_size: int, align_corners: bool,
                  dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(
        _interp_matrix(in_size, out_size, align_corners)).to(
            device=device, dtype=dtype)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int,
                    align_corners: bool = True,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Bilinearly resize an NHWC (or HWC) tensor to (out_h, out_w).

    Computes in `compute_dtype` (each interp matmul rounds to it, as the
    reference's einsums do) and returns the input dtype."""
    squeeze = x.dim() == 3
    if squeeze:
        x = x[None]
    _, h, w, _ = x.shape
    if (h, w) != (out_h, out_w):
        dt = x.dtype
        xf = x.to(compute_dtype)
        if h != out_h:
            ah = interp_matrix(h, out_h, align_corners, compute_dtype,
                               x.device)
            xf = torch.einsum("oh,nhwc->nowc", ah, xf)
        if w != out_w:
            aw = interp_matrix(w, out_w, align_corners, compute_dtype,
                               x.device)
            xf = torch.einsum("ow,nhwc->nhoc", aw, xf)
        x = xf.to(dt)
    return x[0] if squeeze else x


def upsample2x(x: torch.Tensor, align_corners: bool = True,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x2 bilinear upsample of an NHWC tensor."""
    _, h, w, _ = x.shape
    return resize_bilinear(x, 2 * h, 2 * w, align_corners=align_corners,
                           compute_dtype=compute_dtype)
