"""Fused x2 bilinear (align_corners=True) upsample + argmax over K
(kernel B11).

Replaces `lseg_tpu/ops/pallas_upsample_argmax.py` · `upsample2x_argmax`
and `upsample2x_argmax_v2` (the same function in another TPU layout), the
label head of the `use_pallas=True` serving path. The CUDA kernel is
`lseg_tpu_torch/csrc/upsample2x_argmax.cu`; its header gives the rounding
points, what bounds it on the card, and how the full-resolution logits
stay out of device memory.

`upsample2x_argmax` is the wrapper: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs `upsample2x_argmax_plain`,
which rounds at the same points and so agrees with the kernel bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    load_kernels,
)

_MAX_K = 1536  # the kernel's blended source columns fit in shared memory


def _h_taps(h: int):
    """Rows i0, i1 and weights of each of the 2h output rows, as the TPU
    kernel builds them: src = o * ((h-1)/(2h-1)) in fp32, row i weighs
    max(0, 1 - |src - i|)."""
    src = np.arange(2 * h, dtype=np.float32) * (
        np.float32(h - 1) / np.float32(2 * h - 1))
    i0 = np.minimum(np.floor(src).astype(np.int64), h - 1)
    w0 = np.maximum(np.float32(0), np.float32(1) - np.abs(
        src - i0.astype(np.float32)))
    w1 = np.maximum(np.float32(0), np.float32(1) - np.abs(
        src - (i0 + 1).astype(np.float32)))
    w1 = np.where(i0 + 1 < h, w1, np.float32(0)).astype(np.float32)
    return i0, np.minimum(i0 + 1, h - 1), w0, w1


def _w_taps(w: int):
    """Columns lo, lo + 1 and weights of each of the 2w output columns:
    the rows of `ops.resize._interp_matrix(w, 2w, True)` (float64 source
    position, weights rounded to fp32)."""
    if w == 1:
        zero = np.zeros(2, np.int64)
        return zero, zero, np.ones(2, np.float32), np.zeros(2, np.float32)
    src = np.arange(2 * w, dtype=np.float64) * (w - 1) / (2 * w - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, w - 2)
    frac = src - lo
    return lo, lo + 1, (1.0 - frac).astype(np.float32), frac.astype(
        np.float32)


def upsample2x_argmax_plain(logits: torch.Tensor) -> torch.Tensor:
    """(N, H, W, K) fp32 or bf16 -> (N, 2H, 2W) int32: the H blend of two
    rows rounded to the input dtype, the W blend in fp32, the first argmax
    over K. Weights are rounded to the input dtype; every product and sum
    rounds on its own."""
    n, h, w, k = logits.shape
    dt, dev = logits.dtype, logits.device

    def weights(a):
        return torch.from_numpy(a).to(dev).to(dt).float()

    i0, i1, w0, w1 = _h_taps(h)
    i0, i1 = torch.from_numpy(i0).to(dev), torch.from_numpy(i1).to(dev)
    w0, w1 = weights(w0)[:, None, None], weights(w1)[:, None, None]
    hb = (w0 * logits[:, i0].float() + w1 * logits[:, i1].float()).to(dt)
    lo, hi, a0, a1 = _w_taps(w)
    lo, hi = torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev)
    a0, a1 = weights(a0)[:, None], weights(a1)[:, None]
    up = a0 * hb[:, :, lo].float() + a1 * hb[:, :, hi].float()
    return torch.argmax(up, dim=-1).to(torch.int32)


def upsample2x_argmax(logits: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper: (N, H, W, K) fp32 or bf16 logits -> (N, 2H, 2W)
    int32 labels, argmax_K of the x2 align-corners bilinear upsample,
    without the upsampled logits. K <= 1536."""
    check_no_grad("upsample2x_argmax", logits)
    if logits.device.type == "cpu":
        return upsample2x_argmax_plain(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"upsample2x_argmax: unsupported device "
                         f"{logits.device}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"upsample2x_argmax kernel takes fp32 or bf16 "
                        f"logits, got {logits.dtype}")
    n, h, w, k = logits.shape
    if k > _MAX_K or 2 * h > 65535 or n > 65535:
        raise ValueError(f"upsample2x_argmax kernel needs K <= {_MAX_K}, "
                         f"2H <= 65535 and N <= 65535, got "
                         f"{tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("upsample2x_argmax: logits must be contiguous")
    lib = load_kernels()
    out = torch.empty((n, 2 * h, 2 * w), dtype=torch.int32,
                      device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_upsample2x_argmax(logits.data_ptr(), out.data_ptr(),
                                        n, h, w, k,
                                        int(logits.dtype == torch.bfloat16),
                                        stream)
    check_launch(lib, "lseg_upsample2x_argmax", rc)
    upsample2x_argmax.launches += 1
    return out


upsample2x_argmax.launches = 0
