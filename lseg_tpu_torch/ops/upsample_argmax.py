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
bit. The kernel reads its taps from the tables of `b11_taps` (built from
the plain version's `_h_taps` and `_w_taps`, cached on the card by shape
and dtype) and walks the geometry of `b11_geometry`: strips of output
columns, their source columns rounded out to 16 bytes, the blended row's
pitch and the shared-memory budget.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    load_kernels,
)

_MAX_K = 1536  # the widths the wrapper has always taken
# the kernel's shared memory (csrc/upsample2x_argmax.cu): RING source-row
# slots, two blended rows (one a consumer group), 2 RING barriers and each
# group's 128 pixels' (value, label) of the labels' second half, within one
# SM's 227 KB; strips of at most 128 output columns (a group's pixels)
B11_RING, B11_HB, B11_EXTRA_BYTES = 3, 2, 2 * 3 * 8 + 2 * 128 * 8
B11_SMEM_LIMIT = 232448
B11_WIDTHS = (128, 96, 64, 48, 32, 16, 8, 4, 2)


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


def _round_to(a: np.ndarray, bf16: bool) -> np.ndarray:
    """fp32 weights rounded to the logits' dtype, back in fp32."""
    a = a.astype(np.float32)
    if not bf16:
        return a
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def b11_taps(h: int, w: int, dtype: torch.dtype) -> torch.Tensor:
    """Kernel B11's tap tables: int32 (3, 2h + 2w), per output row (the
    first 2h columns) and per output column (the last 2w) the lower
    source index (`_h_taps`'s i0, `_w_taps`'s lo; the upper one is the
    next, clamped to the edge) and the bits of the two fp32 weights, each
    rounded to `dtype` as the plain version rounds them."""
    bf16 = dtype == torch.bfloat16
    i0, _, w0, w1 = _h_taps(h)
    lo, _, a0, a1 = _w_taps(w)
    idx = np.concatenate([i0, lo]).astype(np.int32)
    wa = _round_to(np.concatenate([w0, a0]), bf16).view(np.int32)
    wb = _round_to(np.concatenate([w1, a1]), bf16).view(np.int32)
    return torch.from_numpy(np.stack([idx, wa, wb]))


@functools.lru_cache(maxsize=64)
def _device_taps(h, w, dtype, device) -> torch.Tensor:
    return b11_taps(h, w, dtype).to(device)


def _ceil16(n: int) -> int:
    return -(-n // 16) * 16


@functools.lru_cache(maxsize=64)
def b11_geometry(w: int, k: int, esize: int, aligned: bool = True) -> dict:
    """Kernel B11's walk at W source columns, K labels of `esize` bytes:
    `cw` output columns a strip (the widest of `B11_WIDTHS` whose buffers
    fit), `strips`, each strip's first source column `c0` and column count
    `ncols` in its ring slot, `q` (a strip's edges rounded out to q
    columns, the columns of 16 bytes; 1 without bulk copies), `bulk` (every
    strip of every row starts and ends on 16 bytes: W % q == 0 on an
    aligned tensor), `pitch` (the blended row's, in elements: the least
    P >= K with P = 2 mod 4), the bytes of a ring `slot` and of an `hb`
    buffer, and `smem`."""
    q = 16 // math.gcd(16, k * esize)
    bulk = aligned and w % q == 0
    if not bulk:
        q = 1
    pitch = k + (2 - k) % 4
    lo = _w_taps(w)[0]
    for cw in B11_WIDTHS:
        strips = -(-2 * w // cw)
        c0s, ncols = [], []
        for s in range(strips):
            j1 = min(s * cw + cw, 2 * w) - 1
            c0 = int(lo[s * cw]) // q * q
            chi = min(int(lo[j1]) + 1, w - 1)
            c1 = min(-(-(chi + 1) // q) * q, w)
            c0s.append(c0)
            ncols.append(c1 - c0)
        nc = max(ncols)
        slot = _ceil16(nc * k * esize)
        hb = _ceil16(nc * pitch * esize)
        smem = B11_RING * slot + B11_HB * hb + B11_EXTRA_BYTES
        if smem <= B11_SMEM_LIMIT:
            return {"cw": cw, "strips": strips, "c0": tuple(c0s),
                    "ncols": tuple(ncols), "q": q, "bulk": bulk,
                    "pitch": pitch, "slot": slot, "hb": hb, "smem": smem}
    raise ValueError(f"upsample2x_argmax kernel: K={k} does not fit")


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
    geo = b11_geometry(w, k, logits.element_size(),
                       logits.data_ptr() % 16 == 0)
    taps = _device_taps(h, w, logits.dtype, logits.device)
    lib = load_kernels()
    out = torch.empty((n, 2 * h, 2 * w), dtype=torch.int32,
                      device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream().cuda_stream
        sms = torch.cuda.get_device_properties(
            logits.device).multi_processor_count
        rc = lib.lseg_upsample2x_argmax(
            logits.data_ptr(), taps.data_ptr(), out.data_ptr(), n, h, w, k,
            int(logits.dtype == torch.bfloat16), geo["cw"], geo["q"],
            geo["pitch"], geo["slot"], geo["hb"], int(geo["bulk"]), sms,
            stream)
    check_launch(lib, "lseg_upsample2x_argmax", rc)
    upsample2x_argmax.launches += 1
    return out


upsample2x_argmax.launches = 0
