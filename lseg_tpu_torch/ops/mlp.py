"""Fused int8 transformer MLP (kernel B16).

Replaces `lseg_tpu/ops/pallas_mlp.py` · `mlp_fused`: int8 fc1, tanh GELU,
per-row int8 requantize of the hidden, int8 fc2, bias and residual, the
`vit.mlp_fused` path of the ViT block. The CUDA source is
`lseg_tpu_torch/csrc/mlp_fused.cu`, one launch of a thread-block cluster
per 64-row tile that keeps the hidden on chip, as the TPU kernel does:
fc1 runs once and the hidden codes never touch device memory (the
cluster's CTAs share each row's amax and their slices of the codes
through distributed shared memory). Its header says what bounds it on
the card. The kernel takes the MLP widths of a ViT (`KERNEL_WIDTHS`).

`mlp_fused` is the wrapper: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs `mlp_fused_plain`, which keeps the TPU
kernel's rounding points (`pallas_mlp.py` · `_kernel`): the fc1 output is
dequantized in fp32 and goes through the GELU with no bf16 rounding, the
requantize scale is the row's amax over all H hidden values, and the
residual is added to the fp32 fc2 output before the one cast to bf16.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    check_operands,
    load_kernels,
)
from lseg_tpu_torch.ops.quant import int8_mm, quantize_rows

# The kernel's widths: a cluster of D / 128 CTAs (at most 8, the portable
# cluster size) per row tile, each owning 128 output and 512 hidden
# columns, so H = 4 D (a ViT's MLP ratio) with D a multiple of 128 up to
# 1024: ViT-L/16's (1024, 4096), ViT-B's (768, 3072).
KERNEL_WIDTHS = ("H = 4 D with D a multiple of 128 from 128 to 1024, "
                 "e.g. (1024, 4096) or (768, 3072)")


def check_kernel_widths(d: int, h: int) -> None:
    """Raise ValueError unless the kernel takes (D, H)."""
    if h != 4 * d or d % 128 or not 128 <= d <= 1024:
        raise ValueError(f"mlp_fused kernel takes {KERNEL_WIDTHS}; got "
                         f"D {d}, H {h}")


def _check(xq, sx, resid, w1q, s1, b1, w2q, s2, b2):
    n, t, d = xq.shape
    h = w1q.shape[0]
    want = {"sx": (n, t, 1), "resid": (n, t, d), "w1q": (h, d),
            "s1": (h,), "b1": (h,), "w2q": (d, h), "s2": (d,), "b2": (d,)}
    got = {"sx": sx, "resid": resid, "w1q": w1q, "s1": s1, "b1": b1,
           "w2q": w2q, "s2": s2, "b2": b2}
    for name, v in got.items():
        if tuple(v.shape) != want[name]:
            raise ValueError(f"mlp_fused: {name} {tuple(v.shape)}, expected "
                             f"{want[name]} for codes {tuple(xq.shape)}")
    check_operands("mlp_fused", {
        "xq": (xq, torch.int8), "sx": (sx, torch.float32),
        "resid": (resid, torch.bfloat16), "w1q": (w1q, torch.int8),
        "s1": (s1, torch.float32), "b1": (b1, torch.float32),
        "w2q": (w2q, torch.int8), "s2": (s2, torch.float32),
        "b2": (b2, torch.float32)})
    return n, t, d, h


def mlp_fused_plain(xq: torch.Tensor, sx: torch.Tensor, resid: torch.Tensor,
                    w1q: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                    w2q: torch.Tensor, s2: torch.Tensor,
                    b2: torch.Tensor) -> torch.Tensor:
    """resid + fc2(requant(gelu(fc1(x)))): (N, T, D) int8 row codes,
    (N, T, 1) fp32 row scales, (N, T, D) residual; int8 (H, D) fc1 and
    (D, H) fc2 weights with fp32 per-output-channel scales and biases ->
    (N, T, D) bf16."""
    check_no_grad("mlp_fused_plain", sx, resid, s1, b1, s2, b2)
    n, t, d, _ = _check(xq, sx, resid, w1q, s1, b1, w2q, s2, b2)
    h = (int8_mm(xq.reshape(n * t, d), w1q).float() * sx.reshape(-1, 1)
         * s1.reshape(1, -1) + b1.reshape(1, -1))
    hq, sh = quantize_rows(F.gelu(h, approximate="tanh"))
    y = (int8_mm(hq, w2q).float() * sh * s2.reshape(1, -1)
         + b2.reshape(1, -1))
    return (y + resid.reshape(n * t, d).float()).to(torch.bfloat16).reshape(
        n, t, d)


def mlp_fused(xq: torch.Tensor, sx: torch.Tensor, resid: torch.Tensor,
              w1q: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
              w2q: torch.Tensor, s2: torch.Tensor,
              b2: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper (B16): int8 (N, T, D) codes, fp32 (N, T, 1) row
    scales, bf16 (N, T, D) residual, int8 (H, D) and (D, H) weights, fp32
    scales and biases -> (N, T, D) bf16. On the card (D, H) must be
    kernel widths (`check_kernel_widths`); any T."""
    check_no_grad("mlp_fused", sx, resid, s1, b1, s2, b2)
    n, t, d, h = _check(xq, sx, resid, w1q, s1, b1, w2q, s2, b2)
    if xq.device.type == "cpu":
        return mlp_fused_plain(xq, sx, resid, w1q, s1, b1, w2q, s2, b2)
    if xq.device.type != "cuda":
        raise ValueError(f"mlp_fused: unsupported device {xq.device}")
    check_kernel_widths(d, h)
    lib = load_kernels()
    out = torch.empty((n, t, d), dtype=torch.bfloat16, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_mlp_fused(
            xq.data_ptr(), sx.data_ptr(), resid.data_ptr(), w1q.data_ptr(),
            s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(), s2.data_ptr(),
            b2.data_ptr(), out.data_ptr(), n * t, d, h, None, stream)
    check_launch(lib, "lseg_mlp_fused", rc)
    mlp_fused.launches += 1
    return out


mlp_fused.launches = 0


def mlp_fused_max_clusters(d: int, device) -> int:
    """The most clusters of the kernel at width `d` that `device` holds at
    once (cudaOccupancyMaxActiveClusters)."""
    check_kernel_widths(d, 4 * d)
    lib = load_kernels()
    clusters = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = lib.lseg_mlp_fused(*(None,) * 10, 0, d, 4 * d,
                                ctypes.byref(clusters), None)
    check_launch(lib, "lseg_mlp_fused", rc)
    return clusters.value
