"""Fused LayerNorm + per-row int8 quantize (kernel B3).

Replaces `lseg_tpu/ops/pallas_ln.py` · `ln_quantize_rows`. The CUDA
kernel is `lseg_tpu_torch/csrc/ln_quantize_rows.cu` (arithmetic in
`csrc/ln_quantize.cuh`, shared with B2); its header says what bounds it on
the card (bytes) and how the design reads each row once.

`ln_quantize_rows` is the wrapper: on a CUDA tensor it launches the kernel
(or raises), on a CPU tensor it runs `ln_quantize_rows_plain`, the plain
PyTorch version: fp32 LayerNorm, then `quant.quantize_rows`. The int8
product that consumes the codes is `quant.int8_matmul_preact`.
"""

from __future__ import annotations

import torch

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    load_kernels,
)
from lseg_tpu_torch.ops.quant import quantize_rows


def ln_quantize_rows_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                           ln_bias: torch.Tensor, eps: float = 1e-6):
    """(..., D) -> (int8 codes (..., D), fp32 row scales (..., 1)) of
    LayerNorm(x) computed in fp32: mean, centred variance,
    ((x - mu) * rsqrt(var + eps)) * g + b."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    xn = xc * torch.rsqrt(var + eps) * ln_scale.float() + ln_bias.float()
    return quantize_rows(xn)


def ln_quantize_rows(x: torch.Tensor, ln_scale: torch.Tensor,
                     ln_bias: torch.Tensor, eps: float = 1e-6):
    """Kernel wrapper: (N, T, D) bf16 contiguous, (D,) fp32 scale and bias
    -> (int8 (N, T, D), fp32 (N, T, 1)). Any T; D % 256 == 0, D <= 2048."""
    check_no_grad("ln_quantize_rows", x, ln_scale, ln_bias)
    n, t, d = x.shape
    if ln_scale.shape != (d,) or ln_bias.shape != (d,):
        raise ValueError(f"ln_quantize_rows: LayerNorm params "
                         f"{tuple(ln_scale.shape)} for width {d}")
    if x.device.type == "cpu":
        return ln_quantize_rows_plain(x, ln_scale, ln_bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"ln_quantize_rows: unsupported device {x.device}")
    if (x.dtype, ln_scale.dtype, ln_bias.dtype) != (
            torch.bfloat16, torch.float32, torch.float32):
        raise TypeError("ln_quantize_rows kernel takes bf16 x and fp32 "
                        f"params, got {x.dtype}, {ln_scale.dtype}, "
                        f"{ln_bias.dtype}")
    if d % 256 or d > 2048:
        raise ValueError(f"ln_quantize_rows kernel needs D % 256 == 0 and "
                         f"D <= 2048, got {d}")
    for name, v in (("x", x), ("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        if not v.is_contiguous() or v.data_ptr() % 16 or v.device != x.device:
            raise ValueError(f"ln_quantize_rows: {name} must be contiguous, "
                             f"16-byte aligned and on {x.device}")
    lib = load_kernels()
    q = torch.empty((n, t, d), dtype=torch.int8, device=x.device)
    s = torch.empty((n, t, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_ln_quantize_rows(x.data_ptr(), ln_scale.data_ptr(),
                                       ln_bias.data_ptr(), q.data_ptr(),
                                       s.data_ptr(), n * t, d, float(eps),
                                       stream)
    check_launch(lib, "lseg_ln_quantize_rows", rc)
    ln_quantize_rows.launches += 1
    return q, s


ln_quantize_rows.launches = 0
