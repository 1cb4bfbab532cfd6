"""Fused int8 transformer MLP (kernel B16).

Replaces `lseg_tpu/ops/pallas_mlp.py` · `mlp_fused`: int8 fc1, tanh GELU,
per-row int8 requantize of the hidden, int8 fc2, bias and residual, the
`vit.mlp_fused` path of the ViT block. The CUDA source is
`lseg_tpu_torch/csrc/mlp_fused.cu`, a chain of three launches behind one
op; its header says what bounds it on the card and which tensors pass
through device memory that the TPU kept on chip.

`mlp_fused` is the wrapper: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs `mlp_fused_plain`, which keeps the TPU
kernel's rounding points (`pallas_mlp.py` · `_kernel`): the fc1 output is
dequantized in fp32 and goes through the GELU with no bf16 rounding, the
requantize scale is the row's amax over all H hidden values, and the
residual is added to the fp32 fc2 output before the one cast to bf16.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    check_operands,
    load_kernels,
)
from lseg_tpu_torch.ops.quant import int8_mm, quantize_rows


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
    scales and biases -> (N, T, D) bf16. D % 128 == 0, H % 128 == 0, any
    T."""
    check_no_grad("mlp_fused", sx, resid, s1, b1, s2, b2)
    n, t, d, h = _check(xq, sx, resid, w1q, s1, b1, w2q, s2, b2)
    if xq.device.type == "cpu":
        return mlp_fused_plain(xq, sx, resid, w1q, s1, b1, w2q, s2, b2)
    if xq.device.type != "cuda":
        raise ValueError(f"mlp_fused: unsupported device {xq.device}")
    if d % 128 or h % 128:
        raise ValueError(f"mlp_fused kernel needs D and H multiples of 128, "
                         f"got D {d}, H {h}")
    lib = load_kernels()
    dev = xq.device
    m = n * t
    pm = torch.empty((m, h // 128), dtype=torch.float32, device=dev)
    hq = torch.empty((m, h), dtype=torch.int8, device=dev)
    sh = torch.empty((m,), dtype=torch.float32, device=dev)
    out = torch.empty((n, t, d), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_mlp_fused(
            xq.data_ptr(), sx.data_ptr(), resid.data_ptr(), w1q.data_ptr(),
            s1.data_ptr(), b1.data_ptr(), w2q.data_ptr(), s2.data_ptr(),
            b2.data_ptr(), pm.data_ptr(), hq.data_ptr(), sh.data_ptr(),
            out.data_ptr(), m, d, h, stream)
    check_launch(lib, "lseg_mlp_fused", rc)
    mlp_fused.launches += 1
    return out


mlp_fused.launches = 0
