"""Fused int8 head1 projection + image-text correlation: kernel B4
(logits) and kernel B5 (labels, the argmax over K in the kernel).

B4 replaces `lseg_tpu/ops/pallas_correlation.py` · `head1_correlate_fused`
(CUDA: `lseg_tpu_torch/csrc/head1_correlate.cu`); B5 replaces
`head1_correlate_argmax_fused_t` and its row-major form B12
`head1_correlate_argmax_fused` (CUDA:
`lseg_tpu_torch/csrc/head1_correlate_argmax.cu`). The two kernels share
their tile code (`csrc/head1_tile.cuh`); the sources' headers say what
bounds each on the card and how the (M, 512) pixel-embedding map stays
out of device memory.

`head1_correlate_fused` and `head1_correlate_argmax_fused` are the
wrappers: on a CUDA tensor they launch their kernel (or raise), on a CPU
tensor they run their `_plain` twin. All take the same host-side
preparation as the reference's wrappers: the text matrix L2-normalised in
fp32, times the temperature (B4 only), cast to bf16 (`text_matrix`), and
the fp32 product sx * s1 of the activation scale and the per-channel
weight scales.
"""

from __future__ import annotations

import torch

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    load_kernels,
)
from lseg_tpu_torch.ops.quant import int8_mm


def text_matrix(text_features: torch.Tensor,
                logit_scale: float) -> torch.Tensor:
    """(K, E) -> bf16 logit_scale * t / max(|t|, 1e-12), the norm taken
    as rsqrt(max(sum(t^2), 1e-24)) in fp32."""
    t = text_features.float()
    inv = torch.rsqrt(torch.clamp((t * t).sum(dim=-1, keepdim=True),
                                  min=1e-24))
    return (logit_scale * (t * inv)).to(torch.bfloat16)


def _prepare(xq, sx, w1q, s1, b1, text_features, logit_scale):
    n, h, w, c = xq.shape
    e = w1q.shape[0]
    w1q = w1q.reshape(e, -1)
    if w1q.shape[1] != c or s1.shape != (e,) or b1.shape != (e,) or (
            text_features.dim() != 2 or text_features.shape[1] != e):
        raise ValueError(
            f"head1_correlate: codes {tuple(xq.shape)}, kernel "
            f"{tuple(w1q.shape)}, scales {tuple(s1.shape)}, bias "
            f"{tuple(b1.shape)}, text {tuple(text_features.shape)}")
    sc = torch.as_tensor(sx, dtype=torch.float32,
                         device=s1.device).reshape(1) * s1.float()
    return (n, h, w, c, e), w1q, sc, text_matrix(text_features, logit_scale)


def head1_correlate_fused_plain(xq: torch.Tensor, sx, w1q: torch.Tensor,
                                s1: torch.Tensor, b1: torch.Tensor,
                                text_features: torch.Tensor,
                                logit_scale: float = 1.0 / 0.07,
                                normalize: bool = True) -> torch.Tensor:
    """(N, H, W, C) int8 codes -> (N, H, W, K) bf16 logits:
    e = acc * (sx * s1) + b1 in fp32, then bf16(e) . tn^T in fp32, times
    rsqrt(max(sum(e^2), 1e-24)) when `normalize`, cast to bf16."""
    (n, h, w, c, e), w1q, sc, tn = _prepare(xq, sx, w1q, s1, b1,
                                            text_features, logit_scale)
    acc = int8_mm(xq.reshape(-1, c), w1q)
    ef = acc.float() * sc + b1.float()
    lo = torch.matmul(ef.to(torch.bfloat16).float(), tn.float().t())
    if normalize:
        lo = lo * torch.rsqrt(torch.clamp((ef * ef).sum(dim=-1, keepdim=True),
                                          min=1e-24))
    return lo.to(torch.bfloat16).reshape(n, h, w, -1)


def head1_correlate_fused(xq: torch.Tensor, sx, w1q: torch.Tensor,
                          s1: torch.Tensor, b1: torch.Tensor,
                          text_features: torch.Tensor,
                          logit_scale: float = 1.0 / 0.07,
                          normalize: bool = True) -> torch.Tensor:
    """Kernel wrapper: (N, H, W, C) int8 codes, fp32 scalar activation
    scale, head1 int8 kernel (E, C[, 1, 1]), fp32 (E,) scales and bias,
    (K, E) text features -> (N, H, W, K) bf16. C % 32 == 0,
    E % 128 == 0."""
    check_no_grad("head1_correlate_fused", sx, s1, b1, text_features)
    if xq.device.type == "cpu":
        return head1_correlate_fused_plain(xq, sx, w1q, s1, b1,
                                           text_features, logit_scale,
                                           normalize)
    if xq.device.type != "cuda":
        raise ValueError(f"head1_correlate_fused: unsupported device "
                         f"{xq.device}")
    (n, h, w, c, e), w1q, sc, tn = _prepare(xq, sx, w1q, s1, b1,
                                            text_features, logit_scale)
    if xq.dtype != torch.int8 or w1q.dtype != torch.int8:
        raise TypeError(f"head1_correlate_fused kernel takes int8 codes and "
                        f"kernel, got {xq.dtype}, {w1q.dtype}")
    if c % 32 or e % 128:
        raise ValueError(f"head1_correlate_fused kernel needs C % 32 == 0 "
                         f"and E % 128 == 0, got C={c}, E={e}")
    b1 = b1.float().contiguous()
    args = {"xq": xq, "w1q": w1q, "sc": sc, "b1": b1, "tn": tn}
    for name, v in args.items():
        if not v.is_contiguous() or v.data_ptr() % 16 or v.device != xq.device:
            raise ValueError(f"head1_correlate_fused: {name} must be "
                             f"contiguous, 16-byte aligned and on "
                             f"{xq.device}")
    k = tn.shape[0]
    lib = load_kernels()
    out = torch.empty((n, h, w, k), dtype=torch.bfloat16, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_head1_correlate(xq.data_ptr(), w1q.data_ptr(),
                                      sc.data_ptr(), b1.data_ptr(),
                                      tn.data_ptr(), out.data_ptr(),
                                      n * h * w, c, e, k, int(normalize),
                                      stream)
    check_launch(lib, "lseg_head1_correlate", rc)
    head1_correlate_fused.launches += 1
    return out


head1_correlate_fused.launches = 0


def _quantize(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """bf16 path1 -> int8 codes clip(round(x / sx), -127, 127): division,
    not a reciprocal product; rounding half to even."""
    return torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)


def head1_correlate_argmax_fused_plain(x: torch.Tensor, sx,
                                       w1q: torch.Tensor, s1: torch.Tensor,
                                       b1: torch.Tensor,
                                       text_features: torch.Tensor
                                       ) -> torch.Tensor:
    """(N, H, W, C) int8 codes or bf16 path1 -> (N, H, W) int32 labels:
    bf16 input quantized on the grid sx, e = acc * (sx * s1) + b1 in
    fp32, the first argmax over K of bf16(e) . tn^T (fp32 sums), tn the
    L2-normalised text in bf16. No per-pixel norm and no temperature: the
    argmax is blind to both."""
    (n, h, w, c, e), w1q, sc, tn = _prepare(x, sx, w1q, s1, b1,
                                            text_features, 1.0)
    if x.dtype != torch.int8:
        x = _quantize(x, torch.as_tensor(sx, dtype=torch.float32,
                                         device=x.device))
    acc = int8_mm(x.reshape(-1, c), w1q)
    ef = acc.float() * sc + b1.float()
    lo = torch.matmul(ef.to(torch.bfloat16).float(), tn.float().t())
    return torch.argmax(lo, dim=-1).to(torch.int32).reshape(n, h, w)


def head1_correlate_argmax_fused(x: torch.Tensor, sx, w1q: torch.Tensor,
                                 s1: torch.Tensor, b1: torch.Tensor,
                                 text_features: torch.Tensor
                                 ) -> torch.Tensor:
    """Kernel wrapper: (N, H, W, C) int8 codes or bf16 path1 (quantized
    in the kernel on the grid sx), fp32 scalar activation scale sx, head1
    int8 kernel (E, C[, 1, 1]), fp32 (E,) scales and bias, (K, E) text
    features -> (N, H, W) int32 labels. C % 32 == 0, E % 128 == 0."""
    check_no_grad("head1_correlate_argmax_fused", x, sx, s1, b1,
                  text_features)
    if x.device.type == "cpu":
        return head1_correlate_argmax_fused_plain(x, sx, w1q, s1, b1,
                                                  text_features)
    if x.device.type != "cuda":
        raise ValueError(f"head1_correlate_argmax_fused: unsupported device "
                         f"{x.device}")
    (n, h, w, c, e), w1q, sc, tn = _prepare(x, sx, w1q, s1, b1,
                                            text_features, 1.0)
    if x.dtype not in (torch.int8, torch.bfloat16) or w1q.dtype != torch.int8:
        raise TypeError(f"head1_correlate_argmax_fused kernel takes int8 or "
                        f"bf16 path1 and an int8 kernel, got {x.dtype}, "
                        f"{w1q.dtype}")
    if c % 32 or e % 128:
        raise ValueError(f"head1_correlate_argmax_fused kernel needs "
                         f"C % 32 == 0 and E % 128 == 0, got C={c}, E={e}")
    sxt = torch.as_tensor(sx, dtype=torch.float32,
                          device=x.device).reshape(1).contiguous()
    b1 = b1.float().contiguous()
    args = {"x": x, "sx": sxt, "w1q": w1q, "sc": sc, "b1": b1, "tn": tn}
    for name, v in args.items():
        if not v.is_contiguous() or v.data_ptr() % 16 or v.device != x.device:
            raise ValueError(f"head1_correlate_argmax_fused: {name} must be "
                             f"contiguous, 16-byte aligned and on {x.device}")
    lib = load_kernels()
    out = torch.empty((n, h, w), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_head1_correlate_argmax(
            x.data_ptr(), sxt.data_ptr(), w1q.data_ptr(), sc.data_ptr(),
            b1.data_ptr(), tn.data_ptr(), out.data_ptr(), n * h * w, c, e,
            tn.shape[0], int(x.dtype == torch.bfloat16), stream)
    check_launch(lib, "lseg_head1_correlate_argmax", rc)
    head1_correlate_argmax_fused.launches += 1
    return out


head1_correlate_argmax_fused.launches = 0
