"""Fused L2 normalisation + image-text correlation (kernel B10).

Replaces `lseg_tpu/ops/pallas_correlation.py` · `fused_correlate`, the
correlation of the `use_pallas=True` serving head. The CUDA kernel is
`lseg_tpu_torch/csrc/fused_correlate.cu`; its header says what bounds it
on the card and how the normalised pixel map stays out of device memory.

`fused_correlate` is the wrapper: on a CUDA tensor it launches the kernel
(or raises), on a CPU tensor it runs `fused_correlate_plain`.
"""

from __future__ import annotations

import torch

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    load_kernels,
)

_BN = 160  # labels per block of the kernel; the text scratch pads K to it


def _normalize(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return xf * torch.rsqrt(torch.clamp((xf * xf).sum(dim=-1, keepdim=True),
                                        min=1e-24))


def fused_correlate_plain(image_features: torch.Tensor,
                          text_features: torch.Tensor,
                          logit_scale: float = 1.0 / 0.07,
                          compute_dtype: torch.dtype = torch.float32
                          ) -> torch.Tensor:
    """(N, H, W, C) pixels, (K, C) text -> (N, H, W, K) logits in
    `compute_dtype`: both operands normalised in fp32 with
    rsqrt(max(sum(x^2), 1e-24)), rounded to `compute_dtype`, multiplied
    with fp32 accumulation and times `logit_scale`."""
    xn = _normalize(image_features).to(compute_dtype).float()
    tn = _normalize(text_features).to(compute_dtype).float()
    return (logit_scale * torch.matmul(xn, tn.t())).to(compute_dtype)


def fused_correlate(image_features: torch.Tensor,
                    text_features: torch.Tensor,
                    logit_scale: float = 1.0 / 0.07,
                    compute_dtype: torch.dtype = torch.float32
                    ) -> torch.Tensor:
    """Kernel wrapper: (N, H, W, C) bf16 or fp32 pixel embeddings, (K, C)
    text features -> (N, H, W, K) fp32 logits. C % 32 == 0. The kernel
    takes `compute_dtype=float32` only (the reference's default on the
    serving head)."""
    check_no_grad("fused_correlate", image_features, text_features)
    if image_features.device.type == "cpu":
        return fused_correlate_plain(image_features, text_features,
                                     logit_scale, compute_dtype)
    x = image_features
    if x.device.type != "cuda":
        raise ValueError(f"fused_correlate: unsupported device {x.device}")
    if compute_dtype != torch.float32:
        raise NotImplementedError(
            "fused_correlate kernel: compute_dtype=bfloat16 is not written "
            "(ROADMAP); the serving head runs fp32")
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_correlate kernel takes bf16 or fp32 pixels, "
                        f"got {x.dtype}")
    n, h, w, c = x.shape
    k = text_features.shape[0]
    if text_features.dim() != 2 or text_features.shape[1] != c:
        raise ValueError(f"fused_correlate: pixels {tuple(x.shape)}, text "
                         f"{tuple(text_features.shape)}")
    if c % 32:
        raise ValueError(f"fused_correlate kernel needs C % 32 == 0, got {c}")
    t = text_features.float().contiguous()
    for name, v in (("image_features", x), ("text_features", t)):
        if not v.is_contiguous() or v.data_ptr() % 16 or v.device != x.device:
            raise ValueError(f"fused_correlate: {name} must be contiguous, "
                             f"16-byte aligned and on {x.device}")
    kp = -(-k // _BN) * _BN
    lib = load_kernels()
    tn_t = torch.empty((c, kp), dtype=torch.float32, device=x.device)
    out = torch.empty((n, h, w, k), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_fused_correlate(x.data_ptr(), t.data_ptr(),
                                      tn_t.data_ptr(), out.data_ptr(),
                                      n * h * w, c, k, kp,
                                      int(x.dtype == torch.bfloat16),
                                      float(logit_scale), stream)
    check_launch(lib, "lseg_fused_correlate", rc)
    fused_correlate.launches += 1
    return out


fused_correlate.launches = 0
