"""Per-pixel image-text correlation head (torch port of
`lseg_tpu/ops/correlation.py`).

L2-normalised per-pixel embeddings (N, H, W, C) against L2-normalised
label embeddings (K, C), times the temperature -> (N, H, W, K) logits.
Normalisation is fp32; the matmul takes `compute_dtype` operands and
accumulates in fp32, as the reference's `preferred_element_type` does.

`emulate_fp16=True` is the parity path of lang-seg's own head
(`logit_scale * img.half() @ txt.t()`): both normalised operands are
rounded to fp16, multiplied with fp32 accumulation (a product of two
fp16 values is exact in fp32, so the fp32 product of their upcasts is
that accumulation; a matmul of the fp16 tensors would round its output
to fp16), and scaled afterwards. It returns fp32 whatever
`compute_dtype`, and takes precedence over `defer_pixel_norm`.
"""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """x / ||x||_2 along `dim`, computed in fp32, returned in x.dtype."""
    xf = x.float()
    norm = torch.sqrt(torch.sum(xf * xf, dim=dim, keepdim=True))
    return (xf / torch.clamp(norm, min=eps)).to(x.dtype)


def correlate(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: float = 1.0 / 0.07,
              compute_dtype: torch.dtype = torch.float32,
              defer_pixel_norm: bool = False,
              emulate_fp16: bool = False) -> torch.Tensor:
    """Temperature-scaled cosine-similarity logits (N, H, W, K) in
    `compute_dtype`.

    `defer_pixel_norm` divides by the pixel norm AFTER the matmul
    ((e/|e|).t == (e.t)/|e|): the normalised embedding map is never
    materialised."""
    if emulate_fp16:
        img = l2_normalize(image_features.float()).half().float()
        txt = l2_normalize(text_features.float()).half().float()
        return logit_scale * torch.matmul(img, txt.t())
    txt = (logit_scale * l2_normalize(text_features.float())).to(
        compute_dtype)
    if defer_pixel_norm:
        # fp32 logits are scaled by 1/|e| before the one rounding, so
        # the product is taken in fp32 on operands rounded to the
        # compute dtype
        ef = image_features.float()
        inv = torch.rsqrt(torch.clamp(
            torch.sum(ef * ef, dim=-1, keepdim=True), min=1e-24))
        logits = torch.matmul(ef.to(compute_dtype).float(), txt.float().t())
        return (logits * inv).to(compute_dtype)
    # a matmul in the compute dtype accumulates in fp32 and rounds once,
    # which is the reference's fp32 einsum followed by its cast
    img = l2_normalize(image_features.float()).to(compute_dtype)
    return torch.matmul(img, txt.t())
