"""Fused patchify + patch-embedding matmul (kernel B1).

Replaces `lseg_tpu/ops/pallas_patch.py` · `patch_embed_fused`. The CUDA
kernel is `lseg_tpu_torch/csrc/patch_embed.cu`; its header says what
bounds it on the card (bytes of the image and weights) and how the
design keeps the patchified image out of device memory.

`patch_embed` is the wrapper: on a CUDA tensor it launches the kernel
(or raises), on a CPU tensor it runs `patch_embed_plain`, the plain
PyTorch version with the same rounding points: bf16 operands, fp32
products and accumulation, fp32 bias, one cast to bf16.
"""

from __future__ import annotations

import torch

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    load_kernels,
)


def patchify(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, gh*gw, p*p*C), features ordered (row, col, c)
    like the HWIO flattening of the reference's (p, p, C, D) kernel."""
    n, h, w, c = x.shape
    gh, gw = h // patch, w // patch
    xp = x.reshape(n, gh, patch, gw, patch * c).permute(0, 1, 3, 2, 4)
    return xp.reshape(n, gh * gw, patch * patch * c)


def patch_embed_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, patch: int,
                      dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(N, H, W, C) image, (p*p*C, D) weight, (D,) fp32 bias ->
    (N, gh*gw, D) in `dtype`: operands rounded to `dtype`, product and
    bias in fp32."""
    xp = patchify(x, patch).to(dtype).float()
    y = torch.matmul(xp, weight.to(dtype).float())
    return (y + bias.float()).to(dtype)


def patch_embed(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                patch: int) -> torch.Tensor:
    """Kernel wrapper: (N, H, W, C) fp32 image, (p*p*C, D) bf16 weight,
    (D,) fp32 bias -> (N, gh*gw, D) bf16."""
    n, h, w, c = x.shape
    k, d = weight.shape
    if h % patch or w % patch:
        raise ValueError(f"image {h}x{w} is not a multiple of patch {patch}")
    if k != patch * patch * c or bias.shape != (d,):
        raise ValueError(
            f"weight {tuple(weight.shape)} / bias {tuple(bias.shape)} do "
            f"not match patch {patch} x {patch} x {c}")
    check_no_grad("patch_embed", x, weight, bias)
    if x.device.type == "cpu":
        return patch_embed_plain(x, weight, bias, patch)
    if x.device.type != "cuda":
        raise ValueError(f"patch_embed: unsupported device {x.device}")
    if (x.dtype, weight.dtype, bias.dtype) != (
            torch.float32, torch.bfloat16, torch.float32):
        raise TypeError(
            "patch_embed kernel takes an fp32 image, a bf16 weight and an "
            f"fp32 bias, got {x.dtype}, {weight.dtype}, {bias.dtype}")
    if d % 64:
        raise ValueError(f"patch_embed kernel needs dim % 64 == 0, got {d}")
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"patch_embed: {name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"patch_embed: {name} is on {t.device}")
    lib = load_kernels()
    out = torch.empty((n, (h // patch) * (w // patch), d),
                      dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_patch_embed(x.data_ptr(), weight.data_ptr(),
                                  bias.data_ptr(), out.data_ptr(), n, h, w,
                                  c, patch, d, stream)
    check_launch(lib, "lseg_patch_embed", rc)
    patch_embed.launches += 1
    return out


patch_embed.launches = 0
