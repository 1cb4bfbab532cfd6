"""Flash attention over the flat fused-qkv layout (kernel B6).

Replaces `lseg_tpu/ops/pallas_attention.py` · `flash_attention_flat`
(reached in the reference through `flash_attention_flat_vjp`). The CUDA
kernel is `lseg_tpu_torch/csrc/flash_attention_flat.cu`; its header says
what bounds it on the card (2*T*T*64 FLOP per head for each of q.k^T
and P.V, plus one exp per score) and how the design keeps scores out of
device memory.

`flash_attention_flat` is the wrapper: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs
`flash_attention_flat_plain`, the plain PyTorch version with the TPU
kernel's rounding points: fp32 scores times scale, fp32 softmax
numerator and sum, P cast to the qkv dtype for P.V with fp32
accumulation, division by the sum at the end.
"""

from __future__ import annotations

import torch

from lseg_tpu_torch.ops._build import check_launch, load_kernels

HEAD_DIM = 64  # the kernel is specialised for head_dim 64


def _check(qkv: torch.Tensor, num_heads: int, valid_len):
    n, t, d3 = qkv.shape
    d = d3 // 3
    if d3 != 3 * d or d % num_heads or d // num_heads != HEAD_DIM:
        raise ValueError(
            f"flat flash attention needs head_dim {HEAD_DIM}: qkv "
            f"{tuple(qkv.shape)} with {num_heads} heads")
    if num_heads % 2:
        raise ValueError(f"flat flash attention needs an even head count, "
                         f"got {num_heads}")
    vl = t if valid_len is None else int(valid_len)
    if not 1 <= vl <= t:
        raise ValueError(f"valid_len {vl} outside [1, {t}]")
    return n, t, d, vl


def flash_attention_flat_plain(qkv: torch.Tensor, num_heads: int,
                               scale: float,
                               valid_len: int = None) -> torch.Tensor:
    """(N, T, 3D) -> (N, T, D): per-head einsum attention with the
    kernel's rounding points; keys >= valid_len are masked."""
    n, t, d, vl = _check(qkv, num_heads, valid_len)
    r = qkv.reshape(n, t, 3, num_heads, HEAD_DIM)
    q, k, v = r[:, :, 0].float(), r[:, :, 1].float(), r[:, :, 2]
    s = torch.einsum("nqhd,nkhd->nhqk", q, k) * scale
    if vl != t:
        s[..., vl:] = float("-inf")
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("nhqk,nkhd->nhqd", p.to(qkv.dtype).float(), v.float())
    o = o / l
    return o.permute(0, 2, 1, 3).reshape(n, t, d).to(qkv.dtype)


def flash_attention_flat(qkv: torch.Tensor, num_heads: int, scale: float,
                         valid_len: int = None) -> torch.Tensor:
    """Kernel wrapper: (N, T, 3D) bf16 contiguous -> (N, T, D) bf16."""
    n, t, d, vl = _check(qkv, num_heads, valid_len)
    if qkv.device.type == "cpu":
        return flash_attention_flat_plain(qkv, num_heads, scale, valid_len)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_flat: unsupported device "
                         f"{qkv.device}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention_flat kernel takes bf16, got "
                        f"{qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_flat: qkv must be contiguous "
                         "and 16-byte aligned")
    lib = load_kernels()
    out = torch.empty((n, t, d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_flash_attention_flat(qkv.data_ptr(), out.data_ptr(),
                                           n, t, d, vl, float(scale), stream)
    check_launch(lib, "lseg_flash_attention_flat", rc)
    flash_attention_flat.launches += 1
    return out


flash_attention_flat.launches = 0
