"""Flash attention kernels of the ViT blocks: B6 and B2.

B6 replaces `lseg_tpu/ops/pallas_attention.py` · `flash_attention_flat`
(reached in the reference through `flash_attention_flat_vjp`): flash
attention over the flat fused-qkv layout. The CUDA kernel is
`lseg_tpu_torch/csrc/flash_attention_flat.cu`; its header says what bounds
it on the card (2*T*T*64 FLOP per head for each of q.k^T and P.V, plus one
exp per score) and how the design keeps scores out of device memory.

B2 replaces `pallas_attention.py` · `flash_attention_ln_qkv_fused_q8`:
LayerNorm 1 + per-row int8 quantize + int8 qkv projection + attention +
per-row int8 quantize of the output, the int8 fast path's attention. The
CUDA source is `lseg_tpu_torch/csrc/flash_attention_ln_qkv_q8.cu`, a
chain of three launches behind one op; its header says which tensors now
pass through device memory that the TPU kept on chip.

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
from lseg_tpu_torch.ops.ln_quant import ln_quantize_rows_plain
from lseg_tpu_torch.ops.quant import int8_mm, quantize_rows

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


def _check_q8(x, wq, sw, bias, num_heads, valid_len):
    n, t, d = x.shape
    if wq.shape != (3 * d, d) or sw.shape != (3 * d,) or bias.shape != (
            3 * d,):
        raise ValueError(
            f"ln_qkv_q8: qkv weight {tuple(wq.shape)}, scales "
            f"{tuple(sw.shape)}, bias {tuple(bias.shape)} for width {d}")
    if d % num_heads or d // num_heads != HEAD_DIM or num_heads % 2:
        raise ValueError(f"ln_qkv_q8 needs head_dim {HEAD_DIM} and an even "
                         f"head count: width {d} with {num_heads} heads")
    vl = t if valid_len is None else int(valid_len)
    if not 1 <= vl <= t:
        raise ValueError(f"valid_len {vl} outside [1, {t}]")
    return n, t, d, vl


def flash_attention_ln_qkv_fused_q8_plain(
        x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
        wq: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
        num_heads: int, scale: float, valid_len: int = None,
        eps: float = 1e-6):
    """(N, T, D) raw residual stream -> (int8 (N, T, D), fp32 (N, T, 1)):
    fp32 LN + row quantize, the exact int32 qkv product dequantized as
    ((acc * sx) * sw) + b in fp32 and cast to bf16, the attention of
    `flash_attention_flat_plain`, and `quantize_rows` of its bf16 output.
    `wq` is the (3D, D) int8 weight, `sw` and `bias` its (3D,) fp32
    scales and bias."""
    n, t, d, _ = _check_q8(x, wq, sw, bias, num_heads, valid_len)
    xq, sx = ln_quantize_rows_plain(x, ln_scale, ln_bias, eps)
    acc = int8_mm(xq.reshape(n * t, d), wq)
    qkv = (acc.float() * sx.reshape(-1, 1) * sw.reshape(1, -1)
           + bias.reshape(1, -1)).to(torch.bfloat16)
    out = flash_attention_flat_plain(qkv.reshape(n, t, 3 * d), num_heads,
                                     scale, valid_len)
    return quantize_rows(out)


def flash_attention_ln_qkv_fused_q8(
        x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
        wq: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
        num_heads: int, scale: float, valid_len: int = None,
        eps: float = 1e-6):
    """Kernel wrapper: (N, T, D) bf16, fp32 LN params (D,), int8 (3D, D)
    weight, fp32 (3D,) scales and bias -> (int8 (N, T, D), fp32
    (N, T, 1)). head_dim 64, D % 256 == 0, any T."""
    n, t, d, vl = _check_q8(x, wq, sw, bias, num_heads, valid_len)
    if x.device.type == "cpu":
        return flash_attention_ln_qkv_fused_q8_plain(
            x, ln_scale, ln_bias, wq, sw, bias, num_heads, scale, valid_len,
            eps)
    if x.device.type != "cuda":
        raise ValueError(f"flash_attention_ln_qkv_fused_q8: unsupported "
                         f"device {x.device}")
    want = {"x": torch.bfloat16, "ln_scale": torch.float32,
            "ln_bias": torch.float32, "wq": torch.int8, "sw": torch.float32,
            "bias": torch.float32}
    args = {"x": x, "ln_scale": ln_scale, "ln_bias": ln_bias, "wq": wq,
            "sw": sw, "bias": bias}
    for name, v in args.items():
        if v.dtype != want[name]:
            raise TypeError(f"flash_attention_ln_qkv_fused_q8: {name} must "
                            f"be {want[name]}, got {v.dtype}")
        if not v.is_contiguous() or v.data_ptr() % 16 or v.device != x.device:
            raise ValueError(f"flash_attention_ln_qkv_fused_q8: {name} must "
                             f"be contiguous, 16-byte aligned and on "
                             f"{x.device}")
    if d % 256:
        raise ValueError(f"flash_attention_ln_qkv_fused_q8 kernel needs "
                         f"D % 256 == 0, got {d}")
    lib = load_kernels()
    dev = x.device
    xq = torch.empty((n * t, d), dtype=torch.int8, device=dev)
    sx = torch.empty((n * t,), dtype=torch.float32, device=dev)
    qkv = torch.empty((n * t, 3 * d), dtype=torch.bfloat16, device=dev)
    oq = torch.empty((n, t, d), dtype=torch.int8, device=dev)
    os_ = torch.empty((n, t, 1), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_flash_attention_ln_qkv_q8(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            wq.data_ptr(), sw.data_ptr(), bias.data_ptr(), xq.data_ptr(),
            sx.data_ptr(), qkv.data_ptr(), oq.data_ptr(), os_.data_ptr(),
            n, t, d, vl, float(scale), float(eps), stream)
    check_launch(lib, "lseg_flash_attention_ln_qkv_q8", rc)
    flash_attention_ln_qkv_fused_q8.launches += 1
    return oq, os_


flash_attention_ln_qkv_fused_q8.launches = 0
