"""Flash attention kernels of the ViT blocks: B6, B2, B8, B15, B9 and B7.

B6 replaces `lseg_tpu/ops/pallas_attention.py` · `flash_attention_flat`
(reached in the reference through `flash_attention_flat_vjp`): flash
attention over the flat fused-qkv layout. The CUDA kernel is
`lseg_tpu_torch/csrc/flash_attention_flat.cu` on the wgmma + TMA engine of
`csrc/wgmma.cuh`; its header says what bounds it on the card (2*T*T*64
FLOP per head for each of q.k^T and P.V, plus one exp per score) and how
the design keeps scores out of device memory. With `return_lse` it also
returns each row's log-sum-exp, the statistics the backward reads. fp32
qkv (an fp32 model) takes B6's fp32 mode in
`lseg_tpu_torch/csrc/flash_attention_flat_fp32.cu` and B7's in
`flash_attention_flat_bwd_fp32.cu`, both on split-TF32 tensor-core
products (`csrc/tf32x3.cuh`, ~21 bits of each operand): every step
fp32-accurate, as the TPU kernels compute for fp32 inputs.

B2 replaces `pallas_attention.py` · `flash_attention_ln_qkv_fused_q8`:
LayerNorm 1 + per-row int8 quantize + int8 qkv projection + attention +
per-row int8 quantize of the output, the int8 fast path's attention. The
CUDA source is `lseg_tpu_torch/csrc/flash_attention_ln_qkv_q8.cu`, a
chain of three launches behind one op (B3's LN routine, the s8 wgmma qkv
GEMM of `csrc/qkv_wgmma.cuh`, and the head-pair attention of
`csrc/pair_attention.cuh` launched as thread-block clusters that share
each row's amax); its header says which tensors now pass through device
memory that the TPU kept on chip. The kernel takes the widths of
`B2_KERNEL_WIDTHS`. `qk_int8=True` is the TPU kernel's int8 Q.K^T mode
(`attn_variant='i8qk'`): each head's bf16 q and k rows re-quantized per
row to int8, an exact int32 Q.K^T, the scores float(acc) * ((sq * scale) *
sk_j); on the card the third launch then quantizes the tiles in shared
memory and runs Q.K^T as s8 warpgroup products.

B8 replaces `pallas_attention.py` · `flash_attention_qkv_fused`: the int8
qkv projection of rows quantized beforehand (`quantize_rows` of the
LayerNorm-1 output) + attention, bf16 out, the `attn_impl='flashq'` path.
The CUDA source is `lseg_tpu_torch/csrc/flash_attention_qkv_fused.cu`, a
chain of two launches (the s8 wgmma qkv GEMM, then B6's flash interior)
behind one op. `qkv_int8_gemm` runs that qkv stage alone, for checks.

B15 replaces `pallas_attention.py` · `flash_attention_qkvp_fused`: the
whole int8 attention half-block, B8's work plus the per-(row, head pair)
int8 requantize of the fp32 attention output, the int8 output projection
summed pair by pair, its bias and the residual, the `attn_impl='flashqp'`
path. The CUDA source is `lseg_tpu_torch/csrc/flash_attention_qkvp_fused.cu`,
a chain of three launches behind one op (the qkv GEMM, the head-pair
attention, the projection on s8 warpgroup products flushed pair by
pair).

B9 replaces `pallas_attention.py` · `flash_attention_ln_qkv_fused`: B2
without the quantize of its output, bf16 out. No model path of the
reference calls it. The CUDA source is
`lseg_tpu_torch/csrc/flash_attention_ln_qkv_fused.cu` (B3's LN routine,
then B8's two stages).

B7 replaces `pallas_attention.py` · `_flash_flat_bwd_impl`, the Pallas
backward of `flash_attention_flat_vjp`: (qkv, O, dO) -> dqkv in the same
flat layout. The CUDA source is
`lseg_tpu_torch/csrc/flash_attention_flat_bwd.cu` (two passes: Dr and dQ
per query tile, then dK/dV per key tile); it reads B6's lse instead of
recomputing the row statistics.

`flash_attention_flat` and `flash_attention_flat_bwd` are the wrappers:
on a CUDA tensor they launch the kernel (or raise), on a CPU tensor they
run the plain PyTorch versions `flash_attention_flat_plain` and
`flash_attention_flat_bwd_plain`, which keep the TPU kernels' rounding
points: fp32 scores times scale, fp32 softmax numerator and sum, P cast
to the qkv dtype for P.V with fp32 accumulation, division by the sum at
the end; in the backward, P normalized in fp32 before its cast.

Neither the wrappers nor the plain versions are differentiable: a tensor
that requires grad makes them raise. Gradients go through
`flash_attention_flat_fn` (the `FlashAttentionFlat` autograd.Function),
whose forward is B6 and whose backward is B7, or their plain versions;
its residuals are qkv, O and B6's lse.
"""

from __future__ import annotations

import torch

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    check_operands,
    load_kernels,
)
from lseg_tpu_torch.ops.ln_quant import ln_quantize_rows_plain
from lseg_tpu_torch.ops.quant import int8_mm, quantize_rows

HEAD_DIM = 64  # the kernel is specialised for head_dim 64
# B6's and B7's entry points by qkv dtype: the wgmma kernels for bf16,
# their fp32 modes (csrc/flash_attention_flat_fp32.cu) for fp32
_FLAT_ENTRY = {torch.bfloat16: "lseg_flash_attention_flat",
               torch.float32: "lseg_flash_attention_flat_fp32"}
_FLAT_BWD_ENTRY = {torch.bfloat16: "lseg_flash_attention_flat_bwd",
                   torch.float32: "lseg_flash_attention_flat_bwd_fp32"}


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


def _flat_attention_f32(qkv: torch.Tensor, num_heads: int, scale: float,
                        valid_len: int, qk_int8: bool = False):
    """(N, T, 3D) -> ((N, T, D) fp32 per-head attention, o / l left in
    fp32; (N, H, T) fp32 lse = m + log(l)). `qk_int8`: the scores of
    B2's int8 Q.K^T mode (`_int8_scores`)."""
    n, t, d, vl = _check(qkv, num_heads, valid_len)
    r = qkv.reshape(n, t, 3, num_heads, HEAD_DIM)
    q, k, v = r[:, :, 0].float(), r[:, :, 1].float(), r[:, :, 2]
    if qk_int8:
        s = _int8_scores(q, k, scale)
    else:
        s = torch.einsum("nqhd,nkhd->nhqk", q, k) * scale
    if vl != t:
        s[..., vl:] = float("-inf")
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("nhqk,nkhd->nhqd", p.to(qkv.dtype).float(), v.float())
    o = o / l
    lse = (m + torch.log(l)).squeeze(-1)
    return o.permute(0, 2, 1, 3).reshape(n, t, d), lse


def _int8_scores(q: torch.Tensor, k: torch.Tensor,
                 scale: float) -> torch.Tensor:
    """The scores of the TPU kernel's `qk_int8` branch: q and k (N, T, H,
    64) fp32 (bf16 values) re-quantized per head and row (`quantize_rows`:
    s = max(max|x|, 1e-8) / 127, codes round-half-even(x / s)), the exact
    int32 Q.K^T (taken in float64, which holds every sum of 64 products of
    codes exactly), then float(acc) * ((sq * scale) * sk_j) in fp32, in
    that order: (N, H, T, T)."""
    qi, sq = quantize_rows(q)
    ki, sk = quantize_rows(k)
    acc = torch.einsum("nqhd,nkhd->nhqk", qi.double(), ki.double()).float()
    fac = (sq.permute(0, 2, 1, 3) * scale) * sk.permute(0, 2, 3, 1)
    return acc * fac


def flash_attention_flat_plain(qkv: torch.Tensor, num_heads: int,
                               scale: float, valid_len: int = None,
                               return_lse: bool = False):
    """(N, T, 3D) -> (N, T, D): per-head einsum attention with the
    kernel's rounding points; keys >= valid_len are masked. With
    `return_lse`, also each row's log-sum-exp of the scaled, masked scores,
    fp32 (N, H, T), from its own scores."""
    check_no_grad("flash_attention_flat_plain", qkv)
    o, lse = _flat_attention_f32(qkv, num_heads, scale, valid_len)
    o = o.to(qkv.dtype)
    return (o, lse) if return_lse else o


def flash_attention_flat(qkv: torch.Tensor, num_heads: int, scale: float,
                         valid_len: int = None, return_lse: bool = False):
    """Kernel wrapper: (N, T, 3D) bf16 or fp32 contiguous -> (N, T, D) in
    the qkv dtype; with `return_lse`, also the (N, H, T) fp32 log-sum-exp
    of each row. bf16 runs the wgmma kernel, fp32 its fp32 mode
    (split-TF32 products, no operand rounded below ~21 bits)."""
    check_no_grad("flash_attention_flat", qkv)
    n, t, d, vl = _check(qkv, num_heads, valid_len)
    if qkv.device.type == "cpu":
        return flash_attention_flat_plain(qkv, num_heads, scale, valid_len,
                                          return_lse)
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_flat: unsupported device "
                         f"{qkv.device}")
    entry = _FLAT_ENTRY.get(qkv.dtype)
    if entry is None:
        raise TypeError(f"flash_attention_flat kernel takes bf16 or fp32, "
                        f"got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("flash_attention_flat: qkv must be contiguous "
                         "and 16-byte aligned")
    lib = load_kernels()
    out = torch.empty((n, t, d), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((n, num_heads, t), dtype=torch.float32,
                       device=qkv.device) if return_lse else None)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            qkv.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), n, t, d, vl,
            float(scale), stream)
    check_launch(lib, entry, rc)
    flash_attention_flat.launches += 1
    return (out, lse) if return_lse else out


flash_attention_flat.launches = 0


def flash_attention_flat_bwd_plain(qkv: torch.Tensor, out: torch.Tensor,
                                   do: torch.Tensor, lse, num_heads: int,
                                   scale: float,
                                   valid_len: int = None) -> torch.Tensor:
    """(qkv (N, T, 3D), O (N, T, D), dO (N, T, D)) -> dqkv (N, T, 3D) in
    the qkv dtype, per-head einsums with the TPU kernel's rounding
    points; keys >= valid_len are masked. `lse` is accepted for the
    kernel's signature and not used: the row statistics are recomputed
    from the scores, as the TPU kernel does, so this stays the yardstick
    that the kernel (which reads lse) is held against."""
    check_no_grad("flash_attention_flat_bwd_plain", qkv, out, do)
    n, t, d, vl = _check(qkv, num_heads, valid_len)
    dt = qkv.dtype
    r = qkv.reshape(n, t, 3, num_heads, HEAD_DIM).float()
    q, k, v = r[:, :, 0], r[:, :, 1], r[:, :, 2]
    o = out.reshape(n, t, num_heads, HEAD_DIM).float()
    g = do.to(dt).reshape(n, t, num_heads, HEAD_DIM).float()
    s = torch.einsum("nqhd,nkhd->nhqk", q, k) * scale
    if vl != t:
        s[..., vl:] = float("-inf")
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pn = p / p.sum(dim=-1, keepdim=True)
    dv = torch.einsum("nhqk,nqhd->nkhd", pn.to(dt).float(), g)
    dp = torch.einsum("nqhd,nkhd->nhqk", g, v)
    d_row = (g * o).sum(dim=-1).permute(0, 2, 1).unsqueeze(-1)
    ds = (pn * (dp - d_row)).to(dt).float()
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, k) * scale
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, q) * scale
    return torch.cat([x.reshape(n, t, d) for x in (dq, dk, dv)],
                     dim=-1).to(dt)


def flash_attention_flat_bwd(qkv: torch.Tensor, out: torch.Tensor,
                             do: torch.Tensor, lse, num_heads: int,
                             scale: float,
                             valid_len: int = None) -> torch.Tensor:
    """Kernel wrapper (B7): contiguous qkv (N, T, 3D), O and dO (N, T, D),
    all bf16 or all fp32, B6's fp32 lse (N, H, T) -> dqkv (N, T, 3D) in
    the qkv dtype; fp32 runs B7's fp32 mode. Off the CPU `lse` is
    required: the kernel does not recompute it."""
    check_no_grad("flash_attention_flat_bwd", qkv, out, do)
    n, t, d, vl = _check(qkv, num_heads, valid_len)
    if out.shape != (n, t, d) or do.shape != (n, t, d):
        raise ValueError(f"flash_attention_flat_bwd: out {tuple(out.shape)}"
                         f" and dO {tuple(do.shape)} for qkv "
                         f"{tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return flash_attention_flat_bwd_plain(qkv, out, do, lse, num_heads,
                                              scale, valid_len)
    if lse is None:
        raise ValueError("flash_attention_flat_bwd: the kernel needs the "
                         "forward's lse (flash_attention_flat(..., "
                         "return_lse=True))")
    if qkv.device.type != "cuda":
        raise ValueError(f"flash_attention_flat_bwd: unsupported device "
                         f"{qkv.device}")
    entry = _FLAT_BWD_ENTRY.get(qkv.dtype)
    for name, x in (("qkv", qkv), ("out", out), ("dO", do)):
        if entry is None or x.dtype != qkv.dtype:
            raise TypeError(f"flash_attention_flat_bwd kernel takes bf16 or "
                            f"fp32, all alike, got {name} {x.dtype} with "
                            f"qkv {qkv.dtype}")
        if (not x.is_contiguous() or x.data_ptr() % 16
                or x.device != qkv.device):
            raise ValueError(f"flash_attention_flat_bwd: {name} must be "
                             f"contiguous, 16-byte aligned and on "
                             f"{qkv.device}")
    if (lse.dtype != torch.float32 or lse.shape != (n, num_heads, t)
            or not lse.is_contiguous() or lse.device != qkv.device):
        raise ValueError(f"flash_attention_flat_bwd: lse must be contiguous "
                         f"fp32 {(n, num_heads, t)} on {qkv.device}, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
    lib = load_kernels()
    dqkv = torch.empty_like(qkv)
    dr = torch.empty((n, num_heads, t), dtype=torch.float32,
                     device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            qkv.data_ptr(), out.data_ptr(), do.data_ptr(), lse.data_ptr(),
            dqkv.data_ptr(), dr.data_ptr(), n, t, d, vl, float(scale),
            stream)
    check_launch(lib, entry, rc)
    flash_attention_flat_bwd.launches += 1
    return dqkv


flash_attention_flat_bwd.launches = 0


class FlashAttentionFlat(torch.autograd.Function):
    """Flat flash attention with a gradient: forward B6, backward B7 (the
    reference's `flash_attention_flat_vjp`); with `plain`, or on the CPU,
    their plain versions. The residuals are qkv and O, as in the
    reference, and the forward's per-row lse, which B7 reads instead of
    recomputing the row statistics; the cotangent is cast to the qkv dtype
    first."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, valid_len, plain):
        fwd = flash_attention_flat_plain if plain else flash_attention_flat
        out, lse = fwd(qkv, num_heads, scale, valid_len, return_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.args = (num_heads, scale, valid_len, plain)
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, out, lse = ctx.saved_tensors
        num_heads, scale, valid_len, plain = ctx.args
        bwd = (flash_attention_flat_bwd_plain if plain
               else flash_attention_flat_bwd)
        dqkv = bwd(qkv, out, do.to(qkv.dtype).contiguous(), lse, num_heads,
                   scale, valid_len)
        return dqkv, None, None, None, None


def flash_attention_flat_fn(qkv: torch.Tensor, num_heads: int, scale: float,
                            valid_len: int = None,
                            plain: bool = False) -> torch.Tensor:
    """Differentiable flat flash attention (see `FlashAttentionFlat`)."""
    return FlashAttentionFlat.apply(qkv, num_heads, scale, valid_len, plain)


def _check_q8(x, wq, sw, bias, num_heads, valid_len):
    """Shapes of the int8 qkv attention ops (B2, B8)."""
    n, t, d = x.shape
    if wq.shape != (3 * d, d) or sw.shape != (3 * d,) or bias.shape != (
            3 * d,):
        raise ValueError(
            f"int8 qkv attention: qkv weight {tuple(wq.shape)}, scales "
            f"{tuple(sw.shape)}, bias {tuple(bias.shape)} for width {d}")
    if d % num_heads or d // num_heads != HEAD_DIM or num_heads % 2:
        raise ValueError(f"int8 qkv attention needs head_dim {HEAD_DIM} and "
                         f"an even head count: width {d} with {num_heads} "
                         f"heads")
    vl = t if valid_len is None else int(valid_len)
    if not 1 <= vl <= t:
        raise ValueError(f"valid_len {vl} outside [1, {t}]")
    return n, t, d, vl


def _qkv_plain(xq, sx, wq, sw, bias):
    """The exact int32 qkv product of int8 rows, dequantized as
    ((acc * sx) * sw) + b in fp32 and cast to bf16: (N, T, 3D)."""
    n, t, d = xq.shape
    acc = int8_mm(xq.reshape(n * t, d), wq)
    qkv = (acc.float() * sx.reshape(-1, 1) * sw.reshape(1, -1)
           + bias.reshape(1, -1)).to(torch.bfloat16)
    return qkv.reshape(n, t, 3 * d)


def qkv_int8_gemm(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                  sw: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The qkv stage of B2, B8, B9 and B15 alone (`csrc/qkv_wgmma.cuh`),
    for checks: (N, T, D) int8 row codes, (N, T, 1) fp32 row scales, int8
    (3D, D) weight, fp32 (3D,) scales and bias -> (N, T, 3D) bf16, equal
    to `_qkv_plain` bit for bit (exact int32 sums, the same rounding
    points). D % 128 == 0 on the card."""
    check_no_grad("qkv_int8_gemm", sx, sw, bias)
    n, t, d = xq.shape
    if wq.shape != (3 * d, d) or tuple(sx.shape) != (n, t, 1):
        raise ValueError(f"qkv_int8_gemm: codes {tuple(xq.shape)}, scales "
                         f"{tuple(sx.shape)}, weight {tuple(wq.shape)}")
    if xq.device.type == "cpu":
        return _qkv_plain(xq, sx, wq, sw, bias)
    if xq.device.type != "cuda":
        raise ValueError(f"qkv_int8_gemm: unsupported device {xq.device}")
    check_operands("qkv_int8_gemm", {
        "xq": (xq, torch.int8), "sx": (sx, torch.float32),
        "wq": (wq, torch.int8), "sw": (sw, torch.float32),
        "bias": (bias, torch.float32)})
    if d % 128:
        raise ValueError(f"qkv_int8_gemm kernel needs D % 128 == 0, got {d}")
    lib = load_kernels()
    qkv = torch.empty((n, t, 3 * d), dtype=torch.bfloat16, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_qkv_int8_gemm(
            xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
            bias.data_ptr(), qkv.data_ptr(), n * t, 3 * d, d, stream)
    check_launch(lib, "lseg_qkv_int8_gemm", rc)
    qkv_int8_gemm.launches += 1
    return qkv


qkv_int8_gemm.launches = 0


def _qkv_attention_plain(xq, sx, wq, sw, bias, num_heads, scale,
                         valid_len, qk_int8=False):
    """`_qkv_plain`, then the attention of `flash_attention_flat_plain`
    (with `qk_int8`, on the scores of `_int8_scores`): (N, T, D) bf16."""
    qkv = _qkv_plain(xq, sx, wq, sw, bias)
    o, _ = _flat_attention_f32(qkv, num_heads, scale, valid_len, qk_int8)
    return o.to(qkv.dtype)


# B2's widths on the card: its row scale is shared by a thread-block
# cluster of D / 128 CTAs, one a head pair, at most 8 (the portable
# cluster size): ViT-L/16's 1024 and ViT-B's 768.
B2_KERNEL_WIDTHS = "D a multiple of 128 from 128 to 1024, e.g. 1024 or 768"


def check_b2_widths(d: int) -> None:
    """Raise ValueError unless B2's kernel takes width D."""
    if d % 128 or not 128 <= d <= 1024:
        raise ValueError(f"flash_attention_ln_qkv_fused_q8 kernel takes "
                         f"{B2_KERNEL_WIDTHS}; got D {d}")


def flash_attention_ln_qkv_fused_q8_plain(
        x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
        wq: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
        num_heads: int, scale: float, valid_len: int = None,
        eps: float = 1e-6, qk_int8: bool = False):
    """(N, T, D) raw residual stream -> (int8 (N, T, D), fp32 (N, T, 1)):
    fp32 LN + row quantize, the qkv product and attention of
    `flash_attention_qkv_fused_plain`, and `quantize_rows` of its bf16
    output. `wq` is the (3D, D) int8 weight, `sw` and `bias` its (3D,)
    fp32 scales and bias. `qk_int8`: the int8 Q.K^T mode
    (`_int8_scores`)."""
    _check_q8(x, wq, sw, bias, num_heads, valid_len)
    xq, sx = ln_quantize_rows_plain(x, ln_scale, ln_bias, eps)
    return quantize_rows(_qkv_attention_plain(xq, sx, wq, sw, bias,
                                              num_heads, scale, valid_len,
                                              qk_int8))


def flash_attention_ln_qkv_fused_q8(
        x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
        wq: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
        num_heads: int, scale: float, valid_len: int = None,
        eps: float = 1e-6, qk_int8: bool = False):
    """Kernel wrapper: (N, T, D) bf16, fp32 LN params (D,), int8 (3D, D)
    weight, fp32 (3D,) scales and bias -> (int8 (N, T, D), fp32
    (N, T, 1)). head_dim 64; on the card D must be a kernel width
    (`check_b2_widths`); any T. `qk_int8` takes the int8 Q.K^T mode."""
    check_no_grad("flash_attention_ln_qkv_fused_q8", x, ln_scale, ln_bias,
                  bias)
    n, t, d, vl = _check_q8(x, wq, sw, bias, num_heads, valid_len)
    if x.device.type == "cpu":
        return flash_attention_ln_qkv_fused_q8_plain(
            x, ln_scale, ln_bias, wq, sw, bias, num_heads, scale, valid_len,
            eps, qk_int8)
    if x.device.type != "cuda":
        raise ValueError(f"flash_attention_ln_qkv_fused_q8: unsupported "
                         f"device {x.device}")
    check_operands("flash_attention_ln_qkv_fused_q8", {
        "x": (x, torch.bfloat16), "ln_scale": (ln_scale, torch.float32),
        "ln_bias": (ln_bias, torch.float32), "wq": (wq, torch.int8),
        "sw": (sw, torch.float32), "bias": (bias, torch.float32)})
    check_b2_widths(d)
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
            n, t, d, vl, int(bool(qk_int8)), float(scale), float(eps),
            stream)
    check_launch(lib, "lseg_flash_attention_ln_qkv_q8", rc)
    flash_attention_ln_qkv_fused_q8.launches += 1
    if qk_int8:
        flash_attention_ln_qkv_fused_q8.i8qk_launches += 1
    return oq, os_


flash_attention_ln_qkv_fused_q8.launches = 0
# the launches of them in the int8 Q.K^T mode
flash_attention_ln_qkv_fused_q8.i8qk_launches = 0


def _check_qkv_fused(xq, sx, wq, sw, bias, num_heads, valid_len):
    dims = _check_q8(xq, wq, sw, bias, num_heads, valid_len)
    n, t, _, _ = dims
    if tuple(sx.shape) != (n, t, 1):
        raise ValueError(f"flash_attention_qkv_fused: row scales "
                         f"{tuple(sx.shape)} for codes {tuple(xq.shape)}")
    return dims


def flash_attention_qkv_fused_plain(
        xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
        sw: torch.Tensor, bias: torch.Tensor, num_heads: int, scale: float,
        valid_len: int = None) -> torch.Tensor:
    """(N, T, D) int8 row codes, (N, T, 1) fp32 row scales -> (N, T, D)
    bf16: the exact int32 qkv product dequantized as ((acc * sx) * sw) + b
    in fp32 and cast to bf16, then the attention of
    `flash_attention_flat_plain`. `wq` is the (3D, D) int8 weight, `sw`
    and `bias` its (3D,) fp32 scales and bias."""
    check_no_grad("flash_attention_qkv_fused_plain", sx, sw, bias)
    _check_qkv_fused(xq, sx, wq, sw, bias, num_heads, valid_len)
    return _qkv_attention_plain(xq, sx, wq, sw, bias, num_heads, scale,
                                valid_len)


def flash_attention_qkv_fused(
        xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
        sw: torch.Tensor, bias: torch.Tensor, num_heads: int, scale: float,
        valid_len: int = None) -> torch.Tensor:
    """Kernel wrapper (B8): (N, T, D) int8 row codes, (N, T, 1) fp32 row
    scales, int8 (3D, D) weight, fp32 (3D,) scales and bias -> (N, T, D)
    bf16. head_dim 64, even head count, D % 128 == 0, any T."""
    check_no_grad("flash_attention_qkv_fused", sx, sw, bias)
    n, t, d, vl = _check_qkv_fused(xq, sx, wq, sw, bias, num_heads,
                                   valid_len)
    if xq.device.type == "cpu":
        return flash_attention_qkv_fused_plain(xq, sx, wq, sw, bias,
                                               num_heads, scale, valid_len)
    if xq.device.type != "cuda":
        raise ValueError(f"flash_attention_qkv_fused: unsupported device "
                         f"{xq.device}")
    check_operands("flash_attention_qkv_fused", {
        "xq": (xq, torch.int8), "sx": (sx, torch.float32),
        "wq": (wq, torch.int8), "sw": (sw, torch.float32),
        "bias": (bias, torch.float32)})
    if d % 128:
        raise ValueError(f"flash_attention_qkv_fused kernel needs "
                         f"D % 128 == 0, got {d}")
    lib = load_kernels()
    dev = xq.device
    qkv = torch.empty((n * t, 3 * d), dtype=torch.bfloat16, device=dev)
    out = torch.empty((n, t, d), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_flash_attention_qkv_fused(
            xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
            bias.data_ptr(), qkv.data_ptr(), out.data_ptr(), n, t, d, vl,
            float(scale), stream)
    check_launch(lib, "lseg_flash_attention_qkv_fused", rc)
    flash_attention_qkv_fused.launches += 1
    return out


flash_attention_qkv_fused.launches = 0


def _check_qkvp(xq, sx, wq, sw, bias, wp, sp, bp, resid, num_heads,
                valid_len):
    dims = _check_qkv_fused(xq, sx, wq, sw, bias, num_heads, valid_len)
    n, t, d, _ = dims
    want = {"wp": (d, d), "sp": (d,), "bp": (d,), "resid": (n, t, d)}
    for arg, v in (("wp", wp), ("sp", sp), ("bp", bp), ("resid", resid)):
        if tuple(v.shape) != want[arg]:
            raise ValueError(f"flash_attention_qkvp_fused: {arg} "
                             f"{tuple(v.shape)}, expected {want[arg]}")
    check_operands("flash_attention_qkvp_fused", {
        "xq": (xq, torch.int8), "sx": (sx, torch.float32),
        "wq": (wq, torch.int8), "sw": (sw, torch.float32),
        "bias": (bias, torch.float32), "wp": (wp, torch.int8),
        "sp": (sp, torch.float32), "bp": (bp, torch.float32),
        "resid": (resid, torch.bfloat16)})
    return dims


def flash_attention_qkvp_fused_plain(
        xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
        sw: torch.Tensor, bias: torch.Tensor, wp: torch.Tensor,
        sp: torch.Tensor, bp: torch.Tensor, resid: torch.Tensor,
        num_heads: int, scale: float, valid_len: int = None) -> torch.Tensor:
    """resid + proj(attn(qkv(x))) with the TPU kernel's rounding points
    (`pallas_attention.py` · `_kernel_qkvp`): the bf16 qkv of
    `_qkv_plain`; per head pair, the two heads' attention left in fp32 and
    quantized per row over the pair's 128 columns; each pair's partial
    projection (int32 . sa) . sp in fp32, summed in pair order onto
    (part_0 + bp) + resid; one cast to bf16. `wp` is the (D, D) int8
    proj weight (out, in), `sp` and `bp` its (D,) fp32 scales and bias:
    (N, T, D) bf16."""
    check_no_grad("flash_attention_qkvp_fused_plain", sx, sw, bias, sp, bp,
                  resid)
    n, t, d, _ = _check_qkvp(xq, sx, wq, sw, bias, wp, sp, bp, resid,
                             num_heads, valid_len)
    att = _flat_attention_f32(_qkv_plain(xq, sx, wq, sw, bias), num_heads,
                              scale, valid_len)[0].reshape(n * t, d)
    acc = None
    for lo in range(0, d, 2 * HEAD_DIM):
        hi = lo + 2 * HEAD_DIM
        aq, sa = quantize_rows(att[:, lo:hi])
        part = (int8_mm(aq, wp[:, lo:hi].contiguous()).float() * sa
                * sp.reshape(1, -1))
        acc = (part + bp.reshape(1, -1) + resid.reshape(n * t, d).float()
               if acc is None else acc + part)
    return acc.to(torch.bfloat16).reshape(n, t, d)


def flash_attention_qkvp_fused(
        xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
        sw: torch.Tensor, bias: torch.Tensor, wp: torch.Tensor,
        sp: torch.Tensor, bp: torch.Tensor, resid: torch.Tensor,
        num_heads: int, scale: float, valid_len: int = None) -> torch.Tensor:
    """Kernel wrapper (B15): (N, T, D) int8 row codes, (N, T, 1) fp32 row
    scales, int8 (3D, D) qkv and (D, D) proj weights with fp32 scales and
    biases, bf16 (N, T, D) residual -> (N, T, D) bf16. head_dim 64, even
    head count, any T."""
    check_no_grad("flash_attention_qkvp_fused", sx, sw, bias, sp, bp, resid)
    n, t, d, vl = _check_qkvp(xq, sx, wq, sw, bias, wp, sp, bp, resid,
                              num_heads, valid_len)
    if xq.device.type == "cpu":
        return flash_attention_qkvp_fused_plain(
            xq, sx, wq, sw, bias, wp, sp, bp, resid, num_heads, scale,
            valid_len)
    if xq.device.type != "cuda":
        raise ValueError(f"flash_attention_qkvp_fused: unsupported device "
                         f"{xq.device}")
    lib = load_kernels()
    dev = xq.device
    qkv = torch.empty((n * t, 3 * d), dtype=torch.bfloat16, device=dev)
    aq = torch.empty((n * t, d), dtype=torch.int8, device=dev)
    sa = torch.empty((n * t, d // (2 * HEAD_DIM)), dtype=torch.float32,
                     device=dev)
    out = torch.empty((n, t, d), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_flash_attention_qkvp_fused(
            xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
            bias.data_ptr(), wp.data_ptr(), sp.data_ptr(), bp.data_ptr(),
            resid.data_ptr(), qkv.data_ptr(), aq.data_ptr(), sa.data_ptr(),
            out.data_ptr(), n, t, d, vl, float(scale), stream)
    check_launch(lib, "lseg_flash_attention_qkvp_fused", rc)
    flash_attention_qkvp_fused.launches += 1
    return out


flash_attention_qkvp_fused.launches = 0


def _check_ln_qkv(x, ln_scale, ln_bias, wq, sw, bias, num_heads, valid_len):
    dims = _check_q8(x, wq, sw, bias, num_heads, valid_len)
    d = dims[2]
    if tuple(ln_scale.shape) != (d,) or tuple(ln_bias.shape) != (d,):
        raise ValueError(f"flash_attention_ln_qkv_fused: LayerNorm params "
                         f"{tuple(ln_scale.shape)}, {tuple(ln_bias.shape)} "
                         f"for width {d}")
    check_operands("flash_attention_ln_qkv_fused", {
        "x": (x, torch.bfloat16), "ln_scale": (ln_scale, torch.float32),
        "ln_bias": (ln_bias, torch.float32), "wq": (wq, torch.int8),
        "sw": (sw, torch.float32), "bias": (bias, torch.float32)})
    return dims


def flash_attention_ln_qkv_fused_plain(
        x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
        wq: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
        num_heads: int, scale: float, valid_len: int = None,
        eps: float = 1e-6) -> torch.Tensor:
    """(N, T, D) bf16 raw residual stream -> (N, T, D) bf16: fp32 LN + row
    quantize (`ln_quantize_rows_plain`), then the qkv product and attention
    of `flash_attention_qkv_fused_plain`; B2's plain twin without the
    quantize of its output."""
    check_no_grad("flash_attention_ln_qkv_fused_plain", x, ln_scale, ln_bias,
                  sw, bias)
    _check_ln_qkv(x, ln_scale, ln_bias, wq, sw, bias, num_heads, valid_len)
    xq, sx = ln_quantize_rows_plain(x, ln_scale, ln_bias, eps)
    return _qkv_attention_plain(xq, sx, wq, sw, bias, num_heads, scale,
                                valid_len)


def flash_attention_ln_qkv_fused(
        x: torch.Tensor, ln_scale: torch.Tensor, ln_bias: torch.Tensor,
        wq: torch.Tensor, sw: torch.Tensor, bias: torch.Tensor,
        num_heads: int, scale: float, valid_len: int = None,
        eps: float = 1e-6) -> torch.Tensor:
    """Kernel wrapper (B9): (N, T, D) bf16, fp32 LN params (D,), int8
    (3D, D) weight, fp32 (3D,) scales and bias -> (N, T, D) bf16.
    head_dim 64, D % 256 == 0, D <= 2048, any T."""
    check_no_grad("flash_attention_ln_qkv_fused", x, ln_scale, ln_bias, sw,
                  bias)
    n, t, d, vl = _check_ln_qkv(x, ln_scale, ln_bias, wq, sw, bias,
                                num_heads, valid_len)
    if x.device.type == "cpu":
        return flash_attention_ln_qkv_fused_plain(
            x, ln_scale, ln_bias, wq, sw, bias, num_heads, scale, valid_len,
            eps)
    if x.device.type != "cuda":
        raise ValueError(f"flash_attention_ln_qkv_fused: unsupported device "
                         f"{x.device}")
    if d % 256 or d > 2048:
        raise ValueError(f"flash_attention_ln_qkv_fused kernel needs "
                         f"D % 256 == 0 and D <= 2048, got {d}")
    lib = load_kernels()
    dev = x.device
    xq = torch.empty((n * t, d), dtype=torch.int8, device=dev)
    sx = torch.empty((n * t,), dtype=torch.float32, device=dev)
    qkv = torch.empty((n * t, 3 * d), dtype=torch.bfloat16, device=dev)
    out = torch.empty((n, t, d), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_flash_attention_ln_qkv_fused(
            x.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            wq.data_ptr(), sw.data_ptr(), bias.data_ptr(), xq.data_ptr(),
            sx.data_ptr(), qkv.data_ptr(), out.data_ptr(), n, t, d, vl,
            float(scale), float(eps), stream)
    check_launch(lib, "lseg_flash_attention_ln_qkv_fused", rc)
    flash_attention_ln_qkv_fused.launches += 1
    return out


flash_attention_ln_qkv_fused.launches = 0
