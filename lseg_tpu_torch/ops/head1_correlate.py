"""Fused int8 head1 projection + image-text correlation: kernel B4
(logits), kernel B14 (logits upsampled x2 along W), kernel B13 (labels of
the x2-upsampled logits) and kernel B5 (labels, the argmax over K in the
kernel).

B4 replaces `lseg_tpu/ops/pallas_correlation.py` · `head1_correlate_fused`
(CUDA: `lseg_tpu_torch/csrc/head1_correlate.cu`); B14 replaces
`head1_correlate_wup_fused` (`csrc/head1_correlate_wup.cu`); B13 replaces
`head1_correlate_upsample_argmax`
(`csrc/head1_correlate_upsample_argmax.cu`); B5 replaces
`head1_correlate_argmax_fused_t` and its row-major form B12
`head1_correlate_argmax_fused` (CUDA:
`lseg_tpu_torch/csrc/head1_correlate_argmax.cu`). B4 runs on the
SIMT-staged tile of `csrc/head1_tile.cuh`; B13, B14 and B5 on the wgmma +
TMA tile of `csrc/head1_wgmma.cuh`, whose logits are B4's bit for bit:
B13 walks down strips of source rows (`b13_grid`), B14 and B5 take
persistent grids of 128-pixel steps (`b14_ctas`), and all three walk the
labels in chunks of at most 152. Path1 wider than 256 channels (no
registered config: `features` is 256) takes B14's and B5's earlier
kernels on B4's tile (`csrc/head1_correlate_wup_wide.cu`,
`csrc/head1_correlate_argmax_wide.cu`); B13 refuses it. The
sources' headers say what bounds each on the card and how the (M, 512)
pixel-embedding map stays out of device memory.

`head1_correlate_fused`, `head1_correlate_wup_fused`,
`head1_correlate_upsample_argmax` and `head1_correlate_argmax_fused` are
the wrappers: on a CUDA tensor they launch their kernel (or raise), on a
CPU tensor they run their `_plain` twin. All take the same host-side
preparation as the reference's wrappers: the text matrix L2-normalised in
fp32, times the temperature (not for B5), cast to bf16 (`text_matrix`),
and the fp32 product sx * s1 of the activation scale and the per-channel
weight scales. The x2 upsample of B13 and B14 is the align-corners
operator of `ops.resize`, its weights rounded to bf16 as the reference's
kernels take them.
"""

from __future__ import annotations

import numpy as np
import torch

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    load_kernels,
)
from lseg_tpu_torch.ops.quant import int8_mm
from lseg_tpu_torch.ops.resize import _interp_matrix, interp_matrix

# shared memory of one SM that a block may take (H100: 227 KB)
SMEM_LIMIT = 232448
# the widest path1 the wgmma + TMA head tile takes (two 128-byte k-chunks
# of codes); wider path1 takes B14's and B5's `*_wide.cu` kernels
WGMMA_MAX_C = 256


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


def _int8_operands(name, xq, sx, w1q, s1, b1, text_features, logit_scale):
    """Checks and operands of the int8-code kernels B4, B14 and B13 on the
    card: ((N, H, W, C, E), (codes, kernel (E, C), sc, b1, tn))."""
    if xq.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {xq.device}")
    dims, w1q, sc, tn = _prepare(xq, sx, w1q, s1, b1, text_features,
                                 logit_scale)
    c, e = dims[3], dims[4]
    if xq.dtype != torch.int8 or w1q.dtype != torch.int8:
        raise TypeError(f"{name} kernel takes int8 codes and kernel, got "
                        f"{xq.dtype}, {w1q.dtype}")
    if c % 32 or e % 128:
        raise ValueError(f"{name} kernel needs C % 32 == 0 and E % 128 == 0,"
                         f" got C={c}, E={e}")
    ops = (xq, w1q, sc, b1.float().contiguous(), tn)
    for arg, v in zip(("xq", "w1q", "sc", "b1", "tn"), ops):
        if not v.is_contiguous() or v.data_ptr() % 16 or v.device != xq.device:
            raise ValueError(f"{name}: {arg} must be contiguous, 16-byte "
                             f"aligned and on {xq.device}")
    return dims, ops


def _tile_smem(c: int, e: int) -> int:
    """Bytes of shared memory of the head1 tile (`head1_tile.cuh`
    `layout(c, e).total`): B14's C > 256 route keeps a row's (W, K)
    logits beside it."""
    ldx, lde = c + 16, e + 8
    return (64 * ldx + 64 * lde * 2 + max(128 * ldx, 32 * lde * 2)
            + 2 * 64 * 4)


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
    (n, h, w, c, e), ops = _int8_operands("head1_correlate_fused", xq, sx,
                                          w1q, s1, b1, text_features,
                                          logit_scale)
    k = text_features.shape[0]
    lib = load_kernels()
    out = torch.empty((n, h, w, k), dtype=torch.bfloat16, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_head1_correlate(*[v.data_ptr() for v in ops],
                                      out.data_ptr(), n * h * w, c, e, k,
                                      int(normalize), stream)
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
    features -> (N, H, W) int32 labels. C % 32 == 0, E % 128 == 0; a
    persistent grid of one CTA an SM."""
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
    wide = c > WGMMA_MAX_C
    entry = ("lseg_head1_correlate_argmax_wide" if wide
             else "lseg_head1_correlate_argmax")
    grid = () if wide else (_sms(x.device),)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(
            x.data_ptr(), sxt.data_ptr(), w1q.data_ptr(), sc.data_ptr(),
            b1.data_ptr(), tn.data_ptr(), out.data_ptr(), n * h * w, c, e,
            tn.shape[0], int(x.dtype == torch.bfloat16), *grid, stream)
    check_launch(lib, entry, rc)
    head1_correlate_argmax_fused.launches += 1
    return out


head1_correlate_argmax_fused.launches = 0


def w_interp_bf16(x: torch.Tensor) -> torch.Tensor:
    """The tail of B14 after the logits: the x2 align-corners interp along
    W of (N, H, W, K) bf16 with the bf16 operator, fp32 sums, rounded to
    bf16: (N, H, 2W, K)."""
    w = x.shape[2]
    wi = interp_matrix(w, 2 * w, True, torch.bfloat16, x.device).float()
    return torch.einsum("ow,nhwk->nhok", wi, x.float()).to(torch.bfloat16)


def head1_correlate_wup_fused_plain(xq: torch.Tensor, sx,
                                    w1q: torch.Tensor, s1: torch.Tensor,
                                    b1: torch.Tensor,
                                    text_features: torch.Tensor,
                                    logit_scale: float = 1.0 / 0.07
                                    ) -> torch.Tensor:
    """(N, H, W, C) int8 codes -> (N, H, 2W, K) bf16: the normalized
    logits of `head1_correlate_fused_plain`, then the x2 align-corners
    interp along W (the (2W, W) operator in bf16, fp32 sums, bf16)."""
    return w_interp_bf16(head1_correlate_fused_plain(
        xq, sx, w1q, s1, b1, text_features, logit_scale, True))


def head1_correlate_wup_fused(xq: torch.Tensor, sx, w1q: torch.Tensor,
                              s1: torch.Tensor, b1: torch.Tensor,
                              text_features: torch.Tensor,
                              logit_scale: float = 1.0 / 0.07
                              ) -> torch.Tensor:
    """Kernel wrapper (B14): the arguments of `head1_correlate_fused` ->
    (N, H, 2W, K) bf16. C % 32 == 0, E % 128 == 0; past C = 256 (the
    earlier kernel of `head1_correlate_wup_wide.cu`) also the head1 tile
    plus one row's (W, K) bf16 logits within an SM's shared memory."""
    check_no_grad("head1_correlate_wup_fused", sx, s1, b1, text_features)
    if xq.device.type == "cpu":
        return head1_correlate_wup_fused_plain(xq, sx, w1q, s1, b1,
                                               text_features, logit_scale)
    (n, h, w, c, e), ops = _int8_operands("head1_correlate_wup_fused", xq,
                                          sx, w1q, s1, b1, text_features,
                                          logit_scale)
    k = text_features.shape[0]
    wide = c > WGMMA_MAX_C
    if wide and _tile_smem(c, e) + w * k * 2 > SMEM_LIMIT:
        raise ValueError(f"head1_correlate_wup_fused kernel: at C={c} > "
                         f"{WGMMA_MAX_C} a row of W={w} x K={k} logits does "
                         f"not fit in shared memory")
    lib = load_kernels()
    out = torch.empty((n, h, 2 * w, k), dtype=torch.bfloat16,
                      device=xq.device)
    entry = ("lseg_head1_correlate_wup_wide" if wide
             else "lseg_head1_correlate_wup")
    grid = () if wide else (b14_ctas(w, _sms(xq.device)),)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(*[v.data_ptr() for v in ops],
                                 out.data_ptr(), n, h, w, c, e, k, *grid,
                                 stream)
    check_launch(lib, entry, rc)
    head1_correlate_wup_fused.launches += 1
    return out


head1_correlate_wup_fused.launches = 0


def _h_taps(h: int):
    """The reference kernel's H taps of the x2 align-corners upsample:
    per output row, the first source row with a positive weight and
    f = 1 - that weight in fp32."""
    ah = _interp_matrix(h, 2 * h, True)
    ho = np.argmax(ah > 0, axis=1)
    return ho, (1.0 - ah[np.arange(2 * h), ho]).astype(np.float32)


def head1_correlate_upsample_argmax_plain(xq: torch.Tensor, sx,
                                          w1q: torch.Tensor,
                                          s1: torch.Tensor,
                                          b1: torch.Tensor,
                                          text_features: torch.Tensor,
                                          logit_scale: float = 1.0 / 0.07
                                          ) -> torch.Tensor:
    """(N, H, W, C) int8 codes -> (N, 2H, 2W) int32 labels: the normalized
    logits of `head1_correlate_fused_plain` (bf16); the H-blend
    lo[ho] * (1 - f) + lo[ho + 1] * f in fp32, rounded to bf16; the W
    interp of `head1_correlate_wup_fused_plain`; the first argmax over K
    in fp32 (`upsample_argmax_bf16`)."""
    return upsample_argmax_bf16(head1_correlate_fused_plain(
        xq, sx, w1q, s1, b1, text_features, logit_scale, True))


def upsample_argmax_bf16(lo: torch.Tensor) -> torch.Tensor:
    """The tail of B13 after the logits: (N, H, W, K) bf16 -> (N, 2H, 2W)
    int32, the H-blend lo[ho] * (1 - f) + lo[ho + 1] * f in fp32 rounded
    to bf16, `w_interp_bf16`, the first argmax over K in fp32."""
    h = lo.shape[1]
    ho, f = _h_taps(h)
    dev = lo.device
    f = torch.from_numpy(f).to(dev).reshape(1, -1, 1, 1)
    a = lo[:, torch.from_numpy(ho).to(dev)].float()
    b = lo[:, torch.from_numpy(np.minimum(ho + 1, h - 1)).to(dev)].float()
    hb = (a * (1.0 - f) + b * f).to(torch.bfloat16)
    return torch.argmax(w_interp_bf16(hb).float(), dim=-1).to(torch.int32)


# the head kernels' wgmma tile (csrc/head1_wgmma.cuh): a strip of 127
# source columns (one step of 128 pixels with the column it shares), label
# chunks of 152 (19 tiles of 8 in a thread's registers); B13's segments of
# at most 64 source rows, and its labels within its keys' 16 bits
B13_STRIP, B13_MAX_SEG, HEAD_KG, B13_MAX_K = 127, 64, 152, 0xFFFF


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def b14_ctas(w: int, sms: int) -> int:
    """Kernel B14's persistent grid at W source columns on a card of
    `sms` SMs: the strips of 127 source columns that cover the left taps
    0 .. W - 2 (one at W = 1), times the source rows a round of steps
    takes, one CTA an SM where the strips allow."""
    strips = max(1, -(-(w - 1) // B13_STRIP))
    return strips * max(1, sms // strips)


def b13_grid(n: int, h: int, w: int, sms: int):
    """Kernel B13's grid at (N, H, W) codes on a card of `sms` SMs: the
    strips of 127 source columns that cover the left taps 0 .. W - 2 (one
    at W = 1), and the segment length: the fewest source rows a segment
    that still give one CTA an SM, at most 64. Returns (strips, segment
    rows, segments)."""
    strips = max(1, -(-(w - 1) // B13_STRIP))
    per = max(1, sms // (strips * n))
    seg = min(B13_MAX_SEG, -(-h // per))
    return strips, seg, -(-h // seg)


def head1_correlate_upsample_argmax(xq: torch.Tensor, sx,
                                    w1q: torch.Tensor, s1: torch.Tensor,
                                    b1: torch.Tensor,
                                    text_features: torch.Tensor,
                                    logit_scale: float = 1.0 / 0.07
                                    ) -> torch.Tensor:
    """Kernel wrapper (B13): the arguments of `head1_correlate_fused` ->
    (N, 2H, 2W) int32 labels. C % 32 == 0, C <= 256, E % 128 == 0,
    K < 65536 (in chunks of 152 labels)."""
    check_no_grad("head1_correlate_upsample_argmax", sx, s1, b1,
                  text_features)
    if xq.device.type == "cpu":
        return head1_correlate_upsample_argmax_plain(
            xq, sx, w1q, s1, b1, text_features, logit_scale)
    (n, h, w, c, e), ops = _int8_operands("head1_correlate_upsample_argmax",
                                          xq, sx, w1q, s1, b1, text_features,
                                          logit_scale)
    k = text_features.shape[0]
    if c > WGMMA_MAX_C or k > B13_MAX_K:
        raise ValueError(f"head1_correlate_upsample_argmax kernel needs "
                         f"C <= {WGMMA_MAX_C} and K <= {B13_MAX_K}, got "
                         f"C={c}, K={k}")
    _, seg, _ = b13_grid(n, h, w, _sms(xq.device))
    lib = load_kernels()
    out = torch.empty((n, 2 * h, 2 * w), dtype=torch.int32, device=xq.device)
    with torch.cuda.device(xq.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_head1_correlate_upsample_argmax(
            *[v.data_ptr() for v in ops], out.data_ptr(), n, h, w, c, e, k,
            seg, stream)
    check_launch(lib, "lseg_head1_correlate_upsample_argmax", rc)
    head1_correlate_upsample_argmax.launches += 1
    return out


head1_correlate_upsample_argmax.launches = 0


def correlate_sum_probe(ef: torch.Tensor, tn: torch.Tensor):
    """(M, E) bf16(e) and (K, E) bf16 text on the card -> two (M, K) fp32
    sums of ef . tn^T, k16 step by k16 step in ascending order: on wgmma
    m64n64k16 and on mma.sync m16n8k16 (`csrc/head1_sum_probe.cu`), for a
    bit-for-bit comparison. A probe of the tensor cores, not a path's
    kernel: no launch count."""
    if ef.device.type != "cuda" or ef.dtype != torch.bfloat16 or (
            tn.dtype != torch.bfloat16 or ef.shape[1] != tn.shape[1]
            or ef.shape[1] % 64):
        raise ValueError(f"correlate_sum_probe: bf16 (M, E), (K, E) on the "
                         f"card, E % 64 == 0; got {tuple(ef.shape)} "
                         f"{ef.dtype} {ef.device}, {tuple(tn.shape)}")
    ef, tn = ef.contiguous(), tn.contiguous()
    m, e = ef.shape
    k = tn.shape[0]
    out = torch.empty((2, m, k), dtype=torch.float32, device=ef.device)
    lib = load_kernels()
    with torch.cuda.device(ef.device):
        rc = lib.lseg_head1_sum_probe(
            ef.data_ptr(), tn.data_ptr(), out[0].data_ptr(),
            out[1].data_ptr(), m, k, e,
            torch.cuda.current_stream().cuda_stream)
    check_launch(lib, "lseg_head1_sum_probe", rc)
    return out[0], out[1]
