"""Fused int8 ResidualConvUnit (kernel B18).

Replaces `lseg_tpu/ops/pallas_qconv.py` · `fused_rcu`: the whole unit

    out = x + aff2(conv2(q2(relu(aff1(conv1(q1(relu(x))))))))

of the `decoder_fused_rcu` serving decoder, with q_i the calibrated
per-tensor int8 grids, both 3x3 convolutions exact in int32, and aff_i the
eval-mode BatchNorm (or the conv bias) folded with the dequant scales into
one per-channel affine (`fold_bn_affine`). The CUDA source is
`lseg_tpu_torch/csrc/fused_rcu.cu`; its header says what bounds it on the
card and how its tiles stay in shared memory. `rcu_tile` picks the output
tile the kernel takes at each shape; a cluster of C / 64 CTAs shares a
tile, each CTA owning 64 output channels of both convolutions.

`fused_rcu` is the wrapper: on a CUDA tensor it launches the kernel (or
raises), on a CPU tensor it runs `fused_rcu_plain`, the whole-image form of
the TPU kernel's arithmetic (`pallas_qconv.py` · `_rcu_kernel`): codes
round-half-even(max(x, 0) * s1_inv) clipped to +-127, h = acc1 * d1 + e1 in
fp32, codes of max(h, 0) * s2_inv, zero outside the image (conv2's own
zero padding, not conv1 applied to the padded border), y = acc2 * d2 + e2,
out = bf16(y + x) in fp32. The kernels take their 3x3 weights as (Co, 9C)
int8, K ordered (row, column, input channel): `rcu_weight` lays out the
port's OIHW `weight_q` so.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    check_operands,
    load_kernels,
)
from lseg_tpu_torch.ops.quant import int8_mm

# the TPU kernel's row-band sizes, in the order it tries them
_ROWS = (8, 6, 10, 5, 4, 12, 3, 2)


def _pick_rows(h: int):
    for r in _ROWS:
        if h % r == 0:
            return r
    return None


def rcu_fusable(h: int, w: int, c: int) -> bool:
    """The reference's shape gate: lane-aligned channels, a row-band split
    and enough rows and columns for the 2-pixel halo."""
    return c % 128 == 0 and h >= 4 and w >= 8 and _pick_rows(h) is not None


def fold_bn_affine(sx, sw, bn_scale, bn_bias, bn_mean, bn_var,
                   conv_bias=None, eps: float = 1e-5):
    """The int8 dequant (sx * sw per channel) and the eval-mode BatchNorm
    (or the conv bias without BN) folded into one per-channel fp32 affine
    (d, e): y = acc * d + e, op for op as the reference."""
    sx = torch.as_tensor(sx).float()
    sw = sw.float()
    if bn_scale is None:
        d = sx * sw
        e = (conv_bias.float() if conv_bias is not None
             else torch.zeros_like(sw))
        return d, e
    a = bn_scale.float() * torch.rsqrt(bn_var.float() + eps)
    c = bn_bias.float() - bn_mean.float() * a
    d = sx * sw * a
    if conv_bias is not None:
        c = c + conv_bias.float() * a
    return d, c


def rcu_weight(weight_q: torch.Tensor) -> torch.Tensor:
    """OIHW (Co, C, 3, 3) int8 -> the kernels' (Co, 9C), K ordered (row,
    column, input channel)."""
    o = weight_q.shape[0]
    return weight_q.permute(0, 2, 3, 1).reshape(o, -1).contiguous()


# the kernel's tile limits (csrc/fused_rcu.cu): conv2's TR x TC outputs in
# 3 m-blocks of 64 rows, conv1's (TR + 2) x (TC + 2) pixels in 4, the q1
# halo of (TR + 4) x (TC + 4) pixels in its shared-memory tile
RCU_M2_ROWS, RCU_M1_ROWS, RCU_Q1_PIXELS = 192, 256, 320
RCU_CHANNELS = 64  # output channels of one CTA of a tile's cluster


@functools.lru_cache(maxsize=None)
def rcu_tile(h: int, w: int):
    """The (TR, TC) output tile of kernel B18 at an H x W image: the
    fewest tiles within the kernel's limits (every tile costs a cluster the
    same), then the widest rows (8-row ldmatrix groups that do not wrap),
    then the tallest."""
    best = None
    for tr in range(1, 17):
        for tc in range(1, 17):
            if (tr * tc > RCU_M2_ROWS or (tr + 2) * (tc + 2) > RCU_M1_ROWS
                    or (tr + 4) * (tc + 4) > RCU_Q1_PIXELS):
                continue
            key = (-(-h // tr) * -(-w // tc), -tc, -tr)
            if best is None or key < best[0]:
                best = (key, (tr, tc))
    return best[1]


def _codes(v: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """round-half-even(v * inv) clipped to +-127, as int8."""
    return torch.clamp(torch.round(v * inv), -127, 127).to(torch.int8)


def _conv3x3(q: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) int8, zero-padded by one pixel, against (Co, 9C) ->
    (N, H, W, Co) exact int32."""
    n, h, w, c = q.shape
    qp = F.pad(q, (0, 0, 1, 1, 1, 1))
    cols = torch.cat([qp[:, i:i + h, j:j + w] for i in range(3)
                      for j in range(3)], dim=-1)
    return int8_mm(cols.reshape(-1, 9 * c), wk).reshape(n, h, w, -1)


def _check(x, w1q, d1, e1, s1_inv, w2q, d2, e2, s2_inv):
    if x.dim() != 4:
        raise ValueError(f"fused_rcu: x must be (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    want = {"w1q": (c, 9 * c), "w2q": (c, 9 * c), "d1": (c,), "e1": (c,),
            "d2": (c,), "e2": (c,), "s1_inv": (), "s2_inv": ()}
    got = {"w1q": w1q, "w2q": w2q, "d1": d1, "e1": e1, "d2": d2, "e2": e2,
           "s1_inv": s1_inv, "s2_inv": s2_inv}
    for name, v in got.items():
        if tuple(v.shape) != want[name]:
            raise ValueError(f"fused_rcu: {name} {tuple(v.shape)}, expected "
                             f"{want[name]} for x {tuple(x.shape)}")
    check_operands("fused_rcu", {
        "x": (x, torch.bfloat16), "w1q": (w1q, torch.int8),
        "d1": (d1, torch.float32), "e1": (e1, torch.float32),
        "s1_inv": (s1_inv, torch.float32), "w2q": (w2q, torch.int8),
        "d2": (d2, torch.float32), "e2": (e2, torch.float32),
        "s2_inv": (s2_inv, torch.float32)})


def fused_rcu_plain(x: torch.Tensor, w1q: torch.Tensor, d1: torch.Tensor,
                    e1: torch.Tensor, s1_inv: torch.Tensor, w2q: torch.Tensor,
                    d2: torch.Tensor, e2: torch.Tensor,
                    s2_inv: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) bf16, (C, 9C) int8 kernels, fp32 (C,) affines and fp32
    scalar inverse scales -> (N, H, W, C) bf16, over the whole image."""
    check_no_grad("fused_rcu_plain", x, d1, e1, s1_inv, d2, e2, s2_inv)
    _check(x, w1q, d1, e1, s1_inv, w2q, d2, e2, s2_inv)
    xf = x.float()
    q1 = _codes(torch.clamp(xf, min=0.0), s1_inv)
    h = _conv3x3(q1, w1q).float() * d1 + e1
    q2 = _codes(torch.clamp(h, min=0.0), s2_inv)
    y = _conv3x3(q2, w2q).float() * d2 + e2
    return (y + xf).to(torch.bfloat16)


def fused_rcu(x: torch.Tensor, w1q: torch.Tensor, d1: torch.Tensor,
              e1: torch.Tensor, s1_inv: torch.Tensor, w2q: torch.Tensor,
              d2: torch.Tensor, e2: torch.Tensor,
              s2_inv: torch.Tensor) -> torch.Tensor:
    """Kernel wrapper (B18): the arguments of `fused_rcu_plain` ->
    (N, H, W, C) bf16. C % 64 == 0; any H and W."""
    check_no_grad("fused_rcu", x, d1, e1, s1_inv, d2, e2, s2_inv)
    _check(x, w1q, d1, e1, s1_inv, w2q, d2, e2, s2_inv)
    if x.device.type == "cpu":
        return fused_rcu_plain(x, w1q, d1, e1, s1_inv, w2q, d2, e2, s2_inv)
    if x.device.type != "cuda":
        raise ValueError(f"fused_rcu: unsupported device {x.device}")
    n, h, w, c = x.shape
    if c % 64 or c > 256:
        raise ValueError(f"fused_rcu kernel needs C % 64 == 0 and C <= 256, "
                         f"got C={c}")
    tr, tc = rcu_tile(h, w)
    lib = load_kernels()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_fused_rcu(
            x.data_ptr(), w1q.data_ptr(), d1.data_ptr(), e1.data_ptr(),
            s1_inv.data_ptr(), w2q.data_ptr(), d2.data_ptr(), e2.data_ptr(),
            s2_inv.data_ptr(), out.data_ptr(), n, h, w, c, tr, tc, stream)
    check_launch(lib, "lseg_fused_rcu", rc)
    fused_rcu.launches += 1
    return out


fused_rcu.launches = 0
