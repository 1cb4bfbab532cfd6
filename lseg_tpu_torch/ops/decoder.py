"""Fused decoder tail (kernel B19): x2 align-corners bilinear upsample,
activation quantize and the int8 1x1 `out_conv`, optionally emitting int8.

Replaces `lseg_tpu/ops/pallas_decoder.py` · `fused_upsample_outconv`, the
`decoder_fused_tail` path of the FeatureFusionBlock. The CUDA source is
`lseg_tpu_torch/csrc/fused_upsample_outconv.cu`; its header says what
bounds it on the card and why no row of the upsampled tensor reaches
device memory.

`fused_upsample_outconv` is the wrapper: on a CUDA tensor it launches the
kernel (or raises), on a CPU tensor it runs `fused_upsample_outconv_plain`,
the whole-image form of the TPU kernel's arithmetic (`pallas_decoder.py` ·
`_tail_kernel`), for output pixel (jo, io):

    hb = bf16(x[ho[jo]] * w0[jo] + x[ho[jo] + 1] * w1[jo])     fp32 sum
    ub = bf16(hb[wo[io]] * v0[io] + hb[wo[io] + 1] * v1[io])  fp32 sum
    q  = clip(round-half-even(ub * (1 / s_in)), +-127)
    y  = (q . wq) * (s_in * sw) + b                           int32 -> fp32
    out = bf16(y), or int8 clip(round-half-even(y * (1 / out_scale)), +-127)

The taps are the rows of the port's `ops.resize._interp_matrix`, each
rounded to bf16 on its own (bf16(1 - f) != 1 - bf16(f)), the reference's
bf16 interp operator: every blend is one fp32 sum of two exact products of
bf16 values, rounded once, so kernel and plain twin agree bit for bit. The
second tap is 0 where it would leave the image and reads the last row or
column there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    check_operands,
    load_kernels,
)
from lseg_tpu_torch.ops.quant import int8_mm
from lseg_tpu_torch.ops.resize import _interp_matrix


def tail_fusable(h: int, w: int, c: int, co: int) -> bool:
    """The reference's shape gate: lane-aligned channels and an upsampled
    width that is a multiple of 8."""
    return c % 128 == 0 and co % 128 == 0 and (2 * w) % 8 == 0 and h >= 2


@functools.lru_cache(maxsize=64)
def interp_taps(n: int, device) -> torch.Tensor:
    """The x2 align-corners taps of an axis of length n, cached on
    `device`: (3, 2n) fp32 rows of, per output index, the first source
    index with a positive weight (as a float, exact), that weight, and the
    next one (0 at the edge), each weight rounded to bf16 on its own."""
    a = _interp_matrix(n, 2 * n, True)
    ab = torch.from_numpy(a).to(torch.bfloat16).float().numpy()
    lo = np.argmax(a > 0, axis=1)
    idx = np.arange(2 * n)
    hi = np.minimum(lo + 1, n - 1)
    t1 = np.where(hi > lo, ab[idx, hi], 0.0)
    return torch.from_numpy(np.stack([lo, ab[idx, lo], t1]).astype(
        np.float32)).to(device)


def _check(x, wq, sw, b, s_in, out_scale):
    if x.dim() != 4:
        raise ValueError(f"fused_upsample_outconv: x must be (N, H, W, C), "
                         f"got {tuple(x.shape)}")
    c = x.shape[-1]
    co = wq.shape[0]
    want = {"wq": (co, c), "sw": (co,), "b": (co,), "s_in": ()}
    got = {"wq": wq, "sw": sw, "b": b, "s_in": s_in}
    ops = {"x": (x, torch.bfloat16), "wq": (wq, torch.int8),
           "sw": (sw, torch.float32), "b": (b, torch.float32),
           "s_in": (s_in, torch.float32)}
    if out_scale is not None:
        want["out_scale"] = ()
        got["out_scale"] = out_scale
        ops["out_scale"] = (out_scale, torch.float32)
    for name, v in got.items():
        if tuple(v.shape) != want[name]:
            raise ValueError(f"fused_upsample_outconv: {name} "
                             f"{tuple(v.shape)}, expected {want[name]} for x "
                             f"{tuple(x.shape)}")
    check_operands("fused_upsample_outconv", ops)
    return co


def _scales(s_in, sw, out_scale):
    """(1 / s_in, s_in * sw, 1 / out_scale or 1): fp32 reciprocals of the
    rounded quotients, as the reference forms them."""
    inv_in = 1.0 / s_in
    inv_out = (1.0 / out_scale if out_scale is not None
               else torch.ones_like(s_in))
    return inv_in, s_in * sw, inv_out


def fused_upsample_outconv_plain(x: torch.Tensor, wq: torch.Tensor,
                                 sw: torch.Tensor, b: torch.Tensor,
                                 s_in: torch.Tensor,
                                 out_scale: torch.Tensor = None
                                 ) -> torch.Tensor:
    """(N, H, W, C) bf16, (Co, C) int8 1x1 kernel, fp32 (Co,) weight scales
    and bias, fp32 scalar input scale (amax / 127) -> (N, 2H, 2W, Co) bf16,
    or int8 on the grid `out_scale` where it is given."""
    check_no_grad("fused_upsample_outconv_plain", x, sw, b, s_in, out_scale)
    _check(x, wq, sw, b, s_in, out_scale)
    n, h, w, c = x.shape
    dev = x.device
    th, tw = interp_taps(h, dev), interp_taps(w, dev)
    ho = th[0].long()
    hb = (x[:, ho].float() * th[1].reshape(1, -1, 1, 1)
          + x[:, torch.clamp(ho + 1, max=h - 1)].float()
          * th[2].reshape(1, -1, 1, 1)).to(torch.bfloat16)
    wo = tw[0].long()
    ub = (hb[:, :, wo].float() * tw[1].reshape(1, 1, -1, 1)
          + hb[:, :, torch.clamp(wo + 1, max=w - 1)].float()
          * tw[2].reshape(1, 1, -1, 1)).to(torch.bfloat16)
    inv_in, sc, inv_out = _scales(s_in, sw, out_scale)
    q = torch.clamp(torch.round(ub.float() * inv_in), -127, 127
                    ).to(torch.int8)
    y = int8_mm(q.reshape(-1, c), wq).float() * sc + b
    y = y.reshape(n, 2 * h, 2 * w, -1)
    if out_scale is None:
        return y.to(torch.bfloat16)
    return torch.clamp(torch.round(y * inv_out), -127, 127).to(torch.int8)


def fused_upsample_outconv(x: torch.Tensor, wq: torch.Tensor,
                           sw: torch.Tensor, b: torch.Tensor,
                           s_in: torch.Tensor,
                           out_scale: torch.Tensor = None) -> torch.Tensor:
    """Kernel wrapper (B19): the arguments of
    `fused_upsample_outconv_plain` -> (N, 2H, 2W, Co) bf16 or int8.
    C % 32 == 0, C <= 256 and Co % 128 == 0; H, W >= 2."""
    check_no_grad("fused_upsample_outconv", x, sw, b, s_in, out_scale)
    co = _check(x, wq, sw, b, s_in, out_scale)
    if x.device.type == "cpu":
        return fused_upsample_outconv_plain(x, wq, sw, b, s_in, out_scale)
    if x.device.type != "cuda":
        raise ValueError(f"fused_upsample_outconv: unsupported device "
                         f"{x.device}")
    n, h, w, c = x.shape
    if c % 32 or c > 256 or co % 128 or h < 2 or w < 2:
        raise ValueError(f"fused_upsample_outconv kernel needs C % 32 == 0, "
                         f"C <= 256, Co % 128 == 0 and H, W >= 2, got C={c}, "
                         f"Co={co}, H={h}, W={w}")
    lib = load_kernels()
    th, tw = interp_taps(h, x.device), interp_taps(w, x.device)
    inv_in, sc, inv_out = _scales(s_in, sw, out_scale)
    out = torch.empty((n, 2 * h, 2 * w, co), device=x.device,
                      dtype=torch.bfloat16 if out_scale is None
                      else torch.int8)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_fused_upsample_outconv(
            x.data_ptr(), th.data_ptr(), tw.data_ptr(), wq.data_ptr(),
            sc.data_ptr(), b.data_ptr(), inv_in.data_ptr(),
            inv_out.data_ptr(), out.data_ptr(), n, h, w, c, co,
            int(out_scale is not None), stream)
    check_launch(lib, "lseg_fused_upsample_outconv", rc)
    fused_upsample_outconv.launches += 1
    return out


fused_upsample_outconv.launches = 0
