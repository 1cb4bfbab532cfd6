"""Int8 product with three summed 128-wide scale slices (kernel B20).

Replaces the Pallas kernel of `scripts/mosaic_probe.py` (`main`, body
`kernel`), the reference's probe of a Mosaic toolchain regression: x
(N, T, D) int8 times w (D, 128) int8 into int32, taken as fp32, times each
of three 128-wide slices of 384 scales, the three products summed with
Python's `sum` and rounded to bf16. Its four variants hold the same 384
floats in two block shapes (`SCALE_SHAPES`), so one kernel serves all
four. The port launches it on the probe path, `python -m
lseg_tpu_torch.probe <variant>`. The CUDA source is
`lseg_tpu_torch/csrc/int8_sliced_scale.cu`; its header says what bounds it
on the card.

`int8_matmul_sliced_scale` is the wrapper: on a CUDA tensor it launches
the kernel (or raises), on a CPU tensor it runs
`int8_matmul_sliced_scale_plain`.
"""

from __future__ import annotations

import torch

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_operands,
    load_kernels,
)
from lseg_tpu_torch.ops.quant import int8_mm

SLICE = 128
# the reference's variant -> the shape of its scale block (and array)
SCALE_SHAPES = {"sliced": (1, 1, 3 * SLICE), "rows": (3, SLICE),
                "rows1d": (3, SLICE), "bcast": (1, 1, 3 * SLICE)}


def _check(x, w, sw):
    if x.dim() != 3 or tuple(w.shape) != (x.shape[2], SLICE):
        raise ValueError(f"int8_matmul_sliced_scale: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}: expected (N, T, D) and "
                         f"(D, {SLICE})")
    if tuple(sw.shape) not in SCALE_SHAPES.values():
        raise ValueError(f"int8_matmul_sliced_scale: scales "
                         f"{tuple(sw.shape)}, expected one of "
                         f"{sorted(set(SCALE_SHAPES.values()))}")
    check_operands("int8_matmul_sliced_scale", {
        "x": (x, torch.int8), "w": (w, torch.int8),
        "sw": (sw, torch.float32)})
    return x.shape


def int8_matmul_sliced_scale_plain(x: torch.Tensor, w: torch.Tensor,
                                   sw: torch.Tensor) -> torch.Tensor:
    """(N, T, D) int8, (D, 128) int8, 384 fp32 scales in either block
    shape -> (N, T, 128) bf16 = bf16(sum(acc * s_i for i in 0, 1, 2)),
    acc the exact int32 product as fp32."""
    n, t, d = _check(x, w, sw)
    acc = int8_mm(x.reshape(n * t, d), w.t().contiguous()).float()
    s = sw.reshape(3, SLICE)
    parts = [acc * s[i] for i in range(3)]
    return sum(parts).to(torch.bfloat16).reshape(n, t, SLICE)


def int8_matmul_sliced_scale(x: torch.Tensor, w: torch.Tensor,
                             sw: torch.Tensor, lib=None) -> torch.Tensor:
    """Kernel wrapper (B20): the function of
    `int8_matmul_sliced_scale_plain`; D % 64 == 0, 0 < D <= 1024 (the int32
    sums stay exact in fp32). `lib` is the kernel library to launch from:
    the port's (`load_kernels()`, the default) or the probe's library of
    this one source."""
    n, t, d = _check(x, w, sw)
    if x.device.type == "cpu":
        return int8_matmul_sliced_scale_plain(x, w, sw)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul_sliced_scale: unsupported device "
                         f"{x.device}")
    if d % 64 or not 0 < d <= 1024:
        raise ValueError(f"int8_matmul_sliced_scale kernel needs D % 64 == 0 "
                         f"and 0 < D <= 1024, got {d}")
    w_t = w.t().contiguous()  # the (128, D) column-major B of the tile
    if lib is None:
        lib = load_kernels()
    out = torch.empty((n, t, SLICE), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_int8_sliced_scale(x.data_ptr(), w_t.data_ptr(),
                                        sw.data_ptr(), out.data_ptr(), n * t,
                                        d, stream)
    check_launch(lib, "lseg_int8_sliced_scale", rc)
    int8_matmul_sliced_scale.launches += 1
    return out


int8_matmul_sliced_scale.launches = 0
