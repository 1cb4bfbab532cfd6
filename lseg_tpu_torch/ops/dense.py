"""Dense product with a bias and residual epilogue (kernel B17).

Replaces `lseg_tpu/ops/pallas_dense.py` · `dense_residual`: y = x @ w + b
(+ residual) with fp32 accumulation, rounded once to `out_dtype`. No model
path of the reference calls it (it is kept there as tested infrastructure
for the MLP's fc2 and the attention projection); the port launches it on
the probe path, `python -m lseg_tpu_torch.probe dense`. The CUDA source is
`lseg_tpu_torch/csrc/dense_residual.cu`; its header says what bounds it on
the card and how each dtype route runs.

`dense_residual` is the wrapper: on a CUDA tensor it launches the kernel
(or raises), on a CPU tensor it runs `dense_residual_plain`. Both take the
reference's `tile_m`, the TPU kernel's row tile, and ignore it: the kernel
masks its ragged row edge instead of padding M.
"""

from __future__ import annotations

import torch

from lseg_tpu_torch.ops._build import (
    check_launch,
    check_no_grad,
    check_operands,
    load_kernels,
)

_FLOATS = (torch.bfloat16, torch.float32)
_RESID_KIND = {None: 0, torch.bfloat16: 1, torch.float32: 2}


def _check(x, w, b, residual, out_dtype):
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1]:
        raise ValueError(f"dense_residual: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}: expected (M, K) and (K, N)")
    m, k = x.shape
    n = w.shape[1]
    if tuple(b.shape) != (n,):
        raise ValueError(f"dense_residual: b {tuple(b.shape)}, expected "
                         f"({n},)")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"dense_residual: residual "
                         f"{tuple(residual.shape)}, expected {(m, n)}")
    for name, dt in (("x", x.dtype), ("out_dtype", out_dtype),
                     ("residual", getattr(residual, "dtype", None))):
        if dt is not None and dt not in _FLOATS:
            raise TypeError(f"dense_residual: {name} must be bf16 or fp32, "
                            f"got {dt}")
    return m, k, n


def dense_residual_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         residual: torch.Tensor | None = None,
                         tile_m: int = 256,
                         out_dtype: torch.dtype = torch.bfloat16
                         ) -> torch.Tensor:
    """(M, K) x, (K, N) w, (N,) b, optional (M, N) residual -> (M, N) in
    `out_dtype`: w cast to x's dtype, the products summed in fp32, then
    the fp32 bias and the residual (read in its own dtype) added in fp32,
    and one rounding. `tile_m` is accepted and unused."""
    check_no_grad("dense_residual_plain", x, w, b, residual)
    _check(x, w, b, residual, out_dtype)
    acc = torch.matmul(x.float(), w.to(x.dtype).float())
    acc = acc + b.float()
    if residual is not None:
        acc = acc + residual.float()
    return acc.to(out_dtype)


def dense_residual(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   residual: torch.Tensor | None = None, tile_m: int = 256,
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Kernel wrapper (B17): the function of `dense_residual_plain`. x
    bf16 runs on the tensor cores, x fp32 in full fp32 FMAs; the kernel
    needs K % 16 == 0 and N % 8 == 0 and takes any M. `tile_m` is
    accepted and unused."""
    check_no_grad("dense_residual", x, w, b, residual)
    m, k, n = _check(x, w, b, residual, out_dtype)
    if x.device.type == "cpu":
        return dense_residual_plain(x, w, b, residual, tile_m, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dense_residual: unsupported device {x.device}")
    if k % 16 or n % 8:
        raise ValueError(f"dense_residual kernel needs K % 16 == 0 and "
                         f"N % 8 == 0, got K={k}, N={n}")
    wx = w.to(x.dtype).contiguous()
    bf = b.float().contiguous()
    operands = {"x": (x, x.dtype), "w": (wx, x.dtype),
                "b": (bf, torch.float32)}
    if residual is not None:
        operands["residual"] = (residual, residual.dtype)
    check_operands("dense_residual", operands)
    lib = load_kernels()
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lseg_dense_residual(
            x.data_ptr(), wx.data_ptr(), bf.data_ptr(),
            0 if residual is None else residual.data_ptr(), out.data_ptr(),
            m, k, n, int(x.dtype == torch.bfloat16),
            _RESID_KIND[getattr(residual, "dtype", None)],
            int(out_dtype == torch.bfloat16), stream)
    check_launch(lib, "lseg_dense_residual", rc)
    dense_residual.launches += 1
    return out


dense_residual.launches = 0
