"""Layers with the reference's rounding points (flax.linen semantics).

- `Dense`: flax `nn.Dense(dtype=dt)` rounds input and kernel to `dt`,
  takes the product (fp32 accumulation, one rounding to `dt`), then adds
  the bias rounded to `dt` in `dt`. The weight is stored in `dt`, which
  is exactly the per-call cast the reference makes.
- `LayerNorm`: statistics and affine in fp32, output cast to `dt`.
- `Conv2d`: NHWC in and out (the reference's layout); the convolution
  runs on an NCHW view of the channels-last tensor, so no copy is made.
  Bias added after the product, in `dt`, as flax `nn.Conv` does.
- `BatchNorm`: eval-mode running statistics, fp32 affine, cast to `dt`.

Every layer takes an explicit `device` and fills its parameters from an
explicit `torch.Generator` in `reset_parameters`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _empty(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator = None) -> None:
    t.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.weight = _empty((out_features, in_features), dtype, device)
        self.bias = _empty((out_features,), dtype, device)

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        self.bias.zero_()

    def forward(self, x):
        return F.linear(x.to(self.weight.dtype), self.weight) + self.bias


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = _empty((dim,), torch.float32, device)
        self.bias = _empty((dim,), torch.float32, device)

    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        return F.layer_norm(x.float(), self.weight.shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


class Conv2d(nn.Module):
    """NHWC conv with an OIHW weight (PyTorch's layout)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int,
                 stride: int = 1, padding: int = 0, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.weight = _empty((out_ch, in_ch, kernel, kernel), dtype, device)
        self.bias = _empty((out_ch,), dtype, device) if bias else None

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        w = self.weight
        y = F.conv2d(x.to(w.dtype).permute(0, 3, 1, 2), w,
                     stride=self.stride, padding=self.padding)
        y = y.permute(0, 2, 3, 1)
        return y + self.bias if self.bias is not None else y


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm (running statistics) over the last axis."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = _empty((features,), torch.float32, device)
        self.bias = _empty((features,), torch.float32, device)
        self.register_buffer("running_mean", torch.zeros(
            features, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.ones(
            features, dtype=torch.float32, device=device))

    def reset_parameters(self, generator=None):
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - self.running_mean) * mul + self.bias
        return y.to(self.dtype)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator = None
                 ) -> nn.Module:
    """Fill every parameter of `module` from `generator` with the
    reference's initialisers (lecun-normal kernels, zero biases, unit
    norms). Seeded random weights stand in for a checkpoint."""
    for m in module.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return module
