"""Layers with the reference's rounding points (flax.linen semantics).

- `Dense`: flax `nn.Dense(dtype=dt)` rounds input and kernel to `dt`,
  takes the product (fp32 accumulation, one rounding to `dt`), then adds
  the bias rounded to `dt` in `dt`.
- `LayerNorm`: statistics and affine in fp32, output cast to `dt`.
- `Conv2d`: NHWC in and out (the reference's layout); the convolution
  runs on an NCHW view of the channels-last tensor, so no copy is made.
  Bias added after the product, in `dt`, as flax `nn.Conv` does.
- `BatchNorm`: flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)`, driven by
  `nn.Module.train()`. Eval mode normalizes with the running statistics;
  train mode with the batch statistics, taken in fp32 as
  E[x^2] - E[x]^2 clamped at 0 (flax's `_compute_stats`), and updates the
  running statistics with the BIASED variance (which `F.batch_norm` does
  not). fp32 affine, output cast to `dt`. With a process group of more
  than one rank (`parallel.dist.sync_batchnorm_`) the train-mode
  statistics are those of the global batch: one differentiable
  all_reduce of each rank's (sum, sum of squares, count) in float64, so
  the backward carries the cross-rank terms (the reference's
  `sync_batchnorm=True`; JAX's global view computes the same).

Storage and compute dtypes are apart, as flax's `param_dtype` and `dtype`
are: every layer casts its parameters to its compute dtype at each call.
Serving models store the kernels in the compute dtype, so the cast is a
no-op; a training model keeps fp32 masters (`set_param_dtype_`) and gets
the same forward numbers, since the reference casts its fp32 parameters
the same way.

Every layer takes an explicit `device` and fills its parameters from an
explicit `torch.Generator` in `reset_parameters`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from lseg_tpu_torch.parallel.dist import all_reduce_sum, size


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
        self.dtype = dtype
        self.weight = _empty((out_features, in_features), dtype, device)
        self.bias = _empty((out_features,), dtype, device)

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight.shape[1], generator)
        self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


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
        self.dtype = dtype
        self.weight = _empty((out_ch, in_ch, kernel, kernel), dtype, device)
        self.bias = _empty((out_ch,), dtype, device) if bias else None

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            self.bias.zero_()

    def forward(self, x):
        dt = self.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt),
                     stride=self.stride, padding=self.padding)
        y = y.permute(0, 2, 3, 1)
        return y + self.bias.to(dt) if self.bias is not None else y


class BatchNorm(nn.Module):
    """BatchNorm over the last axis (flax semantics, see the module
    docstring); the running statistics keep MOMENTUM of their old
    value, as the reference's `nn.BatchNorm(momentum=0.9)`."""

    MOMENTUM = 0.9
    group = None  # the data group of the batch statistics (None: local)

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
        xf = x.float()
        if self.training:
            axes = tuple(range(xf.dim() - 1))
            if size(self.group) > 1:
                mean, var = self._global_stats(xf, axes)
            else:
                mean = xf.mean(dim=axes)
                var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean,
                                  min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var
                                       + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype)

    def _global_stats(self, xf, axes):
        """(E[x], max(E[x^2] - E[x]^2, 0)) over every rank's batch."""
        c = xf.shape[-1]
        count = xf.new_full((1,), xf.numel() // c, dtype=torch.float64)
        sums = all_reduce_sum(torch.cat([xf.sum(dim=axes).double(),
                                         (xf * xf).sum(dim=axes).double(),
                                         count]), self.group)
        mean = (sums[:c] / sums[-1]).float()
        var = torch.clamp((sums[c:2 * c] / sums[-1]).float() - mean * mean,
                          min=0.0)
        return mean, var


def set_param_dtype_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store every floating-point parameter of `module` in `dtype` (flax's
    `param_dtype`); integer leaves (int8 codes) keep theirs. The layers
    cast to their compute dtype at each call, so fp32 masters give the
    forward of the compute-dtype storage."""
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module


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
