"""DPT decoder blocks (torch port of the unquantized paths of
`lseg_tpu/models/blocks.py`): readout, reassemble, scratch projection and
RefineNet-style fusion. Activations stay NHWC as in the reference; the
convolutions run on NCHW views of the channels-last tensors.

The spatial-regularisation head blocks (`arch_option` 1/2) and the int8
serving paths are not ported yet.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from lseg_tpu_torch.models.layers import (
    BatchNorm,
    Conv2d,
    Dense,
    lecun_normal_,
)
from lseg_tpu_torch.ops.resize import upsample2x


class ProjectReadout(nn.Module):
    """concat(patch, cls) -> Linear(2D -> D) -> exact GELU."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.project = Dense(2 * dim, dim, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, t, d = x.shape
        feats = torch.cat([x[:, 1:], x[:, :1].expand(n, t - 1, d)], dim=-1)
        return F.gelu(self.project(feats), approximate="none")


def apply_readout(readout: nn.Module, x: torch.Tensor,
                  kind: str) -> torch.Tensor:
    """The three readout ops; returns patch tokens (N, gh*gw, D)."""
    if kind == "ignore":
        return x[:, 1:]
    if kind == "add":
        return x[:, 1:] + x[:, :1]
    if kind == "project":
        return readout(x)
    raise ValueError(f"unknown readout {kind!r}")


class TokenUpsample(nn.Module):
    """k=s stride-s transposed conv as one matmul + pixel shuffle.

    The weight has ConvTranspose2d's layout (C_in, C_out, s, s). The
    product takes bf16-rounded operands in fp32 and the fp32 bias is
    added before the cast, as the reference's einsum with an fp32
    accumulator does."""

    def __init__(self, channels: int, scale: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.scale = scale
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(
            (channels, channels, scale, scale), dtype=dtype, device=device),
            requires_grad=False)
        self.bias = nn.Parameter(torch.empty(
            (channels,), dtype=torch.float32, device=device),
            requires_grad=False)

    def reset_parameters(self, generator=None):
        c, _, s, _ = self.weight.shape
        lecun_normal_(self.weight, c * s * s, generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        s = self.scale
        o = self.weight.shape[1]
        wm = self.weight.permute(0, 2, 3, 1).reshape(c, s * s * o)
        y = torch.matmul(x.to(self.dtype).float(), wm.float())
        y = (y.reshape(n, h, w, s, s, o) + self.bias).to(self.dtype)
        return y.permute(0, 1, 3, 2, 4, 5).reshape(n, h * s, w * s, o)


class Reassemble(nn.Module):
    """Tokens -> feature map: readout -> unflatten -> 1x1 conv ->
    resample (token upsample, identity or stride-2 3x3 conv)."""

    def __init__(self, out_channels: int, resample: float, vit_dim: int,
                 readout: str, dtype=torch.float32, device=None):
        super().__init__()
        self.kind = readout
        self.vit_dim = vit_dim
        if readout == "project":
            self.readout = ProjectReadout(vit_dim, dtype, device)
        self.proj = Conv2d(vit_dim, out_channels, 1, dtype=dtype,
                           device=device)
        if resample > 1:
            self.resample = TokenUpsample(out_channels, int(resample),
                                          dtype, device)
        elif resample < 1:
            self.resample = Conv2d(out_channels, out_channels, 3, stride=2,
                                   padding=1, dtype=dtype, device=device)
        else:
            self.resample = nn.Identity()

    def forward(self, tokens: torch.Tensor,
                grid: Tuple[int, int]) -> torch.Tensor:
        gh, gw = grid
        x = apply_readout(getattr(self, "readout", None), tokens, self.kind)
        x = x.reshape(x.shape[0], gh, gw, self.vit_dim)
        return self.resample(self.proj(x))


class ResidualConvUnit(nn.Module):
    """relu -> 3x3 conv -> [BN] -> relu -> 3x3 conv -> [BN] + residual.
    Conv bias only without BN."""

    def __init__(self, features: int, use_bn: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.use_bn = use_bn
        kw = dict(padding=1, bias=not use_bn, dtype=dtype, device=device)
        self.conv1 = Conv2d(features, features, 3, **kw)
        self.conv2 = Conv2d(features, features, 3, **kw)
        if use_bn:
            self.bn1 = BatchNorm(features, 1e-5, dtype, device)
            self.bn2 = BatchNorm(features, 1e-5, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv1(torch.relu(x))
        if self.use_bn:
            out = self.bn1(out)
        out = self.conv2(torch.relu(out))
        if self.use_bn:
            out = self.bn2(out)
        return out + x


class FeatureFusionBlock(nn.Module):
    """(+ RCU1(skip)) -> RCU2 -> x2 bilinear (align_corners, fp32
    compute on the unquantized path) -> 1x1 out_conv."""

    def __init__(self, features: int, use_bn: bool = True,
                 dtype=torch.float32, with_skip: bool = True, device=None):
        super().__init__()
        if with_skip:
            self.rcu1 = ResidualConvUnit(features, use_bn, dtype, device)
        self.rcu2 = ResidualConvUnit(features, use_bn, dtype, device)
        self.out_conv = Conv2d(features, features, 1, dtype=dtype,
                               device=device)

    def forward(self, x: torch.Tensor,
                skip: torch.Tensor = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        x = upsample2x(x, align_corners=True, compute_dtype=torch.float32)
        return self.out_conv(x)


class Scratch(nn.Module):
    """Four 3x3 no-bias convs projecting the pyramid to `features`."""

    def __init__(self, in_channels: Sequence[int], features: int,
                 dtype=torch.float32, device=None):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"layer{i + 1}_rn", Conv2d(
                c, features, 3, padding=1, bias=False, dtype=dtype,
                device=device))

    def forward(self, layers: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [getattr(self, f"layer{i + 1}_rn")(x)
                for i, x in enumerate(layers)]
