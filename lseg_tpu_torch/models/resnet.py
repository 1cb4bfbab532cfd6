"""ResNet-101 image backbone of the `clip_resnet101` variant (torch port of
`lseg_tpu/models/resnet.py`).

The reference repackages a torchvision resnet101 into 4 stages whose
outputs feed the scratch/fusion decoder with channels (256, 512, 1024,
2048); stage 1 bundles the stem (7x7 stride-2 conv, BN, relu, 3x3
stride-2 max pool) with layer1. NHWC in and out, as the reference; the
convolutions are the cuDNN convolutions of `layers.Conv2d` (the reference
runs this backbone outside any Pallas kernel) and the BatchNorms
`layers.BatchNorm`: running statistics in eval mode, batch statistics
(and running-statistics updates) under `.train()`.

`all_taps=True` is HSNet's feature-extraction mode: the forward returns
every bottleneck's pre-relu sum (`out + identity` before the block's last
relu), in block order, instead of the stage outputs.

The module names follow the reference's parameter tree (`conv1`, `bn1`,
`layer{s}_block{b}.conv{1,2,3}` / `bn{1,2,3}` / `down_conv` / `down_bn`),
so `utils.convert.from_jax_variables` fills it without a renaming.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from lseg_tpu_torch.config import ResNetConfig
from lseg_tpu_torch.models.layers import BatchNorm, Conv2d

PLANES = (64, 128, 256, 512)
EXPANSION = 4


class Bottleneck(nn.Module):
    """torchvision Bottleneck: 1x1 reduce -> 3x3 (the stride here) -> 1x1
    expand x4, BN after each conv, relu, identity or projection
    shortcut."""

    def __init__(self, in_ch: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        out = planes * EXPANSION
        self.conv1 = Conv2d(in_ch, planes, 1, bias=False, dtype=dtype,
                            device=device)
        self.bn1 = BatchNorm(planes, 1e-5, dtype, device)
        self.conv2 = Conv2d(planes, planes, 3, stride, 1, False, dtype, device)
        self.bn2 = BatchNorm(planes, 1e-5, dtype, device)
        self.conv3 = Conv2d(planes, out, 1, bias=False, dtype=dtype,
                            device=device)
        self.bn3 = BatchNorm(out, 1e-5, dtype, device)
        if downsample:
            self.down_conv = Conv2d(in_ch, out, 1, stride, 0, False, dtype,
                                    device)
            self.down_bn = BatchNorm(out, 1e-5, dtype, device)

    def forward(self, x: torch.Tensor, with_prerelu: bool = False):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = (self.down_bn(self.down_conv(x))
                    if hasattr(self, "down_conv") else x)
        pre = out + identity
        post = torch.relu(pre)
        return (post, pre) if with_prerelu else post


class ResNetBackbone(nn.Module):
    """(N, H, W, 3) -> the 4-stage feature pyramid (strides 4, 8, 16, 32;
    channels 256 .. 2048), or with `all_taps` every block's pre-relu
    sum."""

    def __init__(self, cfg: ResNetConfig, dtype=torch.float32, device=None,
                 all_taps: bool = False):
        super().__init__()
        self.all_taps = all_taps
        self.conv1 = Conv2d(3, 64, 7, 2, 3, False, dtype, device)
        self.bn1 = BatchNorm(64, 1e-5, dtype, device)
        in_ch = 64
        for stage, (n_blocks, planes) in enumerate(zip(cfg.layers, PLANES)):
            stride = 1 if stage == 0 else 2
            for b in range(n_blocks):
                self.add_module(f"layer{stage + 1}_block{b}", Bottleneck(
                    in_ch, planes, stride if b == 0 else 1, b == 0, dtype,
                    device))
                in_ch = planes * EXPANSION
        self.layers = tuple(cfg.layers)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = torch.relu(self.bn1(self.conv1(x)))
        # torch MaxPool2d(3, stride=2, padding=1): the reference pads with
        # -inf and pools VALID, the same function
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        outs, taps = [], []
        for stage, n_blocks in enumerate(self.layers):
            for b in range(n_blocks):
                block = getattr(self, f"layer{stage + 1}_block{b}")
                if self.all_taps:
                    x, pre = block(x, with_prerelu=True)
                    taps.append(pre)
                else:
                    x = block(x)
            outs.append(x)
        return taps if self.all_taps else outs
