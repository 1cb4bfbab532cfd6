"""VGG16 feature extractor, HSNet's third backbone (torch port of
`lseg_tpu/models/vgg.py`).

The reference loads torchvision's vgg16 and taps the OUTPUT of the
modules of `features` at indices (17, 19, 21, 24, 26, 28, 30): conv
outputs before their relu for 17..28, and the last max pool's output for
30. The modules here keep torchvision's `features` indexing (`conv{idx}`
at the conv indices 0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28), so
`utils.checkpoint_convert.torchvision_vgg16_key_map` is a renaming. NHWC
in and out; the convolutions are the cuDNN convolutions of
`layers.Conv2d`.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from lseg_tpu_torch.models.layers import Conv2d

# torchvision vgg16 cfg 'D': out channels per conv, "M" a 2x2 max pool
VGG16_LAYOUT = (
    64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
    512, 512, 512, "M", 512, 512, 512, "M",
)
HSNET_VGG_TAPS = (17, 19, 21, 24, 26, 28, 30)


def vgg16_conv_indices() -> List[int]:
    """The `features` index of every conv of the layout (a conv and its
    relu take two indices, a pool one)."""
    out, idx = [], 0
    for item in VGG16_LAYOUT:
        if item != "M":
            out.append(idx)
        idx += 1 if item == "M" else 2
    return out


class VGG16Features(nn.Module):
    """(N, H, W, 3) -> the outputs of the modules listed in `taps`
    (torchvision `features` indexing), in index order."""

    def __init__(self, taps: Sequence[int] = HSNET_VGG_TAPS,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.taps = frozenset(taps)
        cin = 3
        for idx, item in zip(vgg16_conv_indices(),
                             (c for c in VGG16_LAYOUT if c != "M")):
            self.add_module(f"conv{idx}", Conv2d(cin, item, 3, 1, 1, True,
                                                 dtype, device))
            cin = item

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = []
        idx = 0
        for item in VGG16_LAYOUT:
            if item == "M":
                x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(
                    0, 2, 3, 1)
                if idx in self.taps:
                    outs.append(x)
                idx += 1
                continue
            x = getattr(self, f"conv{idx}")(x)
            if idx in self.taps:  # conv output, before its relu
                outs.append(x)
            x = torch.relu(x)
            if idx + 1 in self.taps:
                outs.append(x)
            idx += 2
        return outs
