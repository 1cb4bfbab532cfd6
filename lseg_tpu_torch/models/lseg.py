"""The LSeg network (torch port of `lseg_tpu/models/lseg.py`, ViT
backbones, unquantized paths).

    taps   = DenseViT(x)                      # 4 tapped token sequences
    layers = Reassemble_i(taps_i)             # multi-res pyramid
    rn     = Scratch(layers)                  # common width
    path   = refinenet4..1 cascade            # H/32 -> H/2
    img    = head1(path1)                     # (N, H/2, W/2, out_c)
    out    = correlate(img, text)             # (N, H/2, W/2, K)
    out    = x2 bilinear (align_corners=True) # (N, H, W, K)

Text features come precomputed (`text.cache.TextFeatureCache`), so a
label-set swap never re-encodes. Inputs and outputs are NHWC, as in the
reference.
"""

from __future__ import annotations

import torch
from torch import nn

from lseg_tpu_torch import LSegConfig
from lseg_tpu_torch.models.blocks import (
    FeatureFusionBlock,
    Reassemble,
    Scratch,
)
from lseg_tpu_torch.models.layers import Conv2d
from lseg_tpu_torch.models.vit import DenseViT
from lseg_tpu_torch.ops.correlation import correlate
from lseg_tpu_torch.ops.resize import upsample2x


def head_dtype(cfg: LSegConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.head_dtype == "bfloat16" else torch.float32


def _nearest2x(pred: torch.Tensor) -> torch.Tensor:
    """x2 nearest upsample of an (N, H, W) label map."""
    return pred.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _check_supported(cfg: LSegConfig) -> None:
    if not cfg.is_vit:
        raise NotImplementedError("the ResNet backbone is not ported yet")
    unported = {
        "arch_option": cfg.arch_option not in (0,),
        "decoder_quant": bool(cfg.decoder_quant),
        "head_fused": bool(cfg.head_fused),
        "decoder_conv_first": cfg.decoder_conv_first,
        "decoder_fused_tail": cfg.decoder_fused_tail,
        "decoder_fused_rcu": cfg.decoder_fused_rcu,
        "vit.quant_int8": bool(cfg.vit.quant_int8),
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"config options not ported yet: {', '.join(bad)}")


class LSegNet(nn.Module):
    """forward(x (N, H, W, 3), text_features (K, out_c) or None).

    - `text_features=None`: the (N, H/2, W/2, out_c) pixel embeddings;
    - default: (N, H, W, K) fp32 logits;
    - `return_halfres`: skip the x2 output upsample;
    - `return_argmax`: (N, H, W) int32 labels from the half-res argmax,
      nearest-x2 upsampled (half-res with `return_halfres`)."""

    def __init__(self, cfg: LSegConfig, dtype=torch.float32, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        vit = cfg.vit
        self.vit = DenseViT(vit, dtype, device)
        for i in range(4):
            self.add_module(f"reassemble{i + 1}", Reassemble(
                vit.post_channels[i], vit.resample[i], vit.embed_dim,
                cfg.readout, dtype, device))
        self.scratch = Scratch(vit.post_channels, cfg.features, dtype,
                               device)
        for i in range(1, 5):
            self.add_module(f"refinenet{i}", FeatureFusionBlock(
                cfg.features, cfg.use_bn, dtype, with_skip=i != 4,
                device=device))
        self.head1 = Conv2d(cfg.features, cfg.out_c, 1, dtype=dtype,
                            device=device)

    def forward(self, x: torch.Tensor, text_features: torch.Tensor = None,
                return_halfres: bool = False, return_argmax: bool = False):
        cfg = self.cfg
        taps, grid = self.vit(x)
        layers = [getattr(self, f"reassemble{i + 1}")(taps[i], grid)
                  for i in range(4)]
        rn = self.scratch(layers)
        path = self.refinenet4(rn[3])
        path = self.refinenet3(path, rn[2])
        path = self.refinenet2(path, rn[1])
        path = self.refinenet1(path, rn[0])
        image_features = self.head1(path)
        if text_features is None:
            return image_features

        hd = head_dtype(cfg)
        out = correlate(image_features, text_features,
                        logit_scale=cfg.logit_scale, compute_dtype=hd,
                        defer_pixel_norm=cfg.head_dtype == "bfloat16")
        if return_argmax:
            pred = torch.argmax(out.float(), dim=-1).to(torch.int32)
            return pred if return_halfres else _nearest2x(pred)
        if return_halfres:
            return out
        return upsample2x(out, align_corners=True, compute_dtype=hd).float()
