"""The LSeg network (torch port of `lseg_tpu/models/lseg.py`, ViT
backbones).

    taps   = DenseViT(x)                      # 4 tapped token sequences
    layers = Reassemble_i(taps_i)             # multi-res pyramid
    rn     = Scratch(layers)                  # common width
    path   = refinenet4..1 cascade            # H/32 -> H/2
    img    = head1(path1)                     # (N, H/2, W/2, out_c)
    out    = correlate(img, text)             # (N, H/2, W/2, K)
    out    = x2 bilinear (align_corners=True) # (N, H, W, K)

The int8 fast config (`fast_serving(cfg, 'static' | 'static_cal')`) sets
`head_fused='lowres'` and `decoder_conv_first`: with text features the
int8 head1 projection and the correlation run in kernel B4
(`ops.head1_correlate`), quantizing path1 on head1's (calibrated or
dynamic) per-tensor grid first. In argmax mode (`return_argmax`)
refinenet1 skips its x2 upsample, B4 correlates at H/4 without the
per-pixel norm, and only the K-logit map is x2-upsampled before the
argmax; otherwise B4 correlates at H/2 with the norm. With
`head_fused=True` (or 'lowres' without `decoder_conv_first`) the argmax
mode runs kernel B5 instead: head1, the correlation and the argmax over K
in one kernel at H/2, which takes the bf16 path1 of a calibrated model and
quantizes it itself; only the label map leaves it. With `head_fused='wup'`
the logits call (no `return_argmax`, no `return_halfres`) runs kernel B14
(`ops.head1_correlate.head1_correlate_wup_fused`): head1, the correlation
with the norm and the x2 W-interp at H/2 in one kernel, leaving only the
bf16 H-interp outside it, as `make_logits_fn` and the TTA evaluator call
it; its argmax and half-res calls take B5 and B4 as above. Kernel B13
(`head1_correlate_upsample_argmax`, the labels of the x2-upsampled logits
in one kernel) serves no call of the model, as in the reference, where
only a script drives it on path1. Without text features
head1 runs unfused (`StaticQuantConv`), as `make_predictor` and the
calibration forward use it.

The fused int8 decoder (`decoder_fused_rcu`, `decoder_fused_tail`; see
`models.blocks`) runs the refinenets' RCUs as kernel B18 and their tails
as kernel B19. Where the fused head runs on a calibrated model, refinenet1
is handed head1's grid (`act_scale / 127`): if its tail takes B19 (no
`decoder_conv_first`) it returns int8 codes on that grid, and B4, B5 and
B14 take them as they are, with no quantize pass of their own.

Text features come precomputed (`text.cache.TextFeatureCache`), so a
label-set swap never re-encodes. Inputs and outputs are NHWC, as in the
reference.
"""

from __future__ import annotations

import torch
from torch import nn

from lseg_tpu_torch import LSegConfig
from lseg_tpu_torch.models.blocks import (
    QUANT_MODES,
    FeatureFusionBlock,
    Reassemble,
    Scratch,
    conv,
)
from lseg_tpu_torch.models.layers import set_param_dtype_
from lseg_tpu_torch.models.vit import DenseViT
from lseg_tpu_torch.ops.correlation import correlate
from lseg_tpu_torch.ops.head1_correlate import (
    head1_correlate_argmax_fused,
    head1_correlate_argmax_fused_plain,
    head1_correlate_fused,
    head1_correlate_fused_plain,
    head1_correlate_wup_fused,
    head1_correlate_wup_fused_plain,
)
from lseg_tpu_torch.ops.quant import quantize_tensor
from lseg_tpu_torch.ops.resize import resize_bilinear, upsample2x


def head_dtype(cfg: LSegConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.head_dtype == "bfloat16" else torch.float32


def _nearest2x(pred: torch.Tensor) -> torch.Tensor:
    """x2 nearest upsample of an (N, H, W) label map."""
    return pred.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _check_supported(cfg: LSegConfig) -> None:
    """Raise for the options whose reference path runs a kernel (or a
    module) the port does not have yet."""
    if not cfg.is_vit:
        raise NotImplementedError("the ResNet backbone is not ported yet")
    vit = cfg.vit
    unported = {
        "arch_option (head blocks 1/2)": cfg.arch_option not in (0,),
        "vit.quant_int8 dynamic": vit.quant_int8 in (True, "dynamic"),
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
      nearest-x2 upsampled (half-res with `return_halfres`).

    `plain=True` swaps every kernel for its plain PyTorch twin.

    The model is built in eval mode, as the reference's `train=False`
    default; `.train()` turns on the BatchNorm batch statistics (training
    calls the forward with text features and gets the full-resolution
    fp32 logits of the parity head). `remat` checkpoints each ViT block;
    `param_dtype` stores the float parameters apart from the compute
    `dtype` (fp32 masters for training, `layers.set_param_dtype_`)."""

    def __init__(self, cfg: LSegConfig, dtype=torch.float32, device=None,
                 plain: bool = False, remat: bool = False,
                 param_dtype: torch.dtype = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.dtype = dtype
        self.plain = plain
        # set by ops.quant.calibrate_act_scales: head1 then runs unfused
        # so that its act_scale site records path1
        self.calibrating = False
        vit = cfg.vit
        q = cfg.decoder_quant
        self.vit = DenseViT(vit, dtype, device, plain, remat)
        for i in range(4):
            self.add_module(f"reassemble{i + 1}", Reassemble(
                vit.post_channels[i], vit.resample[i], vit.embed_dim,
                cfg.readout, dtype, q, device))
        self.scratch = Scratch(vit.post_channels, cfg.features, dtype, q,
                               device)
        for i in range(1, 5):
            self.add_module(f"refinenet{i}", FeatureFusionBlock(
                cfg.features, cfg.use_bn, dtype, with_skip=i != 4, quant=q,
                conv_first=cfg.decoder_conv_first and i == 1,
                device=device, tail_fused=cfg.decoder_fused_tail,
                rcu_fused=cfg.decoder_fused_rcu, plain=plain))
        self.head1 = conv(cfg.features, cfg.out_c, 1, q, dtype,
                          device=device)
        if param_dtype is not None:
            set_param_dtype_(self, param_dtype)
        self.eval()

    def _head1_codes(self, path1, keep_bf16=False):
        """path1 on head1's per-tensor grid: (codes, sx). An int8 path1
        is refinenet1's B19 output, already on head1's calibrated grid.
        With `keep_bf16` a bf16 path1 on the calibrated grid stays bf16 for
        B5 to quantize in the kernel (the same codes)."""
        h1 = self.head1
        if path1.dtype == torch.int8:
            return path1, h1.act_scale / 127.0
        if not h1.static_act:
            return quantize_tensor(path1)
        sx = h1.act_scale / 127.0
        if keep_bf16 and path1.dtype == torch.bfloat16:
            return path1, sx
        return torch.clamp(torch.round(path1.float() / sx), -127, 127
                           ).to(torch.int8), sx

    def _fused_head(self, path1, text_features, normalize):
        """B4 on path1 quantized on head1's per-tensor grid."""
        h1 = self.head1
        xq, sx = self._head1_codes(path1)
        op = head1_correlate_fused_plain if self.plain else \
            head1_correlate_fused
        return op(xq.contiguous(), sx, h1.weight_q, h1.scale, h1.bias,
                  text_features, self.cfg.logit_scale, normalize)

    def _fused_wup_head(self, path1, text_features):
        """B14: (N, H/2, W, K) bf16 logits, upsampled x2 along W only."""
        h1 = self.head1
        xq, sx = self._head1_codes(path1)
        op = head1_correlate_wup_fused_plain if self.plain else \
            head1_correlate_wup_fused
        return op(xq.contiguous(), sx, h1.weight_q, h1.scale, h1.bias,
                  text_features, self.cfg.logit_scale)

    def _fused_argmax_head(self, path1, text_features):
        """B5: (N, H/2, W/2) int32 labels from path1."""
        h1 = self.head1
        x, sx = self._head1_codes(path1, keep_bf16=True)
        op = head1_correlate_argmax_fused_plain if self.plain else \
            head1_correlate_argmax_fused
        return op(x.contiguous(), sx, h1.weight_q, h1.scale, h1.bias,
                  text_features)

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

        use_head_fused = (
            bool(cfg.head_fused) and cfg.decoder_quant in QUANT_MODES
            and cfg.head_dtype == "bfloat16"
            and text_features is not None and not self.calibrating)
        use_lowres_head = (use_head_fused and cfg.head_fused == "lowres"
                           and cfg.decoder_conv_first and return_argmax)
        # head1's grid for refinenet1's fused tail to emit int8 on
        # (reference `lseg.py:168-176`)
        head_scale = (self.head1.act_scale / 127.0
                      if use_head_fused and cfg.decoder_quant == "static_cal"
                      else None)
        path1 = self.refinenet1(path, rn[0],
                                skip_out_upsample=use_lowres_head,
                                out_int8_scale=head_scale)

        hd = head_dtype(cfg)
        if use_lowres_head:
            # raw e.Tn scores at H/4; the positive per-pixel norm is
            # argmax-invariant, the x2 upsample commutes with the head
            s_lo = self._fused_head(path1, text_features, normalize=False)
            up = upsample2x(s_lo, align_corners=True,
                            compute_dtype=torch.bfloat16)
            pred = torch.argmax(up.float(), dim=-1).to(torch.int32)
            return pred if return_halfres else _nearest2x(pred)
        if use_head_fused and return_argmax:
            pred = self._fused_argmax_head(path1, text_features)
            return pred if return_halfres else _nearest2x(pred)
        if use_head_fused and cfg.head_fused == "wup" and not return_halfres:
            # only the H-interp is left outside the kernel
            out = self._fused_wup_head(path1, text_features)
            n, h, w2, _ = out.shape
            return resize_bilinear(out, 2 * h, w2, align_corners=True,
                                   compute_dtype=torch.bfloat16).float()
        if use_head_fused:
            out = self._fused_head(path1, text_features, normalize=True)
            if return_halfres:
                return out
            return upsample2x(out, align_corners=True,
                              compute_dtype=torch.bfloat16).float()

        image_features = self.head1(path1)
        if text_features is None:
            return image_features
        out = correlate(image_features, text_features,
                        logit_scale=cfg.logit_scale, compute_dtype=hd,
                        defer_pixel_norm=cfg.head_dtype == "bfloat16")
        if return_argmax:
            pred = torch.argmax(out.float(), dim=-1).to(torch.int32)
            return pred if return_halfres else _nearest2x(pred)
        if return_halfres:
            return out
        return upsample2x(out, align_corners=True, compute_dtype=hd).float()
