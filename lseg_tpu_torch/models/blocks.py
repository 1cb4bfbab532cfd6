"""DPT decoder blocks (torch port of `lseg_tpu/models/blocks.py`):
readout, reassemble, scratch projection and RefineNet-style fusion.
Activations stay NHWC as in the reference; the float convolutions run on
NCHW views of the channels-last tensors.

`quant` is the config's `decoder_quant`: 'static' / 'static_cal' swap the
readout dense and the reassemble, scratch, RCU and out_conv convolutions
for their pre-quantized int8 twins (`ops.quant`), with dynamic or
calibrated activation scales, and run the fusion x2 upsample in the model
dtype. `DepthwiseHeadBlock` and `BottleneckHeadBlock` are the spatial
regularisation blocks that `arch_option` 2 and 1 put between the
correlation and the output upsample.

The fused int8 decoder of the serving config (`quant='static_cal'`, bf16):
`decoder_fused_rcu` runs a whole ResidualConvUnit as kernel B18
(`ops.qconv.fused_rcu`) and `decoder_fused_tail` the fusion block's x2
upsample + quantize + out_conv as kernel B19
(`ops.decoder.fused_upsample_outconv`), which at refinenet1 can emit int8
codes on the fused head's grid. Each routes by the reference's own gate
(config, mode and shape; `lseg_tpu/models/blocks.py:222-230` and
`:346-353`): calibration takes the unfused path so the convs record their
input ranges, and so does training for the RCU. The fused paths read the
same `conv1/conv2/bn1/bn2/out_conv` modules, so the state dict does not
change; the kernels' operands (weights in their layout, the folded
BatchNorm affines, the inverse scales) are prepared once per module state,
not per call.
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
from lseg_tpu_torch.ops.decoder import (
    fused_upsample_outconv,
    fused_upsample_outconv_plain,
    tail_fusable,
)
from lseg_tpu_torch.ops.qconv import (
    fold_bn_affine,
    fused_rcu,
    fused_rcu_plain,
    rcu_fusable,
    rcu_weight,
)
from lseg_tpu_torch.ops.quant import (
    StaticQuantConv,
    StaticQuantDense,
    div127,
    inv127,
)
from lseg_tpu_torch.ops.resize import upsample2x

QUANT_MODES = ("static", "static_cal")


def conv(in_ch: int, out_ch: int, kernel: int, quant=False,
         dtype=torch.float32, stride: int = 1, padding: int = 0,
         bias: bool = True, device=None) -> nn.Module:
    """`Conv2d`, or its pre-quantized int8 twin for `quant` 'static'
    (dynamic activation scales) / 'static_cal' (calibrated), as the
    reference's `_conv`."""
    if quant in QUANT_MODES:
        return StaticQuantConv(in_ch, out_ch, kernel, stride, padding, bias,
                               dtype, quant == "static_cal", device)
    return Conv2d(in_ch, out_ch, kernel, stride, padding, bias, dtype,
                  device)


class ProjectReadout(nn.Module):
    """concat(patch, cls) -> Linear(2D -> D) -> exact GELU; the linear
    is the int8 `StaticQuantDense` under `quant`."""

    def __init__(self, dim: int, dtype=torch.float32, quant=False,
                 device=None):
        super().__init__()
        self.project = (StaticQuantDense(2 * dim, dim, dtype, device=device)
                        if quant in QUANT_MODES
                        else Dense(2 * dim, dim, dtype, device))

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
        wm = self.weight.to(self.dtype).permute(0, 2, 3, 1).reshape(
            c, s * s * o)
        y = torch.matmul(x.to(self.dtype).float(), wm.float())
        y = (y.reshape(n, h, w, s, s, o) + self.bias).to(self.dtype)
        return y.permute(0, 1, 3, 2, 4, 5).reshape(n, h * s, w * s, o)


class Reassemble(nn.Module):
    """Tokens -> feature map: readout -> unflatten -> 1x1 conv ->
    resample (token upsample, identity or stride-2 3x3 conv)."""

    def __init__(self, out_channels: int, resample: float, vit_dim: int,
                 readout: str, dtype=torch.float32, quant=False,
                 device=None):
        super().__init__()
        self.kind = readout
        self.vit_dim = vit_dim
        if readout == "project":
            self.readout = ProjectReadout(vit_dim, dtype, quant, device)
        self.proj = conv(vit_dim, out_channels, 1, quant, dtype,
                         device=device)
        if resample > 1:
            # the token upsample stays float under quant, as in the
            # reference
            self.resample = TokenUpsample(out_channels, int(resample),
                                          dtype, device)
        elif resample < 1:
            self.resample = conv(out_channels, out_channels, 3, quant, dtype,
                                 stride=2, padding=1, device=device)
        else:
            self.resample = nn.Identity()

    def forward(self, tokens: torch.Tensor,
                grid: Tuple[int, int]) -> torch.Tensor:
        gh, gw = grid
        x = apply_readout(getattr(self, "readout", None), tokens, self.kind)
        x = x.reshape(x.shape[0], gh, gw, self.vit_dim)
        return self.resample(self.proj(x))


def _prepared(module: nn.Module, tensors, make):
    """`make()`, kept on `module` until one of `tensors` is replaced or
    modified in place (`load_state_dict`, `.to()`): a fused kernel's
    operands are prepared once per module state, not per call."""
    key = tuple((t.data_ptr(), t._version) for t in tensors if t is not None)
    hit = module.__dict__.get("_prepared_ops")
    if hit is None or hit[0] != key:
        hit = (key, make())
        module.__dict__["_prepared_ops"] = hit
    return hit[1]


class ResidualConvUnit(nn.Module):
    """relu -> 3x3 conv -> [BN] -> relu -> 3x3 conv -> [BN] + residual.
    Conv bias only without BN. `fused` runs the unit as kernel B18 where
    the reference's gate lets it (see the module docstring); `plain` takes
    the kernel's plain twin instead."""

    def __init__(self, features: int, use_bn: bool = True,
                 dtype=torch.float32, quant=False, device=None,
                 fused: bool = False, plain: bool = False):
        super().__init__()
        self.features = features
        self.use_bn = use_bn
        self.quant = quant
        self.fused = fused
        self.plain = plain
        kw = dict(quant=quant, dtype=dtype, padding=1, bias=not use_bn,
                  device=device)
        self.conv1 = conv(features, features, 3, **kw)
        self.conv2 = conv(features, features, 3, **kw)
        if use_bn:
            self.bn1 = BatchNorm(features, 1e-5, dtype, device)
            self.bn2 = BatchNorm(features, 1e-5, dtype, device)

    def _takes_kernel(self, x: torch.Tensor) -> bool:
        """The reference's gate (`blocks.py:222-230`)."""
        _, h, w, c = x.shape
        return (self.fused and self.quant == "static_cal"
                and not self.training
                and not (self.conv1.calibrating or self.conv2.calibrating)
                and rcu_fusable(h, w, c) and c == self.features)

    def _kernel_operands(self):
        """(w1 (C, 9C), d1, e1, 127 / a1, w2, d2, e2, 127 / a2): the int8
        kernels in the kernel's layout and the BatchNorm (or bias) folded
        with the dequant scales a_i / 127, as `blocks.py:246-251`."""
        convs = (self.conv1, self.conv2)
        bns = (self.bn1, self.bn2) if self.use_bn else (None, None)
        tensors = [t for cv in convs for t in (cv.weight_q, cv.scale,
                                               cv.bias, cv.act_scale)]
        tensors += [t for bn in bns if bn is not None
                    for t in (bn.weight, bn.bias, bn.running_mean,
                              bn.running_var)]

        def make():
            ops = []
            for cv, bn in zip(convs, bns):
                stats = ((bn.weight, bn.bias, bn.running_mean,
                          bn.running_var) if bn is not None else (None,) * 4)
                d, e = fold_bn_affine(div127(cv.act_scale), cv.scale, *stats,
                                      conv_bias=cv.bias)
                ops += [rcu_weight(cv.weight_q), d.contiguous(),
                        e.contiguous(), inv127(cv.act_scale)]
            return tuple(ops)

        return _prepared(self, tensors, make)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._takes_kernel(x):
            op = fused_rcu_plain if self.plain else fused_rcu
            return op(x.contiguous(), *self._kernel_operands())
        out = self.conv1(torch.relu(x))
        if self.use_bn:
            out = self.bn1(out)
        out = self.conv2(torch.relu(out))
        if self.use_bn:
            out = self.bn2(out)
        return out + x


class FeatureFusionBlock(nn.Module):
    """(+ RCU1(skip)) -> RCU2 -> x2 bilinear (align_corners) -> 1x1
    out_conv. The upsample computes in fp32 on the unquantized path and in
    the model dtype under `quant`. `conv_first` runs out_conv BEFORE the
    upsample (they commute exactly: a channel-only conv, a spatial-only
    interpolation whose rows sum to 1); `skip_out_upsample` then returns
    the low-resolution conv output (the lowres serving head).

    `tail_fused` runs the upsample + quantize + out_conv tail as kernel
    B19 where the reference's gate lets it, after the `conv_first` branch;
    with `out_int8_scale` (the consumer's calibrated grid) it then returns
    int8 codes on that grid instead of bf16. `rcu_fused` makes both RCUs
    take kernel B18; `plain` takes the kernels' plain twins."""

    def __init__(self, features: int, use_bn: bool = True,
                 dtype=torch.float32, with_skip: bool = True, quant=False,
                 conv_first: bool = False, device=None,
                 tail_fused: bool = False, rcu_fused: bool = False,
                 plain: bool = False):
        super().__init__()
        self.features = features
        self.quant = quant
        self.conv_first = conv_first
        self.tail_fused = tail_fused
        self.plain = plain
        self.up_dtype = dtype if quant in QUANT_MODES else torch.float32
        kw = dict(device=device, fused=rcu_fused, plain=plain)
        if with_skip:
            self.rcu1 = ResidualConvUnit(features, use_bn, dtype, quant, **kw)
        self.rcu2 = ResidualConvUnit(features, use_bn, dtype, quant, **kw)
        self.out_conv = conv(features, features, 1, quant, dtype,
                             device=device)

    def _tail_takes_kernel(self, x: torch.Tensor) -> bool:
        """The reference's gate (`blocks.py:346-353`): no training term."""
        _, h, w, c = x.shape
        return (self.tail_fused and self.quant == "static_cal"
                and not self.out_conv.calibrating
                and tail_fusable(h, w, c, self.features))

    def _fused_tail(self, x: torch.Tensor, out_scale) -> torch.Tensor:
        oc = self.out_conv
        op = (fused_upsample_outconv_plain if self.plain
              else fused_upsample_outconv)
        wq = oc.weight_q.reshape(oc.weight_q.shape[0], -1)   # (Co, C) view
        return op(x.contiguous(), wq, oc.scale, oc.bias,
                  div127(oc.act_scale), out_scale)

    def forward(self, x: torch.Tensor, skip: torch.Tensor = None,
                skip_out_upsample: bool = False,
                out_int8_scale: torch.Tensor = None) -> torch.Tensor:
        if skip is not None:
            x = x + self.rcu1(skip)
        x = self.rcu2(x)
        if self.conv_first:
            x = self.out_conv(x)
            if skip_out_upsample:
                return x
            return upsample2x(x, align_corners=True,
                              compute_dtype=self.up_dtype)
        if self._tail_takes_kernel(x):
            return self._fused_tail(x, out_int8_scale)
        x = upsample2x(x, align_corners=True, compute_dtype=self.up_dtype)
        return self.out_conv(x)


class Scratch(nn.Module):
    """Four 3x3 no-bias convs projecting the pyramid to `features`."""

    def __init__(self, in_channels: Sequence[int], features: int,
                 dtype=torch.float32, quant=False, device=None):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"layer{i + 1}_rn", conv(
                c, features, 3, quant, dtype, padding=1, bias=False,
                device=device))

    def forward(self, layers: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [getattr(self, f"layer{i + 1}_rn")(x)
                for i, x in enumerate(layers)]


_ACTIVATIONS = {
    "relu": torch.relu,
    "lrelu": lambda x: F.leaky_relu(x, 0.01),
    "tanh": torch.tanh,
}


class DepthwiseHeadBlock(nn.Module):
    """arch_option 2: one shared 3x3 single-channel conv (weight (1, 1, 3,
    3), bias (1,)) applied depthwise over all K class channels of the
    (N, H, W, K) logits, in fp32, then the activation unless `act=False`
    (reference: lang-seg `lseg_net.py:29-58`)."""

    def __init__(self, activation: str = "relu", device=None):
        super().__init__()
        self.activation = _ACTIVATIONS[activation]
        self.weight = nn.Parameter(torch.empty(
            (1, 1, 3, 3), dtype=torch.float32, device=device),
            requires_grad=False)
        self.bias = nn.Parameter(torch.empty(
            (1,), dtype=torch.float32, device=device), requires_grad=False)

    def reset_parameters(self, generator=None):
        lecun_normal_(self.weight, 9, generator)
        self.bias.zero_()

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        k = x.shape[-1]
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.expand(k, 1, 3, 3),
                     padding=1, groups=k)
        return y.permute(0, 2, 3, 1) + self.bias

    def forward(self, x: torch.Tensor, act: bool = True) -> torch.Tensor:
        y = self._conv(x)
        return self.activation(y) if act else y


class BottleneckHeadBlock(DepthwiseHeadBlock):
    """arch_option 1: the depthwise block plus each pixel's max over the
    K channels as a residual, before the activation (reference: lang-seg
    `lseg_net.py:61-79`)."""

    def forward(self, x: torch.Tensor, act: bool = True) -> torch.Tensor:
        y = self._conv(x) + x.amax(dim=-1, keepdim=True)
        return self.activation(y) if act else y

