"""Hypercorrelation Squeeze Network (HSNet), the reference's few-shot
baseline side-car (torch port of `lseg_tpu/models/hsnet.py`).

    taps   = backbone(query), backbone(support) # frozen, pre-relu taps
    taps_s = taps_s * resize(support_mask)      # align_corners=True
    pyr    = multilayer_correlation(taps_q, taps_s)  # [layer4, 3, 2]
    logits = HPNLearner(pyr)                    # (B, h, w, 2)
    logits = resize(logits, H, W)               # unless use_original_imgsize

Hypercorrelations are channels-last 6-D tensors (B, ha, wa, hb, wb, C):
query plane (ha, wa), support plane (hb, wb). A center-pivot 4-D
convolution is two 2-D convolutions, one over the query plane at the
stride-pruned support pivots and one over the support plane (stride s),
each with the other plane folded into the batch: one cuDNN convolution
each, as the reference runs them outside Pallas. The building blocks'
GroupNorm is `layers.GroupNorm`, flax's (epsilon 1e-6).

The backbone is frozen: `HSNet.train()` leaves it in eval mode, so its
BatchNorms keep their running statistics (the reference never passes
`train` to it), and its taps are computed without gradient. Module names
follow the reference's parameter tree (`backbone`, `hpn_learner.
encoder_layer4.conv4d_0.conv_query`, `... .gn_0`, `decoder1_conv1`, ...),
so `utils.convert.from_jax_variables` fills the model without a renaming.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch import nn

from lseg_tpu_torch.config import ResNetConfig
from lseg_tpu_torch.models.layers import Conv2d, GroupNorm, set_param_dtype_
from lseg_tpu_torch.models.resnet import ResNetBackbone
from lseg_tpu_torch.models.vgg import VGG16Features
from lseg_tpu_torch.ops.resize import resize_bilinear

CORR_EPS = 1e-5


def multilayer_correlation(query_feats: Sequence[torch.Tensor],
                           support_feats: Sequence[torch.Tensor],
                           stack_sizes: Tuple[int, int, int]
                           ) -> List[torch.Tensor]:
    """Per-tap channel-normalised cosine correlations in fp32, relu-clamped,
    stacked channels-last into the [layer4, layer3, layer2] pyramid of
    (B, ha, wa, hb, wb, n) tensors. `stack_sizes` = (#layer4, #layer3,
    #layer2) taps, counted from the end of the lists. Each group is
    written into one preallocated tensor, so a correlation is held once
    beside it."""
    n4, n3, n2 = stack_sizes
    n = len(query_feats)
    groups = [(n - n4, n), (n - n4 - n3, n - n4), (n - n4 - n3 - n2,
                                                   n - n4 - n3)]
    pyramid = []
    for lo, hi in groups:
        out = None
        for j, i in enumerate(range(lo, hi)):
            q = query_feats[i].float()
            s = support_feats[i].float()
            q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True)
                     + CORR_EPS)
            s = s / (torch.linalg.vector_norm(s, dim=-1, keepdim=True)
                     + CORR_EPS)
            b, ha, wa, c = q.shape
            hb, wb = s.shape[1:3]
            if out is None:
                out = q.new_empty((b, ha, wa, hb, wb, hi - lo))
            corr = torch.matmul(q.reshape(b, ha * wa, c),
                                s.reshape(b, hb * wb, c).transpose(1, 2))
            out[..., j] = corr.clamp_(min=0.0).reshape(b, ha, wa, hb, wb)
            del corr
        pyramid.append(out)
    return pyramid


class CenterPivotConv4d(nn.Module):
    """x (B, ha, wa, hb, wb, C) -> (B, ha, wa, hb', wb', F): `conv_query`
    over the query plane at the support pivots `x[..., ::s, ::s, :]`, plus
    `conv_support` over the support plane at stride s."""

    def __init__(self, in_ch: int, features: int, kernel: int,
                 stride: int = 1, dtype=torch.float32, device=None):
        super().__init__()
        self.stride = stride
        pad = kernel // 2
        self.conv_query = Conv2d(in_ch, features, kernel, 1, pad, True,
                                 dtype, device)
        self.conv_support = Conv2d(in_ch, features, kernel, stride, pad,
                                   True, dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, ha, wa, hb, wb, c = x.shape
        s = self.stride
        xp = x[:, :, :, ::s, ::s] if s > 1 else x
        hb2, wb2 = xp.shape[3], xp.shape[4]
        a = xp.permute(0, 3, 4, 1, 2, 5).reshape(b * hb2 * wb2, ha, wa, c)
        a = self.conv_query(a)
        f = a.shape[-1]
        out = self.conv_support(x.reshape(b * ha * wa, hb, wb, c)).reshape(
            b, ha, wa, hb2, wb2, f)
        return out.add_(a.reshape(b, hb2, wb2, ha, wa, f).permute(
            0, 3, 4, 1, 2, 5))


class BuildingBlock(nn.Module):
    """[CenterPivotConv4d -> GroupNorm(4) -> relu] x len(channels)."""

    def __init__(self, in_ch: int, channels: Sequence[int],
                 kernels: Sequence[int], strides: Sequence[int],
                 dtype=torch.float32, device=None):
        super().__init__()
        self.depth = len(channels)
        for i, (f, k, s) in enumerate(zip(channels, kernels, strides)):
            self.add_module(f"conv4d_{i}", CenterPivotConv4d(
                in_ch, f, k, s, dtype, device))
            self.add_module(f"gn_{i}", GroupNorm(4, f, dtype=dtype,
                                                 device=device))
            in_ch = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"conv4d_{i}")(x)
            x = torch.relu(getattr(self, f"gn_{i}")(x))
        return x


def _resize_query_dims(x: torch.Tensor, oh: int, ow: int) -> torch.Tensor:
    """Bilinear (align_corners=True) resize of the query plane (ha, wa) of
    a (B, ha, wa, hb, wb, C) tensor."""
    b, ha, wa, hb, wb, c = x.shape
    flat = resize_bilinear(x.reshape(b, ha, wa, hb * wb * c), oh, ow,
                           align_corners=True)
    return flat.reshape(b, oh, ow, hb, wb, c)


class HPNLearner(nn.Module):
    """Squeeze each pyramid level, mix 4 -> 3 -> 2, collapse the support
    plane, decode to (B, h, w, 2) logits. `in_channels` = (#layer4,
    #layer3, #layer2) taps."""

    def __init__(self, in_channels: Tuple[int, int, int],
                 dtype=torch.float32, device=None):
        super().__init__()
        o1, o2, o3 = 16, 64, 128
        n4, n3, n2 = in_channels
        self.dtype = dtype
        self.encoder_layer4 = BuildingBlock(n4, (o1, o2, o3), (3, 3, 3),
                                            (2, 2, 2), dtype, device)
        self.encoder_layer3 = BuildingBlock(n3, (o1, o2, o3), (5, 3, 3),
                                            (4, 2, 2), dtype, device)
        self.encoder_layer2 = BuildingBlock(n2, (o1, o2, o3), (5, 5, 3),
                                            (4, 4, 2), dtype, device)
        self.encoder_layer4to3 = BuildingBlock(o3, (o3, o3, o3), (3, 3, 3),
                                               (1, 1, 1), dtype, device)
        self.encoder_layer3to2 = BuildingBlock(o3, (o3, o3, o3), (3, 3, 3),
                                               (1, 1, 1), dtype, device)
        self.decoder1_conv1 = Conv2d(o3, o3, 3, 1, 1, True, dtype, device)
        self.decoder1_conv2 = Conv2d(o3, o2, 3, 1, 1, True, dtype, device)
        self.decoder2_conv1 = Conv2d(o2, o2, 3, 1, 1, True, dtype, device)
        self.decoder2_conv2 = Conv2d(o2, 2, 3, 1, 1, True, dtype, device)

    def forward(self, pyramid: List[torch.Tensor]) -> torch.Tensor:
        sq4 = self.encoder_layer4(pyramid[0])
        sq3 = self.encoder_layer3(pyramid[1])
        sq2 = self.encoder_layer2(pyramid[2])
        sq4 = _resize_query_dims(sq4, sq3.shape[1], sq3.shape[2])
        mix43 = self.encoder_layer4to3(sq4 + sq3)
        mix43 = _resize_query_dims(mix43, sq2.shape[1], sq2.shape[2])
        mix432 = self.encoder_layer3to2(mix43 + sq2)
        # collapse the support plane (the mean in fp32, as jnp.mean of a
        # bf16 tensor), decode to a 2-channel mask
        enc = mix432.float().mean(dim=(3, 4)).to(self.dtype)
        x = torch.relu(self.decoder1_conv1(enc))
        x = torch.relu(self.decoder1_conv2(x))
        up = x.shape[2] * 2  # square upsample keyed on W, as the reference
        x = resize_bilinear(x, up, up, align_corners=True)
        x = torch.relu(self.decoder2_conv1(x))
        return self.decoder2_conv2(x)


class HSNet(nn.Module):
    """forward(query_img (B, H, W, 3), support_img (B, H, W, 3),
    support_mask (B, H, W) {0, 1}) -> (B, H, W, 2) logits in the model
    dtype, or at the learner's resolution with `use_original_imgsize`
    (the caller resizes them to each episode's original query size,
    `predict_mask_nshot(..., org_size=)`).

    Backbones: 'resnet' (`resnet.layers`; taps of layers 2-4, pyramid
    groups (layers[3], layers[2], layers[1])) or 'vgg16' (groups (1, 3,
    3)). `param_dtype` stores the float parameters apart from the compute
    `dtype` (fp32 masters for training, `layers.set_param_dtype_`)."""

    def __init__(self, resnet: ResNetConfig = ResNetConfig(),
                 backbone: str = "resnet", dtype=torch.float32,
                 device=None, use_original_imgsize: bool = False,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if backbone not in ("resnet", "vgg16"):
            raise ValueError(f"backbone must be 'resnet' or 'vgg16', got "
                             f"{backbone!r}")
        self.resnet_cfg = resnet
        self.backbone_name = backbone
        self.dtype = dtype
        self.use_original_imgsize = use_original_imgsize
        if backbone == "vgg16":
            self.backbone = VGG16Features(dtype=dtype, device=device)
        else:
            self.backbone = ResNetBackbone(resnet, dtype, device,
                                           all_taps=True)
        self.hpn_learner = HPNLearner(self.stack_sizes, dtype, device)
        if param_dtype is not None:
            set_param_dtype_(self, param_dtype)
        self.eval()

    @property
    def stack_sizes(self) -> Tuple[int, int, int]:
        if self.backbone_name == "vgg16":
            return (1, 3, 3)
        layers = self.resnet_cfg.layers
        return (layers[3], layers[2], layers[1])

    def train(self, mode: bool = True):
        """Train the learner; the frozen backbone stays in eval mode."""
        super().train(mode)
        self.backbone.eval()
        return self

    def _taps(self, img: torch.Tensor) -> List[torch.Tensor]:
        taps = self.backbone(img)
        if self.backbone_name == "resnet":
            # layers 2..4 only (the reference's feat_ids skip layer1)
            taps = taps[self.resnet_cfg.layers[0]:]
        return taps

    def forward(self, query_img: torch.Tensor, support_img: torch.Tensor,
                support_mask: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            q_taps = self._taps(query_img)
            s_taps = self._taps(support_img)
            m = support_mask.float()[..., None]
            s_taps = [t * resize_bilinear(m, t.shape[1], t.shape[2],
                                          align_corners=True).to(t.dtype)
                      for t in s_taps]
        pyramid = multilayer_correlation(q_taps, s_taps, self.stack_sizes)
        del q_taps, s_taps
        logits = self.hpn_learner(pyramid)
        if self.use_original_imgsize:
            return logits
        return resize_bilinear(logits, query_img.shape[1],
                               query_img.shape[2], align_corners=True)


def load_backbone(model: HSNet, path: str):
    """Load a torchvision `state_dict` file (resnet50/101, or vgg16 for
    `backbone='vgg16'`) into `model.backbone` through its key map; every
    backbone entry must be covered. Returns the map ({port name under
    `backbone.`: (torchvision key, transform)})."""
    from lseg_tpu_torch.utils.checkpoint_convert import (
        apply_key_map,
        extract_state_dict,
        load_torch_file,
        prefixed,
        torchvision_resnet_key_map,
        torchvision_vgg16_key_map,
    )

    sd = extract_state_dict(load_torch_file(path))
    key_map = prefixed(
        torchvision_resnet_key_map(sd, model.resnet_cfg.layers)
        if model.backbone_name == "resnet" else torchvision_vgg16_key_map(),
        "backbone.")
    missing, unexpected = model.load_state_dict(apply_key_map(sd, key_map),
                                                strict=False)
    missing = [k for k in missing if k.startswith("backbone.")]
    if missing or unexpected:
        raise ValueError(f"{path}: backbone entries missing {missing[:3]}, "
                         f"unexpected {unexpected[:3]}")
    return key_map


def predict_mask_nshot(apply_fn: Callable, batch, nshot: int,
                       org_size: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
    """n-shot vote: the sum of the per-shot argmax masks, thresholded at
    half the largest vote of each image. `apply_fn(query, support,
    mask)` returns one shot's logits; `batch` holds `query_img` (B, H, W,
    3), `support_imgs` (B, S, H, W, 3) and `support_masks` (B, S, H, W).
    `org_size=(H, W)` resizes each shot's logits (fp32, align_corners=True)
    to the episode's original query size before the argmax. int64
    labels."""
    agg = None
    for s in range(nshot):
        logits = apply_fn(batch["query_img"], batch["support_imgs"][:, s],
                          batch["support_masks"][:, s])
        if org_size is not None:
            logits = resize_bilinear(logits.float(), int(org_size[0]),
                                     int(org_size[1]), align_corners=True)
        vote = torch.argmax(logits, dim=-1)
        agg = vote if agg is None else agg + vote
    if nshot == 1:
        return agg
    bsz = agg.shape[0]
    max_vote = torch.clamp(agg.reshape(bsz, -1).max(dim=1).values,
                           min=1).reshape(bsz, 1, 1)
    return (agg.float() / max_vote >= 0.5).to(agg.dtype)
