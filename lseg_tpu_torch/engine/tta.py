"""Multi-scale sliding-window + horizontal-flip TTA evaluator (torch port
of `lseg_tpu/engine/tta.py`).

The reference protocol, reproduced exactly (test_lseg.py:308-316 and
lang-seg's `encoding_models.py:54-155`):

    for scale in scales:
        long = ceil(base_size * scale); aspect-preserving resize
        (bilinear align_corners=True)
        pad to crop with value -mean/std (normalized zero)
        if bigger than crop: sliding windows of crop, stride 2/3 crop,
        the last window snapped to the border
        per window: logits(crop) + hflip(logits(hflip(crop))),
        accumulated into a canvas with per-pixel counts
        canvas /= counts; resize back to (H, W); sum over scales

The protocol and the host plan (`TTAProtocol`, `TTAPlan`, `make_plan`,
`build_pyramid`) are copies of the JAX package's, verbatim apart from
their imports. The device stages are PyTorch on the model's device:

- the scale pyramid, one (S, Pmax, Pmax, 3) fp32 tensor built from the
  one uploaded image by two interpolation products per scale, their
  operators made on the device from `arange` (align_corners=True: source
  o (h - 1) / (hs - 1), tent weights), pad value outside each scale's
  region; `build_pyramid` on the host is the oracle it is held to;
- the crop loop: chunks of `CROPS_PER_STEP` crops (4) sliced from the
  pyramid, run with their flips as one batch (8) through the caller's
  `apply_fn`, the flipped half flipped back along W and added in fp32;
  each crop's sum is added into its scale's canvas, a slice of ONE
  (S, Pmax, Pmax, K) fp32 tensor, and 1 into the counts; the padding
  slots that fill the last chunk run through the forward and add nothing;
- assembly: each canvas divided by its counts and mapped back to (H, W)
  by two contractions with `ops.resize._interp_matrix` (the host's
  operators), summed over the scales; the (H, W, K) fp32 sums, or their
  argmax.

The pyramid and assembly products run in full fp32 (no TF32), as the JAX
package runs them at `Precision.HIGHEST`. There is no output-size bucket:
the JAX package pads sizes to multiples of 64 for XLA's compile cache,
which PyTorch has no use for; the sums are those of the same protocol.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from lseg_tpu_torch.ops.resize import _interp_matrix


# ---------------------------------------------------------------------------
# Protocol + host-side planning
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TTAProtocol:
    """The eval protocol constants (reference: test_lseg.py:308-316,
    lseg_module.py:29-38). `citys` preset uses base 2048 / crop 768 /
    scales 0.75..2.25 (test_lseg.py:308-312)."""

    base_size: int = 520
    crop_size: int = 480
    scales: Tuple[float, ...] = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)
    flip: bool = True
    # normalized pad value per channel = (0 - mean) / std
    pad_value: Tuple[float, float, float] = (-1.0, -1.0, -1.0)

    @property
    def stride(self) -> int:
        # int(crop * 1/3 * 2), reference encoding_models.py:63
        return int(self.crop_size * 2.0 / 3.0)

    @functools.cached_property
    def canvas_sizes(self) -> Tuple[int, ...]:
        """Static per-scale canvas side = max(crop, ceil(base*scale))."""
        return tuple(
            max(self.crop_size, int(math.ceil(self.base_size * s)))
            for s in self.scales
        )

    @functools.cached_property
    def max_crops(self) -> int:
        """Worst-case total window count across scales (square image at
        the long-side bound)."""
        total = 0
        for c in self.canvas_sizes:
            n = self._n_windows(c)
            total += n * n
        return total

    def _n_windows(self, d: int) -> int:
        d = max(d, self.crop_size)
        return int(math.ceil((d - self.crop_size) / self.stride)) + 1

    def window_positions(self, d: int) -> List[int]:
        """Window origins along a dim of (padded) size d: stride grid
        with the last window snapped to the border
        (reference encoding_models.py:103-125)."""
        d = max(d, self.crop_size)
        return [
            min(i * self.stride, d - self.crop_size)
            for i in range(self._n_windows(d))
        ]

    def scaled_size(self, h: int, w: int, scale: float) -> Tuple[int, int]:
        """Aspect-preserving resize target: long side = ceil(base*scale)
        (reference encoding_models.py:66-76)."""
        long_size = int(math.ceil(self.base_size * scale))
        if h > w:
            height = long_size
            width = int(1.0 * w * long_size / h + 0.5)
        else:
            width = long_size
            height = int(1.0 * h * long_size / w + 0.5)
        return height, width


@dataclasses.dataclass
class TTAPlan:
    """Host-computed static plan for one input size (H, W)."""

    h: int
    w: int
    sizes: List[Tuple[int, int]]          # per-scale (h_s, w_s)
    crops: np.ndarray                      # (MAX_CROPS, 4) s,y0,x0,valid
    n_valid: int


def make_plan(proto: TTAProtocol, h: int, w: int) -> TTAPlan:
    crops = []
    sizes = []
    for si, scale in enumerate(proto.scales):
        hs, ws = proto.scaled_size(h, w, scale)
        sizes.append((hs, ws))
        for y0 in proto.window_positions(hs):
            for x0 in proto.window_positions(ws):
                crops.append((si, y0, x0, 1))
    n_valid = len(crops)
    assert n_valid <= proto.max_crops, (n_valid, proto.max_crops)
    while len(crops) < proto.max_crops:
        crops.append((0, 0, 0, 0))
    return TTAPlan(
        h=h, w=w, sizes=sizes,
        crops=np.asarray(crops, dtype=np.int32), n_valid=n_valid,
    )


def _resize_np(img: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Exact align_corners=True bilinear resize on host (same operator
    matrices as the device path)."""
    h, w, _ = img.shape
    out = img.astype(np.float32)
    if h != oh:
        out = np.einsum("oh,hwc->owc", _interp_matrix(h, oh, True), out)
    if w != ow:
        out = np.einsum("ow,hwc->hoc", _interp_matrix(w, ow, True), out)
    return out


def build_pyramid(
    proto: TTAProtocol, image: np.ndarray, plan: TTAPlan
) -> np.ndarray:
    """Resize the normalized (H, W, 3) image to each scale and embed it
    in ONE stacked (S, Pmax, Pmax, 3) buffer (pad = normalized zero,
    reference pad_image encoding_models.py:144-155). A single stacked
    tensor keeps the crop program switch-free (a plain dynamic_slice
    indexed by scale), which also keeps the compiled graph small."""
    pmax = max(proto.canvas_sizes)
    pad = np.asarray(proto.pad_value, dtype=np.float32)
    pyr = np.broadcast_to(
        pad, (len(proto.scales), pmax, pmax, 3)
    ).copy()
    for s, (hs, ws) in enumerate(plan.sizes):
        pyr[s, :hs, :ws] = _resize_np(image, hs, ws)
    return pyr


@contextlib.contextmanager
def fp32_products():
    """fp32 matmuls in full precision (no TF32) inside the block."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


def _axis_weights(pmax: int, dim: int, targets: torch.Tensor
                  ) -> torch.Tensor:
    """(S, Pmax, dim) interpolation rows onto each scale's `targets`
    (align_corners=True), zero past each target."""
    dev = targets.device
    o = torch.arange(pmax, device=dev, dtype=torch.float32)[None, :, None]
    i = torch.arange(dim, device=dev, dtype=torch.float32)[None, None, :]
    t = targets.to(torch.float32)[:, None, None]
    ratio = torch.tensor(float(dim - 1), device=dev) / torch.clamp(
        t - 1.0, min=1.0)
    wts = torch.clamp(1.0 - torch.abs(o * ratio - i), min=0.0)
    return torch.where(o < t, wts, torch.zeros((), device=dev))


def device_pyramid(proto: TTAProtocol, image: torch.Tensor,
                   plan: TTAPlan) -> torch.Tensor:
    """`build_pyramid` on the device: (H, W, 3) -> (S, Pmax, Pmax, 3)."""
    pmax = max(proto.canvas_sizes)
    dev = image.device
    sizes = torch.tensor(plan.sizes, dtype=torch.int64, device=dev)
    img = image.to(torch.float32)
    with fp32_products():
        wh = _axis_weights(pmax, img.shape[0], sizes[:, 0])
        ww = _axis_weights(pmax, img.shape[1], sizes[:, 1])
        t = torch.einsum("soh,hwc->sowc", wh, img)
        pyr = torch.einsum("spw,sowc->sopc", ww, t)
    oy = torch.arange(pmax, device=dev)
    inside = ((oy[None, :, None] < sizes[:, :1, None])
              & (oy[None, None, :] < sizes[:, 1:, None]))
    pad = torch.tensor(proto.pad_value, dtype=torch.float32, device=dev)
    return torch.where(inside[..., None], pyr, pad)


# crops a forward takes, each with its flip: the forward runs at batch 8
CROPS_PER_STEP = 4


class MultiScaleEvaluator:
    """The reference `LSeg_MultiEvalModule`: `__call__(image,
    text_features)` -> (H, W) int32 labels (or the (H, W, K) fp32 summed
    logits with `return_logits`), on the device of `text_features`.

    `apply_fn(images, text_features)`: the batched crop forward,
    (B, crop, crop, 3) -> (B, crop, crop, K) (`engine.serve.
    make_logits_fn`)."""

    def __init__(self, apply_fn: Callable, num_classes: int,
                 proto: TTAProtocol = TTAProtocol()):
        self.proto = proto
        self.num_classes = num_classes
        self._apply_fn = apply_fn
        self._plans: Dict[Tuple[int, int], TTAPlan] = {}

    def _plan(self, h: int, w: int) -> TTAPlan:
        plan = self._plans.get((h, w))
        if plan is None:
            plan = make_plan(self.proto, h, w)
            self._plans[(h, w)] = plan
        return plan

    def _forward(self, patches, text_features) -> torch.Tensor:
        """(g, c, c, 3) crops -> (g, c, c, K) fp32, the flipped half
        flipped back along W and added."""
        g = patches.shape[0]
        if not self.proto.flip:
            return self._apply_fn(patches, text_features).float()
        logits = self._apply_fn(torch.cat([patches, patches.flip(2)]),
                                text_features).float()
        return logits[:g] + logits[g:].flip(2)

    @torch.inference_mode()
    def _canvases(self, image, text_features) -> Tuple[torch.Tensor,
                                                      TTAPlan]:
        """The count-normalized (S, Pmax, Pmax, K) canvases of `image`."""
        dev = (text_features.device if torch.is_tensor(text_features)
               else torch.device("cpu"))
        h, w = image.shape[:2]
        plan = self._plan(h, w)
        pyramid = device_pyramid(self.proto, torch.as_tensor(
            image, dtype=torch.float32, device=dev), plan)
        crop, g = self.proto.crop_size, CROPS_PER_STEP
        s, pmax = len(self.proto.scales), max(self.proto.canvas_sizes)
        canvases = torch.zeros((s, pmax, pmax, self.num_classes),
                               dtype=torch.float32, device=dev)
        counts = torch.zeros((s, pmax, pmax, 1), dtype=torch.float32,
                             device=dev)
        n_chunks = -(-plan.n_valid // g)
        metas = plan.crops[:n_chunks * g]
        if len(metas) < n_chunks * g:
            metas = np.concatenate([metas, np.zeros(
                (n_chunks * g - len(metas), 4), metas.dtype)])
        for ci in range(n_chunks):
            chunk = metas[ci * g:(ci + 1) * g].tolist()
            patches = torch.stack([pyramid[si, y0:y0 + crop, x0:x0 + crop]
                                   for si, y0, x0, _ in chunk])
            combined = self._forward(patches, text_features)
            for j, (si, y0, x0, valid) in enumerate(chunk):
                if valid:
                    canvases[si, y0:y0 + crop, x0:x0 + crop] += combined[j]
                    counts[si, y0:y0 + crop, x0:x0 + crop] += 1.0
        return canvases.div_(counts.clamp_(min=1.0)), plan

    @torch.inference_mode()
    def _assemble(self, canvases: torch.Tensor, plan: TTAPlan
                 ) -> torch.Tensor:
        """(H, W, K) fp32: each canvas resized back to (H, W) by two
        contractions with the host's interpolation operators, summed over
        the scales."""
        dev = canvases.device
        total = None
        with fp32_products():
            for si, (hs, ws) in enumerate(plan.sizes):
                mh = torch.from_numpy(_interp_matrix(hs, plan.h, True)).to(
                    dev)
                mw = torch.from_numpy(_interp_matrix(ws, plan.w, True)).to(
                    dev)
                c = canvases[si, :hs, :ws]
                t = torch.einsum("oh,hwk->owk", mh, c)
                t = torch.einsum("pw,owk->opk", mw, t)
                total = t if total is None else total.add_(t)
        return total

    def __call__(self, image, text_features,
                 return_logits: bool = False) -> torch.Tensor:
        """image: (H, W, 3) normalized fp32 (numpy or tensor)."""
        total = self._assemble(*self._canvases(image, text_features))
        if return_logits:
            return total
        return torch.argmax(total, dim=-1).to(torch.int32)


# Dataset protocol presets (test_lseg.py:308-316: cityscapes uses base
# 2048 / crop 768 and a shifted scale ladder).
ADE20K_PROTOCOL = TTAProtocol()
CITYSCAPES_PROTOCOL = TTAProtocol(
    base_size=2048,
    crop_size=768,
    scales=(0.75, 1.0, 1.25, 1.5, 1.75, 2.0, 2.25),
)
