"""Serving predictors (torch port of `lseg_tpu/engine/serve.py`).

`make_predictor` returns the image -> label-map function behind the
demo, the app and the benchmark. Text features come precomputed from
`text.cache.TextFeatureCache`, so a label-set swap costs nothing on the
image path.

The default (`use_pallas=False`) head is the reference's: the pixel
embeddings from `LSegNet(x, None)`, then the correlation and the x2
align-corners upsample in the config's head dtype (bf16 in the fast
config), then the argmax over K at full resolution, int32 out. On the
int8 configs `LSegNet(x, None)` runs head1 unfused (`StaticQuantConv`),
as the reference's predictor does; the fused heads B4 and B5 serve
`LSegNet(x, text, return_argmax=True)`, the call of the reference's
bench.

The streamed `use_pallas=True` head never writes full-resolution logits:
kernel B10 (`ops.fused_correlate`) normalises and correlates in fp32, and
kernel B11 (`ops.upsample_argmax`) upsamples and takes the argmax in one
pass, so only the (N, H, W) labels leave it. A `plain=True` model runs
both kernels' plain twins.

`make_logits_fn` returns the (N, H, W, K) fp32 logits of the full
`LSegNet.forward`, the TTA evaluator's crop forward: on an int8 config
with `head_fused='wup'` that call runs kernel B14 (head1, the correlation
and the x2 W-interp in one kernel, the H-interp after it), otherwise B4 or
the unfused head. Kernel B13 (`ops.head1_correlate.
head1_correlate_upsample_argmax`) serves neither function, as the
reference's predictors do not call it.
"""

from __future__ import annotations

from typing import Callable

import torch

from lseg_tpu_torch.models.lseg import LSegNet, head_dtype
from lseg_tpu_torch.ops.correlation import correlate
from lseg_tpu_torch.ops.fused_correlate import (
    fused_correlate,
    fused_correlate_plain,
)
from lseg_tpu_torch.ops.resize import upsample2x
from lseg_tpu_torch.ops.upsample_argmax import (
    upsample2x_argmax,
    upsample2x_argmax_plain,
)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_predictor(model: LSegNet, state=None,
                   use_pallas: bool = False) -> Callable:
    """(images (N, H, W, 3) fp32, text_features (K, C)) -> (N, H, W)
    int32 on the model's device. `state`, if given, is loaded first.
    `use_pallas` takes the streamed head (kernels B10 and B11)."""
    if state is not None:
        model.load_state_dict(state)
    model.eval()
    cfg = model.cfg
    hd = head_dtype(cfg)
    device = _device(model)
    corr, up2_argmax = ((fused_correlate_plain, upsample2x_argmax_plain)
                        if model.plain else
                        (fused_correlate, upsample2x_argmax))

    @torch.inference_mode()
    def predict(images, text_features):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        text_features = torch.as_tensor(text_features, device=device)
        emb = model(images, None)  # (N, H/2, W/2, C)
        if use_pallas:
            logits = corr(emb.contiguous(), text_features, cfg.logit_scale)
            return up2_argmax(logits)
        logits = correlate(emb, text_features,
                           logit_scale=cfg.logit_scale, compute_dtype=hd)
        up = upsample2x(logits, align_corners=True, compute_dtype=hd)
        return torch.argmax(up, dim=-1).to(torch.int32)

    return predict


def make_logits_fn(model: LSegNet, state=None) -> Callable:
    """(images, text_features) -> (N, H, W, K) fp32 logits through the
    full `LSegNet.forward`."""
    if state is not None:
        model.load_state_dict(state)
    model.eval()
    device = _device(model)

    @torch.inference_mode()
    def logits(images, text_features):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        return model(images, torch.as_tensor(text_features, device=device))

    return logits
