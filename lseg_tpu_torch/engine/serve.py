"""Serving predictors (torch port of `lseg_tpu/engine/serve.py`).

`make_predictor` returns the image -> label-map function behind the
demo, the app and the benchmark. Text features come precomputed from
`text.cache.TextFeatureCache`, so a label-set swap costs nothing on the
image path.

The head is the reference's default (`use_pallas=False`) head: the
pixel embeddings from `LSegNet(x, None)`, then the correlation and the
x2 align-corners upsample in the config's head dtype (bf16 in the fast
config), then the argmax over K at full resolution, int32 out. The
`use_pallas=True` head of the reference runs two more TPU kernels,
B10 (`fused_correlate`) and B11 (`upsample2x_argmax`), which are not
ported yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from lseg_tpu_torch.models.lseg import LSegNet, head_dtype
from lseg_tpu_torch.ops.correlation import correlate
from lseg_tpu_torch.ops.resize import upsample2x


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def make_predictor(model: LSegNet, state=None,
                   use_pallas: bool = False) -> Callable:
    """(images (N, H, W, 3) fp32, text_features (K, C)) -> (N, H, W)
    int32 on the model's device. `state`, if given, is loaded first."""
    if use_pallas:
        raise NotImplementedError(
            "use_pallas=True needs kernels B10 (fused_correlate) and B11 "
            "(upsample2x_argmax), which are not ported yet")
    if state is not None:
        model.load_state_dict(state)
    model.eval()
    cfg = model.cfg
    hd = head_dtype(cfg)
    device = _device(model)

    @torch.inference_mode()
    def predict(images, text_features):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        text_features = torch.as_tensor(text_features, device=device)
        emb = model(images, None)  # (N, H/2, W/2, C)
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
