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
both kernels' plain twins. A model with the `arch_option` 1 / 2 head
blocks (which sit between the correlation and the upsample) takes its
full forward, `LSegNet(x, text)`, and the argmax of those logits, with
either head, as the reference's predictor does.

`make_logits_fn` returns the (N, H, W, K) fp32 logits of the full
`LSegNet.forward`, the TTA evaluator's crop forward: on an int8 config
with `head_fused='wup'` that call runs kernel B14 (head1, the correlation
and the x2 W-interp in one kernel, the H-interp after it), otherwise B4 or
the unfused head. Kernel B13 (`ops.head1_correlate.
head1_correlate_upsample_argmax`) serves neither function, as the
reference's predictors do not call it.

Multi-GPU serving, one process a card over a data group
(`parallel.dist`):

- `make_data_sharded_predictor`: every rank runs the full forward with
  `return_argmax=True` (bench.py's call; B1 -> B2/B3 -> B4 on fast_cal)
  on its rows of the global batch, and the label maps are all-gathered in
  rank order, the only collective. As the JAX package's `shard_map`, each
  rank's forward sees its own rows only: under uncalibrated `'static'`
  int8 the activation amax is taken over the rank's shard, not over the
  global batch;
- `make_labelset_sharded_predictor`: the embedding runs on every rank,
  each rank correlates, x2 upsamples and takes the argmax over its K / W
  labels in the head dtype (plain torch, as the JAX package computes it
  in XLA), and the (value, global index) pairs are all-gathered; the
  global argmax takes the lowest label index among equal values (the
  lowest rank, since the ranks hold ascending label ranges), as
  `jnp.argmax` does;
- `make_data_sharded_logits_fn`: the TTA evaluator's crop forward on
  each rank's rows of the crop batch, the fp32 logits all-gathered in
  order.

The two data-sharded functions also take a `parallel.dist.Mesh`: the
rows go over its data group and the model is cut over its model group
(`parallel.tensor.shard_module_`; int8 blocks stay whole, so a fast_cal
model runs whole on every rank of the group).
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
from lseg_tpu_torch.parallel.dist import (
    all_gather_rows,
    batch_shard,
    data_group,
    rank,
    size,
)
from lseg_tpu_torch.parallel.tensor import shard_module_


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
        if cfg.arch_option in (1, 2):
            out = model(images, text_features)
            return torch.argmax(out, dim=-1).to(torch.int32)
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


def make_data_sharded_predictor(model: LSegNet, state=None,
                                group=None) -> Callable:
    """(global images (N, H, W, 3), text_features) -> (N, H, W) int32 on
    every rank: each rank's rows through `model(x, txt,
    return_argmax=True)`, the label maps all-gathered. N must divide
    by the (data) group's size."""
    if state is not None:
        model.load_state_dict(state)
    model.eval()
    shard_module_(model, group)
    group = data_group(group)
    device = _device(model)

    @torch.inference_mode()
    def predict(images, text_features):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        labels = model(batch_shard(images, group),
                       torch.as_tensor(text_features, device=device),
                       return_argmax=True)
        return all_gather_rows(labels, group)

    return predict


def make_labelset_sharded_predictor(model: LSegNet, state=None,
                                    group=None) -> Callable:
    """(images, text_features (K, C)) -> (N, H, W) int32 on every rank,
    the K labels split over the group's ranks in ascending ranges; K must
    divide by the group's size. The `arch_option` 1/2 head blocks mix the
    K channels and raise."""
    if state is not None:
        model.load_state_dict(state)
    model.eval()
    cfg = model.cfg
    if cfg.arch_option in (1, 2):
        raise ValueError(
            "arch_option 1/2 heads mix the K channels (depthwise blocks); "
            "label-set sharding does not apply")
    hd = head_dtype(cfg)
    device = _device(model)
    w, r = size(group), rank(group)

    @torch.inference_mode()
    def predict(images, text_features):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        text_features = torch.as_tensor(text_features, device=device)
        k = text_features.shape[0]
        if k % w:
            raise ValueError(f"label count {k} must divide the data group "
                             f"size {w} (pad the label list)")
        per = k // w
        emb = model(images, None)
        logits = correlate(emb, text_features[r * per:(r + 1) * per],
                           logit_scale=cfg.logit_scale, compute_dtype=hd)
        up = upsample2x(logits, align_corners=True, compute_dtype=hd)
        idx = torch.argmax(up, dim=-1, keepdim=True)
        best = up.gather(-1, idx).squeeze(-1).float()
        idx = idx.squeeze(-1).to(torch.int32) + r * per
        n = images.shape[0]
        values = all_gather_rows(best, group).unflatten(0, (w, n))
        labels = all_gather_rows(idx, group).unflatten(0, (w, n))
        # the first maximum over the ranks: the lowest global index
        pick = torch.argmax(values, dim=0, keepdim=True)
        return labels.gather(0, pick).squeeze(0)

    return predict


def make_data_sharded_logits_fn(model: LSegNet, state=None,
                                group=None) -> Callable:
    """(global images, text_features) -> (N, H, W, K) fp32 logits on
    every rank: each rank's rows through `LSegNet.forward`, gathered in
    rank order (the TTA evaluator's crop forward)."""
    logits = make_logits_fn(model, state)
    shard_module_(model, group)
    group = data_group(group)

    @torch.inference_mode()
    def sharded(images, text_features):
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=_device(model))
        out = logits(batch_shard(images, group), text_features)
        return all_gather_rows(out.float(), group)

    return sharded
