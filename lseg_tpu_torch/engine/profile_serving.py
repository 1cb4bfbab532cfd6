"""Where the device time of one serving call goes, on the card.

    python -m lseg_tpu_torch.engine.profile_serving [--path fused_block]

Builds the full-width `clip_vitl16_384` model of one serving path with
seeded random weights (the int8 paths quantized from a seeded fp32 model
by `quantize_tree` and calibrated on one seeded batch, as `chip_smoke.py`
builds them), then times `model(x, txt, return_argmax=True)`, the call of
the reference's bench, and the image encoder `model.vit(x)` alone with
CUDA events, at batch 8, 480x480 and K = 150 (`bench.py`'s shape), and
profiles three calls with `torch.profiler` (`model(x, txt)` on a logits
path). It prints the call's ms, the
encoder's ms, the device busy share (the sum of kernel times over the
profiled wall time) and the largest kernels by device time per call.
Paths: `fast_bf16`, `fast_cal`, `fast_flashq`, `fused_block`
(`fast_cal` with `attn_impl='flashqp'`, `mlp_fused` and no MLP-hidden
calibration), `fused_decoder` (`fast_cal` with `decoder_fused_rcu` and
`decoder_fused_tail`: kernels B18 and B19), `int8_handoff` (that, with
`head_fused=True` and no `decoder_conv_first`, so that refinenet1's B19
hands int8 codes to the B5 head), `fused_argmax` (`fast_cal` with
`head_fused=True` alone: bf16 path1 into B5) and `wup` (`fast_cal` with
`head_fused='wup'`, whose call is `model(x, txt)`, the full-resolution
logits of kernel B14 and the bf16 H-interp). `streamed` is the `fast_bf16`
model through `make_predictor(model, use_pallas=True)`, the streamed
label head of kernels B10 and B11 (its call and the encoder are that
predictor and the model's `vit`). Needs a CUDA device: without one it
exits with an error.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import torch

from lseg_tpu_torch import fast_serving, get_config
from lseg_tpu_torch.engine.serve import make_predictor
from lseg_tpu_torch.models.layers import random_init_
from lseg_tpu_torch.models.lseg import LSegNet
from lseg_tpu_torch.ops.quant import calibrate_act_scales, quantize_tree

# ViT and config overrides of each int8 path on
# `fast_serving(cfg, 'static_cal')`
FUSED_DECODER = {"decoder_fused_rcu": True, "decoder_fused_tail": True}
INT8_PATHS = {
    "fast_cal": ({}, {}),
    "fast_flashq": ({"attn_impl": "flashq", "ln_quant_fused": False,
                     "mlp_act_cal": False}, {}),
    "fused_block": ({"attn_impl": "flashqp", "mlp_fused": True,
                     "mlp_act_cal": False}, {}),
    "fused_decoder": ({}, FUSED_DECODER),
    "int8_handoff": ({}, {**FUSED_DECODER, "head_fused": True,
                          "decoder_conv_first": False}),
    "fused_argmax": ({}, {"head_fused": True}),
    "wup": ({}, {"head_fused": "wup"}),
}
# paths whose call is the logits, `model(x, txt)`
LOGITS_PATHS = {"wup"}
PATHS = ("fast_bf16", "streamed", *INT8_PATHS)
BATCH, SIZE, LABELS = 8, 480, 150
CALLS, TOP, SEED = 3, 30, 0


def build_model(path: str, device):
    """The path's bf16 LSegNet on `device` from seeded random weights."""
    base = get_config("clip_vitl16_384")
    g = torch.Generator(device=device).manual_seed(SEED)
    fast = fast_serving(base, quant=False)
    if path in ("fast_bf16", "streamed"):
        return random_init_(LSegNet(fast, torch.bfloat16, device), g)
    cfg = fast_serving(base, "static_cal")
    vit_kw, cfg_kw = INT8_PATHS[path]
    cfg = dataclasses.replace(cfg, vit=dataclasses.replace(cfg.vit, **vit_kw),
                              **cfg_kw)
    # the same function unquantized in fp32 is the source of the int8 tree
    ref_cfg = dataclasses.replace(fast, head_dtype="float32",
                                  vit=dataclasses.replace(
                                      fast.vit, attn_impl="xla",
                                      attn_scores_dtype="float32",
                                      patch_fused=False))
    ref32 = random_init_(LSegNet(ref_cfg, torch.float32, device), g)
    state = quantize_tree(ref32.state_dict(), decoder=True, act_scale=True,
                          mlp_act_scale=cfg.vit.mlp_act_cal)
    del ref32
    model = LSegNet(cfg, torch.bfloat16, device)
    model.load_state_dict(state)
    cal = torch.randn(BATCH, SIZE, SIZE, 3, device=device, generator=g)
    return calibrate_act_scales(model, cal, None)


def _events_ms(fn, iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=PATHS, default="fused_block")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(args.path, dev).eval()
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(BATCH, SIZE, SIZE, 3, device=dev, generator=g)
    txt = torch.nn.functional.normalize(torch.randn(
        LABELS, model.cfg.out_c, device=dev, generator=g), dim=-1)

    argmax = args.path not in LOGITS_PATHS
    predict = (make_predictor(model, use_pallas=True)
               if args.path == "streamed" else None)

    def call():
        if args.path == "streamed":
            return predict(x, txt)
        with torch.inference_mode():
            return model(x, txt, return_argmax=argmax)

    def encoder():
        with torch.inference_mode():
            return model.vit(x)

    for _ in range(2):
        call()
    torch.cuda.synchronize()
    call_ms = _events_ms(call, 10)
    vit_ms = _events_ms(encoder, 10)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        wall_ms = _events_ms(call, CALLS)
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / CALLS
    print(f"{torch.cuda.get_device_name(0)}; path {args.path}, batch "
          f"{BATCH}, {SIZE}x{SIZE}, K={LABELS}")
    print(f"call {call_ms:.3f} ms, model.vit {vit_ms:.3f} ms "
          f"({100 * vit_ms / call_ms:.1f}%); profiled {wall_ms:.3f} ms per "
          f"call, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}"
          f"%)")
    print("device ms per call, launches per call, kernel:")
    for e in sorted(kernels, key=_device_us, reverse=True)[:TOP]:
        print(f"  {_device_us(e) / 1e3 / CALLS:9.3f} "
              f"{e.count / CALLS:7.1f}  {e.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
