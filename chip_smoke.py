#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`lseg_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before
the result line is printed:

1. device and build: the card, its power limit, and the nvcc build of
   the hand-written kernels (`lseg_tpu_torch/csrc`);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the serving path, with its time beside the plain version's;
3. serving: the full-width `fast_serving(clip_vitl16_384, quant=False)`
   model (ViT-L/16, bf16) with seeded random weights answers three
   requests through `TextFeatureCache` + `make_predictor`; the kernels'
   launch counters prove the path went through them, and the half-res
   logits are held against the plain path and an fp32 reference;
4. numbers: img/s at batch 8, 480x480, K=150 and peak device memory.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is the result object. Needs one GPU and
no network; imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import torch

SEED = 0
# Kernel tolerances against the plain versions on the same inputs.
# patch_embed: both round the same bf16 operands and sum the 768
# products in fp32 in a different order, so the bf16 outputs may differ
# by one ulp (at most 2^-7 of the value) and, where the sum cancels to
# near zero, by the fp32 reordering error of the sum (~1e-4 absolute).
PATCH_RTOL, PATCH_ATOL = 2.0 ** -7, 1e-4
# flash attention: the bound of the reference's own kernel check
# (tests/test_pallas_ops.py:161). The online softmax rounds P to bf16
# relative to the running row maximum, the plain version relative to the
# row maximum, so single P entries differ by up to one bf16 ulp.
FLASH_RTOL, FLASH_ATOL = 2e-2, 2e-2
# Serving: the kernel path's half-res logits may stray from the plain
# path (patch matmul form + einsum attention, same bf16 weights) by at
# most twice what the plain bf16 path strays from the fp32 model, plus a
# floor of one bf16 ulp at the logit scale (|logit| <= 1/0.07).
SERVE_RATIO, SERVE_FLOOR = 2.0, 0.0625


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_time_ms(fn, warmup: int = 3, iters: int = 20) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def deviation(got: torch.Tensor, ref: torch.Tensor):
    d = (got.float() - ref.float()).abs()
    rel = d / ref.float().abs().clamp_min(1e-6)
    return float(d.max()), float(rel.max())


def check_close(name, got, ref, rtol, atol):
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(ref.shape)} {ref.dtype}")
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    max_abs, max_rel = deviation(got, ref)
    bound = atol + rtol * ref.float().abs()
    bad = int(((got.float() - ref.float()).abs() > bound).sum())
    print(f"  {name}: max_abs={max_abs:.6g} max_rel={max_rel:.6g} "
          f"over_tol={bad} (rtol={rtol:g}, atol={atol:g})", flush=True)
    if bad:
        err = ((got.float() - ref.float()).abs() - bound).flatten()
        for i in torch.topk(err, min(bad, 5)).indices.tolist():
            print(f"    at {i}: got {float(got.flatten()[i])!r} "
                  f"plain {float(ref.flatten()[i])!r}")
        fail(f"{name}: {bad} elements outside tolerance")
    return max_abs


def phase_device_and_build():
    from lseg_tpu_torch.ops._build import load_kernels

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(f"[1] device: {name} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  tf32: matmul off, cudnn off")
    load_kernels()
    print(f"  kernel build: {load_kernels.build_seconds:.2f} s")
    for line in load_kernels.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"  ptxas: {line.strip()}")
    return name


def phase_kernels(dev):
    from lseg_tpu_torch.ops.flash_attention import (
        flash_attention_flat,
        flash_attention_flat_plain,
    )
    from lseg_tpu_torch.ops.patch_embed import (
        patch_embed,
        patch_embed_plain,
    )

    print("[2] kernels vs plain versions")
    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    w = (0.05 * torch.randn(768, 1024, device=dev, generator=g)
         ).to(torch.bfloat16)
    b = torch.randn(1024, device=dev, generator=g)
    for shape in ((8, 480, 480, 3), (2, 384, 480, 3)):
        x = torch.randn(shape, device=dev, generator=g)
        err = check_close(f"patch_embed {shape}", patch_embed(x, w, b, 16),
                          patch_embed_plain(x, w, b, 16), PATCH_RTOL,
                          PATCH_ATOL)
        if shape[0] == 8:
            ms = cuda_time_ms(lambda: patch_embed(x, w, b, 16))
            plain_ms = cuda_time_ms(lambda: patch_embed_plain(x, w, b, 16))
            results["patch_embed"] = (err, ms, plain_ms)
            print(f"  patch_embed (8,480,480,3)->(8,900,1024): "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    scale = 64 ** -0.5
    for n, t, vl in ((8, 901, None), (8, 904, 901), (2, 721, None)):
        qkv = torch.randn(n, t, 3 * 1024, device=dev, generator=g
                          ).to(torch.bfloat16)
        err = check_close(
            f"flash_attention_flat ({n},{t},3072) valid_len={vl}",
            flash_attention_flat(qkv, 16, scale, vl),
            flash_attention_flat_plain(qkv, 16, scale, vl),
            FLASH_RTOL, FLASH_ATOL)
        if (n, t, vl) == (8, 901, None):
            ms = cuda_time_ms(lambda: flash_attention_flat(qkv, 16, scale))
            plain_ms = cuda_time_ms(
                lambda: flash_attention_flat_plain(qkv, 16, scale))
            results["flash_attention_flat"] = (err, ms, plain_ms)
            print(f"  flash_attention_flat (8,901,3072) 16 heads: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return results


def _images(g, dev, n, h, w, pad_rows=0):
    x = torch.randn(n, h - 2 * pad_rows, w, 3, device=dev, generator=g)
    if pad_rows:  # the demo pads a 360x480 frame to 384x480 with -1
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, pad_rows, pad_rows),
                                    value=-1.0)
    return x


def phase_serving(dev):
    from lseg_tpu_torch import (
        CLIP_TEXT_VITB32,
        fast_serving,
        get_config,
        get_labels,
    )
    from lseg_tpu_torch.engine.serve import make_predictor
    from lseg_tpu_torch.models.clip_text import CLIPTextEncoder
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.flash_attention import flash_attention_flat
    from lseg_tpu_torch.ops.patch_embed import patch_embed
    from lseg_tpu_torch.text.cache import TextFeatureCache
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer

    print("[3] serving fast_serving(clip_vitl16_384, quant=False), bf16")
    cfg = fast_serving(get_config("clip_vitl16_384"), quant=False)
    vit = cfg.vit
    print(f"  ViT-L/16: depth {vit.depth} (blocks run {vit.hooks[-1] + 1}), "
          f"D={vit.embed_dim}, {vit.num_heads} heads, hooks {vit.hooks}, "
          f"attn {vit.attn_impl}, patch_fused {vit.patch_fused}; features "
          f"{cfg.features}, out_c {cfg.out_c}; text width "
          f"{CLIP_TEXT_VITB32.width} x {CLIP_TEXT_VITB32.layers} layers")
    g = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = random_init_(LSegNet(cfg, torch.bfloat16, dev), g)
    text = random_init_(CLIPTextEncoder(CLIP_TEXT_VITB32, device=dev), g)
    cache = TextFeatureCache(CLIP_TEXT_VITB32, text.state_dict(),
                             ClipBPETokenizer.for_tests(context_length=77),
                             device=dev)
    del text
    predict = make_predictor(model)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  built + random init: {time.perf_counter() - t0:.2f} s, "
          f"{n_params / 1e6:.1f} M image-tower params")

    ade = get_labels("ade20k")
    requests = [
        ("ade20k-150 b8 480x480", ade, _images(g, dev, 8, 480, 480)),
        ("5 labels b1 480x480", "plant,grass,cat,stone,other".split(","),
         _images(g, dev, 1, 480, 480)),
        ("pascal_voc-21 b2 384x480 (padded 360)", get_labels("pascal_voc"),
         _images(g, dev, 2, 384, 480, pad_rows=12)),
    ]
    blocks = vit.hooks[-1] + 1
    patch_embed.launches = 0
    flash_attention_flat.launches = 0
    for name, labels, images in requests:
        p0, f0 = patch_embed.launches, flash_attention_flat.launches
        t0 = time.perf_counter()
        txt = cache(labels)
        pred = predict(images, txt)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n, h, w, _ = images.shape
        k = len(labels)
        if pred.shape != (n, h, w) or pred.dtype != torch.int32:
            fail(f"{name}: labels {tuple(pred.shape)} {pred.dtype}")
        lo, hi = int(pred.min()), int(pred.max())
        if lo < 0 or hi >= k:
            fail(f"{name}: labels outside [0, {k}): [{lo}, {hi}]")
        dp = patch_embed.launches - p0
        df = flash_attention_flat.launches - f0
        print(f"  request {name}: K={k}, labels {tuple(pred.shape)} int32 "
              f"in [{lo}, {hi}], {len(torch.unique(pred))} distinct, "
              f"{dt:.3f} s (first call), launches patch_embed {dp}, "
              f"flash_attention_flat {df}")
        if dp != 1 or df != blocks:
            fail(f"{name}: expected 1 patch_embed and {blocks} flash "
                 f"launches, got {dp} and {df}")
    launches = {"patch_embed": patch_embed.launches,
                "flash_attention_flat": flash_attention_flat.launches}
    print(f"  main path launches: {launches}")
    if cache(ade) is not cache(ade):
        fail("text cache missed a repeated label set")

    # half-res logits: kernel path vs plain path vs fp32 reference
    plain_cfg = dataclasses.replace(cfg, vit=dataclasses.replace(
        vit, attn_impl="xla", attn_scores_dtype="float32",
        patch_fused=False))
    plain = LSegNet(plain_cfg, torch.bfloat16, dev)
    plain.load_state_dict(model.state_dict())
    ref32 = LSegNet(dataclasses.replace(plain_cfg, head_dtype="float32"),
                    torch.float32, dev)
    ref32.load_state_dict(model.state_dict())
    _, labels, images = requests[1]
    txt = cache(labels)
    with torch.inference_mode():
        lk = model(images, txt, return_halfres=True).float()
        lp = plain(images, txt, return_halfres=True).float()
        lr = ref32(images, txt, return_halfres=True).float()
    for name, t in (("kernel", lk), ("plain", lp), ("fp32", lr)):
        if not torch.isfinite(t).all():
            fail(f"half-res logits of the {name} path are not finite")
    d_kernel = float((lk - lp).abs().max())
    d_ref = float((lp - lr).abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    print(f"  half-res logits {tuple(lk.shape)}: |kernel - plain| max "
          f"{d_kernel:.6g}, |plain bf16 - fp32| max {d_ref:.6g}, "
          f"max |logit| {float(lr.abs().max()):.4g}; label agreement "
          f"kernel vs plain {agree:.4f} (not gated)")
    if d_kernel > SERVE_RATIO * d_ref + SERVE_FLOOR:
        fail(f"kernel path deviates {d_kernel} > {SERVE_RATIO} * {d_ref} "
             f"+ {SERVE_FLOOR}")
    del ref32
    return plain, predict, cache, ade, launches


def phase_numbers(dev, plain, predict, cache, ade):
    from lseg_tpu_torch.engine.serve import make_predictor

    print("[4] numbers: batch 8, 480x480, K=150")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    images = _images(g, dev, 8, 480, 480)
    txt = cache(ade)
    for name, fn in (("kernel path", predict),
                     ("plain path", make_predictor(plain))):
        fn(images, txt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: fn(images, txt), warmup=2, iters=10)
        peak = torch.cuda.max_memory_allocated()
        print(f"  {name}: {ms:.3f} ms/batch, img_per_sec_chip_480x480_"
              f"ade20k150_zeroshot={8e3 / ms:.2f}, peak memory "
              f"{peak / 2**30:.3f} GiB")


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    name = phase_device_and_build()
    kernels = phase_kernels(dev)
    plain, predict, cache, ade, launches = phase_serving(dev)
    phase_numbers(dev, plain, predict, cache, ade)
    sources = {
        "patch_embed": ("lseg_tpu_torch/csrc/patch_embed.cu",
                        "lseg_tpu/ops/pallas_patch.py:59"),
        "flash_attention_flat": ("lseg_tpu_torch/csrc/flash_attention_flat.cu",
                                 "lseg_tpu/ops/pallas_attention.py:110"),
    }
    rows = []
    for k, (err, ms, plain_ms) in kernels.items():
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the main path")
        src, rep = sources[k]
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[k],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
