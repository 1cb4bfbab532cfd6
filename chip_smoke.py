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
3b. int8 serving: the full-width `fast_serving(clip_vitl16_384,
   'static_cal')` model, quantized from seeded random fp32 weights by
   `quantize_tree` and calibrated on one seeded batch without text (as
   the reference's bench.py does), answers the same three requests
   through `model(x, txt, return_argmax=True)`; per request the counters
   must read B1 = 1, B2 = B3 = blocks, B4 = 1, B6 = 0, and the half-res
   logits (B4 with the per-pixel norm) are held against the same int8
   model on its plain twins and the fp32 model;
4. numbers: img/s at batch 8, 480x480, K=150 and peak device memory,
   for the bf16 and the static_cal paths, kernels and plain twins;
5. training, after the serving models are freed: the full-width
   `get_config(clip_vitl16_384)` model with `attn_impl='flashflat'`,
   bf16 compute, fp32 master weights from a seeded random init and remat
   (train.py's configuration), against the K=150 ADE20K label set from
   the text cache:
   (a) `fit` for one epoch of 4 batches of 8 over
       `SyntheticSegDataset(size=480, num_classes=150)` with validation
       and a checkpoint in a temporary directory, then a second `fit`
       that resumes from it and runs the next epoch; launch counts per
       fit must read B6 = 48 per step + 24 per validation batch, B7 = 24
       per step;
   (b) one train step at batch 2 from identical weights on the kernel
       path, the plain path and an fp32 model: the ViT gradients' global
       relative deviation, kernel vs plain, must stay within 2x that of
       plain bf16 vs fp32 plus a floor (printed per block); finite
       losses;
   (c) ms/step, img/s and peak memory at batch 8, kernel and plain
       paths (CUDA events, 5 steps after 2 warm-ups), with per-step
       launch counts B6 = 48 (forward + remat recompute), B7 = 24.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is the result object. Needs one GPU and
no network; imports no JAX.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
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
# ln_quantize_rows (B3): the kernel and the plain version sum the row in
# another order, so a code may sit one level off at a bin edge; the row
# scales agree to fp32 rounding.
LNQ_MAX_CODE_DIFF, LNQ_MIN_EQUAL, LNQ_SCALE_RTOL = 1, 0.999, 1e-5
# flash_attention_ln_qkv_fused_q8 (B2): dequantized outputs within 2e-2 of
# the largest |plain| value, the bound of the reference's own variant
# check (tests/test_pallas_ops.py:1001-1002): the LN codes, the online
# softmax and the output codes each may round one step apart.
LNQKV_REL = 2e-2
# head1_correlate_fused (B4): the same bf16 operands and fp32 sums taken
# in another order: one bf16 ulp (2^-7 relative at most) plus 1e-3
# absolute where the sum cancels.
HEAD1_RTOL, HEAD1_ATOL = 2.0 ** -7, 1e-3
# flash_attention_flat_bwd (B7): each of dq, dk and dv within 2e-2 of
# max|plain|: the two sum in another order and round pn and ds to bf16,
# so single entries may round a bf16 step apart.
FLASH_BWD_REL = 2e-2
# Training: the kernel path's ViT gradients may stray from the plain
# path's (global relative norm) by at most twice what the plain bf16
# step strays from an fp32 step, plus a floor of one bf16 ulp (2^-8).
GRAD_RATIO, GRAD_FLOOR = 2.0, 2.0 ** -8
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
    results["flash_attention_flat_bwd"] = _flash_bwd(dev, g, scale)
    results.update(_int8_kernels(dev, g))
    return results


def _flash_bwd(dev, g, scale):
    from lseg_tpu_torch.ops.flash_attention import (
        flash_attention_flat,
        flash_attention_flat_bwd,
        flash_attention_flat_bwd_plain,
    )

    d = 1024
    for t, vl in ((901, None), (904, 901)):
        qkv = torch.randn(8, t, 3 * d, device=dev, generator=g
                          ).to(torch.bfloat16)
        do = torch.randn(8, t, d, device=dev, generator=g).to(torch.bfloat16)
        out = flash_attention_flat(qkv, 16, scale, vl)
        args = (qkv, out, do, 16, scale, vl)
        got = flash_attention_flat_bwd(*args)
        ref = flash_attention_flat_bwd_plain(*args)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got.float()).all():
            fail(f"flash_attention_flat_bwd: {tuple(got.shape)}, finite "
                 f"{bool(torch.isfinite(got.float()).all())}")
        errs = []
        for name, lo in (("dq", 0), ("dk", d), ("dv", 2 * d)):
            a, b = got[..., lo:lo + d].float(), ref[..., lo:lo + d].float()
            err = float((a - b).abs().max())
            rel = err / float(b.abs().max())
            errs.append(err)
            print(f"  flash_attention_flat_bwd (8,{t},3072) valid_len={vl} "
                  f"{name}: max_abs {err:.6g} = {rel:.4g} of max|plain| "
                  f"(tol {FLASH_BWD_REL:g})")
            if rel > FLASH_BWD_REL:
                fail(f"flash_attention_flat_bwd {name}: kernel disagrees "
                     f"with its plain version")
        if vl is None:
            err = max(errs)
            ms, plain_ms = _timed(
                "flash_attention_flat_bwd", "(8,901,3072) 16 heads",
                lambda: flash_attention_flat_bwd(*args),
                lambda: flash_attention_flat_bwd_plain(*args))
    return err, ms, plain_ms


def _timed(name, shape, kernel, plain):
    ms = cuda_time_ms(kernel)
    plain_ms = cuda_time_ms(plain)
    print(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return ms, plain_ms


def _int8_kernels(dev, g):
    from lseg_tpu_torch.ops.flash_attention import (
        flash_attention_ln_qkv_fused_q8,
        flash_attention_ln_qkv_fused_q8_plain,
    )
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_fused,
        head1_correlate_fused_plain,
    )
    from lseg_tpu_torch.ops.ln_quant import (
        ln_quantize_rows,
        ln_quantize_rows_plain,
    )

    results = {}
    d = 1024
    ln_g = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
    ln_b = 0.1 * torch.randn(d, device=dev, generator=g)

    # B3 at the flagship (8, 901, 1024)
    x = torch.randn(8, 901, d, device=dev, generator=g).to(torch.bfloat16)
    q, s = ln_quantize_rows(x, ln_g, ln_b)
    qp, sp = ln_quantize_rows_plain(x, ln_g, ln_b)
    torch.cuda.synchronize()
    diff = (q.int() - qp.int()).abs()
    equal = float((diff == 0).float().mean())
    scale_rel = float(((s - sp).abs() / sp).max())
    err = float((q.float() * s - qp.float() * sp).abs().max())
    print(f"  ln_quantize_rows (8,901,1024): max code diff {int(diff.max())}"
          f", equal {equal:.6f}, scale rel {scale_rel:.3g}, dequant max_abs "
          f"{err:.6g} (codes within {LNQ_MAX_CODE_DIFF}, equal >= "
          f"{LNQ_MIN_EQUAL}, scales rtol {LNQ_SCALE_RTOL:g})")
    if (int(diff.max()) > LNQ_MAX_CODE_DIFF or equal < LNQ_MIN_EQUAL
            or scale_rel > LNQ_SCALE_RTOL):
        fail("ln_quantize_rows: kernel disagrees with its plain version")
    ms, plain_ms = _timed("ln_quantize_rows", "(8,901,1024)",
                          lambda: ln_quantize_rows(x, ln_g, ln_b),
                          lambda: ln_quantize_rows_plain(x, ln_g, ln_b))
    results["ln_quantize_rows"] = (err, ms, plain_ms)

    # B2 at (8, 901, 1024) and the padded (8, 904, 1024), valid_len 901
    wq = torch.randint(-127, 128, (3 * d, d), device=dev, generator=g,
                       dtype=torch.int8)
    sw = 1e-3 * torch.rand(3 * d, device=dev, generator=g)
    bias = 0.05 * torch.randn(3 * d, device=dev, generator=g)
    scale = 64 ** -0.5
    for t, vl in ((901, None), (904, 901)):
        x = torch.randn(8, t, d, device=dev, generator=g).to(torch.bfloat16)
        args = (x, ln_g, ln_b, wq, sw, bias, 16, scale, vl)
        oq, os_ = flash_attention_ln_qkv_fused_q8(*args)
        pq, ps = flash_attention_ln_qkv_fused_q8_plain(*args)
        torch.cuda.synchronize()
        got, ref = oq.float() * os_, pq.float() * ps
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        equal = float((oq == pq).float().mean())
        if not torch.isfinite(got).all():
            fail("flash_attention_ln_qkv_fused_q8: non-finite output")
        print(f"  flash_attention_ln_qkv_fused_q8 (8,{t},1024) valid_len="
              f"{vl}: dequant max_abs {err:.6g} = {rel:.4g} of max|plain| "
              f"(tol {LNQKV_REL:g}), codes equal {equal:.6f}")
        if rel > LNQKV_REL:
            fail("flash_attention_ln_qkv_fused_q8: kernel disagrees with "
                 "its plain version")
        if vl is None:
            ms, plain_ms = _timed(
                "flash_attention_ln_qkv_fused_q8", "(8,901,1024) 16 heads",
                lambda: flash_attention_ln_qkv_fused_q8(*args),
                lambda: flash_attention_ln_qkv_fused_q8_plain(*args))
            results["flash_attention_ln_qkv_fused_q8"] = (err, ms, plain_ms)

    # B4: lowres head (normalize=False) and the half-res logits head
    w1q = torch.randint(-127, 128, (512, 256), device=dev, generator=g,
                        dtype=torch.int8)
    s1 = 1e-3 * torch.rand(512, device=dev, generator=g) + 1e-4
    b1 = 0.1 * torch.randn(512, device=dev, generator=g)
    txt = torch.randn(150, 512, device=dev, generator=g)
    sx = torch.tensor(0.02, device=dev)
    for shape, normalize in (((8, 120, 120, 256), False),
                             ((8, 240, 240, 256), True)):
        xq = torch.randint(-127, 128, shape, device=dev, generator=g,
                           dtype=torch.int8)
        args = (xq, sx, w1q, s1, b1, txt, 1.0 / 0.07, normalize)
        err = check_close(
            f"head1_correlate_fused {shape}->K=150 normalize={normalize}",
            head1_correlate_fused(*args), head1_correlate_fused_plain(*args),
            HEAD1_RTOL, HEAD1_ATOL)
        if not normalize:
            ms, plain_ms = _timed(
                "head1_correlate_fused", f"{shape}->K=150 normalize=False",
                lambda: head1_correlate_fused(*args),
                lambda: head1_correlate_fused_plain(*args))
            results["head1_correlate_fused"] = (err, ms, plain_ms)
        else:
            _timed("head1_correlate_fused", f"{shape}->K=150 normalize=True",
                   lambda: head1_correlate_fused(*args),
                   lambda: head1_correlate_fused_plain(*args))
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
    return plain, predict, cache, ade, requests, launches


def _kernel_counters():
    from lseg_tpu_torch.ops.flash_attention import (
        flash_attention_flat,
        flash_attention_flat_bwd,
        flash_attention_ln_qkv_fused_q8,
    )
    from lseg_tpu_torch.ops.head1_correlate import head1_correlate_fused
    from lseg_tpu_torch.ops.ln_quant import ln_quantize_rows
    from lseg_tpu_torch.ops.patch_embed import patch_embed

    return {"patch_embed": patch_embed,
            "flash_attention_flat": flash_attention_flat,
            "flash_attention_flat_bwd": flash_attention_flat_bwd,
            "ln_quantize_rows": ln_quantize_rows,
            "flash_attention_ln_qkv_fused_q8": flash_attention_ln_qkv_fused_q8,
            "head1_correlate_fused": head1_correlate_fused}


def phase_serving_int8(dev, cache, requests):
    from lseg_tpu_torch import fast_serving, get_config
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.quant import calibrate_act_scales, quantize_tree

    print("[3b] serving fast_serving(clip_vitl16_384, 'static_cal'), int8")
    cfg = fast_serving(get_config("clip_vitl16_384"), "static_cal")
    vit = cfg.vit
    print(f"  attn {vit.attn_impl}, ln_quant_fused {vit.ln_quant_fused}, "
          f"mlp_act_cal {vit.mlp_act_cal}, quant_int8 {vit.quant_int8}; "
          f"decoder_quant {cfg.decoder_quant}, head_fused {cfg.head_fused},"
          f" decoder_conv_first {cfg.decoder_conv_first}")
    # the same function unquantized in fp32: the source of the int8 tree
    # and the reference of d_ref
    fast = fast_serving(get_config("clip_vitl16_384"), quant=False)
    ref_cfg = dataclasses.replace(fast, head_dtype="float32",
                                  vit=dataclasses.replace(
                                      fast.vit, attn_impl="xla",
                                      attn_scores_dtype="float32",
                                      patch_fused=False))
    g = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    ref32 = random_init_(LSegNet(ref_cfg, torch.float32, dev), g).eval()
    state = quantize_tree(ref32.state_dict(), decoder=True, act_scale=True)
    model = LSegNet(cfg, torch.bfloat16, dev).eval()
    model.load_state_dict(state)
    del state
    cal = _images(g, dev, 8, 480, 480)
    calibrate_act_scales(model, cal, None)
    plain = LSegNet(cfg, torch.bfloat16, dev, plain=True).eval()
    plain.load_state_dict(model.state_dict())
    torch.cuda.synchronize()
    scales = [v for k, v in model.state_dict().items()
              if k.endswith("act_scale")]
    if not scales or any(float(v) == 1.0 or not torch.isfinite(v)
                         for v in scales):
        fail("calibration left an act_scale at its placeholder")
    print(f"  quantize_tree + calibrate_act_scales (one batch of 8): "
          f"{time.perf_counter() - t0:.2f} s, {len(scales)} act scales in "
          f"[{min(float(v) for v in scales):.4g}, "
          f"{max(float(v) for v in scales):.4g}]")

    counters = _kernel_counters()
    blocks = vit.hooks[-1] + 1
    expected = {"patch_embed": 1, "flash_attention_flat": 0,
                "flash_attention_flat_bwd": 0, "ln_quantize_rows": blocks,
                "flash_attention_ln_qkv_fused_q8": blocks,
                "head1_correlate_fused": 1}
    for fn in counters.values():
        fn.launches = 0
    for name, labels, images in requests:
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        txt = cache(labels)
        with torch.inference_mode():
            pred = model(images, txt, return_argmax=True)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n, h, w, _ = images.shape
        k = len(labels)
        if pred.shape != (n, h, w) or pred.dtype != torch.int32:
            fail(f"int8 {name}: labels {tuple(pred.shape)} {pred.dtype}")
        lo, hi = int(pred.min()), int(pred.max())
        if lo < 0 or hi >= k:
            fail(f"int8 {name}: labels outside [0, {k}): [{lo}, {hi}]")
        delta = {key: fn.launches - before[key]
                 for key, fn in counters.items()}
        print(f"  request {name}: K={k}, labels {tuple(pred.shape)} int32 "
              f"in [{lo}, {hi}], {len(torch.unique(pred))} distinct, "
              f"{dt:.3f} s (first call), launches {delta}")
        if delta != expected:
            fail(f"int8 {name}: expected launches {expected}, got {delta}")
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"  main path launches: {launches}")

    # half-res logits: kernel path vs plain path vs the fp32 model
    _, labels, images = requests[1]
    txt = cache(labels)
    with torch.inference_mode():
        lk = model(images, txt, return_halfres=True).float()
        lp = plain(images, txt, return_halfres=True).float()
        lr = ref32(images, txt, return_halfres=True).float()
    for name, t in (("kernel", lk), ("plain", lp), ("fp32", lr)):
        if not torch.isfinite(t).all():
            fail(f"int8 half-res logits of the {name} path are not finite")
    d_kernel = float((lk - lp).abs().max())
    d_ref = float((lp - lr).abs().max())
    agree = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    agree_ref = float((lp.argmax(-1) == lr.argmax(-1)).float().mean())
    print(f"  int8 half-res logits {tuple(lk.shape)}: |kernel - plain| max "
          f"{d_kernel:.6g}, |plain int8 - fp32| max {d_ref:.6g}, max "
          f"|logit| {float(lr.abs().max()):.4g}; label agreement kernel vs "
          f"plain {agree:.4f}, plain vs fp32 {agree_ref:.4f} (not gated)")
    if d_kernel > SERVE_RATIO * d_ref + SERVE_FLOOR:
        fail(f"int8 kernel path deviates {d_kernel} > {SERVE_RATIO} * "
             f"{d_ref} + {SERVE_FLOOR}")
    del ref32
    return model, plain, launches


def _measure(name, fn):
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ms = cuda_time_ms(fn, warmup=2, iters=10)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {name}: {ms:.3f} ms/batch, img_per_sec_chip_480x480_"
          f"ade20k150_zeroshot={8e3 / ms:.2f}, peak memory "
          f"{peak / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB resident "
          f"before the call)")


def phase_numbers(dev, plain, predict, cache, ade, model_q, plain_q):
    from lseg_tpu_torch.engine.serve import make_predictor

    print("[4] numbers: batch 8, 480x480, K=150")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    images = _images(g, dev, 8, 480, 480)
    txt = cache(ade)
    plain_predict = make_predictor(plain)
    _measure("kernel path", lambda: predict(images, txt))
    _measure("plain path", lambda: plain_predict(images, txt))

    def argmax_call(model):
        def call():
            with torch.inference_mode():
                return model(images, txt, return_argmax=True)
        return call

    _measure("static_cal kernel path", argmax_call(model_q))
    _measure("static_cal plain path", argmax_call(plain_q))


def _vit_grad_deviation(a, b, blocks):
    """Global relative norm |g_a - g_b| / |g_b| over the ViT's parameter
    gradients, and the same per block."""
    def rel(prefix):
        num = den = 0.0
        for name, pa in a.vit.named_parameters():
            if not name.startswith(prefix):
                continue
            ga = pa.grad.float()
            gb = b.vit.get_parameter(name).grad.float()
            num += float(((ga - gb) ** 2).sum())
            den += float((gb ** 2).sum())
        return (num / den) ** 0.5

    return rel(""), [rel(f"blocks.{i}.") for i in range(blocks)]


def _train_timing(name, state, step, batch, txt, counters, expect):
    """ms/step over 5 steps after 2 warm-ups (CUDA events), peak memory,
    and the launches of each step."""
    def one():
        before = {k: fn.launches for k, fn in counters.items()}
        step(state, batch, txt)
        delta = {k: fn.launches - before[k] for k, fn in counters.items()}
        if delta != expect:
            fail(f"{name}: launches per train step {delta}, expected "
                 f"{expect}")

    for _ in range(2):
        one()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        one()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 5
    peak = torch.cuda.max_memory_allocated()
    n = batch["image"].shape[0]
    print(f"  {name}: {ms:.3f} ms/step, train img/s {n * 1e3 / ms:.2f} at "
          f"batch {n}, peak memory {peak / 2**30:.3f} GiB "
          f"({resident / 2**30:.3f} GiB resident before the steps), "
          f"launches per step {expect}")


def phase_training(dev, cache, ade):
    from lseg_tpu.data.synthetic import SyntheticSegDataset
    from lseg_tpu_torch import get_config
    from lseg_tpu_torch.data.loader import DataLoader
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.train.loop import FitConfig, fit
    from lseg_tpu_torch.train.optim import make_optimizer
    from lseg_tpu_torch.train.step import (
        TrainState,
        enable_grads,
        make_train_step,
    )

    print("[5] training get_config(clip_vitl16_384), flashflat, bf16 with "
          "fp32 masters, remat")
    base = get_config("clip_vitl16_384")
    cfg = dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, attn_impl="flashflat"))
    blocks = cfg.vit.hooks[-1] + 1
    txt = cache(ade)
    k = txt.shape[0]
    g = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    model = random_init_(LSegNet(cfg, torch.bfloat16, dev, remat=True,
                                 param_dtype=torch.float32), g)
    init_state = {n: t.clone() for n, t in model.state_dict().items()}
    enable_grads(model)
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"  built + random init: {time.perf_counter() - t0:.2f} s, "
          f"{n_train / 1e6:.1f} M trainable fp32 parameters; K={k}, crop "
          f"480, batch 8, attn {cfg.vit.attn_impl}, head {cfg.head_dtype}")

    counters = _kernel_counters()
    train_ds = SyntheticSegDataset(n=32, size=480, num_classes=k)
    val_ds = SyntheticSegDataset(n=8, size=480, num_classes=k, seed=1)
    loader = DataLoader(train_ds, 8, num_workers=8, device=dev)
    val_loader = DataLoader(val_ds, 8, shuffle=False, num_workers=8,
                            device=dev)
    state = TrainState(model, make_optimizer(
        model, 0.004, max_steps=2 * len(loader), batch_size=8))
    fit_expect = {"flash_attention_flat": 48 * len(loader)
                  + 24 * len(val_loader),
                  "flash_attention_flat_bwd": 24 * len(loader)}
    launches = None
    with tempfile.TemporaryDirectory() as ckpt_dir:
        for epochs in (1, 2):
            for fn in counters.values():
                fn.launches = 0
            logs = []
            t0 = time.perf_counter()
            fit(state, loader, txt, FitConfig(
                max_epochs=epochs, ckpt_dir=ckpt_dir, log_every=1,
                tensorboard=False), val_loader=val_loader, log=logs.append)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            got = {key: counters[key].launches for key in fit_expect}
            for line in logs:
                print(f"    {line}")
            print(f"  fit to epoch {epochs}: {dt:.2f} s, step {state.step}, "
                  f"launches {got}")
            if launches is None:
                launches = got
            if got != fit_expect:
                fail(f"fit: launches {got}, expected {fit_expect}")
            if state.step != epochs * len(loader):
                fail(f"fit ended at step {state.step}")
            if epochs == 2 and f"resumed from step {len(loader)} (epoch 1)" \
                    not in logs:
                fail("the second fit did not resume from the checkpoint")
        with open(f"{ckpt_dir}/metrics.csv") as f:
            rows = f.read().splitlines()
        print(f"  metrics.csv: {rows}")
        for row in rows[1:]:
            loss, acc = row.split(",")[1], row.split(",")[3]
            if not (float(loss) == float(loss) and 0.0 <= float(acc) <= 1.0):
                fail(f"metrics.csv row {row!r}: loss or val_acc invalid")

    # (b) one step at batch 2 from identical weights: kernel, plain, fp32
    batch8 = next(iter(DataLoader(train_ds, 8, shuffle=False, device=dev)))
    batch2 = {key: v[:2] for key, v in batch8.items()}
    step = make_train_step()
    model.load_state_dict(init_state)
    plain = LSegNet(cfg, torch.bfloat16, dev, plain=True, remat=True,
                    param_dtype=torch.float32)
    ref32 = LSegNet(cfg, torch.float32, dev, plain=True, remat=True)
    losses = {}
    states = {}
    for name, m in (("kernel", model), ("plain", plain), ("fp32", ref32)):
        m.load_state_dict(init_state)
        enable_grads(m)
        states[name] = TrainState(m, make_optimizer(m, 0.004, 100,
                                                    batch_size=2))
        _, metrics = step(states[name], batch2, txt)
        losses[name] = float(metrics["loss"])
    torch.cuda.synchronize()
    print(f"  one step at batch 2, losses {losses}")
    if not all(v == v and abs(v) != float("inf") for v in losses.values()):
        fail("a training loss is not finite")
    d_kernel, per_k = _vit_grad_deviation(model, plain, blocks)
    d_ref, per_r = _vit_grad_deviation(plain, ref32, blocks)
    print(f"  ViT gradients: |kernel - plain| / |plain| {d_kernel:.6g}, "
          f"|plain bf16 - fp32| / |fp32| {d_ref:.6g} (bound {GRAD_RATIO} * "
          f"d_ref + {GRAD_FLOOR:g})")
    print("  per block kernel vs plain: "
          + " ".join(f"{v:.4g}" for v in per_k))
    print("  per block plain vs fp32:   "
          + " ".join(f"{v:.4g}" for v in per_r))
    if not d_kernel <= GRAD_RATIO * d_ref + GRAD_FLOOR:
        fail(f"kernel-path gradients deviate {d_kernel} > {GRAD_RATIO} * "
             f"{d_ref} + {GRAD_FLOOR}")
    del states["fp32"], ref32
    gc.collect()
    torch.cuda.empty_cache()

    # (c) numbers at batch 8
    _train_timing("kernel path", states["kernel"], step, batch8, txt,
                  {key: counters[key] for key in fit_expect},
                  {"flash_attention_flat": 2 * blocks,
                   "flash_attention_flat_bwd": blocks})
    _train_timing("plain path", states["plain"], step, batch8, txt,
                  {key: counters[key] for key in fit_expect},
                  {"flash_attention_flat": 0, "flash_attention_flat_bwd": 0})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)")
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    name = phase_device_and_build()
    kernels = phase_kernels(dev)
    plain, predict, cache, ade, requests, launches = phase_serving(dev)
    model_q, plain_q, launches_q = phase_serving_int8(dev, cache, requests)
    phase_numbers(dev, plain, predict, cache, ade, model_q, plain_q)
    del plain, predict, model_q, plain_q
    gc.collect()
    torch.cuda.empty_cache()
    launches_t = phase_training(dev, cache, ade)
    # each kernel's launches on the path that runs it: B1 and B6 on the
    # bf16 path (phase 3), B2, B3 and B4 on the int8 path (phase 3b, which
    # also checked B1 per request), B7 on the training path (phase 5a,
    # the first fit)
    launches.update({k: launches_q[k] for k in (
        "ln_quantize_rows", "flash_attention_ln_qkv_fused_q8",
        "head1_correlate_fused")})
    launches["flash_attention_flat_bwd"] = launches_t[
        "flash_attention_flat_bwd"]
    sources = {
        "patch_embed": ("lseg_tpu_torch/csrc/patch_embed.cu",
                        "lseg_tpu/ops/pallas_patch.py:59"),
        "flash_attention_flat": ("lseg_tpu_torch/csrc/flash_attention_flat.cu",
                                 "lseg_tpu/ops/pallas_attention.py:110"),
        "flash_attention_flat_bwd": (
            "lseg_tpu_torch/csrc/flash_attention_flat_bwd.cu",
            "lseg_tpu/ops/pallas_attention.py:612"),
        "ln_quantize_rows": ("lseg_tpu_torch/csrc/ln_quantize_rows.cu",
                             "lseg_tpu/ops/pallas_ln.py:43"),
        "flash_attention_ln_qkv_fused_q8": (
            "lseg_tpu_torch/csrc/flash_attention_ln_qkv_q8.cu",
            "lseg_tpu/ops/pallas_attention.py:780"),
        "head1_correlate_fused": ("lseg_tpu_torch/csrc/head1_correlate.cu",
                                  "lseg_tpu/ops/pallas_correlation.py:638"),
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
