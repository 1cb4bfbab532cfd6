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
3c. the streamed head: the bf16 model of phase 3 answers the same
   requests through `make_predictor(model, use_pallas=True)`; per request
   the counters must read B1 = 1, B6 = blocks, B10 = 1, B11 = 1, and the
   labels must agree with B10's and B11's plain twins on the same
   embeddings (agreement with the whole plain path and the default head
   is printed);
3d. the fused argmax head: the static_cal tree of phase 3b with
   `head_fused=True` answers them through `model(x, txt,
   return_argmax=True)`; per request B1 = 1, B2 = B3 = blocks, B5 = 1,
   B4 = 0, and the labels must agree with B5's plain twin on the same
   path1;
4. numbers: img/s at batch 8, 480x480, K=150 and peak device memory,
   for the bf16, the static_cal, the streamed-head and the fused-argmax
   paths, kernels and plain twins;
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

Phase 2 also times, for each kernel, the PyTorch library call that
computes the same function where there is one, and computes its bound
from the inputs and the card's published peaks. The line before the last
is a JSON object with each kernel's launches, error, times and bound; the
last line is the result object. Needs one GPU and no network; imports no
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import re
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
# fused_correlate (B10): fp32 normalisation and fp32 FMA sums of 512
# products in another order than the plain version's cuBLAS SGEMM (TF32
# off): a few fp32 ulps of the logit scale (|logit| <= 1/0.07).
CORR_RTOL, CORR_ATOL = 1e-5, 1e-4
# upsample2x_argmax (B11) rounds at the plain version's points, op by op:
# the labels must agree everywhere. head1_correlate_argmax_fused (B5): the
# same bf16 operands and codes, fp32 sums in another order, so a label may
# flip where two logits tie to fp32 rounding.
UPARGMAX_MIN_EQUAL, HEAD_ARGMAX_MIN_EQUAL = 1.0, 0.999
# Served labels of the two streamed heads against their plain twins on the
# same head inputs (the embeddings, path1).
HEAD_SERVE_MIN_EQUAL = 0.999
# The card's published peaks (H100 SXM data sheet, dense): the least time
# a kernel's work could take is the larger of its bytes over the memory
# rate and the sum, over the types of its operations, of each count over
# that type's rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(moved: int, ops: dict):
    """(bound_ms, bound_by) of `moved` bytes and {type: operations}."""
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def result(err, ms, plain_ms, moved, ops, library_ms=None):
    bound_ms, bound_by = bound(moved, ops)
    print(f"    bound {bound_ms:.4f} ms ({bound_by}: {moved / 1e6:.1f} MB, "
          + ", ".join(f"{n / 1e9:.1f} G {k}" for k, n in ops.items())
          + f"); library call "
          + ("none" if library_ms is None else f"{library_ms:.4f} ms"))
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


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


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def _kernel_name(mangled: str) -> str:
    """The `..._kernel` identifier (and template arguments) of a mangled
    entry point: the length-prefixed name whose prefix matches."""
    for m in re.finditer(r"(?=(\d{1,3})([a-z]\w*?_kernel)(I\w*?E)?)",
                         mangled):
        if int(m.group(1)) == len(m.group(2)):
            return m.group(2) + (m.group(3) or "")
    return mangled


def ptxas_summary(log: str):
    """One line per compiled kernel: registers, shared memory, spills."""
    name = None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\w+)'", line)
        if hit:
            name = _kernel_name(hit.group(1))
        elif "spill stores" in line and name:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif "Used" in line and "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            smem = re.search(r"(\d+) bytes smem", line)
            yield (f"{name}: {regs} registers, "
                   f"{smem.group(1) if smem else 0} B static smem, "
                   f"{spill} B spilled")
            name = None


def phase_device_and_build():
    from lseg_tpu_torch.ops._build import load_kernels

    name = torch.cuda.get_device_name(0)
    print(f"[1] device: {name} (count {torch.cuda.device_count()}), "
          f"torch {torch.__version__}, cuda {torch.version.cuda}")
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("  tf32: matmul off, cudnn off")
    load_kernels()
    print(f"  kernel build: {load_kernels.build_seconds:.2f} s")
    for line in ptxas_summary(load_kernels.build_log):
        print(f"  ptxas: {line}")
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
        out = patch_embed(x, w, b, 16)
        err = check_close(f"patch_embed {shape}", out,
                          patch_embed_plain(x, w, b, 16), PATCH_RTOL,
                          PATCH_ATOL)
        if shape[0] == 8:
            ms = cuda_time_ms(lambda: patch_embed(x, w, b, 16))
            plain_ms = cuda_time_ms(lambda: patch_embed_plain(x, w, b, 16))
            print(f"  patch_embed (8,480,480,3)->(8,900,1024): "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            # the library call: a stride-16 convolution on the same image
            # and weight, NCHW bf16 (the layout change is not timed)
            xc = x.permute(0, 3, 1, 2).to(torch.bfloat16)
            wc = w.reshape(16, 16, 3, 1024).permute(3, 2, 0, 1).contiguous()
            bc = b.to(torch.bfloat16)
            lib_ms = cuda_time_ms(lambda: torch.nn.functional.conv2d(
                xc, wc, bc, stride=16))
            results["patch_embed"] = result(
                err, ms, plain_ms, nbytes(x, w, b, out),
                {"bf16": 2 * 8 * 900 * 768 * 1024}, lib_ms)

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
            print(f"  flash_attention_flat (8,901,3072) 16 heads: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            q, k, v = qkv.view(n, t, 3, 16, 64).permute(2, 0, 3, 1, 4)
            lib_ms = cuda_time_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, scale=scale))
            results["flash_attention_flat"] = result(
                err, ms, plain_ms, nbytes(qkv) + nbytes(qkv) // 3,
                {"bf16": 4 * n * 16 * t * t * 64}, lib_ms)
    results["flash_attention_flat_bwd"] = _flash_bwd(dev, g, scale)
    results.update(_int8_kernels(dev, g))
    results.update(_head_kernels(dev, g))
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
            # the library call: the backward of scaled_dot_product_attention
            # on the same q, k, v and output gradient
            q, k, v = (qkv.view(8, t, 3, 16, 64).permute(2, 0, 3, 1, 4)
                       .detach().clone().requires_grad_())
            so = torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale)
            dso = do.view(8, t, 16, 64).transpose(1, 2)
            lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
                so, (q, k, v), dso, retain_graph=True))
            # qkv, out, dout read, dqkv written; s recomputed: 10 T^2 hd
            # per head (s, dp, dv, dq, dk)
            res = result(err, ms, plain_ms, nbytes(qkv, out, do, got),
                         {"bf16": 10 * 8 * 16 * t * t * 64}, lib_ms)
    return res


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
    results["ln_quantize_rows"] = result(
        err, ms, plain_ms, nbytes(x, ln_g, ln_b, q, s),
        {"fp32": 8 * 8 * 901 * d})  # ~8 operations per element

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
            results["flash_attention_ln_qkv_fused_q8"] = result(
                err, ms, plain_ms, nbytes(x, ln_g, ln_b, wq, sw, bias, oq,
                                          os_),
                {"int8": 2 * 8 * t * d * 3 * d,
                 "bf16": 4 * 8 * 16 * t * t * 64})

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
            m = xq.numel() // 256
            results["head1_correlate_fused"] = result(
                err, ms, plain_ms,
                nbytes(xq, w1q, s1, b1, txt) + m * 150 * 2,
                {"int8": 2 * m * 256 * 512, "bf16": 2 * m * 512 * 150})
        else:
            _timed("head1_correlate_fused", f"{shape}->K=150 normalize=True",
                   lambda: head1_correlate_fused(*args),
                   lambda: head1_correlate_fused_plain(*args))
    return results


def _head_kernels(dev, g):
    """B10, B11 and B5 at the flagship shapes of their paths."""
    from lseg_tpu_torch.ops.fused_correlate import (
        fused_correlate,
        fused_correlate_plain,
    )
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_argmax_fused,
        head1_correlate_argmax_fused_plain,
    )
    from lseg_tpu_torch.ops.upsample_argmax import (
        upsample2x_argmax,
        upsample2x_argmax_plain,
    )

    results = {}
    scale = 1.0 / 0.07
    # B10: the embeddings of the use_pallas head, bf16, against K = 150;
    # fp32 pixels and a ragged K at smaller shapes
    emb = torch.randn(8, 240, 240, 512, device=dev, generator=g
                      ).to(torch.bfloat16)
    txt = torch.randn(150, 512, device=dev, generator=g)
    logits = fused_correlate(emb, txt, scale)
    err = check_close("fused_correlate (8,240,240,512) bf16 -> K=150",
                      logits, fused_correlate_plain(emb, txt, scale),
                      CORR_RTOL, CORR_ATOL)
    for shape, k in (((1, 240, 240, 512), 21), ((2, 7, 9, 64), 5)):
        x = torch.randn(shape, device=dev, generator=g)
        t = torch.randn(k, shape[-1], device=dev, generator=g)
        t[0] = 0.0  # a zero label row gives logits of 0
        check_close(f"fused_correlate {shape} fp32 -> K={k}",
                    fused_correlate(x, t, scale),
                    fused_correlate_plain(x, t, scale), CORR_RTOL, CORR_ATOL)
    ms, plain_ms = _timed("fused_correlate", "(8,240,240,512) bf16 -> K=150",
                          lambda: fused_correlate(emb, txt, scale),
                          lambda: fused_correlate_plain(emb, txt, scale))
    # the library call: one fp32 matmul of the normalised operands
    xn = torch.nn.functional.normalize(emb.float().reshape(-1, 512), dim=-1)
    tn_t = torch.nn.functional.normalize(txt, dim=-1).t().contiguous()
    lib_ms = cuda_time_ms(lambda: torch.matmul(xn, tn_t))
    del xn
    results["fused_correlate"] = result(
        err, ms, plain_ms, nbytes(emb, txt, logits),
        {"fp32": 2 * emb.numel() * 150}, lib_ms)

    # B11: the fp32 logits of B10, then bf16; all-negative logits, where a
    # K padding that leaked into the argmax would win
    def labels_equal(name, lab, ref, k):
        torch.cuda.synchronize()
        if lab.shape != ref.shape or lab.dtype != torch.int32:
            fail(f"{name}: {tuple(lab.shape)} {lab.dtype}")
        equal = float((lab == ref).float().mean())
        lo, hi = int(lab.min()), int(lab.max())
        print(f"  {name}: labels equal {equal:.6f}, in [{lo}, {hi}]")
        if lo < 0 or hi >= k:
            fail(f"{name}: labels outside [0, {k})")
        return equal

    neg = -(torch.rand(2, 60, 64, 150, device=dev, generator=g) + 0.5)
    cases = (("fp32", logits), ("bf16", logits.to(torch.bfloat16)),
             ("all-negative fp32", neg),
             ("all-negative bf16", neg.to(torch.bfloat16)))
    for name, lg in cases:
        equal = labels_equal(
            f"upsample2x_argmax {tuple(lg.shape)} {name}",
            upsample2x_argmax(lg), upsample2x_argmax_plain(lg), 150)
        if equal < UPARGMAX_MIN_EQUAL:
            fail("upsample2x_argmax: kernel disagrees with its plain version")
    tiny = -torch.ones(1, 8, 8, 3, device=dev) * torch.tensor(
        [3.0, 1.0, 2.0], device=dev)
    if not bool((upsample2x_argmax(tiny) == 1).all()):
        fail("upsample2x_argmax: all-negative logits, label is not 1")
    lab = upsample2x_argmax(logits)
    ms, plain_ms = _timed("upsample2x_argmax", "(8,240,240,150) fp32",
                          lambda: upsample2x_argmax(logits),
                          lambda: upsample2x_argmax_plain(logits))
    nchw = logits.permute(0, 3, 1, 2)
    lib_ms = cuda_time_ms(lambda: torch.nn.functional.interpolate(
        nchw, scale_factor=2, mode="bilinear", align_corners=True).argmax(1))
    up = 8 * 480 * 480 * 150
    results["upsample2x_argmax"] = result(
        1.0 - float((lab == upsample2x_argmax_plain(logits)).float().mean()),
        ms, plain_ms, nbytes(logits, lab), {"fp32": 3 * up // 2 + 3 * up},
        lib_ms)
    del logits, lab, nchw

    # B5: bf16 path1 quantized in the kernel, and int8 codes
    path1 = 0.5 * torch.randn(8, 240, 240, 256, device=dev, generator=g
                              ).to(torch.bfloat16)
    sx = path1.float().abs().amax() / 127.0
    w1q = torch.randint(-127, 128, (512, 256), device=dev, generator=g,
                        dtype=torch.int8)
    s1 = 1e-3 * torch.rand(512, device=dev, generator=g) + 1e-4
    b1 = 0.1 * torch.randn(512, device=dev, generator=g)
    xq = torch.clamp(torch.round(path1.float() / sx), -127, 127
                     ).to(torch.int8)
    got = {}
    for name, x in (("bf16", path1), ("int8", xq)):
        got[name] = head1_correlate_argmax_fused(x, sx, w1q, s1, b1, txt)
        equal = labels_equal(
            f"head1_correlate_argmax_fused (8,240,240,256) {name} -> K=150",
            got[name],
            head1_correlate_argmax_fused_plain(x, sx, w1q, s1, b1, txt), 150)
        if equal < HEAD_ARGMAX_MIN_EQUAL:
            fail("head1_correlate_argmax_fused: kernel disagrees with its "
                 "plain version")
    if not torch.equal(got["bf16"], got["int8"]):
        fail("head1_correlate_argmax_fused: bf16 input quantized in the "
             "kernel does not give the labels of quantizing first")
    print("  head1_correlate_argmax_fused: bf16 and int8 inputs give the "
          "same labels")
    # all logits negative (every label row positive, e = b1 < 0): a K
    # padding that leaked into the argmax would win with its logit 0
    small = xq[:1, :16, :16].contiguous()
    pos = torch.rand(150, 512, device=dev, generator=g) + 0.1
    zero_w, neg_b = torch.zeros_like(w1q), -torch.ones(512, device=dev)
    equal = labels_equal(
        "head1_correlate_argmax_fused all-negative logits",
        head1_correlate_argmax_fused(small, sx, zero_w, s1, neg_b, pos),
        head1_correlate_argmax_fused_plain(small, sx, zero_w, s1, neg_b,
                                           pos), 150)
    if equal < HEAD_ARGMAX_MIN_EQUAL:
        fail("head1_correlate_argmax_fused: all-negative logits disagree")
    ms, plain_ms = _timed(
        "head1_correlate_argmax_fused", "(8,240,240,256) bf16 -> K=150",
        lambda: head1_correlate_argmax_fused(path1, sx, w1q, s1, b1, txt),
        lambda: head1_correlate_argmax_fused_plain(path1, sx, w1q, s1, b1,
                                                   txt))
    m = path1.numel() // 256
    results["head1_correlate_argmax_fused"] = result(
        1.0 - float((got["bf16"] == head1_correlate_argmax_fused_plain(
            path1, sx, w1q, s1, b1, txt)).float().mean()),
        ms, plain_ms, nbytes(path1, w1q, s1, b1, txt, got["bf16"]),
        {"int8": 2 * m * 256 * 512, "bf16": 2 * m * 512 * 150})
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
    _, launches = _serve_requests(
        "bf16", predict, requests, cache, _kernel_counters(),
        {"patch_embed": 1, "flash_attention_flat": blocks})
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
    return model, plain, predict, cache, ade, requests, launches


def _kernel_counters():
    from lseg_tpu_torch.ops.flash_attention import (
        flash_attention_flat,
        flash_attention_flat_bwd,
        flash_attention_ln_qkv_fused_q8,
    )
    from lseg_tpu_torch.ops.fused_correlate import fused_correlate
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_argmax_fused,
        head1_correlate_fused,
    )
    from lseg_tpu_torch.ops.ln_quant import ln_quantize_rows
    from lseg_tpu_torch.ops.patch_embed import patch_embed
    from lseg_tpu_torch.ops.upsample_argmax import upsample2x_argmax

    return {"patch_embed": patch_embed,
            "flash_attention_flat": flash_attention_flat,
            "flash_attention_flat_bwd": flash_attention_flat_bwd,
            "ln_quantize_rows": ln_quantize_rows,
            "flash_attention_ln_qkv_fused_q8": flash_attention_ln_qkv_fused_q8,
            "head1_correlate_fused": head1_correlate_fused,
            "fused_correlate": fused_correlate,
            "upsample2x_argmax": upsample2x_argmax,
            "head1_correlate_argmax_fused": head1_correlate_argmax_fused}


def _serve_requests(tag, call, requests, cache, counters, expected):
    """Answer each request through `call(images, txt)` with the launch
    counters set to 0 just before and read just after; every request
    must launch `expected` (missing keys: 0). Returns the labels and the
    launches of the whole run."""
    expected = {k: expected.get(k, 0) for k in counters}
    for fn in counters.values():
        fn.launches = 0
    preds = []
    for name, labels, images in requests:
        before = {k: fn.launches for k, fn in counters.items()}
        t0 = time.perf_counter()
        txt = cache(labels)
        pred = call(images, txt)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n, h, w, _ = images.shape
        k = len(labels)
        if pred.shape != (n, h, w) or pred.dtype != torch.int32:
            fail(f"{tag} {name}: labels {tuple(pred.shape)} {pred.dtype}")
        lo, hi = int(pred.min()), int(pred.max())
        if lo < 0 or hi >= k:
            fail(f"{tag} {name}: labels outside [0, {k}): [{lo}, {hi}]")
        delta = {key: fn.launches - before[key]
                 for key, fn in counters.items()}
        print(f"  request {name}: K={k}, labels {tuple(pred.shape)} int32 "
              f"in [{lo}, {hi}], {len(torch.unique(pred))} distinct, "
              f"{dt:.3f} s (first call), launches "
              f"{ {k: v for k, v in delta.items() if v} }")
        if delta != expected:
            fail(f"{tag} {name}: expected launches {expected}, got {delta}")
        preds.append(pred)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"  main path launches: { {k: v for k, v in launches.items() if v} }")
    return preds, launches


def _agree(a, b):
    return float((a == b).float().mean())


def _argmax_call(model):
    """(images, txt) -> labels through `model(x, txt, return_argmax=True)`,
    `bench.py`'s call."""
    def call(images, txt):
        with torch.inference_mode():
            return model(images, txt, return_argmax=True)
    return call


def phase_serving_streamed(dev, model, default_predict, cache, requests):
    from lseg_tpu_torch.engine.serve import make_predictor
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.fused_correlate import fused_correlate_plain
    from lseg_tpu_torch.ops.upsample_argmax import upsample2x_argmax_plain

    print("[3c] streamed head: make_predictor(fast_bf16 model, "
          "use_pallas=True), kernels B10 + B11")
    cfg = model.cfg
    predict = make_predictor(model, use_pallas=True)
    plain = LSegNet(cfg, torch.bfloat16, dev, plain=True)
    plain.load_state_dict(model.state_dict())
    plain_predict = make_predictor(plain, use_pallas=True)
    blocks = cfg.vit.hooks[-1] + 1
    preds, launches = _serve_requests(
        "streamed", predict, requests, cache, _kernel_counters(),
        {"patch_embed": 1, "flash_attention_flat": blocks,
         "fused_correlate": 1, "upsample2x_argmax": 1})
    # the served labels against the plain twins of B10 and B11 on the same
    # embeddings (gated); against the whole plain path and the default
    # head (printed: random-init margins are near zero)
    for (name, labels, images), pred in zip(requests, preds):
        txt = cache(labels)
        with torch.inference_mode():
            emb = model(images, None)
            twin = upsample2x_argmax_plain(fused_correlate_plain(
                emb, txt, cfg.logit_scale))
        head_eq = _agree(pred, twin)
        print(f"  {name}: labels vs B10 + B11 plain twins on the same "
              f"embeddings {head_eq:.6f} (gate >= {HEAD_SERVE_MIN_EQUAL}); "
              f"vs the whole plain path {_agree(pred, plain_predict(images, txt)):.4f}, "
              f"vs the default head {_agree(pred, default_predict(images, txt)):.4f}"
              f" (not gated)")
        if head_eq < HEAD_SERVE_MIN_EQUAL:
            fail(f"streamed {name}: labels disagree with the plain twins")
    return predict, plain_predict, launches


def phase_serving_head_fused(dev, model_q, cache, requests):
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_argmax_fused_plain,
    )

    print("[3d] fused argmax head: the static_cal tree with "
          "head_fused=True, model(x, txt, return_argmax=True), kernel B5")
    cfg = dataclasses.replace(model_q.cfg, head_fused=True)
    model = LSegNet(cfg, torch.bfloat16, dev).eval()
    model.load_state_dict(model_q.state_dict())
    plain = LSegNet(cfg, torch.bfloat16, dev, plain=True).eval()
    plain.load_state_dict(model_q.state_dict())
    blocks = cfg.vit.hooks[-1] + 1
    preds, launches = _serve_requests(
        "head_fused", _argmax_call(model), requests, cache, _kernel_counters(),
        {"patch_embed": 1, "ln_quantize_rows": blocks,
         "flash_attention_ln_qkv_fused_q8": blocks,
         "head1_correlate_argmax_fused": 1})
    h1 = model.head1
    for (name, labels, images), pred in zip(requests, preds):
        txt = cache(labels)
        seen = {}
        hook = model.refinenet1.register_forward_hook(
            lambda mod, args, out: seen.__setitem__("path1", out))
        with torch.inference_mode():
            again = model(images, txt, return_argmax=True)
            hook.remove()
            x, sx = model._head1_codes(seen["path1"], keep_bf16=True)
            twin = head1_correlate_argmax_fused_plain(
                x.contiguous(), sx, h1.weight_q, h1.scale, h1.bias, txt)
        head_eq = _agree(again[:, ::2, ::2], twin)
        print(f"  {name}: labels vs B5's plain twin on the same path1 "
              f"{head_eq:.6f} (gate >= {HEAD_SERVE_MIN_EQUAL}), repeat "
              f"equal {bool(torch.equal(again, pred))}; vs the whole plain "
              f"path {_agree(pred, _argmax_call(plain)(images, txt)):.4f}, "
              f"vs the default lowres B4 head "
              f"{_agree(pred, _argmax_call(model_q)(images, txt)):.4f}"
              f" (not gated)")
        if head_eq < HEAD_SERVE_MIN_EQUAL:
            fail(f"head_fused {name}: labels disagree with B5's plain twin")
    return model, plain, launches


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

    blocks = vit.hooks[-1] + 1
    _, launches = _serve_requests(
        "int8", _argmax_call(model), requests, cache, _kernel_counters(),
        {"patch_embed": 1, "ln_quantize_rows": blocks,
         "flash_attention_ln_qkv_fused_q8": blocks,
         "head1_correlate_fused": 1})

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


def phase_numbers(dev, plain, predict, cache, ade, model_q, plain_q,
                  streamed, model_hf, plain_hf):
    from lseg_tpu_torch.engine.serve import make_predictor

    print("[4] numbers: batch 8, 480x480, K=150")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    images = _images(g, dev, 8, 480, 480)
    txt = cache(ade)
    plain_predict = make_predictor(plain)
    _measure("kernel path", lambda: predict(images, txt))
    _measure("plain path", lambda: plain_predict(images, txt))
    _measure("static_cal kernel path",
             lambda: _argmax_call(model_q)(images, txt))
    _measure("static_cal plain path",
             lambda: _argmax_call(plain_q)(images, txt))
    _measure("streamed head (use_pallas) kernel path",
             lambda: streamed[0](images, txt))
    _measure("streamed head (use_pallas) plain path",
             lambda: streamed[1](images, txt))
    _measure("static_cal head_fused=True kernel path",
             lambda: _argmax_call(model_hf)(images, txt))
    _measure("static_cal head_fused=True plain path",
             lambda: _argmax_call(plain_hf)(images, txt))


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
    from lseg_tpu_torch.data.synthetic import SyntheticSegDataset
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
    model, plain, predict, cache, ade, requests, launches = phase_serving(dev)
    *streamed, launches_s = phase_serving_streamed(dev, model, predict, cache,
                                                   requests)
    model_q, plain_q, launches_q = phase_serving_int8(dev, cache, requests)
    model_hf, plain_hf, launches_hf = phase_serving_head_fused(
        dev, model_q, cache, requests)
    phase_numbers(dev, plain, predict, cache, ade, model_q, plain_q,
                  streamed, model_hf, plain_hf)
    del model, plain, predict, streamed, model_q, plain_q, model_hf, plain_hf
    gc.collect()
    torch.cuda.empty_cache()
    launches_t = phase_training(dev, cache, ade)
    # each kernel's launches on the path that runs it: B1 and B6 on the
    # bf16 path (phase 3), B10 and B11 on the streamed head (phase 3c),
    # B2, B3 and B4 on the int8 path (phase 3b, which also checked B1 per
    # request), B5 on the fused argmax head (phase 3d), B7 on the training
    # path (phase 5a, the first fit)
    launches.update({k: launches_s[k] for k in (
        "fused_correlate", "upsample2x_argmax")})
    launches.update({k: launches_q[k] for k in (
        "ln_quantize_rows", "flash_attention_ln_qkv_fused_q8",
        "head1_correlate_fused")})
    launches["head1_correlate_argmax_fused"] = launches_hf[
        "head1_correlate_argmax_fused"]
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
        "fused_correlate": ("lseg_tpu_torch/csrc/fused_correlate.cu",
                            "lseg_tpu/ops/pallas_correlation.py:57"),
        "upsample2x_argmax": ("lseg_tpu_torch/csrc/upsample2x_argmax.cu",
                              "lseg_tpu/ops/pallas_upsample_argmax.py:90"),
        "head1_correlate_argmax_fused": (
            "lseg_tpu_torch/csrc/head1_correlate_argmax.cu",
            "lseg_tpu/ops/pallas_correlation.py:564"),
    }
    rows = []
    for k, res in kernels.items():
        if launches[k] == 0:
            fail(f"kernel {k} was not launched on the main path")
        src, rep = sources[k]
        # max_abs_err of the label kernels (B11, B5): the fraction of
        # labels that differ from the plain version's
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[k], **res})
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
