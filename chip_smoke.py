#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`lseg_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before
the result line is printed:

1. device and build: the card, its power limit, and the nvcc build of
   the hand-written kernels (`lseg_tpu_torch/csrc`);
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the serving path, with its time beside the plain version's
   (B10 in both of its modes, fp32 and compute_dtype=bfloat16; B17 at
   ViT-L/16's fc2 and proj shapes and the reference test's fp32 shape,
   with and without a residual; B20 at the reference probe's shape in
   both scale block shapes);
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
3e. the `fast_flashq` rung of the reference's bench.py: `fast_serving(
   clip_vitl16_384, 'static_cal')` with `attn_impl='flashq'`,
   `ln_quant_fused=False` and `mlp_act_cal=False`, quantized from the fp32
   weights of phase 3b and calibrated on one batch, answers them through
   `model(x, txt, return_argmax=True)`; per request B1 = 1, B8 = blocks,
   B4 = 1, B2 = B3 = B6 = 0, and the half-res logits are held as in 3b;
3f. the 'wup' logits head: the static_cal tree of phase 3b with
   `head_fused='wup'` answers them through `model(x, txt)` (the call of
   `make_logits_fn`), and kernel B13 takes the labels of the same path1;
   per request B1 = 1, B2 = B3 = blocks, B14 = 1, B13 = 1, B4 = B5 = 0;
   the full-resolution fp32 logits are held as in 3b, B13's labels
   against its plain twin on the same codes (agreement with the argmax of
   the logits is printed);
3g. the fused int8 block: `fast_serving(clip_vitl16_384, 'static_cal')`
   with `attn_impl='flashqp'`, `mlp_fused=True` and `mlp_act_cal=False`,
   quantized from the fp32 weights of phase 3b without the MLP-hidden
   scale and calibrated on one batch (the ViT must keep no act_scale),
   answers them through `model(x, txt, return_argmax=True)`; per request
   B1 = 1, B15 = B16 = blocks, B4 = 1, B2 = B3 = B6 = B8 = 0, and the
   half-res logits are held as in 3b;
3h. the fused int8 decoder: the static_cal tree of phase 3b under
   `decoder_fused_rcu` and `decoder_fused_tail` answers them through
   `model(x, txt, return_argmax=True)`; per request B1 = 1, B2 = B3 =
   blocks, B18 = 7 (refinenet4's rcu2, both RCUs of refinenets 3-1),
   B19 = 1 (refinenet2 only: refinenet4's and refinenet3's upsampled
   widths 30 and 60 are no multiples of 8, refinenet1 takes
   `decoder_conv_first`), B4 = 1; the half-res logits are held as in 3b,
   and the label agreement with phase 3b's unfused model is printed;
3i. refinenet1's int8 hand-off: the same fp32 weights under the fused
   decoder with `head_fused=True` and no `decoder_conv_first`, quantized
   and calibrated on their own batch, answer them through `model(x, txt,
   return_argmax=True)`; per request B1 = 1, B2 = B3 = blocks, B18 = 7,
   B19 = 2 (refinenet1's emits int8 codes on head1's grid), B5 = 1 on
   that int8 path1, B4 = 0; the labels must agree with B5's plain twin on
   the same codes, and a half-res logits call (B4 on the codes) is held as
   in 3b;
4. numbers: img/s at batch 8, 480x480, K=150 and peak device memory,
   for the bf16, the static_cal, the fused-block, the fused-decoder, the
   int8 hand-off, the streamed-head, the fused-argmax, the fast_flashq and
   the 'wup' logits paths, kernels and plain twins;
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
       launch counts B6 = 48 (forward + remat recompute), B7 = 24;
6. the probe path: `lseg_tpu_torch.probe` compiles B20's source alone
   (`--sources`), then runs its cases in process: the four B20 variants
   (each from the probe's own one-source library), `dense` (B17 at fc2)
   and `ln_qkv` (B9), each against its plain twin; the launch counters
   must show exactly B9, B17 and B20, the kernels that no model path of
   the reference runs.

Phase 2 also times, for each kernel, the PyTorch library call that
computes the same function where there is one, and computes its bound
from the inputs and the card's published peaks. The line before the last
is a JSON object with each kernel's launches (on the path of phases 3-6
that runs it: every kernel runs on a serving path, the training path or
the probe path), error, times and bound (B10's row also holds its bf16
mode's under "bf16"); the last line is the result object. Needs one
GPU and no network; imports no JAX and nothing of the JAX package.
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
# softmax and the output codes each may round one step apart. The same
# bound holds B8 and B9, and B15 and B16 with a zero residual; with a real
# residual B15 and B16 may add one rounding step of the bf16 sum, one bf16
# ulp (2^-7 relative at most) of |plain|.
LNQKV_REL = 2e-2
RESID_RTOL = 2.0 ** -7
# head1_correlate_fused (B4): the same bf16 operands and fp32 sums taken
# in another order: one bf16 ulp (2^-7 relative at most) plus 1e-3
# absolute where the sum cancels. head1_correlate_wup_fused (B14) blends
# two such logits along W, and the blend can cancel to near zero: the
# ulp of each tap carried through the blend plus the blend's own rounding
# on each side, two ulps of the blended magnitudes (the W-interp of
# |logits|), plus 1e-3; and, against the W-interp of kernel B4's logits
# on the same inputs, bit for bit (the same tile code, and a blend of two
# bf16 products rounds once).
HEAD1_RTOL, HEAD1_ATOL = 2.0 ** -7, 1e-3
WUP_RTOL = 2 * HEAD1_RTOL
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
# fused_correlate (B10) with compute_dtype=bfloat16: fp32 sums in another
# order and one rounding to bf16, one bf16 ulp (2^-7 of |plain| at most)
# plus 1e-3; and where the kernel's fp32 norm of a row and the plain
# version's differ in the last bit, a normalised operand may round to bf16
# one ulp (at most 2^-7 of it) apart, which moves the logit by at most
# 2^-7 * scale * max|xn| * max|tn| of its pixel and label (`_corr_bf16_
# magnitude`). On an H100, 7 of the 69,120,000 logits of the flagship
# shape needed that term.
CORR_BF16_RTOL, CORR_BF16_ATOL = 2.0 ** -7, 1e-3
# upsample2x_argmax (B11) rounds at the plain version's points, op by op:
# the labels must agree everywhere, as must those of
# head1_correlate_upsample_argmax (B13) with the plain tail of kernel B4's
# logits. head1_correlate_argmax_fused (B5) and B13 against their plain
# twins: the same bf16 operands and codes, fp32 sums in another order, so
# a label may flip where two logits tie to fp32 rounding.
UPARGMAX_MIN_EQUAL, HEAD_ARGMAX_MIN_EQUAL = 1.0, 0.999
# Served labels of the two streamed heads against their plain twins on the
# same head inputs (the embeddings, path1).
HEAD_SERVE_MIN_EQUAL = 0.999
# fused_rcu (B18) and fused_upsample_outconv (B19) against their plain
# twins: bit for bit. Both int32 sums are exact, every blend is one fp32
# sum of two exact bf16 products, and every other step is an `_rn`
# intrinsic at the plain twin's rounding point (no FMA contraction), so no
# output may differ. B19 is also held, bit for bit, against the same
# function through the dense bf16 interp operators of `ops.resize` (fp32
# products, TF32 off), which does not read the kernel's tap tables.
DECODER_RTOL, DECODER_ATOL = 0.0, 0.0
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
# The kernels that no model path of the reference runs: B9, B17 and B20.
# The probe path (phase 6) launches them, and exactly them; every other
# kernel must run on a serving path or the training path.
PROBE_KERNELS = {"flash_attention_ln_qkv_fused", "dense_residual",
                 "int8_matmul_sliced_scale"}


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


def check_close(name, got, ref, rtol, atol, magnitude=None):
    """Elementwise |got - ref| <= atol + rtol * magnitude (default |ref|)."""
    torch.cuda.synchronize()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        fail(f"{name}: {tuple(got.shape)} {got.dtype} vs "
             f"{tuple(ref.shape)} {ref.dtype}")
    if not torch.isfinite(got.float()).all():
        fail(f"{name}: non-finite output")
    max_abs, max_rel = deviation(got, ref)
    bound = atol + rtol * (ref.float().abs() if magnitude is None
                           else magnitude)
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


def phase_device_and_build():
    from lseg_tpu_torch.ops._build import load_kernels, ptxas_summary

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
    results.update(_upsampled_head_kernels(dev, g))
    results.update(_fused_block_kernels(dev, g))
    results.update(_decoder_kernels(dev, g))
    results.update(_probe_path_kernels(dev, g))
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
        flash_attention_qkv_fused,
        flash_attention_qkv_fused_plain,
    )
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_fused,
        head1_correlate_fused_plain,
    )
    from lseg_tpu_torch.ops.ln_quant import (
        ln_quantize_rows,
        ln_quantize_rows_plain,
    )
    from lseg_tpu_torch.ops.quant import quantize_rows

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

    # B8 at (8, 901, 1024) and the padded (8, 904, 1024), valid_len 901:
    # the row codes and scales of a LayerNorm-1 output, B2's weights
    for t, vl in ((901, None), (904, 901)):
        x = torch.randn(8, t, d, device=dev, generator=g).to(torch.bfloat16)
        xq, sx = quantize_rows(x)
        args = (xq, sx, wq, sw, bias, 16, scale, vl)
        out = flash_attention_qkv_fused(*args)
        ref = flash_attention_qkv_fused_plain(*args)
        torch.cuda.synchronize()
        if out.shape != ref.shape or not torch.isfinite(out.float()).all():
            fail(f"flash_attention_qkv_fused: {tuple(out.shape)}, finite "
                 f"{bool(torch.isfinite(out.float()).all())}")
        err = float((out.float() - ref.float()).abs().max())
        rel = err / float(ref.float().abs().max())
        print(f"  flash_attention_qkv_fused (8,{t},1024) valid_len={vl}: "
              f"max_abs {err:.6g} = {rel:.4g} of max|plain| (tol "
              f"{LNQKV_REL:g})")
        if rel > LNQKV_REL:
            fail("flash_attention_qkv_fused: kernel disagrees with its "
                 "plain version")
        if vl is None:
            ms, plain_ms = _timed(
                "flash_attention_qkv_fused", "(8,901,1024) 16 heads",
                lambda: flash_attention_qkv_fused(*args),
                lambda: flash_attention_qkv_fused_plain(*args))
            # no single PyTorch call computes the int8 qkv product of the
            # codes together with the attention: library call none
            results["flash_attention_qkv_fused"] = result(
                err, ms, plain_ms, nbytes(xq, sx, wq, sw, bias, out),
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
    results["fused_correlate"] = result(
        err, ms, plain_ms, nbytes(emb, txt, logits),
        {"fp32": 2 * emb.numel() * 150}, lib_ms)
    # B10's compute_dtype=bfloat16 mode: bf16 operands on the tensor
    # cores, bf16 logits; fp32 pixels and a zero label at a ragged shape
    bf = torch.bfloat16
    x = torch.randn(2, 7, 9, 64, device=dev, generator=g)
    t = torch.randn(21, 64, device=dev, generator=g)
    t[0] = 0.0
    errs = []
    for name, a, b in (("(8,240,240,512) bf16 -> K=150", emb, txt),
                       ("(2,7,9,64) fp32 -> K=21", x, t)):
        ref = fused_correlate_plain(a, b, scale, bf)
        errs.append(check_close(
            f"fused_correlate {name}, compute bf16",
            fused_correlate(a, b, scale, bf), ref, CORR_BF16_RTOL,
            CORR_BF16_ATOL, _corr_bf16_magnitude(a, b, ref, scale)))
        del ref
    ms, plain_ms = _timed("fused_correlate", "(8,240,240,512) bf16 -> K=150, "
                          "compute bf16",
                          lambda: fused_correlate(emb, txt, scale, bf),
                          lambda: fused_correlate_plain(emb, txt, scale, bf))
    # the library call: one bf16 matmul of the normalised, rounded operands
    xn, tn_t = xn.to(bf), tn_t.to(bf)
    lib_ms = cuda_time_ms(lambda: torch.matmul(xn, tn_t))
    del xn
    results["fused_correlate"]["bf16"] = result(
        errs[0], ms, plain_ms, nbytes(emb, txt) + emb.numel() // 512 * 150 * 2,
        {"bf16": 2 * emb.numel() * 150}, lib_ms)

    # B11: the fp32 logits of B10, then bf16; all-negative logits, where a
    # K padding that leaked into the argmax would win
    neg = -(torch.rand(2, 60, 64, 150, device=dev, generator=g) + 0.5)
    cases = (("fp32", logits), ("bf16", logits.to(torch.bfloat16)),
             ("all-negative fp32", neg),
             ("all-negative bf16", neg.to(torch.bfloat16)))
    for name, lg in cases:
        equal = _labels_equal(
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
        equal = _labels_equal(
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
    equal = _labels_equal(
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


def _corr_bf16_magnitude(x, t, ref, scale):
    """|plain| plus scale * max_c |xn| * max_c |tn| for each (pixel, label):
    the magnitude of one bf16 ulp of the logit and of one operand's bf16
    rounding (CORR_BF16_RTOL)."""
    xm = torch.nn.functional.normalize(x.float(), dim=-1).abs().amax(
        -1, keepdim=True)
    tm = torch.nn.functional.normalize(t.float(), dim=-1).abs().amax(-1)
    return ref.float().abs() + scale * xm * tm


def _labels_equal(name, lab, ref, k):
    torch.cuda.synchronize()
    if lab.shape != ref.shape or lab.dtype != torch.int32:
        fail(f"{name}: {tuple(lab.shape)} {lab.dtype}")
    equal = _agree(lab, ref)
    lo, hi = int(lab.min()), int(lab.max())
    print(f"  {name}: labels equal {equal:.6f}, in [{lo}, {hi}]")
    if lo < 0 or hi >= k:
        fail(f"{name}: labels outside [0, {k})")
    return equal


def _upsampled_head_kernels(dev, g):
    """B14 and B13 at the flagship head shape, H/2 = 240."""
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_fused,
        head1_correlate_fused_plain,
        head1_correlate_upsample_argmax,
        head1_correlate_upsample_argmax_plain,
        head1_correlate_wup_fused,
        head1_correlate_wup_fused_plain,
        upsample_argmax_bf16,
        w_interp_bf16,
    )
    from lseg_tpu_torch.ops.resize import upsample2x

    results = {}
    n, h, w, c, e, k = 8, 240, 240, 256, 512, 150
    xq = torch.randint(-127, 128, (n, h, w, c), device=dev, generator=g,
                       dtype=torch.int8)
    w1q = torch.randint(-127, 128, (e, c), device=dev, generator=g,
                        dtype=torch.int8)
    s1 = 1e-3 * torch.rand(e, device=dev, generator=g) + 1e-4
    b1 = 0.1 * torch.randn(e, device=dev, generator=g)
    txt = torch.randn(k, e, device=dev, generator=g)
    sx = torch.tensor(0.02, device=dev)
    args = (xq, sx, w1q, s1, b1, txt, 1.0 / 0.07)
    m = n * h * w
    head_ops = {"int8": 2 * m * c * e, "bf16": 2 * m * e * k}

    # B14: two ulps of the blended magnitudes + 1e-3 against the plain
    # twin; bit for bit against the W-interp of B4's logits
    out = head1_correlate_wup_fused(*args)
    lo = head1_correlate_fused(*args, True)
    env = w_interp_bf16(head1_correlate_fused_plain(*args, True).abs())
    err = check_close(f"head1_correlate_wup_fused {(n, h, w, c)}->K={k}",
                      out, head1_correlate_wup_fused_plain(*args),
                      WUP_RTOL, HEAD1_ATOL, env.float())
    del env
    same = torch.equal(out, w_interp_bf16(lo))
    print(f"  head1_correlate_wup_fused equals the W-interp of B4's logits "
          f"bit for bit: {same}")
    if not same:
        fail("head1_correlate_wup_fused: differs from the W-interp of B4's "
             "logits")
    ms, plain_ms = _timed("head1_correlate_wup_fused",
                          f"{(n, h, w, c)}->(8,240,480,150)",
                          lambda: head1_correlate_wup_fused(*args),
                          lambda: head1_correlate_wup_fused_plain(*args))
    # no single PyTorch call computes head1, the correlation and the
    # W-interp: library call none. fp32 work: the squared norm (2 per
    # element of e) and the blend (3 per output)
    results["head1_correlate_wup_fused"] = result(
        err, ms, plain_ms, nbytes(xq, w1q, s1, b1, txt, out),
        {**head_ops, "fp32": 2 * m * e + 3 * out.numel()})
    del out

    # B13: labels >= 0.999 equal; printed: agreement with the composition
    # B4 (normalize) -> x2 upsample in bf16 -> argmax
    lab = head1_correlate_upsample_argmax(*args)
    ref = head1_correlate_upsample_argmax_plain(*args)
    equal = _labels_equal(
        f"head1_correlate_upsample_argmax {(n, h, w, c)}->K={k}", lab, ref, k)
    if equal < HEAD_ARGMAX_MIN_EQUAL:
        fail("head1_correlate_upsample_argmax: kernel disagrees with its "
             "plain version")
    tail = _labels_equal("head1_correlate_upsample_argmax vs the plain "
                         "tail of B4's logits", lab,
                         upsample_argmax_bf16(lo), k)
    if tail < UPARGMAX_MIN_EQUAL:
        fail("head1_correlate_upsample_argmax: differs from the plain tail "
             "of B4's logits")
    comp = torch.argmax(upsample2x(lo, compute_dtype=torch.bfloat16).float(),
                        dim=-1).to(torch.int32)
    print(f"  head1_correlate_upsample_argmax vs B4 -> upsample2x bf16 -> "
          f"argmax: {_agree(lab, comp):.6f} (blend order differs, not "
          f"gated)")
    del comp, lo
    # every logit negative (embeddings below zero, text rows above), K =
    # 13: a padded label would win with its logit 0. The logits of all
    # pixels are then close, so near ties are many: gated bit for bit
    # against the plain tail of B4's logits, the plain twin printed
    neg_args = (xq[:1, :16, :16].contiguous(), sx, w1q,
                1e-4 * torch.ones(e, device=dev), -2.0 - 100 * s1,
                torch.rand(13, e, device=dev, generator=g) + 0.1, 1.0 / 0.07)
    neg = head1_correlate_upsample_argmax(*neg_args)
    lo_neg = head1_correlate_fused(*neg_args, True)
    if not bool((lo_neg < 0).all()):
        fail("head1_correlate_upsample_argmax: the all-negative case has a "
             "logit >= 0")
    if _labels_equal("head1_correlate_upsample_argmax all-negative K=13 vs "
                     "the plain tail of B4's logits", neg,
                     upsample_argmax_bf16(lo_neg), 13) < UPARGMAX_MIN_EQUAL:
        fail("head1_correlate_upsample_argmax: all-negative logits "
             "disagree")
    print(f"    vs the plain twin "
          f"{_agree(neg, head1_correlate_upsample_argmax_plain(*neg_args)):.6f}"
          f" (near ties, not gated)")
    ms, plain_ms = _timed("head1_correlate_upsample_argmax",
                          f"{(n, h, w, c)}->(8,480,480)",
                          lambda: head1_correlate_upsample_argmax(*args),
                          lambda: head1_correlate_upsample_argmax_plain(*args))
    up = n * 2 * h * 2 * w * k
    # fp32 work: the squared norm, the H-blend (3 per blended value), the
    # W-interp (3 per output) and the argmax (1 per output); no single
    # PyTorch call computes it: library call none
    results["head1_correlate_upsample_argmax"] = result(
        1.0 - equal, ms, plain_ms, nbytes(xq, w1q, s1, b1, txt, lab),
        {**head_ops, "fp32": 2 * m * e + 3 * up // 2 + 4 * up})
    return results


def _residual_checks(name, fn, plain, make_args):
    """`fn` against `plain` with a zero residual (2e-2 of max|plain|: the
    fused work alone) and a real one (that plus one bf16 ulp of |plain|);
    returns the real-residual error and arguments."""
    for kind in ("zero", "real"):
        args = make_args(kind)
        got, ref = fn(*args), plain(*args)
        torch.cuda.synchronize()
        atol = LNQKV_REL * float(ref.float().abs().max())
        err = check_close(f"{name} {kind} residual", got, ref,
                          RESID_RTOL if kind == "real" else 0.0, atol)
    return err, args


def _fused_block_kernels(dev, g):
    """B16, B15 and B9 at the flagship (8, 901, 1024), 16 heads."""
    from lseg_tpu_torch.ops.flash_attention import (
        flash_attention_ln_qkv_fused,
        flash_attention_ln_qkv_fused_plain,
        flash_attention_qkvp_fused,
        flash_attention_qkvp_fused_plain,
    )
    from lseg_tpu_torch.ops.mlp import mlp_fused, mlp_fused_plain
    from lseg_tpu_torch.ops.quant import quantize_rows

    results = {}
    n, t, d, h, heads = 8, 901, 1024, 4096, 16
    m = n * t
    scale = 64 ** -0.5

    def codes(*shape):
        return torch.randint(-127, 128, shape, device=dev, generator=g,
                             dtype=torch.int8)

    def resid(kind):
        x = 2.0 * torch.randn(n, t, d, device=dev, generator=g)
        return (x if kind == "real" else 0.0 * x).to(torch.bfloat16)

    # the row codes of a LayerNorm output
    xq, sx = quantize_rows(torch.randn(n, t, d, device=dev, generator=g))

    # B16: int8 fc1 -> tanh GELU -> per-row requantize -> int8 fc2. Eight
    # outlier hidden channels of graded size, one in each eighth of H, as
    # transformer MLPs have them: they set each row's requantize scale, so
    # a scale taken over part of the row clips them
    w1, w2 = codes(h, d), codes(d, h)
    s1 = 2e-3 / d ** 0.5 * torch.rand(h, device=dev, generator=g)
    b1 = 0.5 * torch.randn(h, device=dev, generator=g)
    b1[h // 16::h // 8] += torch.arange(1.0, 9.0, device=dev)
    s2 = 2e-2 / h ** 0.5 * torch.rand(d, device=dev, generator=g)
    b2 = 0.05 * torch.randn(d, device=dev, generator=g)
    err, args = _residual_checks(
        "mlp_fused (8,901,1024) H=4096", mlp_fused, mlp_fused_plain,
        lambda kind: (xq, sx, resid(kind), w1, s1, b1, w2, s2, b2))
    ms, plain_ms = _timed("mlp_fused", "(8,901,1024) H=4096",
                          lambda: mlp_fused(*args),
                          lambda: mlp_fused_plain(*args))
    # two int8 products; fp32 per hidden value: dequant 3, GELU ~9
    # (tanh counted as one), amax 1, quantize 2. No single PyTorch call
    # computes the function: library call none
    results["mlp_fused"] = result(
        err, ms, plain_ms, nbytes(*args) + m * d * 2,
        {"int8": 2 * 2 * m * d * h, "fp32": 15 * m * h})
    del w1, w2, args

    # B15: int8 qkv -> attention -> per-(row, pair) requantize -> int8
    # proj summed pair by pair -> bias -> residual
    wq, wp = codes(3 * d, d), codes(d, d)
    sw = 1e-3 * torch.rand(3 * d, device=dev, generator=g)
    bias = 0.05 * torch.randn(3 * d, device=dev, generator=g)
    sp = 2e-2 / d ** 0.5 * torch.rand(d, device=dev, generator=g)
    bp = 0.05 * torch.randn(d, device=dev, generator=g)
    err, args = _residual_checks(
        "flash_attention_qkvp_fused (8,901,1024) 16 heads",
        flash_attention_qkvp_fused, flash_attention_qkvp_fused_plain,
        lambda kind: (xq, sx, wq, sw, bias, wp, sp, bp, resid(kind), heads,
                      scale))
    ms, plain_ms = _timed("flash_attention_qkvp_fused",
                          "(8,901,1024) 16 heads",
                          lambda: flash_attention_qkvp_fused(*args),
                          lambda: flash_attention_qkvp_fused_plain(*args))
    # no single PyTorch call computes it: library call none
    results["flash_attention_qkvp_fused"] = result(
        err, ms, plain_ms, nbytes(*args[:9]) + m * d * 2,
        {"int8": 2 * m * d * 3 * d + 2 * m * d * d,
         "bf16": 4 * n * heads * t * t * 64})

    # B9: LN + row quantize + int8 qkv + attention, bf16 out
    x = torch.randn(n, t, d, device=dev, generator=g).to(torch.bfloat16)
    ln_g = 1.0 + 0.1 * torch.randn(d, device=dev, generator=g)
    ln_b = 0.1 * torch.randn(d, device=dev, generator=g)
    args = (x, ln_g, ln_b, wq, sw, bias, heads, scale)
    out = flash_attention_ln_qkv_fused(*args)
    ref = flash_attention_ln_qkv_fused_plain(*args)
    err = check_close("flash_attention_ln_qkv_fused (8,901,1024) 16 heads",
                      out, ref, 0.0,
                      LNQKV_REL * float(ref.float().abs().max()))
    ms, plain_ms = _timed("flash_attention_ln_qkv_fused",
                          "(8,901,1024) 16 heads",
                          lambda: flash_attention_ln_qkv_fused(*args),
                          lambda: flash_attention_ln_qkv_fused_plain(*args))
    # no single PyTorch call computes it: library call none; fp32 work of
    # the LN and quantize ~8 operations per element, as B3's row
    results["flash_attention_ln_qkv_fused"] = result(
        err, ms, plain_ms, nbytes(*args[:6], out),
        {"int8": 2 * m * d * 3 * d, "bf16": 4 * n * heads * t * t * 64,
         "fp32": 8 * m * d})
    return results


def _rcu_operands(dev, g, c):
    """B18's operands: int8 (C, 9C) kernels and the BatchNorm folded with
    the dequant scales, whose positive shift makes conv1 of the zero-padded
    border non-zero, so conv2's edge padding counts."""
    from lseg_tpu_torch.ops.qconv import fold_bn_affine

    ops = []
    for a in (4.0, 16.0):
        wq = torch.randint(-127, 128, (c, 9 * c), device=dev, generator=g,
                           dtype=torch.int8)
        sw = 2e-3 * torch.rand(c, device=dev, generator=g) + 1e-4
        bn = (torch.rand(c, device=dev, generator=g) + 0.5,
              0.5 * torch.rand(c, device=dev, generator=g) + 0.1,
              0.1 * torch.randn(c, device=dev, generator=g),
              torch.rand(c, device=dev, generator=g) + 0.5)
        act = torch.tensor(a, device=dev)
        d, e = fold_bn_affine(act / 127.0, sw, *bn)
        ops += [wq, d, e, 127.0 / act]
    return ops


def _tail_dense(x, wq, sw, b, s_in, out_scale=None):
    """B19's function through the dense bf16 x2 interp operators of
    `ops.resize` (fp32 products of bf16 values, TF32 off: each output is
    one exact product pair summed and rounded once), independent of
    `ops.decoder.interp_taps`."""
    from lseg_tpu_torch.ops.quant import int8_mm
    from lseg_tpu_torch.ops.resize import interp_matrix

    n, h, w, c = x.shape
    ah = interp_matrix(h, 2 * h, True, torch.bfloat16, x.device).float()
    aw = interp_matrix(w, 2 * w, True, torch.bfloat16, x.device).float()
    hb = torch.einsum("oh,nhwc->nowc", ah, x.float()).to(torch.bfloat16)
    ub = torch.einsum("ow,nhwc->nhoc", aw, hb.float()).to(torch.bfloat16)
    del hb
    q = torch.clamp(torch.round(ub.float() * (1.0 / s_in)), -127, 127
                    ).to(torch.int8)
    y = int8_mm(q.reshape(-1, c), wq).float() * (s_in * sw) + b
    y = y.reshape(n, 2 * h, 2 * w, -1)
    if out_scale is None:
        return y.to(torch.bfloat16)
    return torch.clamp(torch.round(y * (1.0 / out_scale)), -127, 127
                       ).to(torch.int8)


def _decoder_kernels(dev, g):
    """B18 at refinenet1's (8, 120, 120, 256) and refinenet4's odd
    (8, 15, 15, 256); B19 at refinenet2's (8, 60, 60, 256) with bf16 out
    and at refinenet1's hand-off (8, 120, 120, 256) with int8 out."""
    from lseg_tpu_torch.ops.decoder import (
        fused_upsample_outconv,
        fused_upsample_outconv_plain,
    )
    from lseg_tpu_torch.ops.qconv import fused_rcu, fused_rcu_plain

    results = {}
    c = 256
    ops = _rcu_operands(dev, g, c)
    for shape in ((8, 120, 120, c), (8, 15, 15, c)):
        x = (torch.randn(shape, device=dev, generator=g)
             * (1.0 + torch.arange(c, device=dev) / c)).to(torch.bfloat16)
        out = fused_rcu(x, *ops)
        ref = fused_rcu_plain(x, *ops)
        err = check_close(f"fused_rcu {shape}", out, ref, DECODER_RTOL,
                          DECODER_ATOL)
        # the input makes conv2's edge padding count: conv1 of the
        # zero-padded border (the twin on the padded image, cropped) moves
        # outputs on the outermost ring
        wrong = fused_rcu_plain(torch.nn.functional.pad(
            x, (0, 0, 1, 1, 1, 1)), *ops)[:, 1:-1, 1:-1]
        ring = (out != wrong).any(dim=-1)
        n_ring = int(ring.sum())
        inner = int(ring[:, 1:-1, 1:-1].sum())
        print(f"    conv1 of the padded border instead of conv2's zero "
              f"padding would move {n_ring} pixels, {inner} inside the "
              f"outermost ring")
        if n_ring == 0 or inner:
            fail("fused_rcu: the check input does not isolate conv2's edge "
                 "padding")
        del wrong, ring, ref
        if shape[1] == 120:
            ms, plain_ms = _timed("fused_rcu", f"{shape}",
                                  lambda: fused_rcu(x, *ops),
                                  lambda: fused_rcu_plain(x, *ops))
            px = x.numel() // c
            # two 3x3 int8 convolutions; fp32 per element: quantize 3,
            # affine + relu 3, requantize 2, affine 2, residual 1. No
            # single PyTorch call computes the unit: library call none
            results["fused_rcu"] = result(
                err, ms, plain_ms, nbytes(x, out, *ops),
                {"int8": 2 * 2 * 9 * c * c * px, "fp32": 11 * px * c})
        del x, out

    wq = torch.randint(-127, 128, (c, c), device=dev, generator=g,
                       dtype=torch.int8)
    sw = 0.01 * torch.rand(c, device=dev, generator=g) + 1e-3
    b = 0.1 * torch.randn(c, device=dev, generator=g)
    for shape, out_scale in (((8, 60, 60, c), None),
                             ((8, 120, 120, c), torch.tensor(0.05,
                                                             device=dev))):
        x = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
        s_in = x.float().abs().amax() / 127.0
        args = (x, wq, sw, b, s_in, out_scale)
        kind = "bf16" if out_scale is None else "int8"
        out = fused_upsample_outconv(*args)
        err = check_close(f"fused_upsample_outconv {shape} -> {kind}", out,
                          fused_upsample_outconv_plain(*args),
                          DECODER_RTOL, DECODER_ATOL)
        check_close(f"fused_upsample_outconv {shape} -> {kind} vs the dense "
                    f"interp operators", out, _tail_dense(*args),
                    DECODER_RTOL, DECODER_ATOL)
        ms, plain_ms = _timed("fused_upsample_outconv", f"{shape} -> {kind}",
                              lambda: fused_upsample_outconv(*args),
                              lambda: fused_upsample_outconv_plain(*args))
        up = out.numel()
        # the 1x1 int8 product; fp32 per upsampled value: two H-blends and
        # the W-blend (3 each), quantize 2, epilogue 2 (+ 2 for int8). No
        # single PyTorch call computes it: library call none
        res = result(err, ms, plain_ms, nbytes(x, wq, sw, b, out),
                     {"int8": 2 * up * c, "fp32": 13 * up})
        if out_scale is None:
            results["fused_upsample_outconv"] = res
        del x, out
    return results


def _probe_path_kernels(dev, g):
    """B17 at ViT-L/16's fc2 and proj shapes (bf16) and at the reference
    test's fp32 shape, with and without a residual; B20 at the reference
    probe's shape in both scale block shapes."""
    from lseg_tpu_torch import probe
    from lseg_tpu_torch.ops.dense import (
        dense_residual,
        dense_residual_plain,
    )
    from lseg_tpu_torch.ops.scaled_int8 import (
        int8_matmul_sliced_scale,
        int8_matmul_sliced_scale_plain,
    )

    results = {}
    bf, f32 = torch.bfloat16, torch.float32
    cases = (("fc2", (7208, 4096, 1024), bf, bf),
             ("fc2", (7208, 4096, 1024), bf, None),
             ("proj", (7208, 1024, 1024), bf, bf),
             ("proj", (7208, 1024, 1024), bf, None),
             ("reference test", (70, 128, 96), f32, f32),
             ("reference test", (70, 128, 96), f32, None))
    for name, shape, dt, resid in cases:
        args = probe.dense_inputs(dev, g, *shape, dtype=dt, residual=resid)
        tol = ((probe.DENSE_RTOL, probe.DENSE_ATOL) if dt == bf else
               (probe.DENSE_FP32_RTOL, probe.DENSE_FP32_ATOL))
        out = dense_residual(*args, out_dtype=dt)
        err = check_close(
            f"dense_residual {name} {shape} {dt} residual {resid}", out,
            dense_residual_plain(*args, out_dtype=dt), *tol)
        if name != "fc2" or resid is None:
            continue
        ms, plain_ms = _timed("dense_residual", "fc2 (7208,4096).(4096,1024) "
                              "bf16 + bf16 residual",
                              lambda: dense_residual(*args),
                              lambda: dense_residual_plain(*args))
        # the library call: addmm with the residual plus the broadcast bias
        # as its input, that sum made outside the timed region
        x, w, b, r = args
        c = (r.float() + b).to(bf)
        lib_ms = cuda_time_ms(lambda: torch.addmm(c, x, w))
        m, k = x.shape
        results["dense_residual"] = result(
            err, ms, plain_ms, nbytes(x, w, b, r, out),
            {"bf16": 2 * m * k * w.shape[1]}, lib_ms)
        del c
    del args, out

    for variant in ("sliced", "rows"):
        args = probe.b20_inputs(variant, dev, g)
        out = int8_matmul_sliced_scale(*args)
        err = check_close(f"int8_matmul_sliced_scale (2,904,1024) scales "
                          f"{tuple(args[2].shape)}", out,
                          int8_matmul_sliced_scale_plain(*args),
                          probe.B20_RTOL, probe.B20_ATOL)
    ms, plain_ms = _timed("int8_matmul_sliced_scale",
                          "(2,904,1024).(1024,128)",
                          lambda: int8_matmul_sliced_scale(*args),
                          lambda: int8_matmul_sliced_scale_plain(*args))
    # the int8 product; fp32 per output: three products and three sums. No
    # single PyTorch call computes it: library call none
    m = args[0].numel() // 1024
    results["int8_matmul_sliced_scale"] = result(
        err, ms, plain_ms, nbytes(*args, out),
        {"int8": 2 * m * 1024 * 128, "fp32": 6 * m * 128})
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
        flash_attention_ln_qkv_fused,
        flash_attention_ln_qkv_fused_q8,
        flash_attention_qkv_fused,
        flash_attention_qkvp_fused,
    )
    from lseg_tpu_torch.ops.decoder import fused_upsample_outconv
    from lseg_tpu_torch.ops.dense import dense_residual
    from lseg_tpu_torch.ops.fused_correlate import fused_correlate
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_argmax_fused,
        head1_correlate_fused,
        head1_correlate_upsample_argmax,
        head1_correlate_wup_fused,
    )
    from lseg_tpu_torch.ops.ln_quant import ln_quantize_rows
    from lseg_tpu_torch.ops.mlp import mlp_fused
    from lseg_tpu_torch.ops.patch_embed import patch_embed
    from lseg_tpu_torch.ops.qconv import fused_rcu
    from lseg_tpu_torch.ops.scaled_int8 import int8_matmul_sliced_scale
    from lseg_tpu_torch.ops.upsample_argmax import upsample2x_argmax

    return {"patch_embed": patch_embed,
            "flash_attention_flat": flash_attention_flat,
            "flash_attention_flat_bwd": flash_attention_flat_bwd,
            "ln_quantize_rows": ln_quantize_rows,
            "flash_attention_ln_qkv_fused_q8": flash_attention_ln_qkv_fused_q8,
            "head1_correlate_fused": head1_correlate_fused,
            "fused_correlate": fused_correlate,
            "upsample2x_argmax": upsample2x_argmax,
            "head1_correlate_argmax_fused": head1_correlate_argmax_fused,
            "flash_attention_qkv_fused": flash_attention_qkv_fused,
            "head1_correlate_wup_fused": head1_correlate_wup_fused,
            "head1_correlate_upsample_argmax":
                head1_correlate_upsample_argmax,
            "mlp_fused": mlp_fused,
            "flash_attention_qkvp_fused": flash_attention_qkvp_fused,
            "flash_attention_ln_qkv_fused": flash_attention_ln_qkv_fused,
            "fused_rcu": fused_rcu,
            "fused_upsample_outconv": fused_upsample_outconv,
            "dense_residual": dense_residual,
            "int8_matmul_sliced_scale": int8_matmul_sliced_scale}


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
    ref32 = random_init_(LSegNet(ref_cfg, torch.float32, dev), g).eval()
    model, plain = _quantized(cfg, dev, ref32, g)

    blocks = vit.hooks[-1] + 1
    _, launches = _serve_requests(
        "int8", _argmax_call(model), requests, cache, _kernel_counters(),
        {"patch_embed": 1, "ln_quantize_rows": blocks,
         "flash_attention_ln_qkv_fused_q8": blocks,
         "head1_correlate_fused": 1})

    _int8_logits_gate("int8 half-res", model, plain, ref32, requests[1],
                      cache, return_halfres=True)
    return model, plain, ref32, launches


def _int8_logits_gate(tag, model, plain, ref32, request, cache, **kw):
    """Logits of `model(images, txt, **kw)` on the kernel path vs the plain
    path vs the fp32 model: d_kernel <= 2 d_ref + floor."""
    _, labels, images = request
    txt = cache(labels)
    with torch.inference_mode():
        lk = model(images, txt, **kw).float()
        lp = plain(images, txt, **kw).float()
        lr = ref32(images, txt, **kw).float()
    for name, t in (("kernel", lk), ("plain", lp), ("fp32", lr)):
        if not torch.isfinite(t).all():
            fail(f"{tag} logits of the {name} path are not finite")
    d_kernel = float((lk - lp).abs().max())
    d_ref = float((lp - lr).abs().max())
    agree = _agree(lk.argmax(-1), lp.argmax(-1))
    agree_ref = _agree(lp.argmax(-1), lr.argmax(-1))
    print(f"  {tag} logits {tuple(lk.shape)}: |kernel - plain| max "
          f"{d_kernel:.6g}, |plain int8 - fp32| max {d_ref:.6g}, max "
          f"|logit| {float(lr.abs().max()):.4g}; label agreement kernel vs "
          f"plain {agree:.4f}, plain vs fp32 {agree_ref:.4f} (not gated)")
    if d_kernel > SERVE_RATIO * d_ref + SERVE_FLOOR:
        fail(f"{tag}: kernel path deviates {d_kernel} > {SERVE_RATIO} * "
             f"{d_ref} + {SERVE_FLOOR}")


def _quantized(cfg, dev, ref32, g, mlp_act_scale=True):
    """`cfg`'s int8 model from the fp32 model's weights (`quantize_tree`),
    calibrated on one seeded batch of 8 without text, as the reference's
    bench.py does; and its plain twin."""
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.quant import calibrate_act_scales, quantize_tree

    t0 = time.perf_counter()
    state = quantize_tree(ref32.state_dict(), decoder=True, act_scale=True,
                          mlp_act_scale=mlp_act_scale)
    model = LSegNet(cfg, torch.bfloat16, dev).eval()
    model.load_state_dict(state)
    del state
    calibrate_act_scales(model, _images(g, dev, 8, 480, 480), None)
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
    return model, plain


def phase_serving_flashq(dev, ref32, cache, requests):
    from lseg_tpu_torch import fast_serving, get_config

    print("[3e] serving bench.py's fast_flashq rung: fast_serving("
          "clip_vitl16_384, 'static_cal') with attn flashq, no LN-fused "
          "kernels, no MLP-hidden calibration; kernel B8")
    base = fast_serving(get_config("clip_vitl16_384"), "static_cal")
    cfg = dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, attn_impl="flashq", ln_quant_fused=False,
        mlp_act_cal=False))
    vit = cfg.vit
    print(f"  attn {vit.attn_impl}, ln_quant_fused {vit.ln_quant_fused}, "
          f"mlp_act_cal {vit.mlp_act_cal}; head_fused {cfg.head_fused}")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    model, plain = _quantized(cfg, dev, ref32, g, mlp_act_scale=False)
    if any(k.startswith("vit.") and k.endswith("act_scale")
           for k in model.state_dict()):
        fail("fast_flashq: the ViT has a calibrated site")
    blocks = vit.hooks[-1] + 1
    _, launches = _serve_requests(
        "flashq", _argmax_call(model), requests, cache, _kernel_counters(),
        {"patch_embed": 1, "flash_attention_qkv_fused": blocks,
         "head1_correlate_fused": 1})
    _int8_logits_gate("fast_flashq half-res", model, plain, ref32,
                      requests[1], cache, return_halfres=True)
    return model, plain, launches


def phase_serving_fused_block(dev, ref32, cache, requests):
    from lseg_tpu_torch import fast_serving, get_config

    print("[3g] the fused int8 block: fast_serving(clip_vitl16_384, "
          "'static_cal') with attn flashqp and mlp_fused, no MLP-hidden "
          "calibration; kernels B15 + B16")
    base = fast_serving(get_config("clip_vitl16_384"), "static_cal")
    cfg = dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, attn_impl="flashqp", mlp_fused=True, mlp_act_cal=False))
    vit = cfg.vit
    print(f"  attn {vit.attn_impl}, mlp_fused {vit.mlp_fused}, mlp_gelu "
          f"{vit.mlp_gelu}, ln_quant_fused {vit.ln_quant_fused}, mlp_act_cal "
          f"{vit.mlp_act_cal}; head_fused {cfg.head_fused}")
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    model, plain = _quantized(cfg, dev, ref32, g, mlp_act_scale=False)
    if any(k.startswith("vit.") and k.endswith("act_scale")
           for k in model.state_dict()):
        fail("fused block: the ViT has a calibrated site")
    blocks = vit.hooks[-1] + 1
    _, launches = _serve_requests(
        "fused block", _argmax_call(model), requests, cache,
        _kernel_counters(),
        {"patch_embed": 1, "flash_attention_qkvp_fused": blocks,
         "mlp_fused": blocks, "head1_correlate_fused": 1})
    _int8_logits_gate("fused block half-res", model, plain, ref32,
                      requests[1], cache, return_halfres=True)
    return model, plain, launches


FUSED_DECODER = {"decoder_fused_rcu": True, "decoder_fused_tail": True}


def phase_serving_fused_decoder(dev, model_q, ref32, cache, requests):
    from lseg_tpu_torch.models.lseg import LSegNet

    print("[3h] the fused int8 decoder: the static_cal tree with "
          "decoder_fused_rcu and decoder_fused_tail, model(x, txt, "
          "return_argmax=True); kernels B18 + B19")
    cfg = dataclasses.replace(model_q.cfg, **FUSED_DECODER)
    print(f"  head_fused {cfg.head_fused}, decoder_conv_first "
          f"{cfg.decoder_conv_first}, decoder_fused_rcu "
          f"{cfg.decoder_fused_rcu}, decoder_fused_tail "
          f"{cfg.decoder_fused_tail}")
    model = LSegNet(cfg, torch.bfloat16, dev).eval()
    model.load_state_dict(model_q.state_dict())
    plain = LSegNet(cfg, torch.bfloat16, dev, plain=True).eval()
    plain.load_state_dict(model_q.state_dict())
    blocks = cfg.vit.hooks[-1] + 1
    preds, launches = _serve_requests(
        "fused decoder", _argmax_call(model), requests, cache,
        _kernel_counters(),
        {"patch_embed": 1, "ln_quantize_rows": blocks,
         "flash_attention_ln_qkv_fused_q8": blocks, "fused_rcu": 7,
         "fused_upsample_outconv": 1, "head1_correlate_fused": 1})
    for (name, labels, images), pred in zip(requests, preds):
        unfused = _argmax_call(model_q)(images, cache(labels))
        print(f"  {name}: labels vs phase 3b's unfused decoder "
              f"{_agree(pred, unfused):.4f} (not gated)")
    _int8_logits_gate("fused decoder half-res", model, plain, ref32,
                      requests[1], cache, return_halfres=True)
    return model, plain, launches


def phase_serving_handoff(dev, ref32, cache, requests):
    from lseg_tpu_torch import fast_serving, get_config
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_argmax_fused_plain,
    )

    print("[3i] refinenet1's int8 hand-off: the fused decoder with "
          "head_fused=True and no decoder_conv_first; kernels B18 + B19, "
          "B19's int8 codes into B5")
    base = fast_serving(get_config("clip_vitl16_384"), "static_cal")
    cfg = dataclasses.replace(base, head_fused=True, decoder_conv_first=False,
                              **FUSED_DECODER)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    model, plain = _quantized(cfg, dev, ref32, g)
    blocks = cfg.vit.hooks[-1] + 1
    counters = _kernel_counters()
    seen = []
    hook = model.refinenet1.register_forward_hook(
        lambda mod, args, out: seen.append(out))
    try:
        preds, launches = _serve_requests(
            "int8 hand-off", _argmax_call(model), requests, cache, counters,
            {"patch_embed": 1, "ln_quantize_rows": blocks,
             "flash_attention_ln_qkv_fused_q8": blocks, "fused_rcu": 7,
             "fused_upsample_outconv": 2, "head1_correlate_argmax_fused": 1})
    finally:
        hook.remove()
    h1 = model.head1
    for (name, labels, images), pred, path1 in zip(requests, preds, seen):
        n, h, w, _ = images.shape
        if path1.dtype != torch.int8 or path1.shape != (n, h // 2, w // 2,
                                                        cfg.features):
            fail(f"int8 hand-off {name}: path1 {tuple(path1.shape)} "
                 f"{path1.dtype}, expected int8 codes at H/2")
        with torch.inference_mode():
            twin = head1_correlate_argmax_fused_plain(
                path1, h1.act_scale / 127.0, h1.weight_q, h1.scale, h1.bias,
                cache(labels))
        head_eq = _agree(pred[:, ::2, ::2], twin)
        print(f"  {name}: path1 int8 {tuple(path1.shape)}; labels vs B5's "
              f"plain twin on the same codes {head_eq:.6f} (gate >= "
              f"{HEAD_SERVE_MIN_EQUAL}); vs the whole plain path "
              f"{_agree(pred, _argmax_call(plain)(images, cache(labels))):.4f}"
              f" (not gated)")
        if head_eq < HEAD_SERVE_MIN_EQUAL:
            fail(f"int8 hand-off {name}: labels disagree with B5's plain "
                 f"twin")
    del seen
    # the logits call: B4 on the same int8 path1
    before = {k: counters[k].launches for k in (
        "head1_correlate_fused", "fused_upsample_outconv")}
    _int8_logits_gate("int8 hand-off half-res", model, plain, ref32,
                      requests[1], cache, return_halfres=True)
    got = {k: counters[k].launches - v for k, v in before.items()}
    print(f"  half-res logits call launches {got}")
    if got != {"head1_correlate_fused": 1, "fused_upsample_outconv": 2}:
        fail(f"int8 hand-off half-res: launches {got}")
    return model, plain, launches


def _logits_call(model):
    """(images, txt) -> (N, H, W, K) fp32 logits through `model(x, txt)`,
    the call of `make_logits_fn` and the TTA evaluator."""
    def call(images, txt):
        with torch.inference_mode():
            return model(images, txt)
    return call


def phase_serving_wup(dev, model_q, ref32, cache, requests):
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_upsample_argmax,
        head1_correlate_upsample_argmax_plain,
    )

    print("[3f] the 'wup' logits head: the static_cal tree with "
          "head_fused='wup', model(x, txt), kernel B14; kernel B13 on the "
          "served path1")
    cfg = dataclasses.replace(model_q.cfg, head_fused="wup")
    model = LSegNet(cfg, torch.bfloat16, dev).eval()
    model.load_state_dict(model_q.state_dict())
    plain = LSegNet(cfg, torch.bfloat16, dev, plain=True).eval()
    plain.load_state_dict(model_q.state_dict())
    h1 = model.head1
    served = []

    def call(images, txt):
        """The logits, then B13's labels of the same path1: the request's
        answer is B13's label map."""
        seen = {}
        hook = model.refinenet1.register_forward_hook(
            lambda mod, args, out: seen.__setitem__("path1", out))
        try:
            logits = _logits_call(model)(images, txt)
        finally:
            hook.remove()
        with torch.inference_mode():
            xq, sx = model._head1_codes(seen["path1"])
            labels = head1_correlate_upsample_argmax(
                xq.contiguous(), sx, h1.weight_q, h1.scale, h1.bias, txt,
                cfg.logit_scale)
        served.append((logits, xq, sx))
        return labels

    blocks = cfg.vit.hooks[-1] + 1
    preds, launches = _serve_requests(
        "wup", call, requests, cache, _kernel_counters(),
        {"patch_embed": 1, "ln_quantize_rows": blocks,
         "flash_attention_ln_qkv_fused_q8": blocks,
         "head1_correlate_wup_fused": 1,
         "head1_correlate_upsample_argmax": 1})
    for (name, labels, images), pred, (logits, xq, sx) in zip(
            requests, preds, served):
        txt = cache(labels)
        n, h, w, _ = images.shape
        if (logits.shape != (n, h, w, len(labels))
                or logits.dtype != torch.float32
                or not torch.isfinite(logits).all()):
            fail(f"wup {name}: logits {tuple(logits.shape)} {logits.dtype}")
        with torch.inference_mode():
            twin = head1_correlate_upsample_argmax_plain(
                xq.contiguous(), sx, h1.weight_q, h1.scale, h1.bias, txt,
                cfg.logit_scale)
        head_eq = _agree(pred, twin)
        print(f"  {name}: logits {tuple(logits.shape)} fp32; B13 labels vs "
              f"its plain twin on the same codes {head_eq:.6f} (gate >= "
              f"{HEAD_SERVE_MIN_EQUAL}); vs the argmax of the 'wup' logits "
              f"{_agree(pred, logits.argmax(-1)):.4f} (not gated)")
        if head_eq < HEAD_SERVE_MIN_EQUAL:
            fail(f"wup {name}: B13 labels disagree with its plain twin")
    del served
    _int8_logits_gate("'wup' full-resolution", model, plain, ref32,
                      requests[0], cache)
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
    return peak - resident


def phase_numbers(dev, plain, predict, cache, ade, model_q, plain_q,
                  streamed, model_hf, plain_hf, model_fq, plain_fq,
                  model_wup, plain_wup, model_fb, plain_fb, decoder_paths):
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
    _measure("fused block kernel path",
             lambda: _argmax_call(model_fb)(images, txt))
    _measure("fused block plain path",
             lambda: _argmax_call(plain_fb)(images, txt))
    for name, m in decoder_paths.items():
        _measure(name, lambda: _argmax_call(m)(images, txt))
    _measure("streamed head (use_pallas) kernel path",
             lambda: streamed[0](images, txt))
    _measure("streamed head (use_pallas) plain path",
             lambda: streamed[1](images, txt))
    _measure("static_cal head_fused=True kernel path",
             lambda: _argmax_call(model_hf)(images, txt))
    _measure("static_cal head_fused=True plain path",
             lambda: _argmax_call(plain_hf)(images, txt))
    _measure("fast_flashq kernel path",
             lambda: _argmax_call(model_fq)(images, txt))
    _measure("fast_flashq plain path",
             lambda: _argmax_call(plain_fq)(images, txt))
    out_gib = 8 * 480 * 480 * len(ade) * 4 / 2**30
    for name, m in (("kernel", model_wup), ("plain", plain_wup)):
        inc = _measure(f"static_cal head_fused='wup' logits call, {name} "
                       f"path", lambda: _logits_call(m)(images, txt))
        print(f"    increment over resident {inc / 2**30:.3f} GiB, of which "
              f"the fp32 (8,480,480,{len(ade)}) output is {out_gib:.3f} GiB")


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


def phase_probe(dev):
    """The probe path: `lseg_tpu_torch.probe`'s cases in process, each
    kernel once against its plain twin, with the launch counters set to 0
    just before and read just after; B20's source also compiled alone
    through the probe's `--sources` step."""
    from lseg_tpu_torch import probe

    print("[6] probe path: the kernels no model path runs")
    if probe.probe_sources([probe.B20_SOURCE]):
        fail(f"probe: {probe.B20_SOURCE} does not compile alone")
    counters = _kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    for case in probe.CASES:
        if not probe.run_case(case, dev)["ok"]:
            fail(f"probe {case}: kernel disagrees with its plain twin")
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"  probe path launches: "
          f"{ {k: v for k, v in launches.items() if v} }")
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
    model_q, plain_q, ref32, launches_q = phase_serving_int8(dev, cache,
                                                            requests)
    model_hf, plain_hf, launches_hf = phase_serving_head_fused(
        dev, model_q, cache, requests)
    model_fq, plain_fq, launches_fq = phase_serving_flashq(dev, ref32, cache,
                                                           requests)
    model_w, plain_w, launches_w = phase_serving_wup(dev, model_q, ref32,
                                                     cache, requests)
    model_fb, plain_fb, launches_fb = phase_serving_fused_block(
        dev, ref32, cache, requests)
    model_fd, plain_fd, launches_fd = phase_serving_fused_decoder(
        dev, model_q, ref32, cache, requests)
    model_ho, plain_ho, launches_ho = phase_serving_handoff(dev, ref32, cache,
                                                            requests)
    del ref32
    gc.collect()
    torch.cuda.empty_cache()
    decoder_paths = {"fused decoder kernel path": model_fd,
                     "fused decoder plain path": plain_fd,
                     "int8 hand-off kernel path": model_ho,
                     "int8 hand-off plain path": plain_ho}
    phase_numbers(dev, plain, predict, cache, ade, model_q, plain_q,
                  streamed, model_hf, plain_hf, model_fq, plain_fq, model_w,
                  plain_w, model_fb, plain_fb, decoder_paths)
    del model, plain, predict, streamed, model_q, plain_q, model_hf, plain_hf
    del model_fq, plain_fq, model_w, plain_w, model_fb, plain_fb
    del model_fd, plain_fd, model_ho, plain_ho, decoder_paths
    gc.collect()
    torch.cuda.empty_cache()
    launches_t = phase_training(dev, cache, ade)
    launches_p = phase_probe(dev)
    # each kernel's launches on the path that runs it: B1 and B6 on the
    # bf16 path (phase 3), B10 and B11 on the streamed head (phase 3c),
    # B2, B3 and B4 on the int8 path (phase 3b, which also checked B1 per
    # request), B5 on the fused argmax head (phase 3d), B8 on the
    # fast_flashq path (phase 3e), B14 and B13 on the 'wup' head (phase 3f),
    # B15 and B16 on the fused block (phase 3g), B18 on the fused decoder
    # (phase 3h), B19 on the int8 hand-off (phase 3i, which also ran B18),
    # B7 on the training path (phase 5a, the first fit); B9, B17 and B20 on
    # the probe path (phase 6)
    launches.update({k: launches_s[k] for k in (
        "fused_correlate", "upsample2x_argmax")})
    launches.update({k: launches_q[k] for k in (
        "ln_quantize_rows", "flash_attention_ln_qkv_fused_q8",
        "head1_correlate_fused")})
    launches["head1_correlate_argmax_fused"] = launches_hf[
        "head1_correlate_argmax_fused"]
    launches["flash_attention_qkv_fused"] = launches_fq[
        "flash_attention_qkv_fused"]
    launches.update({k: launches_w[k] for k in (
        "head1_correlate_wup_fused", "head1_correlate_upsample_argmax")})
    launches.update({k: launches_fb[k] for k in (
        "flash_attention_qkvp_fused", "mlp_fused")})
    launches["fused_rcu"] = launches_fd["fused_rcu"]
    launches["fused_upsample_outconv"] = launches_ho["fused_upsample_outconv"]
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
        "flash_attention_qkv_fused": (
            "lseg_tpu_torch/csrc/flash_attention_qkv_fused.cu",
            "lseg_tpu/ops/pallas_attention.py:344"),
        "head1_correlate_wup_fused": (
            "lseg_tpu_torch/csrc/head1_correlate_wup.cu",
            "lseg_tpu/ops/pallas_correlation.py:357"),
        "head1_correlate_upsample_argmax": (
            "lseg_tpu_torch/csrc/head1_correlate_upsample_argmax.cu",
            "lseg_tpu/ops/pallas_correlation.py:237"),
        "mlp_fused": ("lseg_tpu_torch/csrc/mlp_fused.cu",
                      "lseg_tpu/ops/pallas_mlp.py:57"),
        "flash_attention_qkvp_fused": (
            "lseg_tpu_torch/csrc/flash_attention_qkvp_fused.cu",
            "lseg_tpu/ops/pallas_attention.py:476"),
        "flash_attention_ln_qkv_fused": (
            "lseg_tpu_torch/csrc/flash_attention_ln_qkv_fused.cu",
            "lseg_tpu/ops/pallas_attention.py:909"),
        "fused_rcu": ("lseg_tpu_torch/csrc/fused_rcu.cu",
                      "lseg_tpu/ops/pallas_qconv.py:137"),
        "fused_upsample_outconv": (
            "lseg_tpu_torch/csrc/fused_upsample_outconv.cu",
            "lseg_tpu/ops/pallas_decoder.py:122"),
        "dense_residual": ("lseg_tpu_torch/csrc/dense_residual.cu",
                           "lseg_tpu/ops/pallas_dense.py:43"),
        "int8_matmul_sliced_scale": (
            "lseg_tpu_torch/csrc/int8_sliced_scale.cu",
            "scripts/mosaic_probe.py:49"),
    }
    # every kernel runs on a model path, on the training path or on the
    # probe path; the probe path runs exactly the kernels without a model
    # path (every serving phase held them at 0 launches per request)
    probed = {k for k, v in launches_p.items() if v}
    if probed != PROBE_KERNELS:
        fail(f"the probe path launched {sorted(probed)}, expected "
             f"{sorted(PROBE_KERNELS)}")
    rows = []
    for k, res in kernels.items():
        if k in PROBE_KERNELS:
            launches[k] = launches_p[k]
        elif launches[k] == 0:
            fail(f"kernel {k} was not launched on a model path or the "
                 f"training path")
        src, rep = sources[k]
        # max_abs_err of the label kernels (B11, B5, B13): the fraction of
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
