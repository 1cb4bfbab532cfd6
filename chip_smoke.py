#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`lseg_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero before
the result line is printed:

1. device and build: the card, its power limit, and the nvcc build of
   the hand-written kernels (`lseg_tpu_torch/csrc`), with `ptxas -v`'s
   registers and spills; the SASS of the built library (`cuobjdump
   --dump-sass`) must hold warpgroup products (HGMMA) and TMA loads
   (UTMALDG) in B6's kernel (in every object that compiles it), in both
   of B7's, and in the kernels of B17's bf16 mode and B10's bf16 mode
   (the GEMM engine of `csrc/wgmma_gemm.cuh`); TF32 warpgroup products
   and TMA loads in B17's fp32 kernel, and TF32 tensor-core products in
   B6's fp32 kernel and both passes of B7's fp32 mode (the split-TF32
   products of `csrc/tf32x3.cuh`); integer warpgroup products (IGMMA)
   and TMA loads in B16's cluster kernel, in the s8 qkv GEMM of B2, B8,
   B9 and B15 (`csrc/qkv_wgmma.cuh`), in B15's projection, in B18's
   three channel widths and in B13's embed, and beside bulk copies
   (UBLKCP) in B19's kernels and B4's two copies; HGMMA and UTMALDG in
   the head-pair attention kernels of B2 and B15 and in B1's three copies
   (k-chunks of 16, 32 and 48 floats); IGMMA, HGMMA and UTMALDG in B2's
   int8 Q.K^T mode (`flash_q8_i8qk_cluster_kernel`); IGMMA and UTMALDG in
   B20's cluster kernel; bulk copies in B3's LN routine and in B11's fp32 and
   bf16 kernels;
2. each kernel against its plain PyTorch version on the card, at the
   shapes of the serving path, with its time beside the plain version's
   (B1 at the flagship, 384x480, a ragged M, ViT-B/32's P = 32 and D =
   768, and two shapes of its wide route, its device time alone from
   `torch.profiler` beside its wrapper time; B10 in both of its modes,
   fp32 and compute_dtype=bfloat16; B17 at
   ViT-L/16's fc2 shape in bf16 and fp32 and its proj shape, and at the
   reference test's fp32 shape, with and without a residual; B20 at the
   reference probe's shape in both scale block shapes, and at M = 1001,
   K = 64, 192 and 256, bit for bit; B6's per-row
   log-sum-exp against the plain one; the fp32 modes of B6 and B7, an
   fp32 model's route, at the flagship shape and a masked ragged one,
   beside SDPA in fp32; B16 as one kernel launch a call (counted by
   `torch.profiler`) with the card's cluster occupancy; at its end B6,
   B7, B8, B9, B2 and B15 timed again, one after another, beside SDPA
   and SDPA's backward; the qkv stage of B2, B8, B9 and B15 alone, bit
   for bit against its plain version; B20's device time alone, from
   `torch.profiler`, beside its host-bound wrapper time, and B3's and
   B1's the same way; B18 checked and timed at each of the fused decoder's four
   shapes, its device time from `torch.profiler`, its row a request's
   seven launches; B19 at refinenet2's shape (its row) and refinenet1's
   int8 hand-off (under "handoff"), each with its bound and device time;
   B4 at the lowres head (its row) and the half-res logits (under "h2"),
   and at K = 300 and ragged M in both modes, bit for bit against the
   mma.sync B4 kernel (`head1_correlate_fused_mma`, its own row: the
   yardstick of the wgmma head tile, which phases 3-6 never launch), as
   are B14's W-interp and B13's tail; B11 in fp32 (its row) and bf16
   (under "bf16") at the flagship, and at one source column, one source
   row, K = 151 and 1536, on ties and NaNs, every label equal; B2's int8
   Q.K^T mode (`qk_int8=True`) at the flagship, the padded (8, 904, 1024)
   with keys masked past 901 and ViT-B's (8, 226, 768) within LNQKV_REL
   of its plain twin, and at the flagship at 10x B2's weight scales (rows
   nearly one-hot) within LNQKV_REL of the twin's attention on B3's codes,
   where the default mode's kernel must miss that twin by more than
   LNQKV_REL (the check sees which kernel ran), timed at the flagship
   beside the default mode on the same inputs (its row's "i8qk" entry));
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
  (b2) one `--dtype float32` train step of a tiny flashflat config (ViT
       width 128, two heads of 64, depth 4) through the fp32 modes of B6
       and B7: launches B6 = 8 and B7 = 4 (counters set to 0 just before,
       read just after), ViT gradients within TRAIN_FP32_GRAD_REL of the
       plain path's;
   (c) ms/step, img/s and peak memory at batch 8, kernel and plain
       paths (CUDA events, 5 steps after 2 warm-ups), with per-step
       launch counts B6 = 48 (forward + remat recompute), B7 = 24;
6. the probe path: `lseg_tpu_torch.probe` compiles B20's source alone
   (`--sources`), then runs its cases in process: the four B20 variants
   (each from the probe's own one-source library), `dense` (B17 at fc2)
   and `ln_qkv` (B9), each against its plain twin; the launch counters
   must show exactly B9, B17 and B20, the kernels that no model path of
   the reference runs;
7. evaluation, at the published widths from reference checkpoints: (a)
   `testing.write_reference_ckpt` (seed 0) and `write_reference_vocab`
   write a full-width lang-seg `.ckpt` and a BPE vocabulary into a
   temporary directory, `load_reference_checkpoint` reads them back, and
   every loaded tensor must equal the written one (read by `torch.load`)
   bit for bit through the key maps; the writer's 0.1 randn weights drive
   the decoder's activations to ~1e10 at these widths, so (a2) the fp32
   model of phase 3b and a CLIP text tower, seeded `random_init_` as in
   phases 3-6, are written as a lang-seg `.ckpt` through the inverse of
   the key maps, read back and held bit for bit the same way, and (b)-(g)
   run on them; (b) the ADE20K-150 text matrix from the loaded text
   tower through `TextFeatureCache`; (c) the calibrated fast_cal model
   with its plain twins, calibrated on the two 480x480 center crops that
   (f) calibrates on; (d) `MultiScaleEvaluator` with `ADE20K_PROTOCOL` (6
   scales + flip) on one 512x683 image, 18 crops in 5 chunks of batch 8:
   the kernel path must launch B1 = 5, B2 = B3 = 120 and B4 = 5 (its
   normalized H/2 mode) and nothing else, its (512, 683, 150) sums must
   stay within SERVE_RATIO times the plain twins' distance from the fp32
   sums plus TTA_FLOOR, and a repeated image must give the same sums bit
   for bit; (e) `SingleScaleEvaluator(flip=True).logits` at batch 8,
   480x480, on `fast_serving(cfg, quant=False)` (B1 = 2, B6 = 48): the
   flip-merged logits within SERVE_RATIO times the plain twin's distance
   from the fp32 model's plus two SERVE_FLOORs, and the pixAcc and mIoU
   against the fp32 model's labels within METRIC_FLOOR of the plain
   twin's; (f) `evaluate.build` and `evaluate.run` with `--fast --int8
   --int8-cal 2` over two ADE-shaped samples in memory, whose label map
   of the image of (d) must equal (d)'s argmax; (g) seconds per image of
   the protocol on the kernel path after one warm-up image, with peak
   memory and the card's name and power limit;
8. the other backbones and heads, at full width with seeded weights,
   480x480: (8a) B4 (lowres and H/2), B14 and B10 (fp32 mode) at E = 640
   and 768 (B4 and B14 also bit for bit against the mma.sync B4 kernel's
   logits), B2 and B3 at D = 768, T = 226, each against its plain twin
   with its time and bound; then, answering an ADE-150 request at batch 8
   and a 5-label one at batch 1 with launch counts per request, each
   call's half-res (or full-resolution) logits held against its plain
   twin and an fp32 model as in 3b, labels of the lowres and streamed
   heads against their heads' plain twins on the same inputs (>= 0.999),
   and ms/batch and peak memory of the kernel and plain paths:
   `clip_vitb16_384` on fast_cal through `model(x, txt,
   return_argmax=True)` (B1 1, B2 = B3 = 12, B4 1) and on fast_bf16
   through `make_predictor` (B1 1, B6 12); `clip_vitb32_384` and
   `clipRN50x4_vitb32_384` on fast_cal (B1 at P = 32, B2 and B3 at T =
   226, B4 at E = 512 and 640); `clipRN50x16_vitl16_384` on fast_cal (B4
   at E = 768), its 'wup' logits call (B14) and the streamed
   `make_predictor(use_pallas=True)` on the int8 model (B10 + B11);
   `clip_resnet101` on fast_cal (the ResNet in cuDNN, the int8 decoder,
   B4 1) and streamed (B10 + B11); `clip_vitl16_384` with the
   arch_option 1 and 2 head blocks at block_depth 2 on fast_bf16 through
   `make_predictor`'s full-forward branch (B1 1, B6 24; the head blocks
   plain). The phase fails unless its counted runs launched exactly
   B1, B2, B3, B4, B6, B10, B11 and B14;
9. few-shot / zero-shot transfer (the reference's test_zs.py) on a
   written PASCAL-5i tree (ten VOC-sized JPEGs of fold 0's five classes,
   masks with a 255 band), batch 8 at 480x480, one ['others', class] pair
   per image from `TextFeatureCache.pair_features`: (E1) test_zs's model,
   `get_config(clip_vitl16_384)` in bf16 loaded from a lang-seg `.ckpt`
   of seeded weights, and `get_config(clip_resnet101)` on ImageNet-
   normalised episodes, through `make_episodic_predictor`: the labels
   against the model's own argmax head given each image's pair, at half
   resolution, and against the argmax of its logits (>= 0.999), no kernel
   launched; (E2) the same predictor on fast_cal's embeddings (B1 = 1,
   B2 = B3 = blocks a batch), its half-res pair logits against its plain
   twins as in 3b, and its labels equal to the plain twins' (>= 0.999)
   on the pixels where the plain twin's margin between 'others' and the
   class exceeds that logits bound (random-weight near-ties below it may
   flip with a code); (E3) `make_episodic_train_step` on the training
   CLI's configuration (flashflat, remat, bf16 on fp32 masters): one
   step's loss and ViT gradients against the plain twin as in 5b, then
   five steps on the same episodes with the loss falling, ms/step and
   peak memory, B6 = 2 x blocks and B7 = blocks a step; (E4) `python -m
   lseg_tpu_torch.test_zs` in a process of its own on the default device
   over the protocol's 1000 episodes, its printed and logged line equal
   to E1's predictor through the in-process `EpisodicEvaluator` (each
   distinct episode decoded once), whose meter must equal a numpy
   recount of its labels with the ignore region folded in, and the
   command's seconds per 1000 episodes. The phase fails
   unless its counted runs (E2's batch, E3's kernel steps) launched
   exactly B1, B2, B3, B6 and B7.
10. multi-GPU, the JAX package's `parallel/` and sharded predictors: (a)
   two ranks share the card over gloo (NCCL refuses two ranks on one
   device), each a process of its own (`chip_smoke.py --parallel-rank`)
   that loads phase 1's kernel library and never builds, on phase 3b's
   seeded weights, 480x480, K = 150: (P1) `make_data_sharded_predictor`
   on fast_cal at a global batch of 8, each rank's rows of the gathered
   labels equal to the single-process call on its 4 images bit for bit,
   B1 1, B2 = B3 = 24, B4 1 a rank, its half-res logits held as in 3b;
   (P2) `make_labelset_sharded_predictor` on fast_bf16 (75 labels a
   rank), its labels equal to the unsharded `make_predictor`'s on every
   pixel whose unsharded top-2 margin exceeds LABELSET_MARGIN, and with
   the same 75 labels on both ranks the lowest label must win every tie,
   B1 1, B6 24 a rank; (P3) one data-parallel train step of train.py's
   configuration, 2 ranks x 4 images from the port's loader (each rank's
   rows checked against its shard of the index stream; rank 0's images
   with their top 192 rows ignored), the ranks' states equal bit for bit,
   and against one process x 8 on rank 0: the loss, the parameter update
   and the BatchNorm statistics within 2 d_ref + 2^-8 (d_ref the
   single-process bf16 step's gap to its fp32 twin), the single-process
   kernel step against its plain twin the same way, B6 48, B7 24 a rank,
   ms/step and peak memory a rank; (P4) `torchrun --nproc_per_node=2 -m
   lseg_tpu_torch.train` on synthetic data, exit 0, one writer's files;
   (b) one NCCL rank in this process: its collectives on the card, then
   P1's and P2's calls bit for bit the undistributed ones. The phase
   fails unless its counted runs launched exactly B1, B2, B3, B4, B6 and
   B7.
11. the HSNet side-car and the remaining entry points, on phase 9's
   PASCAL-5i tree (with a `trn` split added), `.ckpt` and vocabulary:
   seeded torchvision-format ResNet-101 and VGG16 files; (a) hsnet_run's
   model (ResNet-101 (3, 4, 23, 3), bf16, 400 x 400, batch 8), its
   backbone read through `torchvision_resnet_key_map` bit for bit, its 1-
   and 5-shot `predict_mask_nshot` votes against the same weights in fp32
   (logits within HSNET_LOGITS_REL of the fp32 maximum, votes by E2's
   margin rule), ms a batch and peak memory; (b) the same with VGG16;
   (c) `use_original_imgsize` at batch 1 on the 375 x 500 original; (d)
   three Adam steps of hsnet_run's recipe on fp32 masters, the first
   step's loss and learner gradients against the fp32 step, the frozen
   backbone (parameters and BatchNorm statistics) bit for bit unchanged;
   (e) `python -m lseg_tpu_torch.hsnet_run test` over the 1000 episodes
   and `train --niter 3`; (f) `demo.main` at clip_vitl16_384 with
   `--weights random` plain (no launch), `--fast` (B1 1, B6 24), `--fast
   --int8` (B1 1, B2 = B3 = 24), `--fast --tta` (B1 and 24 B6 a crop
   chunk) and `--fast` from the `.ckpt`; (g) `python -m
   lseg_tpu_torch.parity_check` on logits written from the `.ckpt` on the
   plain fp32 `emulate_fp16` path: PARITY: PASS; (h) `app.load` and a
   single-scale and a TTA `app.request` (no launch); (i) a
   `profiling.trace` of one HSNet call, with device kernels in it;
   `StepTimer` takes the times of (a)-(d). HSNet launches no kernel of
   ours; the phase fails unless the demo runs launched exactly B1, B2, B3
   and B6.
12. the int8 modes, at full width with phase 3b's seeded fp32 weights
   (made again from the same seed): (a) `fast_serving(clip_vitl16_384
   with attn_variant='i8qk', 'static_cal')`, quantized and calibrated as
   in 3b, per request B1 = 1, B2 = B3 = blocks (every B2 launch in its
   int8 Q.K^T mode), B4 = 1; (b) `fast_serving(clip_vitl16_384 with
   quant_int8=True, False)`, `QuantDense` on fp32 weights quantized at
   every call, per request B1 = 1, B6 = blocks; each answers phase 3's
   three requests through `model(x, txt, return_argmax=True)`, its
   half-res logits held as in 3b, with ms/batch and peak memory (kernel,
   plain, kernel); (b)'s reference pair, the parity config with
   quant_int8=True (einsum attention), answers one request with no
   launch, its half-res logits within SERVE_RATIO * (b)'s |plain - fp32|
   + SERVE_FLOOR of the fp32 parity model's. The
   phase fails unless its counted runs launched exactly B1, B2, B3, B4
   and B6.

Phase 2 also times, for each kernel, the PyTorch library call that
computes the same function where there is one, and computes its bound
from the inputs and the card's published peaks (for B17's and B7's fp32
modes the smaller of the fp32-FMA bound and the split-TF32 bound, both
kept under "bounds"). The line before the last
is a JSON object with each kernel's launches (on the path of phases 3-6
that runs it: every kernel runs on a serving path, the training path or
the probe path; phase 7 adds no row), error, times and bound (B10's row
also holds its bf16 mode's under "bf16", B17's its fp32 mode's under "fp32"; the fp32 modes
of B6 and B7 have rows of their own, with the launches of phase 5b2;
B19's holds its hand-off shape's under "handoff"; each row also holds
its launches in phase 8 under "backbone_launches", in phase 9 under
"fewshot_launches", in phase 10 under "parallel_launches" (a list,
one count a rank), in phase 11 under "tools_launches" and in phase 12
under "int8_modes_launches"; B2's row holds its int8 Q.K^T mode's
phase-2 numbers and phase-12 launches under "i8qk"; and the rows of B2,
B3, B4, B10 and B14 phase 8a's numbers under "widths"); the last line is
the result object. Needs one
GPU and no network; imports no JAX and nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
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
# B6's lse against the plain lse: fp32 sums of <= 904 terms in another
# order, and exp2 of one FMA against exp of the scaled score.
LSE_ATOL = 1e-4
# The fp32 modes of B6 and B7 against their plain versions: every step in
# fp32 on both sides, summed in another order, the forward's softmax
# rescaled by the running row maximum and the backward reading the
# forward's lse. Scores of 64 fp32 products (|s| ~ 1 for randn inputs)
# agree to ~2e-6, so each P to ~2e-6 relative, and a weighted average of
# values to 2e-6 of max|v| (< 5 for randn): O within 2e-5 + 1e-4 |plain|;
# the lse within 1e-5 (an fp32 ulp at |lse| ~ 8 is 1e-6); each of dq, dk
# and dv within 1e-4 of max|plain|. Both kernels' products are split TF32
# (csrc/tf32x3.cuh), which keeps ~21 bits of each operand: their scores
# agree to a few 1e-7 more, well inside the same bounds.
FLASH_FP32_RTOL, FLASH_FP32_ATOL = 1e-4, 2e-5
LSE_FP32_ATOL = 1e-5
FLASH_BWD_FP32_REL = 1e-4
# One fp32 train step of a tiny flashflat config on the fp32 kernels
# against the same step on the plain path: fp32 on both sides, so the ViT
# gradients' global relative deviation stays at fp32 rounding, 1e-4.
TRAIN_FP32_GRAD_REL = 1e-4
# Kernel -> the SASS opcodes every compiled copy of it must hold (regular
# expressions over `cuobjdump --dump-sass`): warpgroup products (HGMMA)
# and TMA loads (UTMALDG) in B6's interior, both passes of B7, B17's
# bf16 kernel and B10's bf16-mode kernel (the GEMM engine of
# wgmma_gemm.cuh); TF32 warpgroup products and TMA loads in B17's fp32
# kernel, TF32 tensor-core products (HMMA or HGMMA with the TF32 suffix)
# in B6's fp32 kernel and both passes of B7's fp32 mode; integer
# warpgroup products (IGMMA) and TMA loads in B16's cluster kernel, the s8
# qkv GEMM (in every object that compiles it: B2, B8, B9, B15 and the
# stage's own entry point), B15's projection, B18 (each of its three
# channel widths) and the embed of B13 (its one- and many-chunk copies),
# B14 and B5 (their C <= 256 kernels), and B19 (beside its bulk copies);
# HGMMA and TMA loads in the head-pair attention of B2 (its cluster kernel)
# and B15, and in each chunk width's copy of B1's kernel; IGMMA and TMA
# loads in B20's cluster kernel; bulk copies in B3's LN routine (in B3, B2
# and B9); so a SIMT or mma.sync fallback fails the run.
WGMMA_TMA = (r"\bHGMMA\.", r"\bUTMALDG\b")
TF32_MMA = r"\bH(?:G)?MMA\.[\w.]*TF32"
SASS_REQUIRED = {
    "flash_flat_kernel": WGMMA_TMA,
    "bwd_dq_kernel": WGMMA_TMA,
    "bwd_dkdv_kernel": WGMMA_TMA,
    "dense_wgmma_kernel": WGMMA_TMA,
    "fused_correlate_wgmma_kernel": WGMMA_TMA,
    "dense_tf32x3_kernel": (r"\bHGMMA\.[\w.]*TF32", r"\bUTMALDG\b"),
    "flash_flat_fp32_kernel": (TF32_MMA,),
    "bwd_dq_fp32_kernel": (TF32_MMA,),
    "bwd_dkdv_fp32_kernel": (TF32_MMA,),
    "mlp_fused_cluster_kernel": (r"\bIGMMA\.", r"\bUTMALDG\b"),
    "qkv_wgmma_kernel": (r"\bIGMMA\.", r"\bUTMALDG\b"),
    "pair_proj_wgmma_kernel": (r"\bIGMMA\.", r"\bUTMALDG\b"),
    "fused_rcu_wgmma_kernelILi64E": (r"\bIGMMA\.", r"\bUTMALDG\b"),
    "fused_rcu_wgmma_kernelILi128E": (r"\bIGMMA\.", r"\bUTMALDG\b"),
    "fused_rcu_wgmma_kernelILi256E": (r"\bIGMMA\.", r"\bUTMALDG\b"),
    "head1_up_argmax_wgmma_kernelILb0E": (r"\bIGMMA\.", r"\bUTMALDG\b"),
    "head1_up_argmax_wgmma_kernelILb1E": (r"\bIGMMA\.", r"\bUTMALDG\b"),
    "head1_wup_wgmma_kernel": (r"\bIGMMA\.", r"\bUTMALDG\b"),
    "head1_argmax_wgmma_kernel": (r"\bIGMMA\.", r"\bUTMALDG\b"),
    "flash_q8_cluster_kernel": WGMMA_TMA,
    # B2's int8 Q.K^T mode: Q.K^T on s8 warpgroup products, P.V on bf16
    "flash_q8_i8qk_cluster_kernel": (r"\bIGMMA\.", r"\bHGMMA\.",
                                     r"\bUTMALDG\b"),
    "pair_attention_kernel": WGMMA_TMA,
    # B1 (its k-chunks of 16, 32 and 48 floats): the image's segments and
    # the weight by TMA
    **{f"patch_embed_tma_kernelILi{L}E": WGMMA_TMA for L in (16, 32, 48)},
    # B20: x by TMA, the cluster's int32 partials over DSM
    "int8_sliced_scale_kernel": (r"\bIGMMA\.", r"\bUTMALDG\b"),
    # B19 (its int8 and bf16 outputs): the weight by TMA, the source rows
    # by bulk copies
    "upsample_outconv_wgmma_kernelILb1E": (
        r"\bIGMMA\.", r"\bUTMALDG\b", r"\bUBLKCP\b"),
    "upsample_outconv_wgmma_kernelILb0E": (
        r"\bIGMMA\.", r"\bUTMALDG\b", r"\bUBLKCP\b"),
    # B3's routine at each width (VPL chunks a lane; B2 and B9 compile it
    # too): its rows by bulk copies
    **{f"ln_quantize_ring_kernelILi{v}E": (r"\bUBLKCP\b",)
       for v in range(1, 9)},
    # B4 (its normalized and raw copies): codes, weight and text by TMA,
    # the staged logits out by bulk copies
    "head1_correlate_wgmma_kernelILb0E": (
        r"\bIGMMA\.", r"\bUTMALDG\b", r"\bUBLKCP\b"),
    "head1_correlate_wgmma_kernelILb1E": (
        r"\bIGMMA\.", r"\bUTMALDG\b", r"\bUBLKCP\b"),
    # B11 (fp32 and bf16): its source-row strips by bulk copies
    "upsample2x_argmax_ring_kernelIfE": (r"\bUBLKCP\b",),
    "upsample2x_argmax_ring_kernelI13__nv_bfloat16E": (r"\bUBLKCP\b",),
}
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
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12,
                  "tf32": 495e12}
# An fp32 product's bound is the smaller of its fp32 FMAs and three TF32
# tensor-core products of the split operands (tf32x3.cuh), since the card
# computes the fp32-accurate function either way; the kernels line keeps
# both under "bounds".
TF32_SPLIT_PRODUCTS = 3
# Serving: the kernel path's half-res logits may stray from the plain
# path (patch matmul form + einsum attention, same bf16 weights) by at
# most twice what the plain bf16 path strays from the fp32 model, plus a
# floor of one bf16 ulp at the logit scale (|logit| <= 1/0.07).
SERVE_RATIO, SERVE_FLOOR = 2.0, 0.0625
# Phase 7's 6-scale + flip sums: each pixel's sum holds, for each of the 6
# scales, a canvas average of (logits + flipped-back logits), so 12 served
# logits' worth of rounding; each may carry SERVE_FLOOR, as a served logit
# does above.
TTA_FLOOR = 2 * 6 * SERVE_FLOOR
# Phase 7's single-scale metrics, the targets the fp32 model's labels: the
# kernel path's pixAcc and mIoU within this of the plain twin's. On an
# H100 the sound kernels' labels differ from the plain twin's on 0.04% of
# the valid pixels, and the gaps measure 1.1e-4 (pixAcc) and 1.8e-4
# (mIoU): the floor is 2.5 times that share and 6-10 times those gaps.
METRIC_FLOOR = 0.001
# The kernels that no model path of the reference runs: B9, B17 and B20.
# The probe path (phase 6) launches them, and exactly them; every other
# kernel must run on a serving path or the training path.
PROBE_KERNELS = {"flash_attention_ln_qkv_fused", "dense_residual",
                 "int8_matmul_sliced_scale"}
# Kernels kept as yardsticks, which no path runs: the mma.sync B4
# (`head1_correlate_wide.cu`, B4's route for C > 256, which no registered
# config has), the independent logits that phase 2 holds the wgmma head
# tile of B4, B13 and B14 against bit for bit. Every serving phase counts
# it and expects 0 launches a request; its row's `launches` is that 0.
YARDSTICK_KERNELS = {"head1_correlate_fused_mma"}

# Phase 10 (multi-GPU): two ranks share the one card over gloo (NCCL
# refuses two ranks on one device), each a process of its own that loads
# phase 1's kernel library and never builds; a rank that exits non-zero
# or has not finished after PARALLEL_RANK_TIMEOUT s fails the phase.
PARALLEL_WORLD = 2
PARALLEL_BATCH = 8
PARALLEL_RANK_TIMEOUT = 300
# P2, the label-set-sharded head: each rank's K / W logits come from a
# product of its own width, which may round a bf16 logit one ulp
# (SERVE_FLOOR at the logit scale) apart from the unsharded product's,
# and the bf16 x2 upsample may round it once more. Each of the two logits
# a label compares moves by at most two ulps, so the labels must equal
# the unsharded predictor's wherever its top-2 margin exceeds four.
LABELSET_MARGIN = 4 * SERVE_FLOOR
# The kernels phase 10's counted runs launch on each rank: P1's fast_cal
# forward (B1, B2, B3, B4), P2's fast_bf16 embedding (B1, B6), P3's
# train step (B6, B7).
PARALLEL_KERNELS = {"patch_embed", "flash_attention_ln_qkv_fused_q8",
                    "ln_quantize_rows", "head1_correlate_fused",
                    "flash_attention_flat", "flash_attention_flat_bwd"}
ROOT = os.path.dirname(os.path.abspath(__file__))


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


def result(err, ms, plain_ms, moved, ops, library_ms=None,
           split_tf32=False):
    """A kernel's numbers. With `split_tf32` (a kernel whose "fp32"
    operations are matrix products), their bound is also taken as
    TF32_SPLIT_PRODUCTS TF32 products, and the smaller of the two bounds
    is the row's."""
    bounds = {"fp32": bound(moved, ops)}
    if split_tf32:
        split = {k: n for k, n in ops.items() if k != "fp32"}
        split["tf32"] = TF32_SPLIT_PRODUCTS * ops["fp32"]
        bounds["tf32x3"] = bound(moved, split)
    name = min(bounds, key=lambda k: bounds[k][0])
    bound_ms, bound_by = bounds[name]
    print(f"    bound {bound_ms:.4f} ms ({bound_by}: {moved / 1e6:.1f} MB, "
          + ", ".join(f"{n / 1e9:.1f} G {k}" for k, n in ops.items())
          + (f"; fp32 FMAs {bounds['fp32'][0]:.4f} ms, split TF32 "
             f"{bounds['tf32x3'][0]:.4f} ms" if len(bounds) > 1 else "")
          + f"); library call "
          + ("none" if library_ms is None else f"{library_ms:.4f} ms"))
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    if len(bounds) > 1:
        row["bounds"] = {k: v[0] for k, v in bounds.items()}
    return row


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
    for line in ptxas_summary(load_kernels.build_log):
        if line.startswith(tuple(SASS_REQUIRED)):
            print(f"  tensor-core kernel spills (expect 0): {line}")
    sass_check()
    return name


def sass_check():
    """Fail unless every compiled copy of each kernel of SASS_REQUIRED
    holds each of its opcodes, read from the built library by
    `cuobjdump --dump-sass`."""
    import re
    from pathlib import Path

    from lseg_tpu_torch.ops._build import (
        _kernel_name,
        find_nvcc,
        library_path,
    )

    tool = Path(find_nvcc()).with_name("cuobjdump")
    proc = subprocess.run([str(tool), "--dump-sass", str(library_path())],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        fail(f"cuobjdump: {proc.stderr.strip()[:500]}")
    copies = {k: [] for k in SASS_REQUIRED}
    for sec in proc.stdout.split("Function : ")[1:]:
        name = _kernel_name(sec.split(None, 1)[0])
        if name in copies:
            copies[name].append([re.search(op, sec)
                                 for op in SASS_REQUIRED[name]])
    for name, found in copies.items():
        ops = SASS_REQUIRED[name]
        seen = sorted({m.group(0) for f in found for m in f if m})
        print(f"  sass {name}: {len(found)} compiled copies, "
              + ", ".join(f"{op} in {sum(bool(f[i]) for f in found)}"
                          for i, op in enumerate(ops))
              + f" (e.g. {', '.join(seen)})")
        if not found or not all(all(f) for f in found):
            fail(f"sass: {name} lacks {' / '.join(ops)} in a copy")


def phase_kernels(dev):
    from lseg_tpu_torch.ops.flash_attention import (
        flash_attention_flat,
        flash_attention_flat_plain,
    )
    from lseg_tpu_torch.ops.patch_embed import (
        b1_plan,
        patch_embed,
        patch_embed_plain,
    )

    print("[2] kernels vs plain versions")
    g = torch.Generator(device=dev).manual_seed(SEED)
    results = {}

    # B1 at the flagship, the demo's 384x480, a ragged M, ViT-B/32's patch
    # and width, and two shapes of the wide route (P*C = 42; gw = 130)
    for shape, p, d in (((8, 480, 480, 3), 16, 1024),
                        ((2, 384, 480, 3), 16, 1024),
                        ((3, 48, 80, 3), 16, 128),
                        ((2, 384, 384, 3), 32, 768),
                        ((1, 224, 224, 3), 14, 64),
                        ((1, 32, 2080, 3), 16, 64)):
        w = (0.05 * torch.randn(p * p * 3, d, device=dev, generator=g)
             ).to(torch.bfloat16)
        b = torch.randn(d, device=dev, generator=g)
        x = torch.randn(shape, device=dev, generator=g)
        route = "tma" if b1_plan(shape[2], 3, p) else "wide"
        out = patch_embed(x, w, b, p)
        err = check_close(f"patch_embed {shape} P={p} D={d} ({route})", out,
                          patch_embed_plain(x, w, b, p), PATCH_RTOL,
                          PATCH_ATOL)
        if shape[0] != 8:
            continue
        ms = cuda_time_ms(lambda: patch_embed(x, w, b, 16))
        plain_ms = cuda_time_ms(lambda: patch_embed_plain(x, w, b, 16))
        # a wrapper call may be paced by the host: the kernel's device time
        # alone, from the profiler over back-to-back calls
        device_ms = _device_ms(lambda: patch_embed(x, w, b, 16))
        print(f"  patch_embed (8,480,480,3)->(8,900,1024): kernel {ms:.4f} "
              f"ms (device time {device_ms:.5f} ms, torch.profiler), plain "
              f"{plain_ms:.4f} ms")
        # the library call: a stride-16 convolution on the same image and
        # weight, NCHW bf16 (the layout change is not timed)
        xc = x.permute(0, 3, 1, 2).to(torch.bfloat16)
        wc = w.reshape(16, 16, 3, 1024).permute(3, 2, 0, 1).contiguous()
        bc = b.to(torch.bfloat16)
        lib_ms = cuda_time_ms(lambda: torch.nn.functional.conv2d(
            xc, wc, bc, stride=16))
        results["patch_embed"] = result(
            err, ms, plain_ms, nbytes(x, w, b, out),
            {"bf16": 2 * 8 * 900 * 768 * 1024}, lib_ms)
        results["patch_embed"]["device_ms"] = device_ms
        del xc

    scale = 64 ** -0.5
    for n, t, vl in ((8, 901, None), (8, 904, 901), (2, 721, None)):
        qkv = torch.randn(n, t, 3 * 1024, device=dev, generator=g
                          ).to(torch.bfloat16)
        out, lse = flash_attention_flat(qkv, 16, scale, vl, return_lse=True)
        ref, ref_lse = flash_attention_flat_plain(qkv, 16, scale, vl,
                                                  return_lse=True)
        err = check_close(
            f"flash_attention_flat ({n},{t},3072) valid_len={vl}", out, ref,
            FLASH_RTOL, FLASH_ATOL)
        check_close(f"flash_attention_flat lse ({n},16,{t})", lse, ref_lse,
                    0.0, LSE_ATOL)
        del out, ref, lse, ref_lse
        if (n, t, vl) == (8, 901, None):
            ms = cuda_time_ms(lambda: flash_attention_flat(qkv, 16, scale))
            plain_ms = cuda_time_ms(
                lambda: flash_attention_flat_plain(qkv, 16, scale))
            print(f"  flash_attention_flat (8,901,3072) 16 heads: "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            q, k, v = qkv.view(n, t, 3, 16, 64).permute(2, 0, 3, 1, 4)
            sdpa = (lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, scale=scale))
            lib_ms = cuda_time_ms(sdpa)
            ATTN_RETIME["B6 flash_attention_flat"] = (
                lambda x=qkv: flash_attention_flat(x, 16, scale))
            ATTN_RETIME["SDPA"] = sdpa
            results["flash_attention_flat"] = result(
                err, ms, plain_ms, nbytes(qkv) + nbytes(qkv) // 3,
                {"bf16": 4 * n * 16 * t * t * 64}, lib_ms)
    results["flash_attention_flat_bwd"] = _flash_bwd(dev, g, scale)
    results.update(_flash_fp32(dev, g, scale))
    results.update(_int8_kernels(dev, g))
    results.update(_head_kernels(dev, g))
    results.update(_upsampled_head_kernels(dev, g))
    results.update(_fused_block_kernels(dev, g))
    results.update(_decoder_kernels(dev, g))
    results.update(_probe_path_kernels(dev, g))
    _retime_attention()
    return results


# The attention kernels' calls (and SDPA's), kept by phase 2's checks for
# one more timing at its end, in one stretch.
ATTN_RETIME = {}


def _retime_attention():
    print("  attention re-timed, one after another (ms):")
    for name, fn in ATTN_RETIME.items():
        print(f"    {name}: {cuda_time_ms(fn):.4f}")
    ATTN_RETIME.clear()


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
        out, lse = flash_attention_flat(qkv, 16, scale, vl, return_lse=True)
        args = (qkv, out, do, lse, 16, scale, vl)
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
            sdpa_bwd = (lambda: torch.autograd.grad(
                so, (q, k, v), dso, retain_graph=True))
            lib_ms = cuda_time_ms(sdpa_bwd)
            ATTN_RETIME["B7 flash_attention_flat_bwd"] = (
                lambda a=args: flash_attention_flat_bwd(*a))
            ATTN_RETIME["SDPA backward"] = sdpa_bwd
            # qkv, out, dout read, dqkv written (lse read: 0.5 MB, left
            # out as in earlier runs); the least work is five products
            # (s, dp, dv, dq, dk): 10 T^2 hd per head
            res = result(err, ms, plain_ms, nbytes(qkv, out, do, got),
                         {"bf16": 10 * 8 * 16 * t * t * 64}, lib_ms)
    return res


def _flash_fp32(dev, g, scale):
    """The fp32 modes of B6 and B7 (an fp32 model's route) against their
    plain versions at the flagship shape and a masked ragged one, each
    timed at the flagship beside SDPA in fp32."""
    from lseg_tpu_torch.ops.flash_attention import (
        flash_attention_flat,
        flash_attention_flat_bwd,
        flash_attention_flat_bwd_plain,
        flash_attention_flat_plain,
    )

    results = {}
    d = 1024
    for t, vl in ((901, None), (904, 901)):
        qkv = torch.randn(8, t, 3 * d, device=dev, generator=g)
        do = torch.randn(8, t, d, device=dev, generator=g)
        out, lse = flash_attention_flat(qkv, 16, scale, vl, return_lse=True)
        ref, ref_lse = flash_attention_flat_plain(qkv, 16, scale, vl,
                                                  return_lse=True)
        err_f = check_close(f"flash_attention_flat fp32 (8,{t},3072) "
                            f"valid_len={vl}", out, ref, FLASH_FP32_RTOL,
                            FLASH_FP32_ATOL)
        check_close(f"flash_attention_flat fp32 lse (8,16,{t})", lse,
                    ref_lse, 0.0, LSE_FP32_ATOL)
        args = (qkv, out, do, lse, 16, scale, vl)
        got = flash_attention_flat_bwd(*args)
        bref = flash_attention_flat_bwd_plain(*args)
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or not torch.isfinite(got).all():
            fail(f"flash_attention_flat_bwd fp32: {got.dtype}, finite "
                 f"{bool(torch.isfinite(got).all())}")
        errs = []
        for name, lo in (("dq", 0), ("dk", d), ("dv", 2 * d)):
            a, b = got[..., lo:lo + d], bref[..., lo:lo + d]
            err = float((a - b).abs().max())
            rel = err / float(b.abs().max())
            errs.append(err)
            print(f"  flash_attention_flat_bwd fp32 (8,{t},3072) valid_len="
                  f"{vl} {name}: max_abs {err:.6g} = {rel:.4g} of max|plain| "
                  f"(tol {FLASH_BWD_FP32_REL:g})")
            if rel > FLASH_BWD_FP32_REL:
                fail(f"flash_attention_flat_bwd fp32 {name}: kernel "
                     f"disagrees with its plain version")
        del ref, ref_lse, bref
        if vl is not None:
            continue
        ms, plain_ms = _timed(
            "flash_attention_flat fp32", "(8,901,3072) 16 heads",
            lambda: flash_attention_flat(qkv, 16, scale),
            lambda: flash_attention_flat_plain(qkv, 16, scale))
        q, k, v = (qkv.view(8, t, 3, 16, 64).permute(2, 0, 3, 1, 4)
                   .detach().clone().requires_grad_())
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib_ms = cuda_time_ms(lambda: sdpa(q, k, v, scale=scale))
        # q.k^T and P.V, 2 T^2 hd each per head, in fp32 FMAs or as
        # split-TF32 products
        results["flash_attention_flat_fp32"] = result(
            err_f, ms, plain_ms, nbytes(qkv) + nbytes(qkv) // 3,
            {"fp32": 4 * 8 * 16 * t * t * 64}, lib_ms, split_tf32=True)
        ms, plain_ms = _timed(
            "flash_attention_flat_bwd fp32", "(8,901,3072) 16 heads",
            lambda: flash_attention_flat_bwd(*args),
            lambda: flash_attention_flat_bwd_plain(*args))
        so = sdpa(q, k, v, scale=scale)
        dso = do.view(8, t, 16, 64).transpose(1, 2)
        lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
            so, (q, k, v), dso, retain_graph=True))
        # the least work, five products (s, dp, dv, dq, dk), in fp32 FMAs
        # or as split-TF32 products
        results["flash_attention_flat_bwd_fp32"] = result(
            max(errs), ms, plain_ms, nbytes(qkv, out, do, got),
            {"fp32": 10 * 8 * 16 * t * t * 64}, lib_ms, split_tf32=True)
        del q, k, v, so, dso
    return results


def _profiled(fn, calls: int = 1, tries: int = 3):
    """The device events (no copies or fills) of `calls` back-to-back
    calls of `fn` after a warm-up, from `torch.profiler`. A trace without
    device time is taken again, up to `tries` times: the profiler on the
    card's machine has once returned an empty trace for a call whose
    output had just been checked."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "Memcpy" not in e.name and "Memset" not in e.name]
        if any(e.device_time_total > 0 for e in events):
            break
        print(f"  torch.profiler: trace {attempt + 1} of {tries} holds no "
              f"device time ({len(events)} device events); taken again")
    return events


def _device_kernels(fn):
    """Names of the device kernels one call of `fn` launches, one entry
    per launch (`torch.profiler`)."""
    return [e.name for e in _profiled(fn) if e.device_time_total > 0]


def _device_ms(fn, calls: int = 50) -> float:
    """Device time a call of `fn` (the kernels it launches, summed), from
    `torch.profiler` over `calls` back-to-back calls after a warm-up."""
    us = sum(e.device_time_total for e in _profiled(fn, calls))
    if us <= 0:
        fail("torch.profiler saw no device time")
    return us / calls / 1e3


def _timed(name, shape, kernel, plain):
    ms = cuda_time_ms(kernel)
    plain_ms = cuda_time_ms(plain)
    print(f"  {name} {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return ms, plain_ms


def _int8_kernels(dev, g):
    from lseg_tpu_torch.ops.flash_attention import (
        _qkv_plain,
        flash_attention_ln_qkv_fused_q8,
        flash_attention_ln_qkv_fused_q8_plain,
        flash_attention_qkv_fused,
        flash_attention_qkv_fused_plain,
        qkv_int8_gemm,
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
    # a wrapper call's events time is paced by the host; the kernel's
    # own time from the profiler over back-to-back calls
    device_ms = _device_ms(lambda: ln_quantize_rows(x, ln_g, ln_b))
    print(f"  ln_quantize_rows: device time {device_ms:.5f} ms a call, "
          f"{ms:.5f} ms a wrapper call")
    results["ln_quantize_rows"] = result(
        err, ms, plain_ms, nbytes(x, ln_g, ln_b, q, s),
        {"fp32": 8 * 8 * 901 * d})  # ~8 operations per element
    results["ln_quantize_rows"]["device_ms"] = device_ms

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
            b2_args = args
            ATTN_RETIME["B2 flash_attention_ln_qkv_fused_q8"] = (
                lambda: flash_attention_ln_qkv_fused_q8(*b2_args))
            results["flash_attention_ln_qkv_fused_q8"] = result(
                err, ms, plain_ms, nbytes(x, ln_g, ln_b, wq, sw, bias, oq,
                                          os_),
                {"int8": 2 * 8 * t * d * 3 * d,
                 "bf16": 4 * 8 * 16 * t * t * 64})
    results["flash_attention_ln_qkv_fused_q8"]["i8qk"] = _b2_i8qk(
        dev, ln_g, ln_b, wq, sw, bias)

    # B8 at (8, 901, 1024) and the padded (8, 904, 1024), valid_len 901:
    # the row codes and scales of a LayerNorm-1 output, B2's weights; and
    # the qkv stage that B2, B8, B9 and B15 share, alone, bit for bit
    for t, vl in ((901, None), (904, 901)):
        x = torch.randn(8, t, d, device=dev, generator=g).to(torch.bfloat16)
        xq, sx = quantize_rows(x)
        stage = qkv_int8_gemm(xq, sx, wq, sw, bias)
        same = torch.equal(stage, _qkv_plain(xq, sx, wq, sw, bias))
        print(f"  qkv stage (8,{t},1024) -> (8,{t},3072): equal to the plain "
              f"stage bit for bit: {same}")
        if not same:
            fail("qkv_int8_gemm: the qkv stage differs from its plain "
                 "version")
        if vl is None:
            _timed("qkv stage", "(7208,1024).(1024,3072)",
                   lambda: qkv_int8_gemm(xq, sx, wq, sw, bias),
                   lambda: _qkv_plain(xq, sx, wq, sw, bias))
        del stage
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
            b8_args = args
            ATTN_RETIME["B8 flash_attention_qkv_fused"] = (
                lambda: flash_attention_qkv_fused(*b8_args))
            # no single PyTorch call computes the int8 qkv product of the
            # codes together with the attention: library call none
            results["flash_attention_qkv_fused"] = result(
                err, ms, plain_ms, nbytes(xq, sx, wq, sw, bias, out),
                {"int8": 2 * 8 * t * d * 3 * d,
                 "bf16": 4 * 8 * 16 * t * t * 64})

    results.update(_b4_kernels(dev, g))
    return results


def _b2_i8qk(dev, ln_g, ln_b, wq, sw, bias):
    """B2's int8 Q.K^T mode (`qk_int8=True`, attn_variant 'i8qk') against
    its plain twin at the flagship (8, 901, 1024), 16 heads, on B2's
    weights, at the padded (8, 904, 1024) with keys masked past 901, and at
    ViT-B's (8, 226, 768), 12 heads, on weights drawn at phase 2's scales
    (scores of a few units), each within LNQKV_REL; and at the flagship on
    B2's weights with 10x their scales (rows nearly one-hot), where the
    default mode's kernel must miss the i8qk twin by more than LNQKV_REL:
    at scores of a few units the two modes sit within about LNQKV_REL of
    each other (printed), so only that case shows which kernel ran. At
    10x a code that the plain LayerNorm puts one level off B3's moves a
    whole code step of a score, which near a tie of one-hot rows moves an
    output by more than LNQKV_REL (0.034 in a run); so there the twin
    starts from B2's first step, B3's codes (B2 launches B3's routine),
    and its qkv product equals B2's second (`_qkv_plain` is bit for bit
    `qkv_int8_gemm`, checked in this phase): the mode's attention alone
    is held within LNQKV_REL, and the whole twin's reading is printed. Its time at the flagship beside
    its bound and the default mode's time on the same inputs. Inputs from
    a generator of their own, so the draws of the other checks stay as
    they were."""
    from lseg_tpu_torch.ops.flash_attention import (
        _qkv_attention_plain,
        flash_attention_ln_qkv_fused_q8,
        flash_attention_ln_qkv_fused_q8_plain,
    )
    from lseg_tpu_torch.ops.ln_quant import ln_quantize_rows
    from lseg_tpu_torch.ops.quant import quantize_rows

    g = torch.Generator(device=dev).manual_seed(SEED + 12)
    scale = 64 ** -0.5
    row = None
    d = 768
    vitb = (1 + 0.1 * torch.randn(d, device=dev, generator=g),
            0.1 * torch.randn(d, device=dev, generator=g),
            torch.randint(-127, 128, (3 * d, d), device=dev, generator=g,
                          dtype=torch.int8),
            1e-3 * torch.rand(3 * d, device=dev, generator=g),
            0.05 * torch.randn(3 * d, device=dev, generator=g))
    for t, vl, heads, weights, one_hot in (
            (901, None, 16, (ln_g, ln_b, wq, sw, bias), False),
            (904, 901, 16, (ln_g, ln_b, wq, sw, bias), False),
            (VITB32_TOKENS, None, 12, vitb, False),
            (901, None, 16, (ln_g, ln_b, wq, 10 * sw, bias), True)):
        d = weights[0].shape[0]
        x = torch.randn(8, t, d, device=dev, generator=g).to(torch.bfloat16)
        args = (x, *weights, heads, scale, vl)
        oq, os_ = flash_attention_ln_qkv_fused_q8(*args, qk_int8=True)
        pq, ps = flash_attention_ln_qkv_fused_q8_plain(*args, qk_int8=True)
        dq, ds = flash_attention_ln_qkv_fused_q8(*args)
        got, ref = oq.float() * os_, pq.float() * ps
        name = (f"flash_attention_ln_qkv_fused_q8 i8qk (8,{t},{d}) {heads} "
                f"heads{', 10x weight scales' if one_hot else ''}")
        if one_hot:
            whole = float((got - ref).abs().max() / ref.abs().max())
            print(f"  {name}: against the whole twin {whole:.4g} of "
                  f"max|plain| (not gated)")
            xq, sx = ln_quantize_rows(x, *weights[:2])
            pq, ps = quantize_rows(_qkv_attention_plain(
                xq, sx, *weights[2:], heads, scale, vl, qk_int8=True))
            ref = pq.float() * ps
            name += " on B3's codes"
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        miss = float((dq.float() * ds - ref).abs().max() / ref.abs().max())
        equal = float((oq == pq).float().mean())
        gate = f"gate: > {LNQKV_REL:g}" if one_hot else "not gated"
        print(f"  {name} valid_len={vl}: dequant max_abs {err:.6g} = "
              f"{rel:.4g} of max|plain| (tol {LNQKV_REL:g}), codes equal "
              f"{equal:.6f}; the default mode's kernel against this twin "
              f"{miss:.4g} of max|plain| ({gate})")
        if not torch.isfinite(got).all() or rel > LNQKV_REL:
            fail(f"{name}: the int8 Q.K^T mode disagrees with its plain "
                 f"twin")
        if one_hot and miss <= LNQKV_REL:
            fail(f"{name}: the default mode's kernel agrees with the int8 "
                 f"Q.K^T twin as well, so the check cannot tell the modes "
                 f"apart")
        if (t, vl, one_hot) != (901, None, False):
            continue
        ms, plain_ms = _timed(
            "flash_attention_ln_qkv_fused_q8 i8qk", f"(8,{t},{d})",
            lambda: flash_attention_ln_qkv_fused_q8(*args, qk_int8=True),
            lambda: flash_attention_ln_qkv_fused_q8_plain(*args,
                                                          qk_int8=True))
        bf16_ms = cuda_time_ms(lambda: flash_attention_ln_qkv_fused_q8(*args))
        print(f"  the default (bf16 Q.K^T) mode on the same inputs: "
              f"{bf16_ms:.4f} ms")
        # the qkv product and Q.K^T in int8, P.V in bf16
        qk = 2 * 8 * heads * t * t * 64
        row = result(err, ms, plain_ms,
                     nbytes(x, *weights, oq, os_),
                     {"int8": 2 * 8 * t * d * 3 * d + qk, "bf16": qk})
        row["bf16_mode_ms"] = bf16_ms
        i8qk_args = args
        ATTN_RETIME["B2 flash_attention_ln_qkv_fused_q8 i8qk"] = (
            lambda: flash_attention_ln_qkv_fused_q8(*i8qk_args,
                                                    qk_int8=True))
    return row


def _b4_kernels(dev, g):
    """B4 (the wgmma tile) at the lowres head (normalize=False, its row)
    and the half-res logits head (normalize=True, its "h2" entry): within
    HEAD1_* of the plain twin, and bit for bit against the mma.sync B4
    kernel (`head1_correlate_fused_mma`, its own row), as at K = 300 and
    at ragged M in both modes. Each check calls the kernel under test
    first, so that its output's memory held nothing of the yardstick's."""
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_fused,
        head1_correlate_fused_mma,
        head1_correlate_fused_plain,
    )

    results = {}
    w1q = torch.randint(-127, 128, (512, 256), device=dev, generator=g,
                        dtype=torch.int8)
    s1 = 1e-3 * torch.rand(512, device=dev, generator=g) + 1e-4
    b1 = 0.1 * torch.randn(512, device=dev, generator=g)
    txt = torch.randn(150, 512, device=dev, generator=g)
    sx = torch.tensor(0.02, device=dev)

    def same_as_mma(name, args):
        got = head1_correlate_fused(*args)
        ref = head1_correlate_fused_mma(*args)
        torch.cuda.synchronize()
        differ = int((got.view(torch.int16) != ref.view(torch.int16)).sum())
        print(f"  {name}: equal to the mma.sync kernel bit for bit: "
              f"{differ == 0} ({differ} of {got.numel()} differ)")
        if differ:
            fail(f"head1_correlate_fused {name}: differs from the mma.sync "
                 f"B4 kernel")
        return got

    for shape, normalize in (((8, 120, 120, 256), False),
                             ((8, 240, 240, 256), True)):
        xq = torch.randint(-127, 128, shape, device=dev, generator=g,
                           dtype=torch.int8)
        args = (xq, sx, w1q, s1, b1, txt, 1.0 / 0.07, normalize)
        name = f"{shape}->K=150 normalize={normalize}"
        got = same_as_mma(name, args)
        err = check_close(f"head1_correlate_fused {name}", got,
                          head1_correlate_fused_plain(*args), HEAD1_RTOL,
                          HEAD1_ATOL)
        del got
        ms, plain_ms = _timed("head1_correlate_fused", name,
                              lambda: head1_correlate_fused(*args),
                              lambda: head1_correlate_fused_plain(*args))
        m = xq.numel() // 256
        row = result(err, ms, plain_ms,
                     nbytes(xq, w1q, s1, b1, txt) + m * 150 * 2,
                     {"int8": 2 * m * 256 * 512, "bf16": 2 * m * 512 * 150})
        if not normalize:
            results["head1_correlate_fused"] = row
            mma_ms = cuda_time_ms(lambda: head1_correlate_fused_mma(*args))
            print(f"  head1_correlate_fused_mma {name}: kernel {mma_ms:.4f} "
                  f"ms")
            results["head1_correlate_fused_mma"] = result(
                float((head1_correlate_fused_mma(*args).float()
                       - head1_correlate_fused_plain(*args).float()
                       ).abs().max()), mma_ms, plain_ms,
                nbytes(xq, w1q, s1, b1, txt) + m * 150 * 2,
                {"int8": 2 * m * 256 * 512, "bf16": 2 * m * 512 * 150})
        else:
            results["head1_correlate_fused"]["h2"] = row
    # two label chunks (K = 300) on two images of the half-res shape, and
    # ragged M (143 and 286 pixels: a last step of 15 or 30) in both modes
    xq = torch.randint(-127, 128, (2, 240, 240, 256), device=dev,
                       generator=g, dtype=torch.int8)
    t300 = torch.randn(300, 512, device=dev, generator=g)
    for normalize in (False, True):
        same_as_mma(f"(2, 240, 240, 256)->K=300 normalize={normalize}",
                    (xq, sx, w1q, s1, b1, t300, 1.0 / 0.07, normalize))
        for n in (1, 2):
            small = xq[:n, :13, :11].contiguous()
            same_as_mma(f"{tuple(small.shape)}->K=150 normalize={normalize}",
                        (small, sx, w1q, s1, b1, txt, 1.0 / 0.07, normalize))
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
    # the edges of its walk: one source column, one source row, an odd K
    # (strips rounded out to 16 bytes, a blended pitch of 154), K = 1536
    # (the widest the wrapper takes: strips of 8 or 16 output columns);
    # labels repeating every 6 (ties) and logits holding NaNs
    for shape in ((2, 60, 1, 150), (2, 1, 240, 150), (2, 240, 240, 151),
                  (1, 24, 40, 1536)):
        x = torch.randn(shape, device=dev, generator=g)
        nan = x.clone()
        nan.view(-1)[torch.randint(0, x.numel(), (5,), device=dev,
                                   generator=g)] = float("nan")
        ties = x[..., torch.arange(shape[-1], device=dev) % 6].contiguous()
        for dt in (torch.float32, torch.bfloat16):
            for name, lg in (("random", x), ("ties", ties), ("NaN", nan)):
                lg = lg.to(dt)
                if _labels_equal(
                        f"upsample2x_argmax {shape} {dt} {name}",
                        upsample2x_argmax(lg), upsample2x_argmax_plain(lg),
                        shape[-1]) < UPARGMAX_MIN_EQUAL:
                    fail("upsample2x_argmax: kernel disagrees with its plain "
                         "version")
        del x, nan, ties
    up = 8 * 480 * 480 * 150
    for dt in (torch.float32, torch.bfloat16):
        lg = logits.to(dt)
        lab = upsample2x_argmax(lg)
        ms, plain_ms = _timed("upsample2x_argmax", f"(8,240,240,150) {dt}",
                              lambda: upsample2x_argmax(lg),
                              lambda: upsample2x_argmax_plain(lg))
        nchw = lg.permute(0, 3, 1, 2)
        lib_ms = cuda_time_ms(lambda: torch.nn.functional.interpolate(
            nchw, scale_factor=2, mode="bilinear",
            align_corners=True).argmax(1))
        row = result(
            1.0 - float((lab == upsample2x_argmax_plain(lg)).float().mean()),
            ms, plain_ms, nbytes(lg, lab), {"fp32": 3 * up // 2 + 3 * up},
            lib_ms)
        if dt == torch.float32:
            results["upsample2x_argmax"] = row
        else:
            results["upsample2x_argmax"]["bf16"] = row
        del lg, lab, nchw
    del logits

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
    ms_i8, plain_i8 = _timed(
        "head1_correlate_argmax_fused", "(8,240,240,256) int8 -> K=150",
        lambda: head1_correlate_argmax_fused(xq, sx, w1q, s1, b1, txt),
        lambda: head1_correlate_argmax_fused_plain(xq, sx, w1q, s1, b1,
                                                   txt))
    m = path1.numel() // 256
    head_ops = {"int8": 2 * m * 256 * 512, "bf16": 2 * m * 512 * 150}
    results["head1_correlate_argmax_fused"] = result(
        1.0 - float((got["bf16"] == head1_correlate_argmax_fused_plain(
            path1, sx, w1q, s1, b1, txt)).float().mean()),
        ms, plain_ms, nbytes(path1, w1q, s1, b1, txt, got["bf16"]), head_ops)
    results["head1_correlate_argmax_fused"]["int8"] = result(
        1.0 - float((got["int8"] == head1_correlate_argmax_fused_plain(
            xq, sx, w1q, s1, b1, txt)).float().mean()),
        ms_i8, plain_i8, nbytes(xq, w1q, s1, b1, txt, got["int8"]), head_ops)
    _correlate_sum_probe(xq, sx, w1q, s1, b1, txt)
    return results


def _correlate_sum_probe(xq, sx, w1q, s1, b1, txt):
    """Printed, not gated: whether wgmma m64n64k16 bf16 sums the
    flagship's bf16(e) . tn^T (B5's head inputs, the text with B13's and
    B14's temperature) to mma.sync m16n8k16's bits, k16 steps in the same
    order (`correlate_sum_probe`)."""
    from lseg_tpu_torch.ops.head1_correlate import (
        correlate_sum_probe,
        text_matrix,
    )
    from lseg_tpu_torch.ops.quant import int8_mm

    ef = (int8_mm(xq.reshape(-1, xq.shape[-1]), w1q).float() * (sx * s1)
          + b1).to(torch.bfloat16)
    sums_w, sums_m = correlate_sum_probe(ef, text_matrix(txt, 1.0 / 0.07))
    torch.cuda.synchronize()
    differ = int((sums_w != sums_m).sum())
    print(f"  probe: wgmma vs mma.sync bf16 k16 sums of {tuple(ef.shape)} . "
          f"{tuple(txt.shape)}^T bit-equal: {differ == 0} ({differ} of "
          f"{sums_w.numel()} differ, max |diff| "
          f"{float((sums_w - sums_m).abs().max()):.3g})")


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
        head1_correlate_fused_mma,
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
    # twin; bit for bit against the W-interp of the logits of the
    # mma.sync B4 kernel (`head1_correlate_fused_mma`, independent of the
    # wgmma tile that B4, B13 and B14 share)
    out = head1_correlate_wup_fused(*args)
    lo = head1_correlate_fused_mma(*args, True)
    env = w_interp_bf16(head1_correlate_fused_plain(*args, True).abs())
    err = check_close(f"head1_correlate_wup_fused {(n, h, w, c)}->K={k}",
                      out, head1_correlate_wup_fused_plain(*args),
                      WUP_RTOL, HEAD1_ATOL, env.float())
    del env
    same = torch.equal(out, w_interp_bf16(lo))
    print(f"  head1_correlate_wup_fused equals the W-interp of the mma.sync "
          f"kernel's logits bit for bit: {same}")
    if not same:
        fail("head1_correlate_wup_fused: differs from the W-interp of the "
             "mma.sync kernel's logits")
    ms, plain_ms = _timed("head1_correlate_wup_fused",
                          f"{(n, h, w, c)}->(8,240,480,150)",
                          lambda: head1_correlate_wup_fused(*args),
                          lambda: head1_correlate_wup_fused_plain(*args))
    _three_hundred_labels(dev, g, xq, w1q, s1, b1, e)
    # no single PyTorch call computes head1, the correlation and the
    # W-interp: library call none. fp32 work: the squared norm (2 per
    # element of e) and the blend (3 per output)
    results["head1_correlate_wup_fused"] = result(
        err, ms, plain_ms, nbytes(xq, w1q, s1, b1, txt, out),
        {**head_ops, "fp32": 2 * m * e + 3 * out.numel()})
    del out

    # B13: labels >= 0.999 equal; printed: agreement with the composition
    # mma.sync logits (normalize) -> x2 upsample in bf16 -> argmax
    lab = head1_correlate_upsample_argmax(*args)
    ref = head1_correlate_upsample_argmax_plain(*args)
    equal = _labels_equal(
        f"head1_correlate_upsample_argmax {(n, h, w, c)}->K={k}", lab, ref, k)
    if equal < HEAD_ARGMAX_MIN_EQUAL:
        fail("head1_correlate_upsample_argmax: kernel disagrees with its "
             "plain version")
    tail = _labels_equal("head1_correlate_upsample_argmax vs the plain "
                         "tail of the mma.sync kernel's logits", lab,
                         upsample_argmax_bf16(lo), k)
    if tail < UPARGMAX_MIN_EQUAL:
        fail("head1_correlate_upsample_argmax: differs from the plain tail "
             "of the mma.sync kernel's logits")
    comp = torch.argmax(upsample2x(lo, compute_dtype=torch.bfloat16).float(),
                        dim=-1).to(torch.int32)
    print(f"  head1_correlate_upsample_argmax vs mma.sync logits -> "
          f"upsample2x bf16 -> argmax: {_agree(lab, comp):.6f} (blend order "
          f"differs, not gated)")
    del comp, lo
    # every logit negative (embeddings below zero, text rows above), K =
    # 13: a padded label would win with its logit 0. The logits of all
    # pixels are then close, so near ties are many: gated bit for bit
    # against the plain tail of the mma.sync kernel's logits, the plain
    # twin printed
    neg_args = (xq[:1, :16, :16].contiguous(), sx, w1q,
                1e-4 * torch.ones(e, device=dev), -2.0 - 100 * s1,
                torch.rand(13, e, device=dev, generator=g) + 0.1, 1.0 / 0.07)
    neg = head1_correlate_upsample_argmax(*neg_args)
    lo_neg = head1_correlate_fused_mma(*neg_args, True)
    if not bool((lo_neg < 0).all()):
        fail("head1_correlate_upsample_argmax: the all-negative case has a "
             "logit >= 0")
    if _labels_equal("head1_correlate_upsample_argmax all-negative K=13 vs "
                     "the plain tail of the mma.sync kernel's logits", neg,
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


def _three_hundred_labels(dev, g, xq, w1q, s1, b1, e):
    """B14 and B13 at K = 300, two label chunks, on the first two images
    of the flagship's codes, under the gates of K = 150; both timed at the
    flagship's 8 images, printed."""
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_fused_mma,
        head1_correlate_fused_plain,
        head1_correlate_upsample_argmax,
        head1_correlate_upsample_argmax_plain,
        head1_correlate_wup_fused,
        head1_correlate_wup_fused_plain,
        upsample_argmax_bf16,
        w_interp_bf16,
    )

    k = 300
    txt = torch.randn(k, e, device=dev, generator=g)
    sx = torch.tensor(0.02, device=dev)
    args = (xq[:2].contiguous(), sx, w1q, s1, b1, txt, 1.0 / 0.07)
    shape = tuple(args[0].shape)
    out = head1_correlate_wup_fused(*args)
    lo = head1_correlate_fused_mma(*args, True)
    env = w_interp_bf16(head1_correlate_fused_plain(*args, True).abs())
    check_close(f"head1_correlate_wup_fused {shape}->K={k}", out,
                head1_correlate_wup_fused_plain(*args), WUP_RTOL,
                HEAD1_ATOL, env.float())
    del env
    if not torch.equal(out, w_interp_bf16(lo)):
        fail(f"head1_correlate_wup_fused K={k}: differs from the W-interp of "
             f"the mma.sync kernel's logits")
    print(f"  head1_correlate_wup_fused K={k} equals the W-interp of the "
          f"mma.sync kernel's logits bit for bit: True")
    del out
    lab = head1_correlate_upsample_argmax(*args)
    if _labels_equal(f"head1_correlate_upsample_argmax {shape}->K={k}", lab,
                     head1_correlate_upsample_argmax_plain(*args),
                     k) < HEAD_ARGMAX_MIN_EQUAL:
        fail(f"head1_correlate_upsample_argmax K={k}: kernel disagrees with "
             f"its plain version")
    if _labels_equal(f"head1_correlate_upsample_argmax K={k} vs the plain "
                     f"tail of the mma.sync kernel's logits", lab,
                     upsample_argmax_bf16(lo), k) < UPARGMAX_MIN_EQUAL:
        fail(f"head1_correlate_upsample_argmax K={k}: differs from the plain "
             f"tail of the mma.sync kernel's logits")
    del lab, lo
    full = (xq, sx, w1q, s1, b1, txt, 1.0 / 0.07)
    for name, fn in (("head1_correlate_wup_fused", head1_correlate_wup_fused),
                     ("head1_correlate_upsample_argmax",
                      head1_correlate_upsample_argmax)):
        print(f"  {name} {tuple(xq.shape)}->K={k}: kernel "
              f"{cuda_time_ms(lambda: fn(*full)):.4f} ms")


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
    from lseg_tpu_torch.ops.mlp import (
        mlp_fused,
        mlp_fused_max_clusters,
        mlp_fused_plain,
    )
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
    # one launch a call: the device kernels of one call, as the profiler
    # sees them, and the clusters of 8 CTAs the card holds at once
    names = _device_kernels(lambda: mlp_fused(*args))
    tiles = -(-m // 64)
    clusters = mlp_fused_max_clusters(d, dev)
    print(f"  mlp_fused: device kernels a call {names}; {tiles} clusters of "
          f"{d // 128} CTAs, {clusters} resident at once "
          f"({tiles / clusters:.2f} waves)")
    if len(names) != 1 or "mlp_fused_cluster_kernel" not in names[0]:
        fail(f"mlp_fused: one call launched {names}, not the one cluster "
             f"kernel")
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
    b15_args = args
    ATTN_RETIME["B15 flash_attention_qkvp_fused"] = (
        lambda: flash_attention_qkvp_fused(*b15_args))
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
    ATTN_RETIME["B9 flash_attention_ln_qkv_fused"] = (
        lambda: flash_attention_ln_qkv_fused(*args))
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


# B18's shapes on the fused decoder: (side, launches a request) of
# refinenet1's two RCUs, refinenet2's, refinenet3's and refinenet4's rcu2
RCU_SHAPES = ((120, 2), (60, 2), (30, 2), (15, 1))


def _decoder_kernels(dev, g):
    """B18 at the fused decoder's four shapes, (8, S, S, 256) for S = 120,
    60, 30, 15, each checked and timed, its row the sum over a request's
    seven launches; B19 at refinenet2's (8, 60, 60, 256) with bf16 out and
    at refinenet1's hand-off (8, 120, 120, 256) with int8 out."""
    from lseg_tpu_torch.ops.decoder import (
        fused_upsample_outconv,
        fused_upsample_outconv_plain,
    )
    from lseg_tpu_torch.ops.qconv import fused_rcu, fused_rcu_plain

    results = {}
    c = 256
    ops = _rcu_operands(dev, g, c)
    # per request: device ms, plain ms, bytes and operations, each shape's
    # sum weighted by its launches
    req = {"ms": 0.0, "plain_ms": 0.0, "moved": 0, "int8": 0, "fp32": 0,
           "err": 0.0}
    shapes = {}
    for side, launches in RCU_SHAPES:
        shape = (8, side, side, c)
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
        ms, plain_ms = _timed("fused_rcu", f"{shape}",
                              lambda: fused_rcu(x, *ops),
                              lambda: fused_rcu_plain(x, *ops))
        # the device time: at the small shapes the wrapper's host time
        # (tensor maps, ctypes) exceeds the kernel's
        dev_ms = _device_ms(lambda: fused_rcu(x, *ops))
        px = x.numel() // c
        # two 3x3 int8 convolutions; fp32 per element: quantize 3, affine
        # + relu 3, requantize 2, affine 2, residual 1
        moved, int8, fp32 = (nbytes(x, out, *ops), 2 * 2 * 9 * c * c * px,
                             11 * px * c)
        b_ms, _ = bound(moved, {"int8": int8, "fp32": fp32})
        print(f"    device {dev_ms:.4f} ms a call, bound {b_ms:.4f} ms, "
              f"{launches} a request")
        shapes[str(side)] = {"ms": dev_ms, "events_ms": ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms,
                             "launches_per_request": launches}
        req["ms"] += launches * dev_ms
        req["plain_ms"] += launches * plain_ms
        req["moved"] += launches * moved
        req["int8"] += launches * int8
        req["fp32"] += launches * fp32
        req["err"] = max(req["err"], err)
        del x, out
    # the row: a request's seven launches (device time, plain time, bytes
    # and operations summed; every shape is bound by its operations, so
    # the bound of the sums is the sum of the bounds). No single PyTorch
    # call computes the unit: library call none
    print(f"  fused_rcu a request (7 launches): device {req['ms']:.4f} ms, "
          f"plain {req['plain_ms']:.4f} ms")
    results["fused_rcu"] = result(
        req["err"], req["ms"], req["plain_ms"], req["moved"],
        {"int8": req["int8"], "fp32": req["fp32"]})
    results["fused_rcu"]["shapes"] = shapes

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
        device_ms = _device_ms(lambda: fused_upsample_outconv(*args))
        up = out.numel()
        # the 1x1 int8 product; fp32 per upsampled value: two H-blends and
        # the W-blend (3 each), quantize 2, epilogue 2 (+ 2 for int8). No
        # single PyTorch call computes it: library call none
        res = result(err, ms, plain_ms, nbytes(x, wq, sw, b, out),
                     {"int8": 2 * up * c, "fp32": 13 * up})
        res["device_ms"] = device_ms
        print(f"    device {device_ms:.4f} ms a call")
        if out_scale is None:
            results["fused_upsample_outconv"] = res
        else:
            handoff = res
        del x, out
    # the row is refinenet2's (3h and 3i); refinenet1's hand-off beside it
    results["fused_upsample_outconv"]["handoff"] = handoff
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
             ("fc2", (7208, 4096, 1024), f32, f32),
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
        dname = "bf16" if dt == bf else "fp32"
        ms, plain_ms = _timed("dense_residual", f"fc2 (7208,4096).(4096,1024) "
                              f"{dname} + {dname} residual",
                              lambda: dense_residual(*args, out_dtype=dt),
                              lambda: dense_residual_plain(*args,
                                                           out_dtype=dt))
        # the library call: addmm with the residual plus the broadcast bias
        # as its input, that sum made outside the timed region
        x, w, b, r = args
        c = (r.float() + b).to(dt)
        lib_ms = cuda_time_ms(lambda: torch.addmm(c, x, w))
        m, k = x.shape
        # fp32: the product in fp32 FMAs or as split-TF32 products
        res = result(err, ms, plain_ms, nbytes(x, w, b, r, out),
                     {"bf16" if dt == bf else "fp32": 2 * m * k * w.shape[1]},
                     lib_ms, split_tf32=dt == f32)
        if dt == bf:
            results["dense_residual"] = res
        else:  # the fp32 mode's numbers beside the bf16 row's
            results["dense_residual"]["fp32"] = res
        del c
    del args, out

    # B20 bit for bit: M not a multiple of its 64-row tile, K = 64 (two
    # ranks of its cluster without k-steps), 192, 256; then the reference
    # probe's shape in both scale block shapes (the timed one last)
    for n, t, d in ((1, 1001, 1024), (2, 904, 64), (1, 77, 192),
                    (2, 904, 256)):
        args = probe.b20_inputs("rows", dev, g, n=n, t=t, d=d)
        check_close(f"int8_matmul_sliced_scale ({n},{t},{d})",
                    int8_matmul_sliced_scale(*args),
                    int8_matmul_sliced_scale_plain(*args), probe.B20_RTOL,
                    probe.B20_ATOL)
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
    # the wrapper call is host-bound: the kernel's device time alone, from
    # the profiler over back-to-back calls
    device_ms = _device_ms(lambda: int8_matmul_sliced_scale(*args))
    print(f"  int8_matmul_sliced_scale: device time {device_ms:.5f} ms a "
          f"call (torch.profiler), wrapper call {ms:.4f} ms")
    # the int8 product; fp32 per output: three products and three sums. No
    # single PyTorch call computes it: library call none
    m = args[0].numel() // 1024
    results["int8_matmul_sliced_scale"] = result(
        err, ms, plain_ms, nbytes(*args, out),
        {"int8": 2 * m * 1024 * 128, "fp32": 6 * m * 128})
    results["int8_matmul_sliced_scale"]["device_ms"] = device_ms
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
        head1_correlate_fused_mma,
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
            "head1_correlate_fused_mma": head1_correlate_fused_mma,
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

    print("[3b] serving fast_serving(clip_vitl16_384, 'static_cal'), int8")
    cfg = fast_serving(get_config("clip_vitl16_384"), "static_cal")
    vit = cfg.vit
    print(f"  attn {vit.attn_impl}, ln_quant_fused {vit.ln_quant_fused}, "
          f"mlp_act_cal {vit.mlp_act_cal}, quant_int8 {vit.quant_int8}; "
          f"decoder_quant {cfg.decoder_quant}, head_fused {cfg.head_fused},"
          f" decoder_conv_first {cfg.decoder_conv_first}")
    g = torch.Generator(device=dev).manual_seed(SEED)
    ref32 = _fp32_reference(dev, g)
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


def _fp32_reference(dev, g):
    """The fast config's function unquantized in fp32 (`fast_serving(
    clip_vitl16_384, False)` with xla attention, fp32 scores and head, no
    patch kernel), seeded `random_init_` from `g`: the source of the int8
    trees and the reference of d_ref."""
    from lseg_tpu_torch import fast_serving, get_config
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet

    fast = fast_serving(get_config("clip_vitl16_384"), quant=False)
    ref_cfg = dataclasses.replace(fast, head_dtype="float32",
                                  vit=dataclasses.replace(
                                      fast.vit, attn_impl="xla",
                                      attn_scores_dtype="float32",
                                      patch_fused=False))
    return random_init_(LSegNet(ref_cfg, torch.float32, dev), g).eval()


def _int8_logits_gate(tag, model, plain, ref32, request, cache,
                      what="int8", **kw):
    """Logits of `model(images, txt, **kw)` on the kernel path vs the plain
    path (`what`: its kind, for the printout) vs the fp32 model: d_kernel
    <= 2 d_ref + floor. Returns d_ref, |plain - fp32| max."""
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
          f"{d_kernel:.6g}, |plain {what} - fp32| max {d_ref:.6g}, max "
          f"|logit| {float(lr.abs().max()):.4g}; label agreement kernel vs "
          f"plain {agree:.4f}, plain vs fp32 {agree_ref:.4f} (not gated)")
    if d_kernel > SERVE_RATIO * d_ref + SERVE_FLOOR:
        fail(f"{tag}: kernel path deviates {d_kernel} > {SERVE_RATIO} * "
             f"{d_ref} + {SERVE_FLOOR}")
    return d_ref


def _quantized(cfg, dev, ref32, g, mlp_act_scale=True, images=None):
    """`cfg`'s int8 model from the fp32 model's weights (`quantize_tree`),
    calibrated on one seeded batch of 8 without text, as the reference's
    bench.py does (or on `images`); and its plain twin."""
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.quant import calibrate_act_scales, quantize_tree

    t0 = time.perf_counter()
    state = quantize_tree(ref32.state_dict(), decoder=True, act_scale=True,
                          mlp_act_scale=mlp_act_scale)
    model = LSegNet(cfg, torch.bfloat16, dev).eval()
    model.load_state_dict(state)
    del state
    if images is None:
        images = _images(g, dev, 8, 480, 480)
    calibrate_act_scales(model, images, None)
    plain = LSegNet(cfg, torch.bfloat16, dev, plain=True).eval()
    plain.load_state_dict(model.state_dict())
    torch.cuda.synchronize()
    scales = [v for k, v in model.state_dict().items()
              if k.endswith("act_scale")]
    if not scales or any(float(v) == 1.0 or not torch.isfinite(v)
                         for v in scales):
        fail("calibration left an act_scale at its placeholder")
    print(f"  quantize_tree + calibrate_act_scales (one batch of "
          f"{len(images)}): "
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

    launches_fp32 = _fp32_train_step(dev, counters)

    # (c) numbers at batch 8
    _train_timing("kernel path", states["kernel"], step, batch8, txt,
                  {key: counters[key] for key in fit_expect},
                  {"flash_attention_flat": 2 * blocks,
                   "flash_attention_flat_bwd": blocks})
    _train_timing("plain path", states["plain"], step, batch8, txt,
                  {key: counters[key] for key in fit_expect},
                  {"flash_attention_flat": 0, "flash_attention_flat_bwd": 0})
    return launches, launches_fp32


def _fp32_train_step(dev, counters):
    """(b2) One `--dtype float32` train step of a tiny flashflat config
    (ViT width 128, two heads of 64, depth 4; 64 x 64 synthetic batch of
    2) on the kernel path, which takes the fp32 modes of B6 and B7, and on
    the plain path from the same weights; the counters are set to 0 just
    before the kernel step and read just after (B6 = 2 x depth with
    remat, B7 = depth), and the ViT gradients must agree within
    TRAIN_FP32_GRAD_REL. Returns the kernel step's launches."""
    from lseg_tpu_torch.config import ViTConfig
    from lseg_tpu_torch.data.loader import DataLoader
    from lseg_tpu_torch.data.synthetic import SyntheticSegDataset
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.testing import tiny_vit_config
    from lseg_tpu_torch.train.optim import make_optimizer
    from lseg_tpu_torch.train.step import (
        TrainState,
        enable_grads,
        make_train_step,
    )

    cfg = tiny_vit_config(vit=ViTConfig(
        embed_dim=128, num_heads=2, depth=4, hooks=(0, 1, 2, 3),
        post_channels=(16, 32, 64, 64), pretrain_grid=4,
        attn_impl="flashflat"))
    depth = cfg.vit.depth
    batch = next(iter(DataLoader(SyntheticSegDataset(n=2, size=64,
                                                     num_classes=4), 2,
                                 shuffle=False, device=dev)))
    txt = torch.randn(4, cfg.out_c, device=dev,
                      generator=torch.Generator(dev).manual_seed(SEED))
    step = make_train_step()
    models, losses, launched = {}, {}, {}
    for name, plain in (("kernel", False), ("plain", True)):
        m = LSegNet(cfg, torch.float32, dev, plain=plain, remat=True,
                    param_dtype=torch.float32)
        random_init_(m, torch.Generator(dev).manual_seed(SEED))
        enable_grads(m)
        state = TrainState(m, make_optimizer(m, 0.004, 10, batch_size=2))
        for fn in counters.values():
            fn.launches = 0
        _, metrics = step(state, batch, txt)
        torch.cuda.synchronize()
        launched[name] = {k: fn.launches for k, fn in counters.items()
                          if fn.launches}
        models[name], losses[name] = m, float(metrics["loss"])
    d, _ = _vit_grad_deviation(models["kernel"], models["plain"], depth)
    print(f"  (b2) fp32 train step, tiny flashflat config: losses {losses}, "
          f"launches {launched['kernel']}, ViT gradients |kernel - plain| / "
          f"|plain| {d:.6g} (bound {TRAIN_FP32_GRAD_REL:g})")
    expect = {"flash_attention_flat": 2 * depth,
              "flash_attention_flat_bwd": depth}
    if launched["kernel"] != expect or launched["plain"]:
        fail(f"fp32 train step: launches {launched}, expected {expect} on "
             f"the kernel path and none on the plain path")
    if not (losses["kernel"] == losses["kernel"]
            and d <= TRAIN_FP32_GRAD_REL):
        fail(f"fp32 train step: loss {losses['kernel']}, gradient deviation "
             f"{d} > {TRAIN_FP32_GRAD_REL}")
    return launched["kernel"]


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


def _check_loaded(what, loaded, key_map, written):
    """Every tensor of a loaded state_dict against the written lang-seg
    tensor its key map names, through the map's layout change, bit for
    bit."""
    if set(loaded) != set(key_map):
        fail(f"{what}: loaded keys differ from the key map: "
             f"{sorted(set(loaded) ^ set(key_map))[:5]}")
    for name, (ref, fn) in key_map.items():
        want = torch.from_numpy(fn(written[ref].numpy()))
        got = loaded[name]
        if got.dtype != torch.float32 or not torch.equal(got, want):
            fail(f"{what}: {name} differs from the written {ref}")
    n = sum(t.numel() for t in loaded.values())
    print(f"  {what}: {len(loaded)} tensors, {n / 1e6:.1f} M values, each "
          f"equal bit for bit to the written one")


def _check_written(path, cfg, state, text_state):
    """Both loaded state_dicts against the `.ckpt` at `path` as
    `torch.load` reads it, bit for bit through the key maps."""
    from lseg_tpu_torch.utils.checkpoint_convert import (
        lseg_key_map,
        text_key_map,
    )

    written = {k[len("net."):]: v for k, v in torch.load(
        path, map_location="cpu", weights_only=True)["state_dict"].items()}
    _check_loaded("LSegNet state", state, lseg_key_map(cfg), written)
    _check_loaded("text state", text_state, text_key_map(written), written)


def _write_lang_seg_ckpt(path, cfg, state, text_state):
    """The port's `state` (LSegNet) and `text_state` (CLIPTextEncoder)
    written as a lang-seg Lightning `.ckpt`: each tensor under the
    reference key the loader's key maps name, through the inverse of the
    map's layout change (the patch embed's rows back to a conv weight)."""
    import numpy as np

    from lseg_tpu_torch.utils.checkpoint_convert import (
        lseg_key_map,
        patch_rows,
        text_key_map,
    )

    p = cfg.vit.patch_size
    sd = {}
    for what, st, key_map in (
            ("LSegNet state", state, lseg_key_map(cfg)),
            ("text state", text_state, text_key_map({}, cfg.text.layers))):
        if set(st) != set(key_map):
            fail(f"{what}: keys differ from the key map: "
                 f"{sorted(set(st) ^ set(key_map))[:5]}")
        for name, (ref, fn) in key_map.items():
            a = st[name].detach().float().cpu().numpy()
            if fn is patch_rows:
                a = a.reshape(p, p, -1, a.shape[1]).transpose(3, 2, 0, 1)
            elif fn(a) is not a:
                fail(f"{what}: no inverse for the layout change of {name}")
            sd[f"net.{ref}"] = torch.from_numpy(np.ascontiguousarray(a))
    torch.save({"state_dict": sd}, path)


def _eval_sample(g, dev, h, w):
    """An ADE20K-shaped sample: a normalized image in [-1, 1] and a target
    of 150 classes with void (-1)."""
    image = torch.rand(h, w, 3, device=dev, generator=g) * 2.0 - 1.0
    target = torch.randint(-1, 150, (h, w), device=dev, generator=g)
    return {"image": image, "target": target}


def _center_crop(sample, crop):
    h, w = sample["image"].shape[:2]
    y, x = (h - crop) // 2, (w - crop) // 2
    return {k: v[y:y + crop, x:x + crop] for k, v in sample.items()}


def _tta_sums(tag, logits_fn, image, txt, counters=None, expected=None):
    from lseg_tpu_torch.engine.tta import ADE20K_PROTOCOL, MultiScaleEvaluator

    ev = MultiScaleEvaluator(logits_fn, txt.shape[0], ADE20K_PROTOCOL)
    if counters is not None:
        for fn in counters.values():
            fn.launches = 0
    t0 = time.perf_counter()
    sums = ev(image, txt, return_logits=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if (sums.shape != (*image.shape[:2], txt.shape[0])
            or not torch.isfinite(sums).all()):
        fail(f"TTA {tag}: sums {tuple(sums.shape)} not finite or misshaped")
    line = f"  TTA {tag}: sums {tuple(sums.shape)}, {dt:.3f} s (first image)"
    if counters is not None:
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {k: expected.get(k, 0) for k in counters}
        line += f", launches { {k: v for k, v in launches.items() if v} }"
        if launches != want:
            print(line)
            fail(f"TTA {tag}: expected launches {want}, got {launches}")
    print(line)
    return ev, sums


def phase_evaluation(dev):
    """A reference checkpoint written and read back through the loader at
    the published widths, then the evaluation path on it: 6-scale + flip
    TTA on the fast_cal kernel path against its plain twins and fp32,
    single-scale flip metrics on fast_bf16, and `evaluate.run`."""
    from lseg_tpu_torch import evaluate, fast_serving, get_config, get_labels
    from lseg_tpu_torch.engine.eval_single import SingleScaleEvaluator
    from lseg_tpu_torch.engine.serve import make_logits_fn
    from lseg_tpu_torch.models.clip_text import CLIPTextEncoder
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.metrics import SegmentationMetric
    from lseg_tpu_torch.testing import (
        write_reference_ckpt,
        write_reference_vocab,
    )
    from lseg_tpu_torch.text.cache import TextFeatureCache
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
    from lseg_tpu_torch.utils.checkpoint_convert import (
        load_reference_checkpoint,
    )

    print("[7] evaluation: a reference checkpoint through the loader, "
          "6-scale + flip TTA, single-scale eval, evaluate.run")
    t_phase = time.perf_counter()
    cfg = get_config("clip_vitl16_384")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt, vocab = os.path.join(tmp, "ref.ckpt"), os.path.join(
            tmp, "bpe_vocab.txt.gz")
        # a. write, load, hold bit for bit
        t0 = time.perf_counter()
        write_reference_ckpt(ckpt, cfg, seed=SEED)
        write_reference_vocab(vocab)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, text_state = load_reference_checkpoint(ckpt, cfg)
        t_load = time.perf_counter() - t0
        print(f"  reference .ckpt (ViT-L/16, features {cfg.features}, out_c "
              f"{cfg.out_c}, text {cfg.text.width} x {cfg.text.layers}): "
              f"{os.path.getsize(ckpt) / 2**30:.3f} GiB, written in "
              f"{t_write:.2f} s, loaded by load_reference_checkpoint in "
              f"{t_load:.2f} s")
        _check_written(ckpt, cfg, state, text_state)

        # a2. the same file format from phase 3's weight regime: the
        # writer's 0.1 randn drives the decoder's activations to ~1e10 at
        # these widths, so the evaluation below runs on seeded lecun-normal
        # weights (random_init_, as phases 3-6), written as a lang-seg
        # .ckpt and read back through the same loader
        g = torch.Generator(device=dev).manual_seed(SEED + 7)
        fast = fast_serving(cfg, quant=False)
        ref_cfg = dataclasses.replace(fast, head_dtype="float32",
                                      vit=dataclasses.replace(
                                          fast.vit, attn_impl="xla",
                                          attn_scores_dtype="float32",
                                          patch_fused=False))
        ref32 = random_init_(LSegNet(ref_cfg, torch.float32, dev), g).eval()
        text = random_init_(CLIPTextEncoder(cfg.text, device=dev), g)
        t0 = time.perf_counter()
        _write_lang_seg_ckpt(ckpt, cfg, ref32.state_dict(),
                             text.state_dict())
        t_write = time.perf_counter() - t0
        del text
        t0 = time.perf_counter()
        state, text_state = load_reference_checkpoint(ckpt, cfg)
        print(f"  phase 3's regime as a lang-seg .ckpt: written in "
              f"{t_write:.2f} s, loaded in {time.perf_counter() - t0:.2f} s")
        _check_written(ckpt, cfg, state, text_state)
        ref32.load_state_dict(state)

        # b. the ADE20K-150 text matrix from the loaded text tower
        tok = ClipBPETokenizer.from_file(vocab, cfg.text.context_length)
        cache = TextFeatureCache(cfg.text, text_state, tok, device=dev)
        ade = get_labels("ade20k")
        txt = cache(ade)
        if txt.shape != (150, cfg.out_c) or not torch.isfinite(txt).all():
            fail(f"text features {tuple(txt.shape)} not finite")

        # c. the calibrated fast_cal model with its plain twins from the
        # loaded fp32 model, calibrated on the two center crops that
        # evaluate.run calibrates on in f
        samples = [_eval_sample(g, dev, 512, 683),
                   _eval_sample(g, dev, 480, 640)]
        crops = [_center_crop(s, 480) for s in samples]
        model_q, plain_q = _quantized(
            fast_serving(cfg, "static_cal"), dev, ref32, g,
            images=torch.stack([c["image"] for c in crops]))

        # d. 6-scale + flip TTA on one 512x683 image: kernel, plain, fp32
        image = samples[0]["image"]
        blocks = cfg.vit.hooks[-1] + 1
        chunks = 5  # 18 crops, 4 a chunk, each run with its flips
        ev_k, sums_k = _tta_sums(
            "fast_cal kernel path", make_logits_fn(model_q), image, txt,
            _kernel_counters(),
            {"patch_embed": chunks, "ln_quantize_rows": chunks * blocks,
             "flash_attention_ln_qkv_fused_q8": chunks * blocks,
             "head1_correlate_fused": chunks})
        _, sums_p = _tta_sums("fast_cal plain path", make_logits_fn(plain_q),
                              image, txt)
        _, sums_r = _tta_sums("fp32 reference", make_logits_fn(ref32), image,
                              txt)
        d_kernel = float((sums_k - sums_p).abs().max())
        d_ref = float((sums_p - sums_r).abs().max())
        labels_k = sums_k.argmax(-1)
        print(f"  TTA sums: |kernel - plain| max {d_kernel:.6g}, |plain int8 "
              f"- fp32| max {d_ref:.6g}, max |sum| "
              f"{float(sums_r.abs().max()):.4g}; label agreement kernel vs "
              f"plain {_agree(labels_k, sums_p.argmax(-1)):.4f}, plain vs "
              f"fp32 {_agree(sums_p.argmax(-1), sums_r.argmax(-1)):.4f} "
              f"(not gated)")
        if d_kernel > SERVE_RATIO * d_ref + TTA_FLOOR:
            fail(f"TTA: kernel path deviates {d_kernel} > {SERVE_RATIO} * "
                 f"{d_ref} + {TTA_FLOOR}")
        del sums_p, sums_r
        again = ev_k(image, txt, return_logits=True)
        if not torch.equal(again, sums_k):
            fail("TTA: the kernel path's sums differ on a repeated image")
        del again

        # e. single-scale flip at batch 8 on fast_bf16: the flip-merged
        # logits and the metrics of the kernel path against its plain twin
        model_b = LSegNet(fast, torch.bfloat16, dev).eval()
        model_b.load_state_dict(state)
        plain_b = LSegNet(fast, torch.bfloat16, dev, plain=True).eval()
        plain_b.load_state_dict(state)
        images = _images(g, dev, 8, 480, 480)
        logits_r = SingleScaleEvaluator(make_logits_fn(ref32), 150,
                                        flip=True).logits(images, txt)
        targets = logits_r.argmax(-1)
        targets[:, :16] = -1  # a void band
        counters = _kernel_counters()
        for fn in counters.values():
            fn.launches = 0
        logits_k = SingleScaleEvaluator(make_logits_fn(model_b), 150,
                                        flip=True).logits(images, txt)
        launches = {k: fn.launches for k, fn in counters.items()}
        want = {k: 0 for k in counters}
        want.update({"patch_embed": 2, "flash_attention_flat": 2 * blocks})
        print(f"  single-scale launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        if launches != want:
            fail(f"single-scale: expected launches {want}, got {launches}")
        logits_p = SingleScaleEvaluator(make_logits_fn(plain_b), 150,
                                        flip=True).logits(images, txt)
        d_kernel = float((logits_k - logits_p).abs().max())
        d_ref = float((logits_p - logits_r).abs().max())
        valid = targets >= 0
        lab_k, lab_p = logits_k.argmax(-1), logits_p.argmax(-1)
        print(f"  single-scale flip-merged logits {tuple(logits_k.shape)}: "
              f"|kernel - plain| max {d_kernel:.6g}, |plain bf16 - fp32| "
              f"max {d_ref:.6g}, max |logit| "
              f"{float(logits_r.abs().max()):.4g}; label agreement kernel "
              f"vs plain {_agree(lab_k[valid], lab_p[valid]):.4f}, plain vs "
              f"fp32 {_agree(lab_p[valid], targets[valid]):.4f}")
        if d_kernel > SERVE_RATIO * d_ref + 2 * SERVE_FLOOR:
            fail(f"single-scale: kernel path deviates {d_kernel} > "
                 f"{SERVE_RATIO} * {d_ref} + {2 * SERVE_FLOOR}")
        metrics = {}
        for tag, logits in (("fast_bf16 kernel path", logits_k),
                            ("fast_bf16 plain path", logits_p)):
            metric = SegmentationMetric(150)
            metric.update(logits, targets)
            metrics[tag] = metric.get()
            print(f"  single-scale {tag}, against the fp32 model's labels: "
                  f"pixAcc {metrics[tag][0]:.6f} mIoU {metrics[tag][1]:.6f}")
        for what, k, p in zip(("pixAcc", "mIoU"), *metrics.values()):
            print(f"  {what}: |kernel - plain| {abs(k - p):.6f} (gate <= "
                  f"{METRIC_FLOOR})")
            if abs(k - p) > METRIC_FLOOR:
                fail(f"single-scale {what}: kernel {k} vs plain {p}")
        del model_b, plain_b, ref32, plain_q, logits_k, logits_p, logits_r

        # f. evaluate.run over the two samples in memory
        args = evaluate.parse_args([
            "--weights", ckpt, "--bpe_vocab", vocab, "--fast", "--int8",
            "--int8-cal", "2", "--logdir", os.path.join(tmp, "logs"),
            "--device", str(dev)])
        t0 = time.perf_counter()
        model_e, txt_e, labels = evaluate.build(args)
        print(f"  evaluate.build: {time.perf_counter() - t0:.2f} s")
        if not torch.equal(txt_e, txt):
            fail("evaluate.build: text features differ from the cache's")
        preds = {}
        pa, miou, per_class = evaluate.run(
            args, model_e, txt_e, labels, samples, cal_dataset=crops,
            sink=preds.__setitem__)
        if len(per_class) != 150 or not 0.0 <= pa <= 1.0:
            fail(f"evaluate.run: pixAcc {pa}, {len(per_class)} IoUs")
        same = torch.equal(preds[0], labels_k.to(torch.int32))
        print(f"  evaluate.run on the image of d: labels equal d's argmax "
              f"{same} (agreement {_agree(preds[0], labels_k):.6f})")
        if not same:
            fail("evaluate.run: labels differ from the TTA argmax of d")
        del model_e

        # g. seconds per image of the protocol on the kernel path
        ev_k(image, txt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            labels_t = ev_k(image, txt)
        torch.cuda.synchronize()
        per_image = (time.perf_counter() - t0) / reps
        peak = torch.cuda.max_memory_allocated()
        # the protocol's five batch-8 forwards alone, on crops of the image
        batch = torch.cat([image[None, :480, :480]] * 4)
        batch = torch.cat([batch, batch.flip(2)])
        fwd = make_logits_fn(model_q)
        fwd(batch, txt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps * chunks):
            fwd(batch, txt)
        torch.cuda.synchronize()
        forwards = (time.perf_counter() - t0) / reps
        if not torch.equal(labels_t, labels_k.to(torch.int32)):
            fail("TTA: a repeated image gave other labels")
        print(f"  TTA 6 scales + flip, fast_cal kernel path, 512x683, "
              f"K=150: {per_image:.4f} s/image (mean of {reps} after one "
              f"warm-up image; its {chunks} batch-8 forwards alone "
              f"{forwards:.4f} s), peak memory {peak / 2**30:.3f} GiB "
              f"({resident / 2**30:.3f} GiB resident before; the canvases "
              f"alone 6 x 910 x 910 x 150 x 4 B = "
              f"{6 * 910 * 910 * 150 * 4 / 2**30:.3f} GiB); {card_line()}")
        del model_q
    print(f"  phase 7: {time.perf_counter() - t_phase:.1f} s")


# ---- phase 8: the other backbones and heads ----

FIVE_LABELS = ("plant", "grass", "cat", "stone", "other")
# text-width kernels of phase 8a: E = 640 (RN50x4's CLIP) and 768
# (RN50x16's), and ViT-B's D = 768 at ViT-B/32's T = 226 (480 x 480)
BACKBONE_TEXT_WIDTHS = (640, 768)
VITB32_TOKENS = 226
# the kernels phase 8's counted runs launch, and no other
BACKBONE_KERNELS = {"patch_embed", "flash_attention_flat", "ln_quantize_rows",
                    "flash_attention_ln_qkv_fused_q8",
                    "head1_correlate_fused", "head1_correlate_wup_fused",
                    "fused_correlate", "upsample2x_argmax"}


def _backbone_width_kernels(dev, g):
    """8a: B4 (lowres and H/2), B14 and B10 (fp32 mode, the streamed head)
    at E = 640 and 768, and B2 and B3 at D = 768, T = 226, each against
    its plain twin under phase 2's tolerances (B4 and B14 also bit for bit
    against the mma.sync B4 kernel's logits), with its time beside the
    plain twin's and its bound. Returns {kernel: {shape tag: row}}."""
    from lseg_tpu_torch.ops.flash_attention import (
        flash_attention_ln_qkv_fused_q8,
        flash_attention_ln_qkv_fused_q8_plain,
    )
    from lseg_tpu_torch.ops.fused_correlate import (
        fused_correlate,
        fused_correlate_plain,
    )
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_fused,
        head1_correlate_fused_mma,
        head1_correlate_fused_plain,
        head1_correlate_wup_fused,
        head1_correlate_wup_fused_plain,
        w_interp_bf16,
    )
    from lseg_tpu_torch.ops.ln_quant import (
        ln_quantize_rows,
        ln_quantize_rows_plain,
    )

    print("[8a] the kernels at the new widths")
    rows = {}
    sx = torch.tensor(0.02, device=dev)
    for e in BACKBONE_TEXT_WIDTHS:
        w1q = torch.randint(-127, 128, (e, 256), device=dev, generator=g,
                            dtype=torch.int8)
        s1 = 1e-3 * torch.rand(e, device=dev, generator=g) + 1e-4
        b1 = 0.1 * torch.randn(e, device=dev, generator=g)
        txt = torch.randn(150, e, device=dev, generator=g)
        for shape, normalize in (((8, 120, 120, 256), False),
                                 ((8, 240, 240, 256), True)):
            xq = torch.randint(-127, 128, shape, device=dev, generator=g,
                               dtype=torch.int8)
            args = (xq, sx, w1q, s1, b1, txt, 1.0 / 0.07, normalize)
            name = f"{shape} E={e} ->K=150 normalize={normalize}"
            got = head1_correlate_fused(*args)
            if not torch.equal(got, head1_correlate_fused_mma(*args)):
                fail(f"head1_correlate_fused {name}: differs from the "
                     f"mma.sync B4 kernel")
            err = check_close(f"head1_correlate_fused {name}", got,
                              head1_correlate_fused_plain(*args), HEAD1_RTOL,
                              HEAD1_ATOL)
            del got
            ms, plain_ms = _timed("head1_correlate_fused", name,
                                  lambda: head1_correlate_fused(*args),
                                  lambda: head1_correlate_fused_plain(*args))
            m = xq.numel() // 256
            rows.setdefault("head1_correlate_fused", {})[
                f"E{e}_{'h2' if normalize else 'lowres'}"] = result(
                err, ms, plain_ms, nbytes(xq, w1q, s1, b1, txt) + m * 300,
                {"int8": 2 * m * 256 * e, "bf16": 2 * m * e * 150})
        # B14 on two images of the H/2 rows of a 480 x 480 crop
        xq = torch.randint(-127, 128, (2, 240, 240, 256), device=dev,
                           generator=g, dtype=torch.int8)
        args = (xq, sx, w1q, s1, b1, txt, 1.0 / 0.07)
        name = f"(2, 240, 240, 256) E={e} ->K=150"
        got = head1_correlate_wup_fused(*args)
        if not torch.equal(got, w_interp_bf16(head1_correlate_fused_mma(
                *args, True))):
            fail(f"head1_correlate_wup_fused {name}: differs from the "
                 f"W-interp of the mma.sync B4 kernel's logits")
        env = w_interp_bf16(head1_correlate_fused_plain(*args).abs()).float()
        err = check_close(f"head1_correlate_wup_fused {name}", got,
                          head1_correlate_wup_fused_plain(*args), WUP_RTOL,
                          HEAD1_ATOL, magnitude=env)
        del got, env
        ms, plain_ms = _timed("head1_correlate_wup_fused", name,
                              lambda: head1_correlate_wup_fused(*args),
                              lambda: head1_correlate_wup_fused_plain(*args))
        m = xq.numel() // 256
        rows.setdefault("head1_correlate_wup_fused", {})[f"E{e}"] = result(
            err, ms, plain_ms, nbytes(xq, w1q, s1, b1, txt) + 2 * m * 300,
            {"int8": 2 * m * 256 * e, "bf16": 2 * m * e * 150})
        del xq
        # B10, the streamed head's fp32 mode, on bf16 embeddings at H/2
        emb = torch.randn(8, 240, 240, e, device=dev, generator=g
                          ).to(torch.bfloat16)
        name = f"(8, 240, 240, {e}) bf16 ->K=150"
        logits = fused_correlate(emb, txt)
        err = check_close(f"fused_correlate {name}", logits,
                          fused_correlate_plain(emb, txt), CORR_RTOL,
                          CORR_ATOL)
        ms, plain_ms = _timed("fused_correlate", name,
                              lambda: fused_correlate(emb, txt),
                              lambda: fused_correlate_plain(emb, txt))
        rows.setdefault("fused_correlate", {})[f"E{e}"] = result(
            err, ms, plain_ms, nbytes(emb, txt, logits),
            {"fp32": 2 * emb.numel() * 150})
        del emb, logits
    # B2 and B3 at ViT-B's width and ViT-B/32's tokens, batch 8
    d, t = 768, VITB32_TOKENS
    x = torch.randn(8, t, d, device=dev, generator=g).to(torch.bfloat16)
    ln_g = 1 + 0.1 * torch.randn(d, device=dev, generator=g)
    ln_b = 0.1 * torch.randn(d, device=dev, generator=g)
    # phase 2's weight scales: scores of a few units, as a model's
    wq = torch.randint(-127, 128, (3 * d, d), device=dev, generator=g,
                       dtype=torch.int8)
    sw = 1e-3 * torch.rand(3 * d, device=dev, generator=g)
    bias = 0.05 * torch.randn(3 * d, device=dev, generator=g)
    args = (x, ln_g, ln_b, wq, sw, bias, 12, 64 ** -0.5)
    name = f"(8, {t}, {d}) 12 heads"
    oq, os_ = flash_attention_ln_qkv_fused_q8(*args)
    pq, ps = flash_attention_ln_qkv_fused_q8_plain(*args)
    got, ref = oq.float() * os_, pq.float() * ps
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    print(f"  flash_attention_ln_qkv_fused_q8 {name}: dequant max_abs "
          f"{err:.6g} = {rel:.4g} of max|plain| (tol {LNQKV_REL:g})")
    if not torch.isfinite(got).all() or rel > LNQKV_REL:
        fail(f"flash_attention_ln_qkv_fused_q8 {name}: kernel disagrees "
             f"with its plain version")
    ms, plain_ms = _timed("flash_attention_ln_qkv_fused_q8", name,
                          lambda: flash_attention_ln_qkv_fused_q8(*args),
                          lambda: flash_attention_ln_qkv_fused_q8_plain(*args))
    rows["flash_attention_ln_qkv_fused_q8"] = {"D768_T226": result(
        err, ms, plain_ms, nbytes(x, ln_g, ln_b, wq, sw, bias, oq, os_),
        {"int8": 2 * 8 * t * d * 3 * d, "bf16": 4 * 8 * 12 * t * t * 64})}
    q, s = ln_quantize_rows(x, ln_g, ln_b)
    qp, sp = ln_quantize_rows_plain(x, ln_g, ln_b)
    diff = (q.int() - qp.int()).abs()
    equal = float((diff == 0).float().mean())
    s_rel = float(((s - sp).abs() / sp.abs()).max())
    print(f"  ln_quantize_rows (8, {t}, {d}): codes max diff "
          f"{int(diff.max())}, equal {equal:.6f}, scale max rel {s_rel:.3g}")
    if (int(diff.max()) > LNQ_MAX_CODE_DIFF or equal < LNQ_MIN_EQUAL
            or s_rel > LNQ_SCALE_RTOL):
        fail(f"ln_quantize_rows (8, {t}, {d}): kernel disagrees with its "
             f"plain version")
    ms, plain_ms = _timed("ln_quantize_rows", f"(8, {t}, {d})",
                          lambda: ln_quantize_rows(x, ln_g, ln_b),
                          lambda: ln_quantize_rows_plain(x, ln_g, ln_b))
    rows["ln_quantize_rows"] = {"D768_T226": result(
        float(diff.max()), ms, plain_ms, nbytes(x, ln_g, ln_b, q, s),
        {"fp32": 8 * 8 * t * d})}
    return rows


def _text_cache(dev, g, text_cfg):
    from lseg_tpu_torch.models.clip_text import CLIPTextEncoder
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.text.cache import TextFeatureCache
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer

    text = random_init_(CLIPTextEncoder(text_cfg, device=dev), g)
    return TextFeatureCache(text_cfg, text.state_dict(),
                            ClipBPETokenizer.for_tests(context_length=77),
                            device=dev)


def _ref32_model(cfg, dev, g):
    """The fp32 twin of `cfg`'s fast function (einsum attention with fp32
    scores, the patch matmul form, fp32 head) with seeded weights: the
    source of the served trees and the reference of d_ref."""
    from lseg_tpu_torch import fast_serving
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet

    fast = fast_serving(cfg, quant=False)
    vit = fast.vit and dataclasses.replace(
        fast.vit, attn_impl="xla", attn_scores_dtype="float32",
        patch_fused=False)
    ref_cfg = dataclasses.replace(fast, head_dtype="float32", vit=vit)
    return random_init_(LSegNet(ref_cfg, torch.float32, dev), g).eval()


def _path1_of(model, call):
    """(call's result, refinenet1's output in that call)."""
    seen = {}
    hook = model.refinenet1.register_forward_hook(
        lambda mod, args, out: seen.__setitem__("path1", out))
    try:
        out = call()
    finally:
        hook.remove()
    return out, seen["path1"]


def _lowres_labels_gate(tag, model, requests, cache):
    """The served labels of the lowres argmax head (B4 unnormalized at H/4,
    the logit upsample, the argmax) against the same head on B4's plain
    twin on the same path1."""
    from lseg_tpu_torch.ops.head1_correlate import head1_correlate_fused_plain
    from lseg_tpu_torch.ops.resize import upsample2x

    h1 = model.head1
    for name, labels, images in requests:
        txt = cache(labels)
        pred, path1 = _path1_of(model, lambda: _argmax_call(model)(images,
                                                                   txt))
        with torch.inference_mode():
            xq, sx = model._head1_codes(path1)
            s_lo = head1_correlate_fused_plain(
                xq.contiguous(), sx, h1.weight_q, h1.scale, h1.bias, txt,
                model.cfg.logit_scale, False)
            twin = torch.argmax(upsample2x(
                s_lo, align_corners=True, compute_dtype=torch.bfloat16
            ).float(), dim=-1).to(torch.int32)
        eq = _agree(pred[:, ::2, ::2], twin)
        print(f"  {tag} {name}: labels vs the lowres head on B4's plain twin"
              f" on the same path1 {eq:.6f} (gate >= {HEAD_SERVE_MIN_EQUAL})")
        if eq < HEAD_SERVE_MIN_EQUAL:
            fail(f"{tag} {name}: labels disagree with B4's plain twin")


def _streamed_labels_gate(tag, model, preds, requests, cache):
    """The streamed head's served labels against the plain twins of B10
    and B11 on the same embeddings."""
    from lseg_tpu_torch.ops.fused_correlate import fused_correlate_plain
    from lseg_tpu_torch.ops.upsample_argmax import upsample2x_argmax_plain

    for (name, labels, images), pred in zip(requests, preds):
        txt = cache(labels)
        with torch.inference_mode():
            twin = upsample2x_argmax_plain(fused_correlate_plain(
                model(images, None), txt, model.cfg.logit_scale))
        eq = _agree(pred, twin)
        print(f"  {tag} {name}: labels vs B10 + B11 plain twins on the same "
              f"embeddings {eq:.6f} (gate >= {HEAD_SERVE_MIN_EQUAL})")
        if eq < HEAD_SERVE_MIN_EQUAL:
            fail(f"{tag} {name}: labels disagree with the plain twins")


def _backbone_numbers(tag, call, plain_call, requests, cache):
    """ms/batch and peak memory of `call` and its plain twin on the
    batch-8 ADE-150 request, in turns: kernel, plain, kernel."""
    _, labels, images = requests[0]
    txt = cache(labels)
    _measure(f"{tag} kernel path", lambda: call(images, txt))
    _measure(f"{tag} plain path", lambda: plain_call(images, txt))
    _measure(f"{tag} kernel path (again)", lambda: call(images, txt))


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _add(total, launches):
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def phase_backbones(dev):
    """Phase 8: each registered backbone family other than ViT-L/16 with
    CLIP ViT-B/32 text, at full width with seeded weights, through the
    calls a user makes, each against its plain twin; returns the kernels'
    launches summed over its counted runs."""
    from lseg_tpu_torch import (
        CLIP_TEXT_VITB32,
        fast_serving,
        get_config,
        get_labels,
    )
    from lseg_tpu_torch.config import CLIP_TEXT_RN50X4, CLIP_TEXT_RN50X16
    from lseg_tpu_torch.engine.serve import make_predictor
    from lseg_tpu_torch.models.lseg import LSegNet

    t0 = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    widths = _backbone_width_kernels(dev, g)
    print("[8] the other backbones and heads at full width, 480x480, with "
          "seeded weights")
    caches = {512: _text_cache(dev, g, CLIP_TEXT_VITB32),
              640: _text_cache(dev, g, CLIP_TEXT_RN50X4),
              768: _text_cache(dev, g, CLIP_TEXT_RN50X16)}
    ade = get_labels("ade20k")
    requests = [("ade20k-150 b8 480x480", ade, _images(g, dev, 8, 480, 480)),
                ("5 labels b1 480x480", list(FIVE_LABELS),
                 _images(g, dev, 1, 480, 480))]
    total = {}
    vitl = {"patch_embed": 1, "ln_quantize_rows": 24,
            "flash_attention_ln_qkv_fused_q8": 24}
    vitb = {"patch_embed": 1, "ln_quantize_rows": 12,
            "flash_attention_ln_qkv_fused_q8": 12}

    def fast_cal(name, blocks, seed):
        """`name`'s fast_cal model from seeded fp32 weights through the
        argmax call: launches, the half-res logits gate and the lowres
        label gate, the numbers."""
        base = get_config(name)
        cfg = fast_serving(base, "static_cal")
        cache = caches[cfg.out_c]
        vit = cfg.vit
        print(f"  {name}: "
              + (f"ViT P={vit.patch_size} D={vit.embed_dim} "
                 f"{vit.num_heads} heads, blocks run {vit.hooks[-1] + 1}, "
                 f"attn {vit.attn_impl}" if vit else
                 f"ResNet layers {cfg.resnet.layers}")
              + f"; features {cfg.features}, out_c {cfg.out_c}, text width "
              f"{cfg.text.width}; head_fused {cfg.head_fused}, "
              f"decoder_conv_first {cfg.decoder_conv_first}")
        gen = torch.Generator(device=dev).manual_seed(SEED + seed)
        ref32 = _ref32_model(base, dev, gen)
        model, plain = _quantized(cfg, dev, ref32, gen)
        _, launches = _serve_requests(
            f"{name} fast_cal", _argmax_call(model), requests, cache,
            _kernel_counters(), {**blocks, "head1_correlate_fused": 1})
        _add(total, launches)
        _lowres_labels_gate(f"{name} fast_cal", model, requests, cache)
        _int8_logits_gate(f"{name} fast_cal half-res", model, plain, ref32,
                          requests[1], cache, return_halfres=True)
        _backbone_numbers(f"{name} fast_cal", _argmax_call(model),
                          _argmax_call(plain), requests, cache)
        return cfg, cache, ref32, model, plain

    def streamed(name, model, plain, cache, blocks):
        predict = make_predictor(model, use_pallas=True)
        preds, launches = _serve_requests(
            f"{name} streamed", predict, requests, cache, _kernel_counters(),
            {**blocks, "fused_correlate": 1, "upsample2x_argmax": 1})
        _add(total, launches)
        _streamed_labels_gate(f"{name} streamed", model, preds, requests,
                              cache)
        _backbone_numbers(f"{name} streamed", predict,
                          make_predictor(plain, use_pallas=True), requests,
                          cache)

    # ViT-B/16: fast_cal, then the fast_bf16 predictor on the same weights
    cfg, cache, ref32, model, plain = fast_cal("clip_vitb16_384", vitb, 81)
    bcfg = fast_serving(get_config("clip_vitb16_384"), quant=False)
    print(f"  clip_vitb16_384 fast_bf16: attn {bcfg.vit.attn_impl}, "
          f"patch_fused {bcfg.vit.patch_fused}")
    bf16 = LSegNet(bcfg, torch.bfloat16, dev).eval()
    bf16.load_state_dict(ref32.state_dict())
    bf16_plain = LSegNet(bcfg, torch.bfloat16, dev, plain=True).eval()
    bf16_plain.load_state_dict(ref32.state_dict())
    _, launches = _serve_requests(
        "clip_vitb16_384 fast_bf16", make_predictor(bf16), requests, cache,
        _kernel_counters(), {"patch_embed": 1, "flash_attention_flat": 12})
    _add(total, launches)
    _int8_logits_gate("clip_vitb16_384 fast_bf16 half-res", bf16,
                      bf16_plain, ref32, requests[1], cache, what="bf16",
                      return_halfres=True)
    _backbone_numbers("clip_vitb16_384 fast_bf16", make_predictor(bf16),
                      make_predictor(bf16_plain), requests, cache)
    del cfg, ref32, model, plain, bf16, bf16_plain
    _free()

    # ViT-B/32 (B1 at P = 32, B2 and B3 at T = 226), with ViT-B/32's and
    # with RN50x4's CLIP text (B4 at E = 640)
    for name, seed in (("clip_vitb32_384", 82), ("clipRN50x4_vitb32_384", 83)):
        fast_cal(name, vitb, seed)
        _free()

    # ViT-L/16 with RN50x16's CLIP text (E = 768): fast_cal, the 'wup'
    # logits call (B14), the streamed predictor on the int8 model (B10 +
    # B11 on its unfused head1 embeddings)
    name = "clipRN50x16_vitl16_384"
    cfg, cache, ref32, model, plain = fast_cal(name, vitl, 84)
    wcfg = dataclasses.replace(cfg, head_fused="wup")
    wup = LSegNet(wcfg, torch.bfloat16, dev).eval()
    wup.load_state_dict(model.state_dict())
    wup_plain = LSegNet(wcfg, torch.bfloat16, dev, plain=True).eval()
    wup_plain.load_state_dict(model.state_dict())
    _, launches = _serve_requests(
        f"{name} 'wup'",
        lambda images, txt: _logits_call(wup)(images, txt).argmax(-1).to(
            torch.int32), requests, cache, _kernel_counters(),
        {**vitl, "head1_correlate_wup_fused": 1})
    _add(total, launches)
    _int8_logits_gate(f"{name} 'wup' full-resolution", wup, wup_plain, ref32,
                      requests[1], cache)
    _backbone_numbers(f"{name} 'wup' logits", _logits_call(wup),
                      _logits_call(wup_plain), requests, cache)
    del wup, wup_plain
    _free()
    streamed(name, model, plain, cache, vitl)
    del cfg, ref32, model, plain
    _free()

    # ResNet-101: fast_cal (no ViT knob; the int8 decoder and the lowres
    # B4 head), the streamed predictor on the int8 model
    name = "clip_resnet101"
    cfg, cache, ref32, model, plain = fast_cal(name, {}, 85)
    streamed(name, model, plain, cache, {})
    del cfg, ref32, model, plain
    _free()

    # ViT-L/16 with the arch_option 1 and 2 head blocks, block_depth 2,
    # on fast_bf16: make_predictor's full-forward branch (B1, B6; the head
    # blocks stay plain)
    gen = torch.Generator(device=dev).manual_seed(SEED + 86)
    ref32 = None
    for option in (1, 2):
        name = f"clip_vitl16_384 arch_option={option} block_depth=2"
        base = get_config("clip_vitl16_384", arch_option=option,
                          block_depth=2)
        bcfg = fast_serving(base, quant=False)
        if ref32 is None:
            ref32 = _ref32_model(base, dev, gen)
            state = ref32.state_dict()
        else:
            ref32 = _ref32_model(base, dev, gen)
            ref32.load_state_dict(state)
        model = LSegNet(bcfg, torch.bfloat16, dev).eval()
        model.load_state_dict(state)
        plain = LSegNet(bcfg, torch.bfloat16, dev, plain=True).eval()
        plain.load_state_dict(state)
        print(f"  {name}: attn {bcfg.vit.attn_impl}, activation "
              f"{bcfg.activation}, head block "
              f"{type(model.head_block).__name__}")
        _, launches = _serve_requests(
            f"{name} fast_bf16", make_predictor(model), requests,
            caches[512], _kernel_counters(),
            {"patch_embed": 1, "flash_attention_flat": 24})
        _add(total, launches)
        _int8_logits_gate(f"{name} full-resolution", model, plain, ref32,
                          requests[1], caches[512], what="bf16")
        _backbone_numbers(f"{name} fast_bf16", make_predictor(model),
                          make_predictor(plain), requests, caches[512])
        del model, plain
        _free()
    del ref32, state, requests, caches
    _free()
    print(f"  phase 8 launches: { {k: v for k, v in total.items() if v} }, "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"  {card_line()}")
    return total, widths



# Phase 9: few-shot and zero-shot transfer (the JAX package's test_zs.py)
FEWSHOT_BATCH = 8
# Fold 0 of PASCAL-5i: classes 0-4 (1-based 1-5 in the masks); two images
# a class, written interleaved so that consecutive episodes differ in
# class and a pair rolled by one image is a wrong pair
FEWSHOT_CLASSES, FEWSHOT_PER_CLASS = 5, 2
FEWSHOT_KERNELS = {"patch_embed", "flash_attention_ln_qkv_fused_q8",
                   "ln_quantize_rows", "flash_attention_flat",
                   "flash_attention_flat_bwd"}


def _fewshot_tree(root):
    """A PASCAL-5i tree under `root`: VOC-sized JPEGs (375 x 500, smooth
    seeded colour fields), `SegmentationClassAug` masks holding the class
    (1-based) in a box with a 255 band along its left edge and the image's
    top rows, and `splits/pascal/val/fold0.txt`. Returns (datapath,
    splits_dir)."""
    import numpy as np
    from PIL import Image

    img_dir = os.path.join(root, "VOC2012", "JPEGImages")
    ann_dir = os.path.join(root, "VOC2012", "SegmentationClassAug")
    splits = os.path.join(root, "splits", "pascal", "val")
    for d in (img_dir, ann_dir, splits):
        os.makedirs(d)
    rng = np.random.RandomState(SEED + 9)
    h, w = 375, 500
    lines = []
    for j in range(FEWSHOT_PER_CLASS):
        for c in range(FEWSHOT_CLASSES):
            name = f"2008_{c:03d}{j:03d}"
            low = rng.randint(0, 255, (12, 16, 3)).astype(np.uint8)
            Image.fromarray(low).resize((w, h), Image.BILINEAR).save(
                os.path.join(img_dir, name + ".jpg"), quality=90)
            mask = np.zeros((h, w), np.uint8)
            y, x = rng.randint(10, h // 2), rng.randint(0, w // 2)
            mask[y:y + h // 2, x:x + w // 2] = c + 1
            mask[y:y + h // 2, x:x + 6] = 255
            mask[:5] = 255
            Image.fromarray(mask).save(os.path.join(ann_dir, name + ".png"))
            lines.append(f"{name}__{c + 1}")
    with open(os.path.join(splits, "fold0.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return root, os.path.join(root, "splits")


def _episode_batch(ds, dev, n=FEWSHOT_BATCH):
    """The first `n` episodes of `ds` on the card, and their class ids."""
    import numpy as np

    eps = [ds[i] for i in range(n)]
    batch = {k: torch.from_numpy(np.stack([e[k] for e in eps])).to(dev)
             for k in ("query_img", "query_mask", "query_ignore")}
    return batch, [int(e["class_id"]) for e in eps]


def _pairs(cache, labels, class_ids):
    return torch.stack([cache.pair_features(labels[c]) for c in class_ids])


def _idle(tag, counters, fn):
    """`fn()` with every kernel's counter at 0 before; all must stay 0."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    ran = {k: c.launches for k, c in counters.items() if c.launches}
    if ran:
        fail(f"{tag}: kernels launched {ran}, expected none")
    return out


def _zero_shot_gate(tag, model, images, pairs, counters):
    """E1: the episodic predictor's labels against the model's own argmax
    head given each image's pair, at the head's half resolution
    (`return_argmax=True, return_halfres=True`), and the full-resolution
    labels against the argmax of the model's own logits; no kernel may
    launch. The model's head takes one label set for its batch, so it runs
    once per pair on the whole batch and image i is read from the run with
    pair i: the same batch gives the same embeddings, where a batch of one
    would round its products otherwise."""
    from lseg_tpu_torch.engine.episodic import (
        make_episodic_predictor,
        pair_logits,
    )

    scale = model.cfg.logit_scale
    predict = make_episodic_predictor(model)
    n = images.shape[0]
    with torch.inference_mode():
        pred = _idle(f"{tag} predictor", counters,
                     lambda: predict(images, pairs))
        half = pair_logits(model(images, None), pairs, scale).argmax(-1)
        own = torch.stack([model(images, pairs[i], return_argmax=True,
                                 return_halfres=True)[i] for i in range(n)])
        full = torch.stack([model(images, pairs[i])[i].argmax(-1)
                            for i in range(n)])
    if pred.shape != images.shape[:3] or pred.dtype != torch.int32:
        fail(f"{tag}: labels {tuple(pred.shape)} {pred.dtype}")
    eq_half, eq_full = _agree(half, own), _agree(pred, full)
    nearest = _agree(pred, own.repeat_interleave(2, 1).repeat_interleave(
        2, 2))
    fg = float((pred == 1).float().mean())
    print(f"  E1 {tag}: labels {tuple(pred.shape)}, foreground share "
          f"{fg:.4f}; half-res labels vs the model's argmax head with each "
          f"image's pair {eq_half:.6f}, full-res labels vs the argmax of its "
          f"logits {eq_full:.6f} (gates >= {HEAD_SERVE_MIN_EQUAL}); vs the "
          f"head's nearest x2 {nearest:.6f} (not gated); 0 kernel launches")
    if eq_half < HEAD_SERVE_MIN_EQUAL or eq_full < HEAD_SERVE_MIN_EQUAL:
        fail(f"{tag}: episodic labels disagree with the model's own head")
    return predict


def _timed_batches(tag, fn):
    """ms a batch (CUDA events, 5 calls after 2) and peak memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    ms = cuda_time_ms(fn, warmup=2, iters=5)
    peak = torch.cuda.max_memory_allocated()
    print(f"  {tag}: {ms:.3f} ms/batch of {FEWSHOT_BATCH}, peak memory "
          f"{peak / 2**30:.3f} GiB ({resident / 2**30:.3f} GiB resident)")
    return ms


class _RecountingEpisodes:
    """A dataset proxy that remembers the episodes of the batch being
    read, and a predictor proxy that recounts, in numpy, each batch's
    {bg, fg} areas from its labels with the ignore region folded in, into
    float64 per-class buffers: an independent count of what the
    evaluator's meter must hold. A zero-shot PASCAL episode is its query
    image alone (`img_metadata[i % len]`, no support drawn), so episode i
    repeats every len(img_metadata): the proxy decodes each once and holds
    its first repeat equal, array for array, to a fresh decode."""

    def __init__(self, ds, predict):
        import numpy as np

        if ds.shot != 0:
            fail("E4: episodes repeat only with no support set")
        self.ds, self.inner = ds, predict
        self.class_ids = ds.class_ids
        n = max(self.class_ids) + 1
        self.inter = np.zeros((2, n))
        self.union = np.zeros((2, n))
        self.pending = []
        self.decoded, self.checked = {}, set()

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        import numpy as np

        key = i % len(self.ds.img_metadata)
        ep = self.decoded.get(key)
        if ep is None:
            ep = self.decoded[key] = self.ds[i]
        elif key not in self.checked:
            fresh = self.ds[i]
            if fresh.keys() != ep.keys() or not all(
                    np.array_equal(fresh[k], ep[k]) for k in ep):
                fail(f"E4: episode {i} differs from episode {key}")
            self.checked.add(key)
        self.pending.append(ep)
        return ep

    def predict(self, images, pairs):
        import numpy as np

        pred = self.inner(images, pairs)
        labels = pred.cpu().numpy()
        for ep, p in zip(self.pending, labels):
            valid = ~ep["query_ignore"]
            for r in (0, 1):
                pm, tm = (p == r) & valid, (ep["query_mask"] == r) & valid
                inter = float(np.sum(pm & tm))
                self.inter[r, int(ep["class_id"])] += inter
                self.union[r, int(ep["class_id"])] += (
                    float(np.sum(pm)) + float(np.sum(tm)) - inter)
        self.pending = []
        return pred

    def metrics(self):
        import numpy as np

        sel = np.asarray(self.class_ids)
        miou = 100 * float(np.mean(self.inter[1, sel]
                                   / np.maximum(self.union[1, sel], 1.0)))
        fb = 100 * float(np.mean(self.inter[:, sel].sum(1)
                                 / self.union[:, sel].sum(1)))
        return miou, fb


def _test_zs_cli(datapath, splits, ckpt, vocab, logpath):
    """E4: `python -m lseg_tpu_torch.test_zs` in a process of its own on
    the default device; returns its result line and its seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "lseg_tpu_torch.test_zs", "--dataset",
           "pascal", "--fold", "0", "--datapath", datapath, "--splits_dir",
           splits, "--weights", ckpt, "--bpe_vocab", vocab, "--backbone",
           "clip_vitl16_384", "--logpath", logpath]
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-4000:])
        fail(f"test_zs exited {proc.returncode}")
    lines = proc.stdout.strip().splitlines()
    print(f"  E4 python -m lseg_tpu_torch.test_zs (default device, "
          f"clip_vitl16_384, 1000 episodes, batch 8): {dt:.2f} s in its own "
          f"process; last lines: {lines[-2:]}")
    return lines[-1], dt


def _fewshot_train(dev, batch, pairs, counters):
    """E3: episodic training on the training CLI's configuration (ViT-L/16
    flashflat, remat, bf16 on fp32 masters) at batch 8: one step from the
    same weights on the kernel path, its plain twin and an fp32 model
    (loss and ViT gradients, `GRAD_RATIO` d_ref + `GRAD_FLOOR`), then five
    more kernel steps on the same episodes with ms/step and peak memory;
    every kernel step launches B6 = 2 x blocks, B7 = blocks. Returns the
    six kernel steps' launches."""
    from lseg_tpu_torch import get_config
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.train.episodic import make_episodic_train_step
    from lseg_tpu_torch.train.optim import make_optimizer
    from lseg_tpu_torch.train.step import TrainState, enable_grads

    base = get_config("clip_vitl16_384")
    cfg = dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, attn_impl="flashflat"))
    blocks = cfg.vit.hooks[-1] + 1
    g = torch.Generator(device=dev).manual_seed(SEED + 93)
    init = random_init_(LSegNet(cfg, torch.float32, dev), g)
    init_state = {n: t.clone() for n, t in init.state_dict().items()}
    del init
    step = make_episodic_train_step(cfg.logit_scale)
    expect = {k: 0 for k in counters}
    expect.update({"flash_attention_flat": 2 * blocks,
                   "flash_attention_flat_bwd": blocks})
    models, losses, states = {}, {}, {}
    launches = {k: 0 for k in counters}
    for name, dtype, plain in (("kernel", torch.bfloat16, False),
                               ("plain", torch.bfloat16, True),
                               ("fp32", torch.float32, True)):
        m = LSegNet(cfg, dtype, dev, plain=plain, remat=True,
                    param_dtype=torch.float32)
        m.load_state_dict(init_state)
        enable_grads(m)
        states[name] = TrainState(m, make_optimizer(
            m, 0.004, 100, batch_size=FEWSHOT_BATCH))
        for c in counters.values():
            c.launches = 0
        _, metrics = step(states[name], batch, pairs)
        got = {k: c.launches for k, c in counters.items()}
        want = expect if name == "kernel" else {k: 0 for k in counters}
        if got != want:
            fail(f"E3 {name} step: launches {got}, expected {want}")
        if name == "kernel":
            launches = got
        losses[name] = float(metrics["loss"])
        models[name] = m
        if name == "kernel":
            inter = metrics["inter"].cpu()
    torch.cuda.synchronize()
    if not all(v == v and abs(v) != float("inf") for v in losses.values()):
        fail(f"E3: a loss is not finite: {losses}")
    # the first step's loss, as a relative deviation under the gradients'
    # gate
    l_kernel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    l_ref = abs(losses["plain"] - losses["fp32"]) / abs(losses["fp32"])
    d_kernel, per_k = _vit_grad_deviation(models["kernel"], models["plain"],
                                          blocks)
    d_ref, _ = _vit_grad_deviation(models["plain"], models["fp32"], blocks)
    print(f"  E3 one episodic step at batch {FEWSHOT_BATCH}, losses "
          f"{losses}: |kernel - plain| / |plain| {l_kernel:.6g}, |plain bf16 "
          f"- fp32| / |fp32| {l_ref:.6g}; inter of the kernel step "
          f"{inter.tolist()[:2]} ...; ViT gradients |kernel - plain| / "
          f"|plain| {d_kernel:.6g}, |plain bf16 - fp32| / |fp32| "
          f"{d_ref:.6g}; worst block {max(per_k):.4g} (both bounds "
          f"{GRAD_RATIO} * ref + {GRAD_FLOOR:g})")
    if not l_kernel <= GRAD_RATIO * l_ref + GRAD_FLOOR:
        fail(f"E3: the kernel path's loss deviates {l_kernel} > {GRAD_RATIO} "
             f"* {l_ref} + {GRAD_FLOOR}")
    if not d_kernel <= GRAD_RATIO * d_ref + GRAD_FLOOR:
        fail(f"E3: kernel-path gradients deviate {d_kernel} > {GRAD_RATIO} "
             f"* {d_ref} + {GRAD_FLOOR}")
    del models, states["plain"], states["fp32"]
    _free()

    state = states["kernel"]
    step_losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        before = {k: c.launches for k, c in counters.items()}
        _, metrics = step(state, batch, pairs)
        delta = {k: c.launches - before[k] for k, c in counters.items()}
        if delta != expect:
            fail(f"E3 step {state.step}: launches {delta}, expected {expect}")
        step_losses.append(metrics["loss"])
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 5
    peak = torch.cuda.max_memory_allocated()
    step_losses = [float(v) for v in step_losses]
    print(f"  E3 five more kernel steps on the same episodes: losses "
          f"{[round(v, 5) for v in step_losses]} (first step "
          f"{losses['kernel']:.5f}); {ms:.3f} ms/step, train img/s "
          f"{FEWSHOT_BATCH * 1e3 / ms:.2f}, peak memory {peak / 2**30:.3f} "
          f"GiB ({resident / 2**30:.3f} GiB resident), launches per step "
          f"{ {k: v for k, v in expect.items() if v} }")
    if not step_losses[-1] < losses["kernel"]:
        fail(f"E3: the loss did not fall: {losses['kernel']} -> "
             f"{step_losses}")
    launches = {k: launches[k] + 5 * expect[k] for k in counters}
    del state, states
    _free()
    return launches


def phase_fewshot(dev, root):
    """Phase 9: few-shot / zero-shot transfer through the calls of the
    reference's test_zs.py: the binary ['others', class] head on test_zs's
    model (E1, ViT-L/16 and ResNet-101), the same predictor on fast_cal's
    embeddings (E2), episodic training (E3) and `python -m
    lseg_tpu_torch.test_zs` end to end (E4). Returns the launches of its
    counted runs (E2's batch, E3's kernel steps). The PASCAL-5i tree, the
    `.ckpt` and the vocabulary go into the directory `root` (phase 11
    reads them)."""
    from lseg_tpu_torch import fast_serving, get_config, get_labels
    from lseg_tpu_torch.data.fewshot import build_fewshot_dataset
    from lseg_tpu_torch.engine.episodic import (
        EpisodicEvaluator,
        make_episodic_predictor,
        pair_logits,
    )
    from lseg_tpu_torch.models.clip_text import CLIPTextEncoder
    from lseg_tpu_torch.ops.resize import upsample2x
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.testing import write_reference_vocab
    from lseg_tpu_torch.text.cache import TextFeatureCache
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
    from lseg_tpu_torch.utils.checkpoint_convert import (
        load_reference_checkpoint,
    )

    print("[9] few-shot / zero-shot transfer: the ['others', class] head, "
          "episodic training, python -m lseg_tpu_torch.test_zs")
    t_phase = time.perf_counter()
    counters = _kernel_counters()
    labels = get_labels("pascal")
    total = {k: 0 for k in counters}
    datapath, splits = _fewshot_tree(root)
    ckpt, vocab = (os.path.join(root, "zs.ckpt"),
                   os.path.join(root, "bpe_vocab.txt.gz"))
    write_reference_vocab(vocab)
    tok = ClipBPETokenizer.from_file(vocab)

    def dataset(imagenet_norm):
        return build_fewshot_dataset(
            "pascal", datapath, 0, "test", 0, splits_dir=splits,
            img_size=480, imagenet_norm=imagenet_norm, seed=0)

    # E1 on test_zs's model: seeded weights written as a lang-seg .ckpt
    # and loaded as test_zs loads them
    cfg = get_config("clip_vitl16_384")
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    t0 = time.perf_counter()
    ref32 = random_init_(LSegNet(cfg, torch.float32, dev), g)
    text = random_init_(CLIPTextEncoder(cfg.text, device=dev), g)
    _write_lang_seg_ckpt(ckpt, cfg, ref32.state_dict(),
                         text.state_dict())
    del ref32, text
    _free()
    state, text_state = load_reference_checkpoint(ckpt, cfg)
    model = LSegNet(cfg, torch.bfloat16, dev)
    model.load_state_dict(state)
    del state
    cache = TextFeatureCache(cfg.text, text_state, tok, device=dev)
    print(f"  test_zs's model: get_config(clip_vitl16_384) (attn "
          f"{cfg.vit.attn_impl}, head {cfg.head_dtype}) in bf16 from a "
          f"lang-seg .ckpt of seeded weights "
          f"({os.path.getsize(ckpt) / 2**30:.3f} GiB), written and "
          f"loaded in {time.perf_counter() - t0:.2f} s")
    ds = dataset(False)
    batch, class_ids = _episode_batch(ds, dev)
    pairs = _pairs(cache, labels, class_ids)
    print(f"  episodes 0-{FEWSHOT_BATCH - 1}: classes {class_ids}, "
          f"pairs {tuple(pairs.shape)}, ignore share "
          f"{float(batch['query_ignore'].float().mean()):.4f}")
    images = batch["query_img"]
    predict = _zero_shot_gate("clip_vitl16_384", model, images, pairs,
                              counters)
    _timed_batches("E1 clip_vitl16_384 predictor",
                   lambda: predict(images, pairs))

    rn_cfg = get_config("clip_resnet101")
    rn = random_init_(LSegNet(rn_cfg, torch.float32, dev), g)
    rn_model = LSegNet(rn_cfg, torch.bfloat16, dev)
    rn_model.load_state_dict(rn.state_dict())
    del rn
    rn_text = random_init_(CLIPTextEncoder(rn_cfg.text, device=dev), g)
    rn_cache = TextFeatureCache(rn_cfg.text, rn_text.state_dict(), tok,
                                device=dev)
    del rn_text
    rn_batch, _ = _episode_batch(dataset(True), dev)
    rn_pairs = _pairs(rn_cache, labels, class_ids)
    rn_predict = _zero_shot_gate("clip_resnet101 (ImageNet norm)",
                                 rn_model, rn_batch["query_img"],
                                 rn_pairs, counters)
    _timed_batches("E1 clip_resnet101 predictor",
                   lambda: rn_predict(rn_batch["query_img"], rn_pairs))
    del rn_model, rn_cache, rn_batch, rn_predict
    _free()

    # E2: the predictor on fast_cal's embeddings (B1, B2, B3)
    qcfg = fast_serving(cfg, "static_cal")
    ref32 = _ref32_model(cfg, dev, torch.Generator(
        device=dev).manual_seed(SEED))
    model_q, plain_q = _quantized(qcfg, dev, ref32, g)
    blocks = qcfg.vit.hooks[-1] + 1
    want = {k: 0 for k in counters}
    want.update({"patch_embed": 1, "flash_attention_ln_qkv_fused_q8":
                 blocks, "ln_quantize_rows": blocks})
    pq = make_episodic_predictor(model_q)
    for c in counters.values():
        c.launches = 0
    lab_k = pq(images, pairs)
    got = {k: c.launches for k, c in counters.items()}
    if got != want:
        fail(f"E2: launches {got}, expected {want}")
    for k, v in got.items():
        total[k] += v
    lab_p = _idle("E2 plain", counters,
                  lambda: make_episodic_predictor(plain_q)(images, pairs))
    with torch.inference_mode():
        lk, lp, lr = (pair_logits(m(images, None), pairs,
                                  cfg.logit_scale)
                      for m in (model_q, plain_q, ref32))
    d_kernel = float((lk - lp).abs().max())
    d_ref = float((lp - lr).abs().max())
    # labels where the plain twin's full-res margin between 'others'
    # and the class exceeds the logits bound (the upsample is a convex
    # blend, so no full-res logit strays further than the half-res
    # ones); random-weight near-ties below it may flip with a code
    bound = SERVE_RATIO * d_ref + SERVE_FLOOR
    up_p = upsample2x(lp, align_corners=True)
    clear = (up_p[..., 1] - up_p[..., 0]).abs() > bound
    n_clear = int(clear.sum())
    eq_clear = (float((lab_k == lab_p)[clear].float().mean())
                if n_clear else 0.0)
    print(f"  E2 fast_cal embeddings: launches "
          f"{ {k: v for k, v in got.items() if v} }; half-res pair "
          f"logits {tuple(lk.shape)}: |kernel - plain| max "
          f"{d_kernel:.6g}, |plain int8 - fp32| max {d_ref:.6g} (bound "
          f"{SERVE_RATIO} * d_ref + {SERVE_FLOOR} = {bound:.6g}); labels "
          f"equal to the plain twins' on {eq_clear:.6f} of the "
          f"{n_clear / lab_p.numel():.6f} of pixels whose plain margin "
          f"exceeds the bound (gate >= {HEAD_SERVE_MIN_EQUAL}), on "
          f"{_agree(lab_k, lab_p):.6f} of all (not gated)")
    if n_clear == 0:
        fail("E2: no pixel's plain margin exceeds the logits bound, so "
             "the label gate would count none")
    if eq_clear < HEAD_SERVE_MIN_EQUAL:
        fail(f"E2: kernel-path labels equal the plain twins' on "
             f"{eq_clear} < {HEAD_SERVE_MIN_EQUAL} of the clear pixels")
    if d_kernel > SERVE_RATIO * d_ref + SERVE_FLOOR:
        fail(f"E2: kernel path deviates {d_kernel} > {SERVE_RATIO} * "
             f"{d_ref} + {SERVE_FLOOR}")
    _timed_batches("E2 fast_cal kernel path", lambda: pq(images, pairs))
    _timed_batches("E2 fast_cal plain path",
                   lambda: make_episodic_predictor(plain_q)(images,
                                                            pairs))
    del model_q, plain_q, ref32, pq
    _free()

    # E3: episodic training
    launches_t = _fewshot_train(dev, batch, pairs, counters)
    for k, v in launches_t.items():
        total[k] += v

    # E4: test_zs end to end against the in-process evaluator on the
    # same 1000 episodes (the protocol's clamp; the ten images wrap)
    logpath = os.path.join(root, "logs")
    line, dt_cli = _test_zs_cli(datapath, splits, ckpt, vocab, logpath)
    log_file = os.path.join(logpath, "log_fewshot-test_pascal_fold0.txt")
    if not os.path.exists(log_file):
        fail(f"E4: test_zs wrote no {log_file}")
    with open(log_file) as f:
        logged = f.read().strip()
    if logged != line:
        fail(f"E4: the log holds {logged!r}, the command printed "
             f"{line!r}")
    rec = _RecountingEpisodes(ds, predict)
    t0 = time.perf_counter()
    miou, fb = _idle("E4 in-process evaluator", counters, lambda:
                     EpisodicEvaluator(rec.predict, ds.class_ids).run(
                         rec, lambda c: cache.pair_features(labels[c]),
                         batch_size=FEWSHOT_BATCH, log=lambda *_: None))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    want_line = (f"dataset=pascal fold=0 nshot=0 backbone="
                 f"clip_vitl16_384 mIoU={miou:.2f} FB-IoU={fb:.2f}")
    r_miou, r_fb = rec.metrics()
    print(f"  E4 in-process EpisodicEvaluator on the same {len(ds)} "
          f"episodes (each of the {len(ds.img_metadata)} distinct ones "
          f"decoded once): mIoU {miou:.6f} FB-IoU {fb:.6f}; numpy "
          f"recount of its labels with the ignore region folded in: "
          f"mIoU {r_miou:.6f} FB-IoU {r_fb:.6f}; {dt:.2f} s with the "
          f"recount (a harness time, not the evaluator's); the command "
          f"line {dt_cli:.2f} s per 1000 episodes, start-up, weights, "
          f"text tower and every decode included")
    if abs(miou - r_miou) > 1e-9 or abs(fb - r_fb) > 1e-9:
        fail(f"E4: the evaluator's meter ({miou}, {fb}) differs from the "
             f"recount ({r_miou}, {r_fb})")
    if line != want_line:
        fail(f"E4: test_zs printed {line!r}, the in-process evaluator "
             f"gives {want_line!r}")
    del model, cache, predict
    _free()
    print(f"  phase 9 launches: { {k: v for k, v in total.items() if v} }, "
          f"{time.perf_counter() - t_phase:.1f} s")
    print(f"  {card_line()}")
    return total


def _state_hash(model) -> torch.Tensor:
    """One int64 a state tensor: the sum of its 32-bit patterns, equal on
    two ranks whose states are equal bit for bit."""
    return torch.stack([t.detach().float().contiguous().view(torch.int32)
                        .to(torch.int64).sum()
                        for t in model.state_dict().values()]).cpu()


def _rel(a: dict, b: dict, base: dict, keys) -> float:
    """|(a - base) - (b - base)| / |b - base| over `keys` (one norm)."""
    num = den = 0.0
    for k in keys:
        da = a[k].double() - base[k].double()
        db = b[k].double() - base[k].double()
        num += float(((da - db) ** 2).sum())
        den += float((db ** 2).sum())
    return (num / den) ** 0.5


def _rank_models(dev):
    """Phase 3b's seeded fp32 weights: the fp32 twin, the calibrated
    fast_cal model and its plain twin; the fast_bf16 model and its plain
    twin on the same weights."""
    from lseg_tpu_torch import fast_serving, get_config
    from lseg_tpu_torch.models.lseg import LSegNet

    cfg = get_config("clip_vitl16_384")
    g = torch.Generator(device=dev).manual_seed(SEED)
    ref32 = _ref32_model(cfg, dev, g)
    model_q, plain_q = _quantized(fast_serving(cfg, "static_cal"), dev,
                                  ref32, g)
    fast = fast_serving(cfg, quant=False)
    plain_cfg = dataclasses.replace(fast, vit=dataclasses.replace(
        fast.vit, attn_impl="xla", attn_scores_dtype="float32",
        patch_fused=False))
    model_f = LSegNet(fast, torch.bfloat16, dev)
    plain_f = LSegNet(plain_cfg, torch.bfloat16, dev)
    for m in (model_f, plain_f):
        m.load_state_dict(ref32.state_dict())
    return ref32, model_q, plain_q, model_f, plain_f


def _rank_request(dev):
    """The global batch of 8 at 480x480 and K = 150 seeded label
    embeddings, the same on every rank."""
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    return (_images(g, dev, PARALLEL_BATCH, 480, 480),
            torch.randn(150, 512, device=dev, generator=g))


def _wall_ms(group, fn, iters=5):
    """ms a call of `fn` on every rank together: one warm-up, a barrier,
    `iters` calls, a synchronize and a barrier."""
    from lseg_tpu_torch.parallel.dist import barrier

    fn()
    torch.cuda.synchronize()
    barrier(group)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    barrier(group)
    return (time.perf_counter() - t0) * 1e3 / iters


def _counted(counters, expect, tag, fn):
    """`fn()` with the counters set to 0 just before and read just after;
    they must read `expect` (missing keys: 0)."""
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    got = {k: c.launches for k, c in counters.items()}
    want = {k: expect.get(k, 0) for k in counters}
    if got != want:
        fail(f"{tag}: launches {got}, expected {want}")
    return out, got


def _p1_data_sharded(r, group, dev, models, request, counters):
    """P1: `make_data_sharded_predictor` on fast_cal, the global batch
    over the ranks."""
    from lseg_tpu_torch.engine.serve import make_data_sharded_predictor
    from lseg_tpu_torch.parallel.dist import all_gather_rows, barrier

    ref32, model_q, plain_q, _, _ = models
    images, txt = request
    per = PARALLEL_BATCH // PARALLEL_WORLD
    shard = images[r * per:(r + 1) * per]
    blocks = model_q.cfg.vit.hooks[-1] + 1
    predict = make_data_sharded_predictor(model_q, None, group)
    labels, got = _counted(counters, {
        "patch_embed": 1, "flash_attention_ln_qkv_fused_q8": blocks,
        "ln_quantize_rows": blocks, "head1_correlate_fused": 1},
        "P1 data-sharded fast_cal", lambda: predict(images, txt))
    local = _argmax_call(model_q)(shard, txt)
    if labels.shape != (PARALLEL_BATCH, 480, 480):
        fail(f"P1: gathered labels {tuple(labels.shape)}")
    if not torch.equal(labels[r * per:(r + 1) * per], local):
        fail(f"P1: rank {r}'s rows of the gathered map differ from the "
             f"single-process predictor on its shard")
    others = all_gather_rows(labels.to(torch.int64).sum(dim=(1, 2))
                             .reshape(1, -1).cpu(), group)
    if not bool((others == others[0]).all()):
        fail("P1: the ranks hold different gathered maps")
    _int8_logits_gate(f"P1 rank {r} shard", model_q, plain_q, ref32,
                      ("shard", None, shard), lambda _: txt,
                      return_halfres=True)
    ms = _wall_ms(group, lambda: predict(images, txt))
    out = {"launches": got, "ms": ms}
    print(f"  P1 rank {r}: rows {r * per}-{(r + 1) * per - 1} equal the "
          f"single-process predictor on the shard bit for bit; the gathered"
          f" map is the ranks' shards in order; {ms:.3f} ms per global "
          f"batch of {PARALLEL_BATCH} (both ranks on one card)")
    if r == 0:
        ms1 = cuda_time_ms(lambda: _argmax_call(model_q)(images, txt),
                           warmup=2, iters=5)
        out["single_ms"] = ms1
        print(f"  P1 beside it: the single-process fast_cal call at batch "
              f"{PARALLEL_BATCH} on rank 0 alone, {ms1:.3f} ms")
    barrier(group)
    return out


def _p2_labelset_sharded(r, group, dev, models, request, counters):
    """P2: `make_labelset_sharded_predictor` on fast_bf16, K = 150 split
    over the ranks, against the unsharded `make_predictor`."""
    from lseg_tpu_torch.engine.serve import (
        make_labelset_sharded_predictor,
        make_predictor,
    )
    from lseg_tpu_torch.ops.correlation import correlate
    from lseg_tpu_torch.ops.resize import upsample2x
    from lseg_tpu_torch.parallel.dist import barrier

    ref32, _, _, model_f, plain_f = models
    images, txt = request
    k = txt.shape[0]
    blocks = model_f.cfg.vit.hooks[-1] + 1
    predict = make_labelset_sharded_predictor(model_f, None, group)
    labels, got = _counted(counters, {"patch_embed": 1,
                                      "flash_attention_flat": blocks},
                           "P2 label-set-sharded fast_bf16",
                           lambda: predict(images, txt))
    # equal logits on both halves: every pixel ties across the ranks, and
    # the lowest label index (rank 0's) must win
    twin = torch.cat([txt[:k // 2], txt[:k // 2]])
    tied = predict(images, twin)
    if int(tied.max()) >= k // 2:
        fail(f"P2: on labels tied across the ranks the gathered argmax took "
             f"a label >= {k // 2} (the lowest index must win)")
    _int8_logits_gate(f"P2 rank {r} embedding", model_f, plain_f, ref32,
                      ("b1", None, images[:1]), lambda _: txt, what="bf16",
                      return_halfres=True)
    ms = _wall_ms(group, lambda: predict(images, txt))
    out = {"launches": got, "ms": ms}
    if r == 0:
        whole = make_predictor(model_f)
        ref = whole(images, txt)
        with torch.inference_mode():
            up = upsample2x(correlate(model_f(images, None), txt,
                                      logit_scale=model_f.cfg.logit_scale,
                                      compute_dtype=torch.bfloat16),
                            align_corners=True,
                            compute_dtype=torch.bfloat16)
            top2 = up.float().topk(2, dim=-1).values
        del up
        clear = (top2[..., 0] - top2[..., 1]) > LABELSET_MARGIN
        n_clear = int(clear.sum())
        eq = labels == ref
        eq_clear = float(eq[clear].float().mean()) if n_clear else 0.0
        out.update(clear_share=n_clear / eq.numel(), eq_clear=eq_clear,
                   agree=float(eq.float().mean()),
                   single_ms=cuda_time_ms(lambda: whole(images, txt),
                                          warmup=2, iters=5))
        print(f"  P2: labels equal the unsharded make_predictor's on "
              f"{eq_clear:.6f} of the {out['clear_share']:.6f} of pixels "
              f"whose unsharded top-2 margin exceeds {LABELSET_MARGIN} "
              f"(gate: all), on {out['agree']:.6f} of all (not gated); "
              f"ties across the ranks to the lowest label; {ms:.3f} ms per "
              f"batch on both ranks, the unsharded predictor "
              f"{out['single_ms']:.3f} ms on rank 0 alone")
        if n_clear == 0 or eq_clear < 1.0:
            fail(f"P2: labels differ from the unsharded predictor's on "
                 f"pixels with a clear margin ({eq_clear} of {n_clear})")
    barrier(group)
    return out


def _p3_batches(r, dev, ds):
    """The rank's batch from the port's loader (4 rows, its shard) and
    the global batch of 8 built from the dataset by the loader's
    documented rule: rank q's batch 0 is rows [0, 4) of its contiguous
    half of epoch 0's shuffled stream. Rank 0's images lose their top 192
    rows to the ignore label, rank 1's none."""
    import numpy as np

    from lseg_tpu_torch.data.loader import DataLoader

    per = PARALLEL_BATCH // PARALLEL_WORLD
    loader = DataLoader(ds, per, num_workers=per, device=dev,
                        process_count=PARALLEL_WORLD, process_index=r)
    batch = next(iter(loader))
    stream = np.arange(len(ds))
    np.random.RandomState(0).shuffle(stream)
    half = len(ds) // PARALLEL_WORLD
    rows = [stream[q * half:q * half + per] for q in range(PARALLEL_WORLD)]
    glob = {key: torch.from_numpy(np.stack([
        ds[int(i)][key] for q in rows for i in q])).to(dev)
        for key in ("image", "target")}
    glob["target"] = glob["target"].long()
    if not torch.equal(batch["image"], glob["image"][r * per:(r + 1) * per]):
        fail(f"P3: rank {r}'s loader rows are not rows 0-{per - 1} of its "
             f"shard of the index stream")
    glob["target"][:per, :192] = -1
    if r == 0:
        batch["target"][:, :192] = -1
    return batch, glob


def _p3_training(r, group, dev, counters):
    """P3: one data-parallel train step on train.py's configuration
    (flashflat, remat, bf16 on fp32 masters), 2 ranks x 4 images, against
    one process x 8 (rank 0)."""
    from lseg_tpu_torch import get_config
    from lseg_tpu_torch.data.synthetic import SyntheticSegDataset
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.parallel.dist import all_gather_rows, barrier
    from lseg_tpu_torch.train.optim import make_optimizer
    from lseg_tpu_torch.train.step import (
        TrainState,
        enable_grads,
        make_train_step,
    )

    base = get_config("clip_vitl16_384")
    cfg = dataclasses.replace(base, vit=dataclasses.replace(
        base.vit, attn_impl="flashflat"))
    blocks = cfg.vit.hooks[-1] + 1
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    txt = torch.randn(150, 512, device=dev, generator=g)
    model = random_init_(LSegNet(cfg, torch.bfloat16, dev, remat=True,
                                 param_dtype=torch.float32), g)
    init = ({n: t.detach().clone() for n, t in model.state_dict().items()}
            if r == 0 else None)
    enable_grads(model)
    state = TrainState(model, make_optimizer(model, 0.004, 100,
                                             batch_size=PARALLEL_BATCH))
    ds = SyntheticSegDataset(n=16, size=480, num_classes=150)
    batch, glob = _p3_batches(r, dev, ds)
    step = make_train_step(group=group)
    (_, metrics), got = _counted(
        counters, {"flash_attention_flat": 2 * blocks,
                   "flash_attention_flat_bwd": blocks},
        "P3 data-parallel train step", lambda: step(state, batch, txt))
    loss = float(metrics["loss"])
    hashes = all_gather_rows(_state_hash(model).reshape(1, -1), group)
    if not bool((hashes == hashes[0]).all()):
        fail("P3: the ranks' parameters and statistics differ after the "
             "step")
    ddp = ({n: t.detach().clone() for n, t in model.state_dict().items()}
           if r == 0 else None)
    torch.cuda.reset_peak_memory_stats()
    ms = _wall_ms(group, lambda: step(state, batch, txt), iters=3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    params = [n for n, _ in model.named_parameters()]
    print(f"  P3 rank {r}: labeled {int(metrics['labeled'])} of "
          f"{PARALLEL_BATCH * 480 * 480} pixels (global), loss {loss:.6f}; "
          f"parameters and statistics equal on both ranks; {ms:.3f} "
          f"ms/step, peak {peak:.3f} GiB")
    out = {"launches": got, "ms": ms, "peak_gib": peak}
    del state, model
    _free()
    if r == 0:
        refs = {}
        for name, dtype, plain in (("kernel", torch.bfloat16, False),
                                   ("plain", torch.bfloat16, True),
                                   ("fp32", torch.float32, True)):
            m = LSegNet(cfg, dtype, dev, plain=plain, remat=True,
                        param_dtype=torch.float32)
            m.load_state_dict(init)
            enable_grads(m)
            st = TrainState(m, make_optimizer(m, 0.004, 100,
                                              batch_size=PARALLEL_BATCH))
            _, met = make_train_step()(st, glob, txt)
            refs[name] = (float(met["loss"]), {
                n: t.detach().clone() for n, t in m.state_dict().items()})
            del m, st
            _free()
        stats = [n for n in init if n.endswith(("running_mean",
                                                "running_var"))]
        lk, sk = refs["kernel"]
        lp, sp = refs["plain"]
        lf, sf = refs["fp32"]
        gates = {
            "loss": (abs(loss - lk) / abs(lk), abs(lk - lf) / abs(lf)),
            "update": (_rel(ddp, sk, init, params),
                       _rel(sk, sf, init, params)),
            "BatchNorm statistics": (_rel(ddp, sk, init, stats),
                                     _rel(sk, sf, init, stats)),
            "update, kernel vs plain": (_rel(sk, sp, init, params),
                                        _rel(sp, sf, init, params))}
        print(f"  P3: losses 2 x 4 {loss:.6f}, 1 x 8 kernel {lk:.6f}, plain "
              f"{lp:.6f}, fp32 {lf:.6f}")
        for what, (d, d_ref) in gates.items():
            print(f"  P3 {what}: d {d:.6g} <= {GRAD_RATIO} x d_ref "
                  f"{d_ref:.6g} + {GRAD_FLOOR:g}")
            if not d <= GRAD_RATIO * d_ref + GRAD_FLOOR:
                fail(f"P3 {what}: {d} > {GRAD_RATIO} * {d_ref} + "
                     f"{GRAD_FLOOR}")
        out["gates"] = gates
    barrier(group)
    return out


def parallel_rank(rank: str, world: str, store: str, out_dir: str) -> int:
    """One rank of phase 10 (a process of its own): gloo over a file
    store, the card shared with the other rank."""
    import torch.distributed as dist

    from lseg_tpu_torch.ops._build import library_path
    from lseg_tpu_torch.parallel import create_mesh, init_distributed

    r, w = int(rank), int(world)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not library_path().exists():
        fail(f"rank {r}: phase 1's kernel library {library_path()} is "
             f"missing (the ranks never build)")
    group = init_distributed(f"file://{store}", w, r, backend="gloo")
    if create_mesh() is not group or dist.get_backend(group) != "gloo":
        fail(f"rank {r}: not in a gloo group of {w}")
    counters = _kernel_counters()
    t0 = time.perf_counter()
    models = _rank_models(dev)
    request = _rank_request(dev)
    print(f"  rank {r}: models built, {time.perf_counter() - t0:.2f} s",
          flush=True)
    out = {"P1": _p1_data_sharded(r, group, dev, models, request, counters),
           "P2": _p2_labelset_sharded(r, group, dev, models, request,
                                      counters)}
    del models
    _free()
    out["P3"] = _p3_training(r, group, dev, counters)
    with open(os.path.join(out_dir, f"rank{r}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    return 0


def _run_ranks(tmp):
    """Start PARALLEL_WORLD ranks of `parallel_rank`, wait for all of them
    (failing on the first non-zero exit or at the timeout, killing the
    rest), print their output; returns their results."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w")
            for r in range(PARALLEL_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--parallel-rank",
         str(r), str(PARALLEL_WORLD), os.path.join(tmp, "store"), tmp],
        stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        for r, log in enumerate(logs)]
    deadline = time.monotonic() + PARALLEL_RANK_TIMEOUT
    problem = None
    try:
        while problem is None and any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                problem = "a rank exited with an error"
            elif time.monotonic() > deadline:
                problem = f"a rank ran past {PARALLEL_RANK_TIMEOUT} s"
            else:
                time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    for r in range(PARALLEL_WORLD):
        with open(os.path.join(tmp, f"rank{r}.log")) as f:
            for line in f.read().splitlines():
                print(f"  [rank {r}] {line.strip()}")
    codes = [p.returncode for p in procs]
    if problem or any(codes):
        fail(f"phase 10: {problem or 'a rank failed'} (exit codes {codes})")
    results = []
    for r in range(PARALLEL_WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results


def _torchrun_cli(tmp):
    """P4: `torchrun --nproc_per_node=2 -m lseg_tpu_torch.train` on
    synthetic data (the tiny config, global batch 16, one epoch: four
    steps and one validation batch a rank); rank 0 alone writes."""
    root = os.path.join(tmp, "cli")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={PARALLEL_WORLD}", "-m", "lseg_tpu_torch.train",
           "--dataset", "synthetic", "--crop_size", "64", "--batch_size",
           "16", "--max_epochs", "1", "--num_workers", "2", "--ckpt_root",
           root, "--device", "cuda"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=PARALLEL_RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        fail(f"P4: torchrun ran past {PARALLEL_RANK_TIMEOUT} s")
    dt = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"  [torchrun] {line}")
    if proc.returncode != 0:
        print(proc.stderr[-4000:])
        fail(f"P4: torchrun exited {proc.returncode}")
    run = os.path.join(root, "lseg")
    files = sorted(os.path.relpath(os.path.join(d, f), run)
                   for d, _, fs in os.walk(run) for f in fs)
    with open(os.path.join(run, "metrics.csv")) as f:
        rows = f.read().splitlines()
    events = [f for f in files if f.startswith("tb")]
    want = sorted(["metrics.csv", "ckpt_0000000004.json",
                   "ckpt_0000000004.pt"] + events)
    print(f"  P4 torchrun --nproc_per_node={PARALLEL_WORLD} -m "
          f"lseg_tpu_torch.train: exit 0 in {dt:.2f} s (start-up included);"
          f" wrote {files}; metrics.csv {rows}")
    if files != want or len(events) > 1 or len(rows) != 2:
        fail(f"P4: the run wrote {files} and {len(rows) - 1} csv rows; one "
             f"writer writes {want} and one row")


def _nccl_one_rank(dev, tmp):
    """(b) One rank with NCCL in this process: the collectives on the card
    at world size 1, then P1's and P2's calls, bit for bit the
    undistributed ones."""
    import torch.distributed as dist

    from lseg_tpu_torch.engine.serve import (
        make_data_sharded_predictor,
        make_labelset_sharded_predictor,
        make_predictor,
    )
    from lseg_tpu_torch.parallel import create_mesh, init_distributed

    group = init_distributed(f"file://{os.path.join(tmp, 'nccl')}", 1, 0,
                             backend="nccl")
    if dist.get_backend(group) != "nccl" or create_mesh() is not group:
        fail("(b): not in an NCCL group")
    x = torch.arange(8.0, device=dev)
    y = x.clone()
    dist.all_reduce(y, group=group)
    dist.broadcast(y, 0, group=group)
    parts = [torch.empty_like(x)]
    dist.all_gather(parts, y, group=group)
    if not torch.equal(parts[0], x):
        fail("(b): NCCL collectives changed a world-size-1 tensor")
    _, model_q, _, model_f, _ = models = _rank_models(dev)
    images, txt = _rank_request(dev)
    p1 = make_data_sharded_predictor(model_q, None, group)(images, txt)
    p2 = make_labelset_sharded_predictor(model_f, None, group)(images, txt)
    ok1 = torch.equal(p1, _argmax_call(model_q)(images, txt))
    ok2 = torch.equal(p2, make_predictor(model_f)(images, txt))
    dist.destroy_process_group()
    print(f"  (b) NCCL, one rank: all_reduce, broadcast, all_gather on the "
          f"card; P1 equal to the undistributed call {ok1}, P2 {ok2}")
    del models, model_q, model_f
    _free()
    if not (ok1 and ok2):
        fail("(b): an NCCL world-size-1 call differs from the "
             "undistributed one")


def phase_parallel(dev):
    """Phase 10: multi-GPU. (a) Two gloo ranks share the card: P1
    data-sharded fast_cal serving, P2 label-set-sharded fast_bf16
    serving, P3 one data-parallel train step, P4 the training CLI under
    torchrun; (b) one NCCL rank in this process. Returns each kernel's
    launches per rank, [rank 0, rank 1], over the counted runs."""
    print("[10] multi-GPU: data- and label-set-sharded serving, a "
          "synced-BN data-parallel train step and torchrun, two gloo ranks "
          "on one card; one NCCL rank")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        results = _run_ranks(tmp)
        _torchrun_cli(tmp)
        _nccl_one_rank(dev, tmp)
    launches = {}
    for res in results:
        for part in ("P1", "P2", "P3"):
            for k, v in res[part]["launches"].items():
                launches.setdefault(k, [0] * PARALLEL_WORLD)
    for r, res in enumerate(results):
        for part in ("P1", "P2", "P3"):
            for k, v in res[part]["launches"].items():
                launches[k][r] += v
    ran = {k for k, v in launches.items() if any(v)}
    if ran != PARALLEL_KERNELS:
        fail(f"phase 10 launched {sorted(ran)}, expected "
             f"{sorted(PARALLEL_KERNELS)}")
    print(f"  phase 10 launches per rank: "
          f"{ {k: v for k, v in launches.items() if any(v)} }, "
          f"{time.perf_counter() - t_phase:.1f} s")
    print(f"  {card_line()}")
    return launches


# Phase 11: the HSNet side-car and the remaining entry points (A13, A15)
HSNET_BATCH, HSNET_SIZE, HSNET_SHOTS = 8, 400, 5
HSNET_LAYERS = (3, 4, 23, 3)
# HSNet has no kernel of ours (its correlation is a matmul, its 4-D
# convolutions cuDNN's), so the bf16 model is held against the same
# weights in fp32 on the card. Each bound is about 3x the largest reading
# on an H100 80GB HBM3 at 700 W over three runs of this phase (the
# readings repeat to every digit shown): logits within HSNET_LOGITS_REL of
# max |fp32 logits| (read 0.0191, at (c)), the first step's loss within
# HSNET_LOSS_REL (read 6.48e-6) and the learner's gradients within
# HSNET_GRAD_REL (read 3.68e-3; global relative norms). Labels and votes
# by E2's rule at HSNet's logit scale: equal (>= HEAD_SERVE_MIN_EQUAL) on
# the pixels whose fp32 margin of every shot exceeds SERVE_RATIO times the
# shots' largest logits deviation plus one bf16 ulp of max |fp32 logits|
# (where LSeg's logits of scale 1/0.07 take SERVE_FLOOR).
HSNET_LOGITS_REL = 0.06
HSNET_LOSS_REL = 2e-5
HSNET_GRAD_REL = 1.2e-2
# the longest a command-line run of phase 11 may take, in seconds
CLI_TIMEOUT = 600
# the kernels the entry points of phase 11 launch: the demo's --fast (B1,
# B6) and --fast --int8 (B1, B2, B3); HSNet, the parity check and the
# app's parity config launch none
TOOLS_KERNELS = {"patch_embed", "flash_attention_flat",
                 "flash_attention_ln_qkv_fused_q8", "ln_quantize_rows"}


# Phase 12 (the int8 modes): the kernels its counted runs launch: (a)
# fast_cal with B2 in its int8 Q.K^T mode (B1, B3, B2, B4), (b) the
# dynamic int8 projections around B6 (B1, B6).
INT8_MODES_KERNELS = {"patch_embed", "ln_quantize_rows",
                      "flash_attention_ln_qkv_fused_q8",
                      "head1_correlate_fused", "flash_attention_flat"}


def _hsnet_splits(root):
    """Phase 9's PASCAL-5i tree made ready for HSNet: four more VOC-sized
    images of each of fold 0's classes in `val/fold0.txt` (six a class, so
    a query has five distinct supports), and the `trn` split of fold 0:
    two images of classes 5, 10 and 15 in `trn/fold1..3.txt`."""
    import numpy as np
    from PIL import Image

    rng = np.random.RandomState(SEED + 11)
    h, w = 375, 500

    def write(c, j):
        name = f"2009_{c:03d}{j:03d}"
        low = rng.randint(0, 255, (12, 16, 3)).astype(np.uint8)
        Image.fromarray(low).resize((w, h), Image.BILINEAR).save(
            os.path.join(root, "VOC2012", "JPEGImages", name + ".jpg"),
            quality=90)
        mask = np.zeros((h, w), np.uint8)
        y, x = rng.randint(10, h // 2), rng.randint(0, w // 2)
        mask[y:y + h // 2, x:x + w // 2] = c + 1
        mask[:5] = 255
        Image.fromarray(mask).save(os.path.join(
            root, "VOC2012", "SegmentationClassAug", name + ".png"))
        return f"{name}__{c + 1}"

    splits = os.path.join(root, "splits", "pascal")
    with open(os.path.join(splits, "val", "fold0.txt"), "a") as f:
        f.write("\n".join(write(c, j) for j in range(4)
                          for c in range(FEWSHOT_CLASSES)) + "\n")
    os.makedirs(os.path.join(splits, "trn"))
    for fold, c in ((1, 5), (2, 10), (3, 15)):
        with open(os.path.join(splits, "trn", f"fold{fold}.txt"), "w") as f:
            f.write("\n".join(write(c, j) for j in range(2)) + "\n")


def _torchvision_files(tmp, dev, g):
    """A seeded torchvision-format ResNet-101 `state_dict` (BatchNorm
    statistics moved off 0 and 1) and VGG16 `features` state_dict,
    written as `.pth` files; returns their paths and the written
    tensors."""
    from lseg_tpu_torch.config import ResNetConfig
    from lseg_tpu_torch.models.layers import random_init_
    from lseg_tpu_torch.models.resnet import ResNetBackbone
    from lseg_tpu_torch.models.vgg import VGG16Features

    rn = random_init_(ResNetBackbone(ResNetConfig(HSNET_LAYERS),
                                     device=dev), g)
    sd_rn = {}
    for name, t in rn.state_dict().items():
        t = t.detach().clone()
        if name.endswith("running_mean") or name.endswith(".bias"):
            t += 0.1 * torch.randn(t.shape, generator=g, device=dev)
        elif name.endswith("running_var") or (t.dim() == 1 and
                                              name.endswith(".weight")):
            t = 1.0 + 0.1 * torch.rand(t.shape, generator=g, device=dev)
        name = name.replace("_block", ".").replace(".down_conv",
                                                   ".downsample.0")
        sd_rn[name.replace(".down_bn", ".downsample.1")] = t.cpu()
    vgg = random_init_(VGG16Features(device=dev), g)
    sd_vgg = {}
    for name, t in vgg.state_dict().items():
        t = t.detach().clone()
        if name.endswith(".bias"):
            t += 0.01 * torch.randn(t.shape, generator=g, device=dev)
        sd_vgg[f"features.{name[len('conv'):]}"] = t.cpu()
    paths = (os.path.join(tmp, "resnet101.pth"), os.path.join(tmp,
                                                              "vgg16.pth"))
    torch.save(sd_rn, paths[0])
    torch.save(sd_vgg, paths[1])
    del rn, vgg
    return paths, (sd_rn, sd_vgg)


def _hsnet_model(backbone, path, written, dev, g):
    """HSNet in bf16, its learner seeded from `g`, its backbone read
    from the torchvision file at `path` by `hsnet.load_backbone` (as
    hsnet_run's), every backbone entry held bit for bit to the written
    tensor."""
    from lseg_tpu_torch.config import ResNetConfig
    from lseg_tpu_torch.models.hsnet import HSNet, load_backbone
    from lseg_tpu_torch.models.layers import random_init_

    model = random_init_(HSNet(ResNetConfig(HSNET_LAYERS), backbone,
                               torch.bfloat16, dev), g)
    key_map = load_backbone(model, path)
    state = model.state_dict()
    if len(key_map) != len(model.backbone.state_dict()):
        fail(f"{backbone} backbone: {len(key_map)} entries mapped of "
             f"{len(model.backbone.state_dict())}")
    for name, (ref, _) in key_map.items():
        got = state[name]
        if not torch.equal(got.cpu(), written[ref].to(got.dtype)):
            fail(f"{backbone} backbone: {name} differs from the written "
                 f"{ref}")
    return model


def _same_weights(model, dev, dtype=torch.float32,
                  use_original_imgsize=False, param_dtype=None):
    """An HSNet of `model`'s weights (cast to the storage dtype) in
    `dtype`."""
    from lseg_tpu_torch.models.hsnet import HSNet

    twin = HSNet(model.resnet_cfg, model.backbone_name, dtype, dev,
                 use_original_imgsize=use_original_imgsize,
                 param_dtype=param_dtype)
    twin.load_state_dict(model.state_dict())
    return twin


def _recorded(model, store):
    def apply(q, s, m):
        out = model(q, s, m)
        store.append(out.float())
        return out
    return apply


def _hsnet_votes_gate(tag, model, twin, batch, nshot, timer, org=None):
    """`predict_mask_nshot` on the bf16 model and its fp32 twin: the
    logits of every shot within HSNET_LOGITS_REL, the votes equal on the
    pixels whose fp32 margin of every shot exceeds the bound; then the
    bf16 call timed by `timer` (StepTimer, 3 calls after 1). Returns
    ms a batch."""
    from lseg_tpu_torch.models.hsnet import predict_mask_nshot
    from lseg_tpu_torch.ops.resize import resize_bilinear

    got, ref = [], []
    with torch.inference_mode():
        pred = predict_mask_nshot(_recorded(model, got), batch, nshot,
                                  org_size=org)
        want = predict_mask_nshot(_recorded(twin, ref), batch, nshot,
                                  org_size=org)
    n = batch["query_img"].shape[0]
    shape = (n,) + (org or tuple(batch["query_img"].shape[1:3]))
    if tuple(pred.shape) != shape or not all(
            torch.isfinite(t).all() for t in got):
        fail(f"{tag}: votes {tuple(pred.shape)}, expected {shape}, or "
             f"non-finite logits")
    d = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    top = max(float(b.abs().max()) for b in ref)
    ulp = torch.finfo(torch.bfloat16).eps * 2.0 ** math.floor(math.log2(top))
    bound = SERVE_RATIO * d + ulp
    clear = torch.ones(shape, dtype=torch.bool, device=pred.device)
    for lg in ref:
        if org is not None:
            lg = resize_bilinear(lg, *org, align_corners=True)
        clear &= (lg[..., 1] - lg[..., 0]).abs() > bound
    n_clear = int(clear.sum())
    eq = float((pred == want)[clear].float().mean()) if n_clear else 0.0
    print(f"  {tag}: {nshot}-shot votes {tuple(pred.shape)}, foreground "
          f"{float(pred.float().mean()):.4f}; logits |bf16 - fp32| max "
          f"{d:.6g} of max |fp32| {top:.6g} (gate <= {HSNET_LOGITS_REL} of "
          f"it); votes equal on {eq:.6f} of the {n_clear / pred.numel():.6f}"
          f" of pixels whose fp32 margin exceeds {bound:.6g} ({SERVE_RATIO}"
          f" x {d:.6g} + a bf16 ulp {ulp:.6g}) in every shot "
          f"(gate >= {HEAD_SERVE_MIN_EQUAL}), on "
          f"{_agree(pred, want):.6f} of all (not gated)")
    if d > HSNET_LOGITS_REL * top:
        fail(f"{tag}: bf16 logits deviate {d} > {HSNET_LOGITS_REL} * {top}")
    if n_clear == 0 or eq < HEAD_SERVE_MIN_EQUAL:
        fail(f"{tag}: votes equal on {eq} of {n_clear} clear pixels")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for _ in range(4):
            timer.step(predict_mask_nshot(model, batch, nshot, org_size=org))
    peak = torch.cuda.max_memory_allocated()
    print(f"    {1e3 * timer.mean:.3f} ms a batch of {n} ({nshot}-shot, "
          f"StepTimer over 3 calls after 1), peak memory "
          f"{peak / 2**30:.3f} GiB")
    return 1e3 * timer.mean


def _hsnet_batch(ds, dev, n):
    """The first `n` episodes of `ds` as a batch on the card."""
    from lseg_tpu_torch.hsnet_run import batches

    return next(batches(ds, [range(n)], dev))[0]


def _learner_grads(model):
    return {n: p.grad.float().clone() for n, p in
            model.hpn_learner.named_parameters()}


def _hsnet_training(tag, model, twin, batch):
    """(d): three Adam steps of hsnet_run's recipe on the bf16 model (fp32
    masters); the first step's loss and learner gradients against the
    fp32 twin's first step, relatively; the backbone's parameters and
    BatchNorm statistics bit for bit unchanged, the backbone in eval mode;
    ms/step (StepTimer over steps 2 and 3) and peak memory."""
    from lseg_tpu_torch.hsnet_run import make_optimizer, train_step
    from lseg_tpu_torch.utils.profiling import StepTimer

    before = {k: t.clone() for k, t in model.backbone.state_dict().items()}
    opt, opt32 = make_optimizer(model, 1e-3), make_optimizer(twin, 1e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses = [float(train_step(model, opt, batch))]
    loss32 = float(train_step(twin, opt32, batch))
    g, g32 = _learner_grads(model), _learner_grads(twin)
    num = sum(float(((g[k] - g32[k]) ** 2).sum()) for k in g32)
    den = sum(float((g32[k] ** 2).sum()) for k in g32)
    grad_rel = (num / den) ** 0.5
    loss_rel = abs(losses[0] - loss32) / abs(loss32)
    timer = StepTimer(warmup=1)
    timer.step(g)
    for _ in range(2):
        loss = train_step(model, opt, batch)
        timer.step(loss)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated()
    print(f"  {tag}: losses {[round(v, 6) for v in losses]}; the first step"
          f" against the fp32 twin's: loss |bf16 - fp32| / |fp32| "
          f"{loss_rel:.6g} (gate <= {HSNET_LOSS_REL}), learner gradients "
          f"{grad_rel:.6g} (gate <= {HSNET_GRAD_REL}); "
          f"{1e3 * timer.mean:.3f} ms/step (StepTimer, steps 2-3), peak "
          f"memory {peak / 2**30:.3f} GiB (both models' steps)")
    if not all(v == v and abs(v) != float("inf") for v in losses):
        fail(f"{tag}: a loss is not finite: {losses}")
    if loss_rel > HSNET_LOSS_REL or not grad_rel <= HSNET_GRAD_REL:
        fail(f"{tag}: the bf16 step deviates from the fp32 one")
    if model.backbone.training or any(
            p.requires_grad for p in model.backbone.parameters()):
        fail(f"{tag}: the backbone trains")
    after = model.backbone.state_dict()
    changed = [k for k, t in before.items() if not torch.equal(t, after[k])]
    if changed:
        fail(f"{tag}: the frozen backbone changed: {changed[:3]}")
    print(f"    backbone: {len(before)} tensors (parameters and BatchNorm "
          f"statistics) bit for bit unchanged after 3 steps")
    return 1e3 * timer.mean


def _cli(tag, args):
    """`python -m <args>` in a process of its own on the default device;
    returns its stdout lines and its seconds."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m"] + args, cwd=root, env=env,
                          capture_output=True, text=True, timeout=CLI_TIMEOUT)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-2000:], proc.stderr[-4000:])
        fail(f"{tag} exited {proc.returncode}")
    return proc.stdout.strip().splitlines(), dt


def _demo_runs(tmp, image, ckpt, vocab, counters):
    """(f): `demo.main` in process at clip_vitl16_384: random weights
    plain, --fast, --fast --int8 and --fast --tta, then --fast from the
    written `.ckpt`; each saves its PNG and launches fixed counts.
    Returns the launches of the five runs."""
    import numpy as np
    from PIL import Image

    from lseg_tpu_torch import demo, get_config
    from lseg_tpu_torch.engine.tta import (
        CROPS_PER_STEP,
        TTAProtocol,
        make_plan,
    )

    blocks = get_config("clip_vitl16_384").vit.hooks[-1] + 1
    h, w = np.asarray(Image.open(image)).shape[:2]
    chunks = -(-make_plan(TTAProtocol(), h, w).n_valid // CROPS_PER_STEP)
    bf16 = {"patch_embed": 1, "flash_attention_flat": blocks}
    runs = (
        ("random", ["--weights", "random"], {}, (360, 480)),
        ("random --fast", ["--weights", "random", "--fast"], bf16,
         (360, 480)),
        ("random --fast --int8", ["--weights", "random", "--fast", "--int8"],
         {"patch_embed": 1, "flash_attention_ln_qkv_fused_q8": blocks,
          "ln_quantize_rows": blocks}, (360, 480)),
        ("random --fast --tta", ["--weights", "random", "--fast", "--tta"],
         {k: chunks * v for k, v in bf16.items()}, (h, w)),
        (".ckpt --fast", ["--weights", ckpt, "--bpe_vocab", vocab, "--fast"],
         bf16, (360, 480)),
    )
    total = {k: 0 for k in counters}
    for tag, flags, want, size in runs:
        out = os.path.join(tmp, f"demo_{len(os.listdir(tmp))}.png")
        want = {k: want.get(k, 0) for k in counters}
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        pred = demo.main(["--image", image, "--labels",
                          ",".join(FIVE_LABELS), "--out", out] + flags)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = {k: c.launches for k, c in counters.items()}
        saved = np.asarray(Image.open(out))
        print(f"  (f) demo {tag}: labels {pred.shape} in "
              f"[{pred.min()}, {pred.max()}], {os.path.basename(out)} "
              f"{saved.shape}, {dt:.2f} s (model build included), launches "
              f"{ {k: v for k, v in got.items() if v} }")
        if got != want:
            fail(f"demo {tag}: launches {got}, expected {want}")
        if pred.shape != size or saved.shape != size + (3,) or not (
                0 <= pred.min() and pred.max() < len(FIVE_LABELS)):
            fail(f"demo {tag}: labels {pred.shape}, image {saved.shape}")
        _add(total, got)
        _free()
    return total


def _parity_check_cli(tmp, ckpt, vocab):
    """(g): a `ref_input` / `ref_logits` pair from the `.ckpt`'s weights on
    the plain fp32 path with `emulate_fp16`, computed on the host's CPU
    (NCHW and NKHW, as lang-seg dumps them), then `python -m
    lseg_tpu_torch.parity_check` on the card against it: the card's
    arithmetic (cuBLAS, cuDNN, TF32 off) against the CPU's, under the
    command's own PASS rule."""
    import numpy as np

    from lseg_tpu_torch import get_config
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.text.cache import TextFeatureCache
    from lseg_tpu_torch.text.tokenizer import ClipBPETokenizer
    from lseg_tpu_torch.utils.checkpoint_convert import (
        load_reference_checkpoint,
    )

    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cfg = get_config("clip_vitl16_384")
    state, text_state = load_reference_checkpoint(ckpt, cfg)
    model = LSegNet(cfg, torch.float32, cpu, plain=True, emulate_fp16=True)
    model.load_state_dict(state)
    txt = TextFeatureCache(cfg.text, text_state, ClipBPETokenizer.from_file(
        vocab), device=cpu)(FIVE_LABELS)
    g = torch.Generator().manual_seed(SEED + 111)
    x = torch.randn((1, 384, 480, 3), generator=g)
    with torch.inference_mode():
        ref = model(x, txt)
    paths = [os.path.join(tmp, f) for f in ("ref_input.npy",
                                            "ref_logits.npy")]
    np.save(paths[0], x.permute(0, 3, 1, 2).numpy())
    np.save(paths[1], ref.permute(0, 3, 1, 2).numpy())
    dt_ref = time.perf_counter() - t0
    del model, state, text_state, txt, x, ref
    _free()
    lines, dt = _cli("parity_check", [
        "lseg_tpu_torch.parity_check", "--weights", ckpt, "--bpe_vocab",
        vocab, "--ref_input", paths[0], "--ref_logits", paths[1],
        "--labels", ",".join(FIVE_LABELS)])
    print(f"  (g) python -m lseg_tpu_torch.parity_check on (1, 3, 384, 480)"
          f" / (1, 5, 384, 480) written on the CPU in {dt_ref:.2f} s: "
          f"{lines[-4:]}, {dt:.2f} s")
    if not lines or lines[-1] != "PARITY: PASS":
        fail("parity_check did not pass")


def _app_requests(ckpt, vocab, image, dev, counters):
    """(h): `app.load` on the `.ckpt` (the parity config in bf16), then one
    single-scale and one TTA request; no kernel launches."""
    import numpy as np
    from PIL import Image

    from lseg_tpu_torch import app

    t0 = time.perf_counter()
    loaded = app.load(ckpt, vocab, "clip_vitl16_384", dev)
    dt_load = time.perf_counter() - t0
    h, w = np.asarray(Image.open(image)).shape[:2]
    for tta, size in ((False, (360, 480)), (True, (h, w))):
        t0 = time.perf_counter()
        overlay, legend = _idle(f"(h) app request tta={tta}", counters,
                                lambda: app.request(
                                    loaded, image, ", ".join(FIVE_LABELS),
                                    use_tta=tta))
        dt = time.perf_counter() - t0
        print(f"  (h) app.request (tta={tta}): overlay {overlay.shape}, "
              f"legend {[n for n, _ in legend]}, {dt:.3f} s (load "
              f"{dt_load:.2f} s), no kernel launched")
        if overlay.shape != size + (3,) or not legend or not {
                n for n, _ in legend} <= set(FIVE_LABELS):
            fail(f"app request tta={tta}: overlay {overlay.shape}, legend "
                 f"{legend}")
    del loaded
    _free()


def phase_tools(dev, root):
    """Phase 11: the HSNet side-car at hsnet_run's defaults (ResNet-101
    and VGG16, bf16, 400 x 400, batch 8; 1- and 5-shot votes against the
    fp32 twin, `use_original_imgsize`, three training steps, `python -m
    lseg_tpu_torch.hsnet_run test` and `train`), then the demo, the parity
    check and the app on phase 9's `.ckpt`, vocabulary and PASCAL-5i tree
    in `root`, and a `profiling.trace`. Returns the launches of the demo
    runs, the only counted runs that launch kernels."""
    from lseg_tpu_torch.data.fewshot import build_fewshot_dataset
    from lseg_tpu_torch.utils.profiling import (
        StepTimer,
        device_memory_stats,
        trace,
    )

    print("[11] the HSNet side-car (ResNet-101, VGG16) at hsnet_run's "
          "defaults, python -m lseg_tpu_torch.hsnet_run, the demo, the "
          "parity check, the app, profiling.trace")
    t_phase = time.perf_counter()
    counters = _kernel_counters()
    datapath, splits = root, os.path.join(root, "splits")
    ckpt, vocab = (os.path.join(root, "zs.ckpt"),
                   os.path.join(root, "bpe_vocab.txt.gz"))
    image = os.path.join(root, "VOC2012", "JPEGImages", "2008_000000.jpg")
    _hsnet_splits(root)
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    t0 = time.perf_counter()
    paths, written = _torchvision_files(root, dev, g)
    print(f"  torchvision-format files: ResNet-101 "
          f"{os.path.getsize(paths[0]) / 2**20:.1f} MiB, VGG16 features "
          f"{os.path.getsize(paths[1]) / 2**20:.1f} MiB, written in "
          f"{time.perf_counter() - t0:.2f} s")

    def episodes(**kw):
        return build_fewshot_dataset(
            "pascal", datapath, 0, "test", HSNET_SHOTS, splits_dir=splits,
            img_size=HSNET_SIZE, imagenet_norm=True, **kw)

    batch = _hsnet_batch(episodes(), dev, HSNET_BATCH)
    numbers = {}
    for backbone, path, sd in (("resnet", paths[0], written[0]),
                               ("vgg16", paths[1], written[1])):
        tag = "(a) ResNet-101" if backbone == "resnet" else "(b) VGG16"
        model = _hsnet_model(backbone, path, sd, dev, g)
        twin = _same_weights(model, dev)
        print(f"  {tag}: HSNet bf16, learner seeded, backbone from the "
              f"torchvision file through the key map, bit for bit; stack "
              f"sizes {model.stack_sizes}")
        for c in counters.values():
            c.launches = 0
        for nshot in (1, HSNET_SHOTS):
            numbers[backbone, nshot] = _hsnet_votes_gate(
                f"{tag} {nshot}-shot", model, twin, batch, nshot,
                StepTimer(warmup=1))
        if backbone == "resnet":
            with tempfile.TemporaryDirectory() as logdir:
                with torch.inference_mode(), trace(logdir):
                    model(batch["query_img"], batch["support_imgs"][:, 0],
                          batch["support_masks"][:, 0])
                files = os.listdir(logdir)
                size = sum(os.path.getsize(os.path.join(logdir, f))
                           for f in files)
                with open(os.path.join(logdir, files[0])) as f:
                    events = json.load(f)["traceEvents"]
            on_card = sum(1 for e in events if e.get("cat") == "kernel")
            print(f"  (i) profiling.trace around one 1-shot call: {files}, "
                  f"{size / 2**20:.2f} MiB, {len(events)} events, {on_card} "
                  f"device kernels")
            if not size or not on_card:
                fail("profiling.trace wrote no device kernel")
            # (c) use_original_imgsize at bsz 1 on the 375 x 500 original
            one = _hsnet_batch(episodes(use_original_imgsize=True), dev, 1)
            org = tuple(one["query_mask"].shape[1:3])
            numbers["orig"] = _hsnet_votes_gate(
                f"(c) use_original_imgsize {org}",
                _same_weights(model, dev, torch.bfloat16, True),
                _same_weights(model, dev, torch.float32, True), one, 1,
                StepTimer(warmup=1), org=org)
            del one
            # (d) training, on fp32 masters
            train = _same_weights(model, dev, torch.bfloat16,
                                  param_dtype=torch.float32)
            twin_t = _same_weights(model, dev)
            del model, twin
            _free()
            numbers["train"] = _hsnet_training("(d) 3 training steps",
                                               train, twin_t, batch)
            del train, twin_t
        else:
            del model, twin
        ran = {k: c.launches for k, c in counters.items() if c.launches}
        if ran:
            fail(f"{tag}: kernels launched {ran}, expected none")
        _free()
    print(f"  {card_line()}; memory now {device_memory_stats()}")

    # (e) the hsnet_run command line on the written tree
    common = ["--datapath", datapath, "--splits_dir", splits,
              "--backbone_weights", paths[0]]
    lines, dt = _cli("hsnet_run test", ["lseg_tpu_torch.hsnet_run", "test",
                                        "--nshot", "1"] + common)
    print(f"  (e) python -m lseg_tpu_torch.hsnet_run test (1-shot, 1000 "
          f"episodes, batch 8, 400 x 400): {dt:.2f} s, so {dt / 1e3:.4f} s "
          f"an episode, start-up, weights and decodes included; last lines "
          f"{lines[-2:]}")
    if not lines or not lines[-1].startswith(
            "FINAL pascal fold0 1-shot mIoU "):
        fail(f"hsnet_run test printed {lines[-1:]}")
    lines, dt = _cli("hsnet_run train", ["lseg_tpu_torch.hsnet_run", "train",
                                         "--niter", "3"] + common)
    print(f"  (e) python -m lseg_tpu_torch.hsnet_run train --niter 3: "
          f"{dt:.2f} s; {lines}")
    if not lines or not lines[0].startswith("iter 0 loss "):
        fail(f"hsnet_run train printed {lines}")

    # (f)-(h) the demo, the parity check and the app on phase 9's files
    launches = _demo_runs(root, image, ckpt, vocab, counters)
    _parity_check_cli(root, ckpt, vocab)
    _app_requests(ckpt, vocab, image, dev, counters)
    print(f"  HSNet ms a batch of {HSNET_BATCH}: ResNet-101 1-shot "
          f"{numbers['resnet', 1]:.3f}, 5-shot "
          f"{numbers['resnet', HSNET_SHOTS]:.3f}; VGG16 1-shot "
          f"{numbers['vgg16', 1]:.3f}, 5-shot "
          f"{numbers['vgg16', HSNET_SHOTS]:.3f}; use_original_imgsize "
          f"{numbers['orig']:.3f} a query; training "
          f"{numbers['train']:.3f} ms/step")
    print(f"  phase 11 launches: "
          f"{ {k: v for k, v in launches.items() if v} }, "
          f"{time.perf_counter() - t_phase:.1f} s")
    print(f"  {card_line()}")
    return launches


def phase_int8_modes(dev, cache, requests):
    """Phase 12: the int8 modes of the reference's ViTConfig, at full width
    (ViT-L/16, 480x480) with phase 3b's seeded fp32 weights, made again
    from the same seed: (a) `fast_serving(clip_vitl16_384 with
    attn_variant='i8qk', 'static_cal')`, quantized and calibrated as in
    3b, B2 in its int8 Q.K^T mode; (b) `fast_serving(clip_vitl16_384 with
    quant_int8=True, False)`: `QuantDense` on fp32 weights (quantized at
    every call) around B6. Each answers phase 3's three requests through
    `model(x, txt, return_argmax=True)` with fixed launch counts per
    request, its half-res logits held against its plain twins and the fp32
    model as in 3b, then ms/batch and peak memory at batch 8, kernel,
    plain, kernel. (b)'s reference pair, the parity config with
    quant_int8=True (einsum attention, no kernel), answers one request
    with no launch, its half-res logits within SERVE_RATIO * (b)'s
    |plain - fp32| + SERVE_FLOOR of the fp32 parity model's. Returns the
    launches of the counted runs of (a) and (b), and B2's launches in its
    int8 Q.K^T mode."""
    from lseg_tpu_torch import fast_serving, get_config
    from lseg_tpu_torch.models.lseg import LSegNet
    from lseg_tpu_torch.ops.flash_attention import (
        flash_attention_ln_qkv_fused_q8,
    )
    from lseg_tpu_torch.ops.quant import QuantDense

    print("[12] the int8 modes at full width: (a) fast_cal with "
          "attn_variant='i8qk' (B2's int8 Q.K^T mode), (b) dynamic int8 "
          "projections (quant_int8=True) around B6")
    t_phase = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(SEED)
    ref32 = _fp32_reference(dev, g)
    base = get_config("clip_vitl16_384")
    blocks = base.vit.hooks[-1] + 1
    counters = _kernel_counters()
    total = {}

    def variant(**kw):
        return dataclasses.replace(base, vit=dataclasses.replace(base.vit,
                                                                 **kw))

    # (a) fast_cal, B2 in its int8 Q.K^T mode
    cfg = fast_serving(variant(attn_variant="i8qk"), "static_cal")
    print(f"  (a) attn {cfg.vit.attn_impl}, attn_variant "
          f"{cfg.vit.attn_variant}, quant_int8 {cfg.vit.quant_int8}")
    model, plain = _quantized(cfg, dev, ref32, g)
    if not all(b.attn.ln_fused and b.attn.qk_int8
               for b in model.vit.blocks):
        fail("i8qk: a block does not take B2's int8 Q.K^T mode")
    flash_attention_ln_qkv_fused_q8.i8qk_launches = 0
    _, launches = _serve_requests(
        "i8qk", _argmax_call(model), requests, cache, counters,
        {"patch_embed": 1, "ln_quantize_rows": blocks,
         "flash_attention_ln_qkv_fused_q8": blocks,
         "head1_correlate_fused": 1})
    i8qk = flash_attention_ln_qkv_fused_q8.i8qk_launches
    if i8qk != launches["flash_attention_ln_qkv_fused_q8"]:
        fail(f"i8qk: {i8qk} of B2's "
             f"{launches['flash_attention_ln_qkv_fused_q8']} launches took "
             f"the int8 Q.K^T mode")
    _add(total, launches)
    _int8_logits_gate("i8qk half-res", model, plain, ref32, requests[1],
                      cache, what="int8 i8qk", return_halfres=True)
    _backbone_numbers("(a) fast_cal i8qk", _argmax_call(model),
                      _argmax_call(plain), requests, cache)
    del model, plain
    _free()

    # (b) dynamic int8 projections around B6
    cfg = fast_serving(variant(quant_int8=True), False)
    print(f"  (b) attn {cfg.vit.attn_impl}, quant_int8 "
          f"{cfg.vit.quant_int8}")
    model = LSegNet(cfg, torch.bfloat16, dev).eval()
    model.load_state_dict(ref32.state_dict())
    plain = LSegNet(cfg, torch.bfloat16, dev, plain=True).eval()
    plain.load_state_dict(ref32.state_dict())
    dense = [m for m in model.modules() if isinstance(m, QuantDense)]
    if (len(dense) != 4 * blocks
            or any(m.weight.dtype != torch.float32 for m in dense)):
        fail(f"dynamic: {len(dense)} QuantDense layers (expected "
             f"{4 * blocks}), weights "
             f"{sorted({str(m.weight.dtype) for m in dense})}")
    _, launches = _serve_requests(
        "dynamic", _argmax_call(model), requests, cache, counters,
        {"patch_embed": 1, "flash_attention_flat": blocks})
    _add(total, launches)
    d_ref = _int8_logits_gate("dynamic int8 half-res", model, plain, ref32,
                              requests[1], cache, what="dynamic int8",
                              return_halfres=True)
    _backbone_numbers("(b) dynamic int8", _argmax_call(model),
                      _argmax_call(plain), requests, cache)
    del model, plain
    _free()

    # (b)'s reference pair: the parity config with quant_int8=True
    par = LSegNet(variant(quant_int8=True), torch.bfloat16, dev).eval()
    par.load_state_dict(ref32.state_dict())
    par32 = LSegNet(base, torch.float32, dev).eval()
    par32.load_state_dict(ref32.state_dict())
    del ref32
    _serve_requests("parity dynamic", _argmax_call(par), requests[1:2],
                    cache, counters, {})
    _, labels, images = requests[1]
    txt = cache(labels)
    with torch.inference_mode():
        lq = par(images, txt, return_halfres=True).float()
        lr = par32(images, txt, return_halfres=True).float()
    if not torch.isfinite(lq).all():
        fail("parity dynamic: half-res logits not finite")
    # the same function as (b)'s plain path with einsum attention: as far
    # from fp32 as phase 3b's rule lets a kernel path sit from its twin
    d_par = float((lq - lr).abs().max())
    bound = SERVE_RATIO * d_ref + SERVE_FLOOR
    print(f"  parity config, quant_int8=True (bf16) vs fp32: half-res "
          f"logits |diff| max {d_par:.6g} (gate: <= {SERVE_RATIO} * (b)'s "
          f"|plain - fp32| {d_ref:.6g} + {SERVE_FLOOR} = {bound:.6g}), max "
          f"|logit| {float(lr.abs().max()):.4g}, label agreement "
          f"{_agree(lq.argmax(-1), lr.argmax(-1)):.4f} (not gated)")
    if d_par > bound:
        fail(f"parity dynamic: half-res logits {d_par} from fp32 > {bound}")
    del par, par32
    _free()
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s")
    return total, i8qk


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
    launches_t, launches_t32 = phase_training(dev, cache, ade)
    launches_p = phase_probe(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_evaluation(dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches_b, widths = phase_backbones(dev)
    ran = {k for k, v in launches_b.items() if v}
    if ran != BACKBONE_KERNELS:
        fail(f"phase 8 launched {sorted(ran)}, expected "
             f"{sorted(BACKBONE_KERNELS)}")
    _free()
    # phase 9's tree, .ckpt and vocabulary serve phase 11 too
    shared_dir = tempfile.TemporaryDirectory()
    shared = shared_dir.name
    launches_f = phase_fewshot(dev, shared)
    ran = {k for k, v in launches_f.items() if v}
    if ran != FEWSHOT_KERNELS:
        fail(f"phase 9 launched {sorted(ran)}, expected "
             f"{sorted(FEWSHOT_KERNELS)}")
    _free()
    launches_par = phase_parallel(dev)
    _free()
    launches_tools = phase_tools(dev, shared)
    shared_dir.cleanup()
    ran = {k for k, v in launches_tools.items() if v}
    if ran != TOOLS_KERNELS:
        fail(f"phase 11 launched {sorted(ran)}, expected "
             f"{sorted(TOOLS_KERNELS)}")
    _free()
    launches_im, i8qk_launches = phase_int8_modes(dev, cache, requests)
    ran = {k for k, v in launches_im.items() if v}
    if ran != INT8_MODES_KERNELS:
        fail(f"phase 12 launched {sorted(ran)}, expected "
             f"{sorted(INT8_MODES_KERNELS)}")
    # B2's int8 Q.K^T mode runs on phase 12's path (a) alone
    kernels["flash_attention_ln_qkv_fused_q8"]["i8qk"][
        "launches"] = i8qk_launches
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
    # the fp32 modes of B6 and B7 on the fp32 train step (phase 5b2)
    launches["flash_attention_flat_fp32"] = launches_t32[
        "flash_attention_flat"]
    launches["flash_attention_flat_bwd_fp32"] = launches_t32[
        "flash_attention_flat_bwd"]
    sources = {
        "patch_embed": ("lseg_tpu_torch/csrc/patch_embed.cu",
                        "lseg_tpu/ops/pallas_patch.py:59"),
        "flash_attention_flat": ("lseg_tpu_torch/csrc/flash_attention_flat.cu",
                                 "lseg_tpu/ops/pallas_attention.py:110"),
        "flash_attention_flat_bwd": (
            "lseg_tpu_torch/csrc/flash_attention_flat_bwd.cu",
            "lseg_tpu/ops/pallas_attention.py:612"),
        "flash_attention_flat_fp32": (
            "lseg_tpu_torch/csrc/flash_attention_flat_fp32.cu",
            "lseg_tpu/ops/pallas_attention.py:110"),
        "flash_attention_flat_bwd_fp32": (
            "lseg_tpu_torch/csrc/flash_attention_flat_bwd_fp32.cu",
            "lseg_tpu/ops/pallas_attention.py:612"),
        "ln_quantize_rows": ("lseg_tpu_torch/csrc/ln_quantize_rows.cu",
                             "lseg_tpu/ops/pallas_ln.py:43"),
        "flash_attention_ln_qkv_fused_q8": (
            "lseg_tpu_torch/csrc/flash_attention_ln_qkv_q8.cu",
            "lseg_tpu/ops/pallas_attention.py:780"),
        "head1_correlate_fused": ("lseg_tpu_torch/csrc/head1_correlate.cu",
                                  "lseg_tpu/ops/pallas_correlation.py:638"),
        "head1_correlate_fused_mma": (
            "lseg_tpu_torch/csrc/head1_correlate_wide.cu",
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
        elif k in YARDSTICK_KERNELS:
            launches[k] = 0  # every serving phase held it at 0 a request
        elif launches[k] == 0:
            fail(f"kernel {k} was not launched on a model path or the "
                 f"training path")
        src, rep = sources[k]
        # max_abs_err of the label kernels (B11, B5, B13): the fraction of
        # labels that differ from the plain version's
        rows.append({"name": k, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[k], **res,
                     "backbone_launches": launches_b.get(k, 0),
                     "fewshot_launches": launches_f.get(k, 0),
                     "parallel_launches": launches_par.get(
                         k, [0] * PARALLEL_WORLD),
                     "tools_launches": launches_tools.get(k, 0),
                     "int8_modes_launches": launches_im.get(k, 0),
                     **({"widths": widths[k]} if k in widths else {})})
    print(f"  total {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-rank"]:
        sys.exit(parallel_rank(*sys.argv[2:]))
    sys.exit(main())
