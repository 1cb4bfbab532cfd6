"""Copy this checkout into a directory with one named variant of a kernel
source applied: a design alternative or a cut to time beside the tree,
or a mutation that the card's checks must catch.

    python -m lseg_tpu_torch.engine.variant_tree NAME DIR
    cd DIR && python -m lseg_tpu_torch.engine.variant_tree --timeline

DIR (a git-ignored directory such as `build/variants/NAME`) receives the
checkout without `.git`, `build/` and `chiprun_out/`, with the variant's
text substitutions applied to a source of `lseg_tpu_torch/csrc` (or,
as `../<path>.py`, a module of the package); run a script from
there (`cd DIR && python3 chip_smoke.py`) or time it against the tree
(`lseg_tpu_torch/engine/time_gemm.py --root DIR`). A substitution that no
longer matches its source fails with exit code 1. `--timeline`, run from
a `b16_timeline` copy, runs that copy's B16 on the card at ViT-L/16's
MLP, (8, 901, 1024) codes and H = 4096, and prints one JSON line: the
median over the CTAs of the microseconds between the kernel's phase
points (`TIMELINE_PHASES`), and the spread of the CTAs' start times;
`--timeline b18`, from a `b18_timeline` copy, does the same for B18 at
(8, 120, 120, 256) and (8, 15, 15, 256) (`B18_PHASES`); `--timeline b1`
(and b13, b14, b5, b19, b19_wide, b11) from that kernel's copy.
Variants:

- `head1_correlate_mma_sync`: the correlate of B13, B14 and B5 on
  mma.sync m16n8k16 (the earlier design) instead of wgmma m64n152k16;
- `b6_fp32_expf`: B6's fp32 mode with expf of the scaled score (lse =
  m + log l) in place of ex2.approx of the score prescaled by log2 e;
- `b6_fp32_lb3`: B6's fp32 mode compiled for three blocks an SM (168
  registers a thread) instead of two (255);
- `b16_fc1_2stages`: B16 with a two-stage fc1 ring instead of three;
- `b16_s2_3`: B16 with three fc2 stages instead of six;
- `b16_copy_8`: B16's copier lanes loading a chunk's 256 bytes in two
  rounds of eight loads instead of one of sixteen (56 registers for the
  producer warpgroup, 224 for the consumers, instead of 88 and 208);
- `b16_timeline`: B16 stamping the global timer at its phase points;
- `b18_timeline`: B18 the same (`--timeline b18` reads it);
- `b13_timeline`: B13 summing, per CTA, its steps' time on the logits
  and on the output rows (`--timeline b13` reads it);
- `b6_fp32_no_alo_bhi`: split TF32 without the a_lo . b_hi product, a
  mutation of B6's fp32 mode (and B7's, which phase 2 of `chip_smoke.py`
  checks after B6's);
- `b16_slice_amax`: B16 with each CTA's requantize scale taken over its
  own hidden slice only (no cluster exchange), a mutation;
- `b2_slice_amax`: B2 with each CTA's row scale taken over its own head
  pair's 128 columns only (no cluster exchange), a mutation;
- `b15_pair0_scale`: B15's projection flushing every pair's int32 sum
  with pair 0's row scale, a mutation;
- `b18_skip_peer`: B18's q2 exchange skipping one peer's slice (CTA r
  never sends its slice to CTA r + 1 of the cluster), a mutation;
- `b13_stale_ring`: B13's ring of logit rows not advanced past a
  segment's first row, a mutation;
- `b13_tie_to_later`: B13's running key of an output pixel replaced by a
  later label chunk's best on equal values (ties to the later label), a
  mutation (phase 2 catches it at K = 300);
- `b14_stale_neighbour`: B14's last lanes taking their own warp's first
  pixel as the right neighbour of their second row, a mutation;
- `b5_unmasked_padding`: B5's labels past K (zero text rows) competing in
  the argmax, a mutation (the all-negative case catches it);
- `b19_timeline`: B19 summing, per consumer warpgroup, its time waiting
  for source rows, in its pair's H-blends and W-blends, its products and
  its epilogues (`--timeline b19`); `b19_wide_timeline`: the earlier B19
  kernel (`fused_upsample_outconv_wide.cu`) summing, per CTA, its tiles'
  blend and their products and epilogues (`--timeline b19_wide`);
- `b19_stale_ring`: B19's tiles reading their top source row from the
  ring slot one load back, a mutation (phase 2 catches it);
- `b3_no_division`: B3's codes by the reciprocal's product alone, without
  the IEEE division near a half-integer, a mutation (the CPU emulation
  `test_b3_fast_codes_are_the_division` holds its arithmetic);
- `b11_timeline`: B11 summing, per consumer group, its time waiting for
  source rows, in its H-blends and in its W-blends (`--timeline b11`);
- `b11_stale_ring`: B11's groups blending their top source row from the
  ring slot one load back, a mutation (phase 2 catches it);
- `b4_last_chunk_dropped`: B4 leaving out the row copies of a step's last
  label chunk (K > 152), a mutation (phase 2's K = 300 check catches it);
- `b1_timeline`: B1 summing, per CTA, a converter thread's waits (for
  the fp32 segments and a free stage) and the rest of its walk, the
  weight loader's waits for free stages, and its first consumer
  warpgroup's waits for converted stages, main loop and epilogue
  (`--timeline b1`);
- `b1_stale_stage`: B1's consumers reading a stage's A one stage ahead,
  before its converted A is published, a mutation (phase 2 catches it);
- `b7_dk_zeroed`: B7 writing zeros for dK, a mutation (phase 2 and phase
  9's E3 catch it);
- `episodic_pairs_rolled`: `engine/episodic.py`'s predictor pairing image
  i with image i - 1's labels, a mutation (phase 9's E1 catches it);
- `episode_ignore_dropped`: `ops.metrics.episode_inter_union` counting
  the ignore region, a mutation (phase 9's E4 catches it);
- `b6_last_keys_dropped`: B6 (its own kernel only, not the attention
  interior that B2, B8 and B9 share) masking the last 64 valid keys of
  each image, a mutation (phase 7's single-scale gate is run against it);
- `b20_drop_peer`: B20 summing three of the cluster's four int32
  partials (the last peer's dropped), a mutation (phase 2 catches it);
- `b14_timeline`, `b5_timeline`: B14 summing, per CTA, its steps' time on
  the logits and on the outputs (W-interp, staging, copies); B5 its
  steps' wait for the codes and the rest of each step (`--timeline b14`,
  `--timeline b5`).

Cuts, whose outputs are wrong by design (only their time is read):
- `b16_no_gelu`: B16's GELU replaced by its argument;
- `b16_no_dsm`: B16's copy of the peers' codes writes without reading
  distributed shared memory;
- `b16_no_fence`: B16's codes copy without its proxy fence (the copy may
  race the products);
- `b16_no_copy`: B16's copier arriving on the fc2 stages without reading
  or writing the codes;
- `b16_fc2_no_mma`: B16's fc2 loads and copies without its products;
- `b16_fc2_one_w2`: B16's fc2 loading the same w2 box for every chunk;
- `b16_no_fc2`: B16 without fc2 (no k-chunks: no w2 loads, codes copies
  or products; its epilogue stores the bias and residual);
- `qkv_no_mma`: the s8 qkv GEMM of B2, B8, B9 and B15 without its
  products (its loads and its epilogue stay);
- `qkv_no_epilogue`: that GEMM without its epilogue (no dequant, no
  stage writes, no TMA stores);
- `pair_no_epilogue`: B15's head-pair attention without its epilogue
  (no division, amax, codes or stores after the interior);
- `pair_rcp`: the head-pair epilogue dividing O by l as a product with
  the row sum's reciprocal, and `quantize_rcp`: every int8 quantize of
  the port (`lseg_common.cuh`) dividing by the scale the same way (the
  cost of the IEEE divisions);
- `proj_no_flush`: B15's projection without its per-pair flushes;
- `proj_no_mma`: B15's projection without its products;
- `b18_no_mma`: B18 without its products (loads, staging, exchange and
  epilogues stay);
- `b18_no_q1`: B18 without the global loads of its q1 staging;
- `b13_no_blend`: B13 without its output rows (no blend, W-interp,
  argmax or label stores);
- `b13_no_correlate`: B13 (and B14, B5) without their correlate
  products;
- `b13_no_store`: B13 without its label stores;
- `b13_no_sync`: B13 without the barrier of each output row (the next
  warp's edge pixel is read unsynchronized);
- `b13_no_interp`: B13 with its argmax reduced to one xor a label (no
  keys, no max);
- `b5_unroll6`: B5's quantizers with six 16-channel groups in flight
  (72 registers for the producer warpgroup, 216 for the consumers)
  instead of four (56, 224);
- `b5_no_prefetch`: B5 without its L2 prefetch of the bf16 rows;
- `b19_no_hblend`: B19's H-blend copying the top row instead of blending;
- `b19_no_wblend`: B19's W-blend and codes replaced by one xor of the
  loaded H-blends (loads and stores stay);
- `b19_no_epilogue`: B19's epilogue staging one xor of two accumulators
  instead of y and its codes (the staging and the stores stay);
- `b11_no_hblend`: B11 without its H-blend (the rows are waited for and
  released, the W-blend reads the unwritten buffer); `b11_no_wblend`: B11
  storing a constant label instead of its W-blend and argmax;
- `b14_no_copy`: B14 staging its outputs without copying them out;
- `b14_no_stage`: B14 without its W-interp and staging (its hand-off of
  the neighbours and its copies of the unwritten staging stay).
"""

from __future__ import annotations

import argparse
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

# variant -> (source under lseg_tpu_torch/csrc, [(old, new), ...])
VARIANTS = {
    "b6_fp32_expf": ("flash_attention_flat_fp32.cu", [
        ("const float sc = scale * kLog2e;", "const float sc = scale;"),
        ("lseg::exp2_approx(", "expf("),
        ("(m_run[h] + log2f(l[h])) * kLn2", "m_run[h] + logf(l[h])"),
    ]),
    "b6_fp32_lb3": ("flash_attention_flat_fp32.cu", [
        ("__launch_bounds__(THREADS, 2)", "__launch_bounds__(THREADS, 3)"),
    ]),
    "b16_fc1_2stages": ("mlp_fused.cu", [
        ("constexpr int S1 = 3;", "constexpr int S1 = 2;"),
    ]),
    "b16_copy_8": ("mlp_fused.cu", [
        ("      uint4 v[A_BYTES / 16 / 32];\n#pragma unroll\n"
         "      for (int j = 0; j < A_BYTES / 16 / 32; ++j)\n"
         "        v[j] = ld_peer(src + 16 * (lane + 32 * j));\n"
         "#pragma unroll\n"
         "      for (int j = 0; j < A_BYTES / 16 / 32; ++j) "
         "st[lane + 32 * j] = v[j];",
         "      for (int h = 0; h < 2; ++h) {\n        uint4 v[8];\n"
         "        for (int j = 0; j < 8; ++j)\n"
         "          v[j] = ld_peer(src + 16 * (lane + 32 * (8 * h + j)));\n"
         "        for (int j = 0; j < 8; ++j) "
         "st[lane + 32 * (8 * h + j)] = v[j];\n      }"),
        ("gm::regs_dec<88>();", "gm::regs_dec<56>();"),
        ("gm::regs_inc<208>();", "gm::regs_inc<224>();"),
    ]),
    "b16_s2_3": ("mlp_fused.cu", [
        ("constexpr int S2 = 6;", "constexpr int S2 = 3;"),
    ]),
    "b16_timeline": ("mlp_fused.cu", [
        ('#include "wgmma_gemm.cuh"\n', '#include "wgmma_gemm.cuh"\n'
         "__device__ unsigned long long lseg_b16_stamps[1024][10];\n"
         "__device__ unsigned long long lseg_b16_chunks[1024][2][32];\n"
         "#define NOW(v) asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
         "\"=l\"(v) :: \"memory\")\n"
         "#define STAMP(i) if (threadIdx.x == 128 && blockIdx.x < 1024) "
         "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"("
         "lseg_b16_stamps[blockIdx.x][i]) :: \"memory\")\n"
         "extern \"C\" int lseg_b16_timeline(void* dst) {\n"
         "  int rc = static_cast<int>(cudaMemcpyFromSymbol(dst, "
         "lseg_b16_stamps, sizeof(lseg_b16_stamps)));\n"
         "  if (rc != 0) return rc;\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(static_cast<char*>"
         "(dst) + sizeof(lseg_b16_stamps), lseg_b16_chunks, "
         "sizeof(lseg_b16_chunks)));\n}\n"),
        # when thread 0 issues each w2 box, and when the consumer has each
        # fc2 chunk
        ("                        &sm.r2.full[s], chunk2(it) * BK, d0);\n",
         "                        &sm.r2.full[s], chunk2(it) * BK, d0);\n"
         "        if (blockIdx.x < 1024 && it < 32) "
         "NOW(lseg_b16_chunks[blockIdx.x][0][it]);\n"),
        ("&sm.r2.full[s], c * BK,\n                        d0);\n",
         "&sm.r2.full[s], c * BK,\n                        d0);\n"
         "      if (tma && blockIdx.x < 1024 && it < 32) "
         "NOW(lseg_b16_chunks[blockIdx.x][0][it]);\n"),
        ("    const int s = sm.r2.wait(it);\n",
         "    const int s = sm.r2.wait(it);\n    if (threadIdx.x == 128 && "
         "blockIdx.x < 1024 && it < 32) "
         "NOW(lseg_b16_chunks[blockIdx.x][1][it]);\n"),
        ("  cl::sync();  // the barriers are set and every CTA of the "
         "cluster runs\n",
         "  STAMP(0);\n  cl::sync();  // the barriers are set and every "
         "CTA of the cluster runs\n  STAMP(1);\n"),
        ("  if (tid == 0) sm.r1.release(n_k1 - 1);\n",
         "  if (tid == 0) sm.r1.release(n_k1 - 1);\n  STAMP(2);\n"),
        ("  cl::sync();  // the row maxima are exchanged\n\n",
         "  STAMP(3);\n  cl::sync();  // the row maxima are exchanged\n"
         "  STAMP(4);\n\n"),
        ("  cl::sync();  // the codes are written\n\n",
         "  STAMP(5);\n  cl::sync();  // the codes are written\n"
         "  STAMP(6);\n\n"),
        ("  wg::wait<0>();\n  gm::fence_acc(acc2);\n",
         "  wg::wait<0>();\n  gm::fence_acc(acc2);\n  STAMP(7);\n"),
        ("  cl::sync();  // no CTA leaves while a peer may read its "
         "codes\n}",
         "  STAMP(8);\n  cl::sync();  // no CTA leaves while a peer may "
         "read its codes\n  STAMP(9);\n}"),
    ]),
    "b16_no_gelu": ("mlp_fused.cu", [
        ("return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, "
         "tanhf(inner)));", "return x;"),
    ]),
    "b16_no_dsm": ("mlp_fused.cu", [
        ("v[j] = ld_peer(src + 16 * (lane + 32 * j));",
         "v[j] = make_uint4(src, 0, 0, 0);"),
    ]),
    "b16_no_fence": ("mlp_fused.cu", [
        ("      gm::fence_proxy_async();  // the copy's writes before wgmma "
         "reads\n", ""),
    ]),
    "b16_no_copy": ("mlp_fused.cu", [
        ("      gm::fence_proxy_async();  // the copy's writes before wgmma "
         "reads\n", ""),
        ("v[j] = ld_peer(src + 16 * (lane + 32 * j));",
         "v[j] = make_uint4(src, 0, 0, 0);"),
        ("st[lane + 32 * j] = v[j];", "(void)v[j];"),
    ]),
    "b16_fc2_no_mma": ("mlp_fused.cu", [
        ("      gm::MmaS8<DC / 2>::ss(acc2, wg::desc_kstep(da, kk),\n"
         "                            wg::desc_kstep(db, kk), 1);\n", ""),
    ]),
    "b16_fc2_one_w2": ("mlp_fused.cu", [
        ("&sm.r2.full[s], chunk2(it) * BK, d0);", "&sm.r2.full[s], 0, d0);"),
        ("&sm.r2.full[s], c * BK,\n                        d0);",
         "&sm.r2.full[s], 0,\n                        d0);"),
    ]),
    "b16_no_fc2": ("mlp_fused.cu", [
        ("const int n_k2 = C * CHUNKS;", "const int n_k2 = 0;"),
    ]),
    "qkv_no_mma": ("qkv_wgmma.cuh", [
        ("        gemm::MmaS8<BN>::ss(acc, wg::desc_kstep(da, kk),\n"
         "                            wg::desc_kstep(db, kk), "
         "kc > 0 || kk > 0);\n", ""),
    ]),
    "qkv_no_epilogue": ("qkv_wgmma.cuh", [
        ("    for (int nt = 0; nt < BN / 8; ++nt) {\n",
         "    for (int nt = 0; nt < 0; ++nt) {\n"),
        ("      for (int b = 0; b < BN / 64; ++b)\n",
         "      for (int b = 0; b < 0; ++b)\n"),
    ]),
    "pair_no_epilogue": ("pair_attention.cuh", [
        ("             scale * 1.4426950408889634f, tid, 1 + hh, o, m2, l);\n",
         "             scale * 1.4426950408889634f, tid, 1 + hh, o, m2, l);\n"
         "  if constexpr (!ROW) return;\n"),
    ]),
    "pair_rcp": ("pair_attention.cuh", [
        ("__fdiv_rn(o[dt][2 * r + e], l[r])",
         "o[dt][2 * r + e] * __frcp_rn(l[r])"),
    ]),
    "quantize_rcp": ("lseg_common.cuh", [
        ("rintf(__fdiv_rn(v, s))", "rintf(v * __frcp_rn(s))"),
    ]),
    "proj_no_flush": ("flash_attention_qkvp_fused.cu", [
        ("      for (int nt = 0; nt < BN / 8; ++nt) {\n"
         "        const int col = n0 + nt * 8 + 2 * t4;\n",
         "      for (int nt = 0; nt < 0; ++nt) {\n"
         "        const int col = n0 + nt * 8 + 2 * t4;\n"),
    ]),
    "proj_no_mma": ("flash_attention_qkvp_fused.cu", [
        ("        gm::MmaS8<BN>::ss(acc, wg::desc_kstep(da, kk),\n"
         "                          wg::desc_kstep(db, kk), kk > 0);\n", ""),
    ]),
    "b18_skip_peer": ("fused_rcu.cu", [
        ("        if (peer != rank) cl::st_peer(cl::peer_addr(p, peer), v);",
         "        if (peer != rank && peer != (rank + 1) % S)\n"
         "          cl::st_peer(cl::peer_addr(p, peer), v);"),
    ]),
    "b13_stale_ring": ("head1_correlate_upsample_argmax.cu", [
        ("      for (int w = 0; w < hw::KT; ++w) sm.prev[h * hw::KT + w][ct] = "
         "cur[h][w];",
         "      for (int w = 0; w < hw::KT; ++w)\n"
         "        if (step == 0) sm.prev[h * hw::KT + w][ct] = cur[h][w];"),
    ]),
    "b18_timeline": ("fused_rcu.cu", [
        ('#include "wgmma_gemm.cuh"\n', '#include "wgmma_gemm.cuh"\n'
         "__device__ unsigned long long lseg_b18_stamps[4096][8];\n"
         "#define STAMP(i) if (threadIdx.x == 128) { const unsigned b = "
         "blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); "
         "if (b < 4096) asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
         "\"=l\"(lseg_b18_stamps[b][i]) :: \"memory\"); }\n"
         "extern \"C\" int lseg_b18_timeline(void* dst) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, "
         "lseg_b18_stamps, sizeof(lseg_b18_stamps)));\n}\n"),
        ("  cl::sync();  // the barriers are set and every CTA of the cluster"
         " runs\n",
         "  STAMP(0);\n  cl::sync();  // the barriers are set and every CTA "
         "of the cluster runs\n  STAMP(1);\n"),
        ("  cl::sync();  // every CTA's q1 is whole\n",
         "  cl::sync();  // every CTA's q1 is whole\n  STAMP(2);\n"),
        ("    conv<C, 2>(sm, acc, abase, q1c, 0, tid);\n",
         "    conv<C, 2>(sm, acc, abase, q1c, 0, tid);\n    STAMP(3);\n"),
        ("    conv1_epilogue(a, sm, q2s, LD, acc, c, ch0, r0, c0, *a.s2_inv);\n",
         "    conv1_epilogue(a, sm, q2s, LD, acc, c, ch0, r0, c0, *a.s2_inv);\n"
         "    STAMP(4);\n"),
        ("  cl::sync();  // the q2 slices are exchanged\n\n",
         "  cl::sync();  // the q2 slices are exchanged\n  STAMP(5);\n\n"),
        ("    conv<C, 2>(sm, acc, abase, q2c, NK, tid);\n",
         "    conv<C, 2>(sm, acc, abase, q2c, NK, tid);\n    STAMP(6);\n"),
        ("    conv2_epilogue<2>(a, sm, acc, 0, C, ch0, r0, c0, img);\n",
         "    conv2_epilogue<2>(a, sm, acc, 0, C, ch0, r0, c0, img);\n"
         "    STAMP(7);\n"),
    ]),
    "b13_timeline": ("head1_correlate_upsample_argmax.cu", [
        ('#include "head1_wgmma.cuh"\n', '#include "head1_wgmma.cuh"\n'
         "__device__ unsigned long long lseg_b13_stamps[1024][4];\n"
         "#define NOW(v) asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
         "\"=l\"(v) :: \"memory\")\n"
         "extern \"C\" int lseg_b13_timeline(void* dst) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, "
         "lseg_b13_stamps, sizeof(lseg_b13_stamps)));\n}\n"),
        ("  uint32_t it = 0;\n  for (int ls = 0; ls < chunks * steps; ++ls) {\n",
         "  uint32_t it = 0;\n  unsigned long long t_a, t_b, t_c, "
         "sum_logits = 0, sum_rows = 0, t_start;\n  NOW(t_start);\n"
         "  for (int ls = 0; ls < chunks * steps; ++ls) {\n    NOW(t_a);\n"),
        ("    hw::logits(cacc, ss, cur);\n",
         "    hw::logits(cacc, ss, cur);\n    NOW(t_b);\n"
         "    sum_logits += t_b - t_a;\n"),
        ("    // this row's logits become the previous row's (this thread's "
         "own)\n",
         "    NOW(t_c);\n    sum_rows += t_c - t_b;\n"
         "    // this row's logits become the previous row's (this thread's "
         "own)\n"),
        ("      for (int w = 0; w < hw::KT; ++w) sm.prev[h * hw::KT + w][ct] = "
         "cur[h][w];\n  }\n}\n",
         "      for (int w = 0; w < hw::KT; ++w) sm.prev[h * hw::KT + w][ct] = "
         "cur[h][w];\n  }\n  const unsigned b = blockIdx.x + gridDim.x * "
         "(blockIdx.y + gridDim.y * blockIdx.z);\n"
         "  if (threadIdx.x == 128 && b < 1024) {\n    NOW(t_a);\n"
         "    lseg_b13_stamps[b][0] = t_a - t_start;\n"
         "    lseg_b13_stamps[b][1] = sum_logits;\n"
         "    lseg_b13_stamps[b][2] = sum_rows;\n"
         "    lseg_b13_stamps[b][3] = steps;\n  }\n}\n"),
    ]),
    "b19_timeline": ("fused_upsample_outconv.cu", [
        ('#include "wgmma_gemm.cuh"\n', '#include "wgmma_gemm.cuh"\n'
         "__device__ unsigned long long lseg_b19_stamps[1024][4][7];\n"
         "#define NOW(v) asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
         "\"=l\"(v) :: \"memory\")\n"
         "extern \"C\" int lseg_b19_timeline(void* dst) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, "
         "lseg_b19_stamps, sizeof(lseg_b19_stamps)));\n}\n"),
        ("  uint32_t seen = 0, rel = 0;  // next load to wait for, to release\n",
         "  unsigned long long t_a, t_b, t_c, t_d, t_e, t_start, s_wait = 0, "
         "s_hblend = 0, s_wblend = 0, s_mma = 0, s_epi = 0, n_tiles = 0;\n"
         "  NOW(t_start);\n"
         "  uint32_t seen = 0, rel = 0;  // next load to wait for, to release\n"),
        ("    wait_upto(f, g);\n",
         "    NOW(t_a);\n    wait_upto(f, g);\n    NOW(t_b);\n"
         "    s_wait += t_b - t_a;\n"),
        ("    wg::named_sync(pair_bar, PAIR_THREADS);  // hb whole; rows read\n",
         "    wg::named_sync(pair_bar, PAIR_THREADS);  // hb whole; rows read\n"
         "    NOW(t_c);\n    s_hblend += t_c - t_b;\n"),
        ("    wg::named_sync(pair_bar, PAIR_THREADS);  // the codes are whole\n",
         "    wg::named_sync(pair_bar, PAIR_THREADS);  // the codes are whole\n"
         "    NOW(t_d);\n    s_wblend += t_d - t_c;\n"),
        ("    product(acc, codes, sm.w + half * NH * 128);\n",
         "    product(acc, codes, sm.w + half * NH * 128);\n    NOW(t_e);\n"
         "    s_mma += t_e - t_d;\n"),
        ("                   col / wk.S * wk.H2 + jo, t, wg_bar);\n",
         "                   col / wk.S * wk.H2 + jo, t, wg_bar);\n"
         "    NOW(t_a);\n    s_epi += t_a - t_e;\n    ++n_tiles;\n"),
        ("  if (t == 0) asm volatile(\"cp.async.bulk.wait_group 0;\\n\" ::: "
         "\"memory\");\n}\n",
         "  if (t == 0) asm volatile(\"cp.async.bulk.wait_group 0;\\n\" ::: "
         "\"memory\");\n  if (t == 0 && blockIdx.x < 1024) {\n    NOW(t_a);\n"
         "    unsigned long long* r = lseg_b19_stamps[blockIdx.x][tid / 128];\n"
         "    r[0] = t_a - t_start;\n    r[1] = s_wait;\n    r[2] = s_hblend;\n"
         "    r[3] = s_wblend;\n    r[4] = s_mma;\n    r[5] = s_epi;\n"
         "    r[6] = n_tiles;\n  }\n}\n"),
    ]),
    "b19_wide_timeline": ("fused_upsample_outconv_wide.cu", [
        ('#include "lseg_common.cuh"\n', '#include "lseg_common.cuh"\n'
         "__device__ unsigned long long lseg_b19_wide_stamps[1024][4];\n"
         "#define NOW(v) asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
         "\"=l\"(v) :: \"memory\")\n"
         "extern \"C\" int lseg_b19_wide_timeline(void* dst) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, "
         "lseg_b19_wide_stamps, sizeof(lseg_b19_wide_stamps)));\n}\n"),
        ("  const int groups = C / 8;  // 8 channels (16 bytes of bf16) per "
         "item\n",
         "  const int groups = C / 8;  // 8 channels (16 bytes of bf16) per "
         "item\n  unsigned long long t_a, t_b, t_c, t_start, s_blend = 0, "
         "s_rest = 0, n_tiles = 0;\n  NOW(t_start);\n"),
        ("    const int p0 = tile * BM;\n",
         "    const int p0 = tile * BM;\n    NOW(t_a);\n"),
        ("      *reinterpret_cast<uint2*>(As + pl * ld + cg) = codes;\n    }\n"
         "    __syncthreads();\n",
         "      *reinterpret_cast<uint2*>(As + pl * ld + cg) = codes;\n    }\n"
         "    __syncthreads();\n    NOW(t_b);\n    s_blend += t_b - t_a;\n"),
        ("    __syncthreads();  // the next tile rewrites As\n  }\n}\n",
         "    __syncthreads();  // the next tile rewrites As\n    NOW(t_c);\n"
         "    s_rest += t_c - t_b;\n    ++n_tiles;\n  }\n"
         "  if (threadIdx.x == 0 && blockIdx.x < 1024) {\n    NOW(t_a);\n"
         "    lseg_b19_wide_stamps[blockIdx.x][0] = t_a - t_start;\n"
         "    lseg_b19_wide_stamps[blockIdx.x][1] = s_blend;\n"
         "    lseg_b19_wide_stamps[blockIdx.x][2] = s_rest;\n"
         "    lseg_b19_wide_stamps[blockIdx.x][3] = n_tiles;\n  }\n}\n"),
    ]),
    "b19_stale_ring": ("fused_upsample_outconv.cu", [
        ("    hblend_strip(hb, sm.ring[f % RING], sm.ring[g % RING],",
         "    hblend_strip(hb, sm.ring[(f + RING - 1) % RING],\n"
         "                 sm.ring[g % RING],"),
    ]),
    "b19_no_wblend": ("fused_upsample_outconv.cu", [
        ("      const uint4 u = blend8(ha[k], hc[k], __int_as_float(tp[k].z),\n"
         "                             __int_as_float(tp[k].w));\n"
         "      uint2 q = make_uint2(codes4(u.x, u.y, inv_in), "
         "codes4(u.z, u.w, inv_in));\n",
         "      uint2 q = make_uint2(ha[k].x ^ hc[k].y, ha[k].z ^ hc[k].w);\n"),
    ]),
    "b19_no_hblend": ("fused_upsample_outconv.cu", [
        ("        blend8(*reinterpret_cast<const uint4*>(top + off),\n"
         "               *reinterpret_cast<const uint4*>(bot + off), w0, w1);\n",
         "        *reinterpret_cast<const uint4*>(top + off);\n"),
    ]),
    "b19_no_epilogue": ("fused_upsample_outconv.cu", [
        ("        if constexpr (INT8) {\n"
         "          *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(\n"
         "              __byte_perm(code_bits(y0, inv_out), code_bits(y1, "
         "inv_out),\n                          0x0040));\n"
         "        } else {\n"
         "          *reinterpret_cast<uint32_t*>(dst) = lseg::pack_f32(y0, y1);"
         "\n        }\n",
         "        *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(\n"
         "            acc[nt][2 * h] ^ acc[nt][2 * h + 1]);\n"),
    ]),
    "b3_no_division": ("ln_quantize.cuh", [
        ("      if (__builtin_expect(near, 0)) {\n",
         "      if (false && near) {\n"),
    ]),
    "b14_timeline": ("head1_correlate_wup.cu", [
        ('#include "head1_wgmma.cuh"\n', '#include "head1_wgmma.cuh"\n'
         "__device__ unsigned long long lseg_b14_stamps[1024][4];\n"
         "#define NOW(v) asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
         "\"=l\"(v) :: \"memory\")\n"
         "extern \"C\" int lseg_b14_timeline(void* dst) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, "
         "lseg_b14_stamps, sizeof(lseg_b14_stamps)));\n}\n"),
        ("  uint32_t it = 0;\n  for (int ls = 0; ls < steps; ++ls) {\n",
         "  uint32_t it = 0;\n  unsigned long long t_a, t_b, t_c, "
         "sum_logits = 0, sum_out = 0, t_start;\n  NOW(t_start);\n"
         "  for (int ls = 0; ls < steps; ++ls) {\n    NOW(t_a);\n"),
        ("    hw::logits(cacc, ss, cur);\n",
         "    hw::logits(cacc, ss, cur);\n    NOW(t_b);\n"
         "    sum_logits += t_b - t_a;\n"),
        ("        asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: "
         "\"memory\");\n      }\n    }\n  }\n",
         "        asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: "
         "\"memory\");\n      }\n    }\n    NOW(t_c);\n"
         "    sum_out += t_c - t_b;\n  }\n"
         "  if (threadIdx.x == 128 && blockIdx.x < 1024) {\n    NOW(t_a);\n"
         "    lseg_b14_stamps[blockIdx.x][0] = t_a - t_start;\n"
         "    lseg_b14_stamps[blockIdx.x][1] = sum_logits;\n"
         "    lseg_b14_stamps[blockIdx.x][2] = sum_out;\n"
         "    lseg_b14_stamps[blockIdx.x][3] = steps;\n  }\n"),
    ]),
    "b5_timeline": ("head1_correlate_argmax.cu", [
        ('#include "head1_wgmma.cuh"\n', '#include "head1_wgmma.cuh"\n'
         "__device__ unsigned long long lseg_b5_stamps[1024][4];\n"
         "#define NOW(v) asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
         "\"=l\"(v) :: \"memory\")\n"
         "extern \"C\" int lseg_b5_timeline(void* dst) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, "
         "lseg_b5_stamps, sizeof(lseg_b5_stamps)));\n}\n"),
        ("  uint32_t it = 0;\n  for (int ls = 0; ls < steps; ++ls) {\n"
         "    const int m0",
         "  uint32_t it = 0;\n  unsigned long long t_a, t_b, "
         "sum_wait = 0, sum_step = 0, t_start;\n  NOW(t_start);\n"
         "  for (int ls = 0; ls < steps; ++ls) {\n    NOW(t_a);\n"
         "    const int m0"),
        ("    hw::codes_full(sm, ls);\n",
         "    hw::codes_full(sm, ls);\n"
         "    NOW(t_b);\n    sum_wait += t_b - t_a;\n"),
        ("      if (t4 == 0 && m0 + pix[h] < a.M) a.out[m0 + pix[h]] = bi[h];\n"
         "    }\n  }\n",
         "      if (t4 == 0 && m0 + pix[h] < a.M) a.out[m0 + pix[h]] = bi[h];\n"
         "    }\n    NOW(t_a);\n    sum_step += t_a - t_b;\n  }\n"
         "  if (threadIdx.x == 128 && blockIdx.x < 1024) {\n    NOW(t_a);\n"
         "    lseg_b5_stamps[blockIdx.x][0] = t_a - t_start;\n"
         "    lseg_b5_stamps[blockIdx.x][1] = sum_wait;\n"
         "    lseg_b5_stamps[blockIdx.x][2] = sum_step;\n"
         "    lseg_b5_stamps[blockIdx.x][3] = steps;\n  }\n"),
    ]),
    "b14_stale_neighbour": ("head1_correlate_wup.cu", [
        ("                : cwarp + 1 < CWARPS ? sm.edge[buf][cwarp + 1][t4][w]",
         "                : cwarp + 1 < CWARPS ? sm.edge[buf][cwarp][t4][w]"),
    ]),
    "b5_unmasked_padding": ("head1_correlate_argmax.cu", [
        ("            if (k < a.K && lseg::argmax_better(v, k, bv[h], bi[h])) {",
         "            if (lseg::argmax_better(v, k, bv[h], bi[h])) {"),
    ]),
    "b13_tie_to_later": ("head1_correlate_upsample_argmax.cu", [
        ("            if (MULTI && ch > 0)\n"
         "              best = max(best, static_cast<uint32_t>(*op));",
         "            if (MULTI && ch > 0 && (static_cast<uint32_t>(*op) >> 16) "
         "> (best >> 16))\n              best = static_cast<uint32_t>(*op);"),
    ]),
    "b11_stale_ring": ("upsample2x_argmax.cu", [
        ("    hblend(hb, reinterpret_cast<const T*>(ring + (l0 % RING) * a.slot),",
         "    hblend(hb, reinterpret_cast<const T*>(\n"
         "               ring + ((l0 + RING - 1) % RING) * a.slot),"),
    ]),
    "b11_timeline": ("upsample2x_argmax.cu", [
        ('#include "wgmma.cuh"\n', '#include "wgmma.cuh"\n'
         "__device__ unsigned long long lseg_b11_stamps[512][2][5];\n"
         "#define NOW(v) asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
         "\"=l\"(v) :: \"memory\")\n"
         "extern \"C\" int lseg_b11_timeline(void* dst) {\n"
         "  return static_cast<int>(cudaMemcpyFromSymbol(dst, "
         "lseg_b11_stamps, sizeof(lseg_b11_stamps)));\n}\n"),
        ("  uint32_t waited = 0, released = 0;  // this group's loads so far\n",
         "  uint32_t waited = 0, released = 0;  // this group's loads so far\n"
         "  unsigned long long t_a, t_b, t_c, t_d, t_start, s_wait = 0, "
         "s_h = 0, s_w = 0, n_rows = 0;\n  NOW(t_start);\n"),
        ("    const uint32_t l0 = base + (i0 - first), l1 = base + (i1 - first);"
         "\n",
         "    const uint32_t l0 = base + (i0 - first), l1 = base + (i1 - first);"
         "\n    NOW(t_a);\n"),
        ("    hblend(hb, reinterpret_cast<const T*>(ring + (l0 % RING) * a.slot),",
         "    NOW(t_b);\n    s_wait += t_b - t_a;\n"
         "    hblend(hb, reinterpret_cast<const T*>(ring + (l0 % RING) * a.slot),"),
        ("    wg::named_sync(1 + grp, GROUP);\n"
         "    // release the rows this group's next tile does not read\n",
         "    wg::named_sync(1 + grp, GROUP);\n    NOW(t_c);\n"
         "    s_h += t_c - t_b;\n"
         "    // release the rows this group's next tile does not read\n"),
        ("    wg::named_sync(1 + grp, GROUP);  // before the next H-blend\n",
         "    wg::named_sync(1 + grp, GROUP);  // before the next H-blend\n"
         "    NOW(t_d);\n    s_w += t_d - t_c;\n    ++n_rows;\n"),
        ("  // the rows this group never read: waited for in order, then "
         "released,\n",
         "  if (t == 0 && blockIdx.x < 512) {\n    NOW(t_a);\n"
         "    unsigned long long* r = lseg_b11_stamps[blockIdx.x][grp];\n"
         "    r[0] = t_a - t_start;\n    r[1] = s_wait;\n    r[2] = s_h;\n"
         "    r[3] = s_w;\n    r[4] = n_rows;\n  }\n"
         "  // the rows this group never read: waited for in order, then "
         "released,\n"),
    ]),
    "b1_stale_stage": ("patch_embed.cu", [
        ("    const uint64_t da = wg::desc(sm.stage[s] + c * 64 * 128);",
         "    const uint64_t da =\n"
         "        wg::desc(sm.stage[(s + 1) % STAGES] + c * 64 * 128);"),
    ]),
    "b1_timeline": ("patch_embed.cu", [
        ('#include "wgmma_gemm.cuh"\n', '#include "wgmma_gemm.cuh"\n'
         "__device__ unsigned long long lseg_b1_stamps[1024][8];\n"
         "#define NOW(v) asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
         "\"=l\"(v) :: \"memory\")\n"
         "extern \"C\" int lseg_b1_timeline(void* dst) {\n"
         "  void* p = nullptr;\n"
         "  cudaError_t e = cudaMemcpyFromSymbol(dst, lseg_b1_stamps, "
         "sizeof(lseg_b1_stamps));\n"
         "  if (e == cudaSuccess) e = cudaGetSymbolAddress(&p, "
         "lseg_b1_stamps);\n"
         "  if (e == cudaSuccess) e = cudaMemset(p, 0, "
         "sizeof(lseg_b1_stamps));\n"
         "  return static_cast<int>(e);\n}\n"),
        ("        const int s = sm.ring.acquire(kc, (BN / 64) * L * 128);\n",
         "        unsigned long long t_p, t_q;\n        NOW(t_p);\n"
         "        const int s = sm.ring.acquire(kc, (BN / 64) * L * 128);\n"
         "        NOW(t_q);\n"
         "        if (blockIdx.x < 1024) lseg_b1_stamps[blockIdx.x][6] += "
         "t_q - t_p;\n"),
        ("      for (int kc = 0; kc < a.n_k; ++kc) {\n"
         "        const int r = sm.raw.wait(kc);\n"
         "        const int s = sm.ring.wait_free(kc);\n",
         "      unsigned long long t_a, t_b, t_l0, t_end, s_wait = 0;\n"
         "      NOW(t_l0);\n"
         "      for (int kc = 0; kc < a.n_k; ++kc) {\n        NOW(t_a);\n"
         "        const int r = sm.raw.wait(kc);\n"
         "        const int s = sm.ring.wait_free(kc);\n"
         "        NOW(t_b);\n        s_wait += t_b - t_a;\n"),
        ("          sm.raw.release(kc);\n        }\n      }\n",
         "          sm.raw.release(kc);\n        }\n      }\n"
         "      NOW(t_end);\n"
         "      if (threadIdx.x == 32 && blockIdx.x < 1024) {\n"
         "        lseg_b1_stamps[blockIdx.x][1] = s_wait;\n"
         "        lseg_b1_stamps[blockIdx.x][2] = t_end - t_l0 - s_wait;\n"
         "      }\n"),
        ("  for (int kc = 0; kc < a.n_k; ++kc) {\n"
         "    const int s = sm.ring.wait(kc);\n",
         "  unsigned long long t0c, t_x, t_y, t_l, t_e, s_cw = 0;\n"
         "  NOW(t0c);\n"
         "  for (int kc = 0; kc < a.n_k; ++kc) {\n    NOW(t_x);\n"
         "    const int s = sm.ring.wait(kc);\n"
         "    NOW(t_y);\n    s_cw += t_y - t_x;\n"),
        ("  wg::wait<0>();\n  gm::fence_acc(acc);\n\n",
         "  wg::wait<0>();\n  gm::fence_acc(acc);\n  NOW(t_l);\n\n"),
        ("    gm::tma_store_drain();\n  }\n}\n",
         "    gm::tma_store_drain();\n  }\n  NOW(t_e);\n"
         "  if (tid == 0 && c == 0 && blockIdx.x < 1024) {\n"
         "    unsigned long long* r = lseg_b1_stamps[blockIdx.x];\n"
         "    r[0] = t_e - t0c;\n    r[3] = s_cw;\n    r[4] = t_l - t0c;\n"
         "    r[5] = t_e - t_l;\n  }\n}\n"),
    ]),
    "b20_drop_peer": ("int8_sliced_scale.cu", [
        ("    for (int p = 0; p < SPLIT; ++p) {\n",
         "    for (int p = 0; p < SPLIT - 1; ++p) {\n"),
    ]),
    "b11_no_hblend": ("upsample2x_argmax.cu", [
        ("    hblend(hb, reinterpret_cast", "    if (st.nc < 0) hblend(hb, "
         "reinterpret_cast"),
    ]),
    "b11_no_wblend": ("upsample2x_argmax.cu", [
        ("      lab = best_of(hb + off0, hb + off1, a0, a1, a.K, pb, pe, tail, "
         "best);", "      lab = off0 + off1;"),
    ]),
    "b4_last_chunk_dropped": ("head1_correlate.cu", [
        ("      } else if (lane < rows) {  // a range a row",
         "      } else if (lane < rows && ch + 1 < chunks) {"),
    ]),
    "b5_no_prefetch": ("head1_correlate_argmax.cu", [
        ("  if (m0 >= M) return;\n", "  if (m0 >= 0) return;\n"),
    ]),
    "b5_unroll6": ("head1_correlate_argmax.cu", [
        ("constexpr int UNROLL = 4;", "constexpr int UNROLL = 6;"),
        ("    gm::regs_dec<56>();", "    gm::regs_dec<72>();"),
        ("  gm::regs_inc<224>();", "  gm::regs_inc<216>();"),
    ]),
    "b14_no_copy": ("head1_correlate_wup.cu", [
        ("        if (kc == K) {  // one chunk: the columns are one range",
         "        if (false) {"),
        ("        } else if (lane < nr) {  // a range a column",
         "        } else if (false) {"),
    ]),
    "b14_no_stage": ("head1_correlate_wup.cu", [
        ("        for (int j = max(jf, r0); j <= min(jl, r0 + nr - 1); ++j) {",
         "        for (int j = max(jf, r0); j < 0; ++j) {"),
    ]),
    "b13_no_store": ("head1_correlate_upsample_argmax.cu", [
        ("          if (valid && t4 == 0) {\n", "          if "
         "(valid && t4 == 0 && best == 7u) {\n"),
    ]),
    "b13_no_sync": ("head1_correlate_upsample_argmax.cu", [
        ("      wg::named_sync(3, CONSUMERS);\n", ""),
    ]),
    "b13_no_interp": ("head1_correlate_upsample_argmax.cu", [
        ("              best = max(best, label_key(e ? up >> 16 : up & "
         "0xffffu, k) &\n",
         "              best ^= up; (void)(\n"),
    ]),
    "b18_no_mma": ("fused_rcu.cu", [
        ("      gm::MmaS8<NS>::rs(acc[mb], af[kk][mb], wg::desc_kstep(db, kk), "
         "1);", "      (void)db;"),
    ]),
    "b18_no_q1": ("fused_rcu.cu", [
        ("        if (i < total && rr >= 0 && rr < a.H && cc >= 0 && "
         "cc < a.W)", "        if (false)"),
    ]),
    "b13_no_blend": ("head1_correlate_upsample_argmax.cu", [
        ("    while (tp < NR) {", "    while (false) {"),
    ]),
    "b13_no_correlate": ("head1_wgmma.cuh", [
        ("    mma_rs152(acc, af[kk],\n"
         "              wg::desc_kstep(wg::desc(tst + (kk / 4) * T_BOX), "
         "kk % 4));",
         "    acc[0][0] += __uint_as_float(af[kk][0] & 1u);"),
    ]),
    # the earlier correlate: mma.sync m16n8k16, the text read from its stage
    "head1_correlate_mma_sync": ("head1_wgmma.cuh", [
        ("  gemm::fence_acc(acc);\n  wg::fence();\n#pragma unroll\n"
         "  for (int kk = 0; kk < 8; ++kk)\n"
         "    mma_rs152(acc, af[kk],\n"
         "              wg::desc_kstep(wg::desc(tst + (kk / 4) * T_BOX), "
         "kk % 4));\n"
         "  wg::commit();\n  wg::wait<0>();\n  gemm::fence_acc(acc);\n",
         "  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;\n"
         "#pragma unroll\n  for (int kk = 0; kk < 8; ++kk) {\n"
         "    const uint8_t* tb = tst + (kk / 4) * T_BOX + g * 128 + 4 * t4;\n"
         "    const int c0 = ((2 * (kk % 4)) ^ g) * 16;\n"
         "    const int c1 = ((2 * (kk % 4) + 1) ^ g) * 16;\n"
         "#pragma unroll\n    for (int lt = 0; lt < KT; ++lt)\n"
         "      mma_bf16_16816(acc[lt], af[kk], ld_u32(tb + lt * 1024 + c0),\n"
         "                     ld_u32(tb + lt * 1024 + c1));\n  }\n"),
    ]),
    "b6_last_keys_dropped": ("flash_flat.cuh", [
        ("  attend(sm.t, sm.b, &map, k_col, v_col, img, n_kt, valid_len,\n",
         "  attend(sm.t, sm.b, &map, k_col, v_col, img, n_kt, "
         "valid_len - BKV,\n"),
    ]),
    "b6_fp32_no_alo_bhi": ("tf32x3.cuh", [
        ("  mma(d, a.lo, b.hi[0], b.hi[1]);\n", ""),
    ]),
    "b16_slice_amax": ("mlp_fused.cu", [
        ("for (int p = 0; p < C; ++p) mx = fmaxf(mx, sm.amax[p][row[h]]);",
         "mx = sm.amax[rank][row[h]];"),
    ]),
    "b2_slice_amax": ("pair_attention.cuh", [
        ("      for (int p = 0; p < pairs; ++p)\n"
         "        mx[r] = fmaxf(mx[r], sm.amax[p][row[r]]);\n",
         "      mx[r] = sm.amax[rank][row[r]];\n"),
    ]),
    "b15_pair0_scale": ("flash_attention_qkvp_fused.cu", [
        ("? sa[static_cast<long long>(r0 + 8 * h) * pairs + p]",
         "? sa[static_cast<long long>(r0 + 8 * h) * pairs]"),
    ]),
    "b7_dk_zeroed": ("flash_attention_flat_bwd.cu", [
        ("  store_rows(ob, 3LL * D, D + head * HD, row0, T, dk, a.scale, g, "
         "t4);\n",
         "  zero(dk);\n  store_rows(ob, 3LL * D, D + head * HD, row0, T, dk, "
         "a.scale, g, t4);\n"),
    ]),
    "episodic_pairs_rolled": ("../engine/episodic.py", [
        ("        txt_pairs = torch.as_tensor(txt_pairs, device=device)\n",
         "        txt_pairs = torch.as_tensor(txt_pairs, device=device).roll(1, "
         "0)\n"),
    ]),
    "episode_ignore_dropped": ("../ops/metrics.py", [
        ("    valid = ~ignore_mask\n",
         "    valid = torch.ones_like(ignore_mask)\n"),
    ]),
}


# b16_timeline's stamps 0..9 -> the phases between consecutive ones
TIMELINE_PHASES = ("cluster_start", "fc1", "gelu_amax", "amax_exchange",
                   "quantize", "codes_barrier", "fc2", "epilogue",
                   "exit_barrier")


def read_timeline() -> dict:
    """Run this checkout's B16 (a `b16_timeline` copy) at the flagship on
    the card; the median microseconds of each phase over the CTAs and the
    spread of their start times."""
    import ctypes

    import torch

    from lseg_tpu_torch.ops._build import load_kernels
    from lseg_tpu_torch.ops.mlp import mlp_fused
    from lseg_tpu_torch.ops.quant import quantize_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    m, d, h = 8 * 901, 1024, 4096
    xq, sx = quantize_rows(torch.randn(8, 901, d, device=dev, generator=g))
    w1 = torch.randint(-127, 128, (h, d), device=dev, generator=g,
                       dtype=torch.int8)
    w2 = torch.randint(-127, 128, (d, h), device=dev, generator=g,
                       dtype=torch.int8)
    s1 = 2e-3 / d ** 0.5 * torch.rand(h, device=dev, generator=g)
    b1 = 0.5 * torch.randn(h, device=dev, generator=g)
    s2 = 2e-2 / h ** 0.5 * torch.rand(d, device=dev, generator=g)
    b2 = 0.05 * torch.randn(d, device=dev, generator=g)
    res = torch.randn(8, 901, d, device=dev, generator=g).to(torch.bfloat16)
    for _ in range(3):
        mlp_fused(xq, sx, res, w1, s1, b1, w2, s2, b2)
    torch.cuda.synchronize()
    raw = torch.zeros(1024 * 10 + 1024 * 2 * 32, dtype=torch.int64)
    rc = load_kernels().lseg_b16_timeline(ctypes.c_void_p(raw.data_ptr()))
    if rc != 0:
        raise RuntimeError(f"lseg_b16_timeline: cudaError {rc}")
    ctas = 8 * -(-m // 64)
    t = raw[:10240].view(1024, 10)[:ctas].double() / 1e3  # microseconds
    chunks = raw[10240:].view(1024, 2, 32)[:ctas].double() / 1e3
    phases = (t[:, 1:] - t[:, :-1]).median(0).values.tolist()
    start = t[:, 0] - t[:, 0].min()
    # each fc2 chunk's w2 box issued, and the consumer holding it, from the
    # consumer's start of fc2 (stamp 6)
    fc2 = (chunks - t[:, 6, None, None]).median(0).values
    return {"phases_us": dict(zip(TIMELINE_PHASES, phases)),
            "fc2_w2_issued_us": [round(v, 2) for v in fc2[0].tolist()],
            "fc2_chunk_ready_us": [round(v, 2) for v in fc2[1].tolist()],
            "cta_us": float((t[:, 9] - t[:, 0]).median()),
            "call_us": float(t[:, 9].max() - t[:, 0].min()),
            "start_us_quantiles": torch.quantile(
                start, torch.tensor([0.0, 0.25, 0.5, 0.75, 1.0],
                                    dtype=torch.float64)).tolist()}


# b18_timeline's stamps 0..7 (thread 128, the first consumer warpgroup's
# first thread) -> the phases between consecutive ones
B18_PHASES = ("cluster_start", "q1_staging", "conv1", "conv1_epilogue",
              "q2_exchange", "conv2", "conv2_epilogue")


def read_b18_timeline() -> dict:
    """Run this checkout's B18 (a `b18_timeline` copy) at (8, 120, 120,
    256) and (8, 15, 15, 256) on the card; per shape, the median
    microseconds of each phase over the CTAs and of a whole CTA, and the
    call's span."""
    import ctypes

    import torch

    from lseg_tpu_torch.engine.time_gemm import rcu_operands
    from lseg_tpu_torch.ops._build import load_kernels
    from lseg_tpu_torch.ops.qconv import fused_rcu, rcu_tile

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    c = 256
    ops = rcu_operands(dev, g, c)
    out = {}
    for side in (120, 15):
        x = torch.randn(8, side, side, c, device=dev,
                        generator=g).to(torch.bfloat16)
        for _ in range(3):
            fused_rcu(x, *ops)
        torch.cuda.synchronize()
        raw = torch.zeros(4096 * 8, dtype=torch.int64)
        rc = load_kernels().lseg_b18_timeline(
            ctypes.c_void_p(raw.data_ptr()))
        if rc != 0:
            raise RuntimeError(f"lseg_b18_timeline: cudaError {rc}")
        tr, tc = rcu_tile(side, side)
        ctas = min(4096, c // 64 * -(-side // tr) * -(-side // tc) * 8)
        t = raw.view(4096, 8)[:ctas].double() / 1e3  # microseconds
        phases = (t[:, 1:] - t[:, :-1]).median(0).values.tolist()
        out[str(side)] = {"phases_us": dict(zip(B18_PHASES, phases)),
                          "cta_us": float((t[:, 7] - t[:, 0]).median()),
                          "call_us": float(t[:, 7].max() - t[:, 0].min()),
                          "ctas": ctas}
    return out


def read_b13_timeline() -> dict:
    """Run this checkout's B13 (a `b13_timeline` copy) at the flagship,
    (8, 240, 240, 256) codes against K = 150, on the card; the median over
    the CTAs of the microseconds of a CTA, of its steps' logits (codes,
    embed, correlate, norm) and of its steps' output rows (blend,
    W-interp, argmax, stores), and of its steps."""
    import ctypes

    import torch

    from lseg_tpu_torch.ops._build import load_kernels
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_upsample_argmax,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    n, h, w, c, e, k = 8, 240, 240, 256, 512, 150
    xq = torch.randint(-127, 128, (n, h, w, c), device=dev, generator=g,
                       dtype=torch.int8)
    w1q = torch.randint(-127, 128, (e, c), device=dev, generator=g,
                        dtype=torch.int8)
    s1 = 1e-3 * torch.rand(e, device=dev, generator=g) + 1e-4
    b1 = 0.1 * torch.randn(e, device=dev, generator=g)
    txt = torch.randn(k, e, device=dev, generator=g)
    for _ in range(3):
        head1_correlate_upsample_argmax(xq, torch.tensor(0.02, device=dev),
                                        w1q, s1, b1, txt, 1.0 / 0.07)
    torch.cuda.synchronize()
    raw = torch.zeros(1024 * 4, dtype=torch.int64)
    rc = load_kernels().lseg_b13_timeline(ctypes.c_void_p(raw.data_ptr()))
    if rc != 0:
        raise RuntimeError(f"lseg_b13_timeline: cudaError {rc}")
    t = raw.view(1024, 4)
    t = t[t[:, 3] > 0].double()
    return {"ctas": int(t.shape[0]),
            "cta_us": float((t[:, 0] / 1e3).median()),
            "logits_us": float((t[:, 1] / 1e3).median()),
            "rows_us": float((t[:, 2] / 1e3).median()),
            "steps": float(t[:, 3].median())}


def _read_head_timeline(name: str, call, columns) -> dict:
    """Run this checkout's B14 or B5 (a `<name>_timeline` copy) at the
    flagship, (8, 240, 240, 256) codes (bf16 path1 for B5) against K =
    150, on the card: the median over the CTAs of the microseconds of a
    CTA and of each summed phase, and of its steps."""
    import ctypes

    import torch

    from lseg_tpu_torch.engine.time_gemm import head_operands
    from lseg_tpu_torch.ops._build import load_kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ops = head_operands(dev, g, 150)
    for _ in range(3):
        call(*ops)
    torch.cuda.synchronize()
    raw = torch.zeros(1024 * 4, dtype=torch.int64)
    rc = getattr(load_kernels(), f"lseg_{name}_timeline")(
        ctypes.c_void_p(raw.data_ptr()))
    if rc != 0:
        raise RuntimeError(f"lseg_{name}_timeline: cudaError {rc}")
    t = raw.view(1024, 4)
    t = t[t[:, 3] > 0].double()
    out = {"ctas": int(t.shape[0]), "cta_us": float((t[:, 0] / 1e3).median())}
    for i, col in enumerate(columns):
        out[col] = float((t[:, i + 1] / 1e3).median())
    out["steps"] = float(t[:, 3].median())
    return out


def read_b14_timeline() -> dict:
    """B14's CTAs: their steps' logits (codes, embed, correlate, norm) and
    outputs (hand-off, W-interp, staging, bulk copies)."""
    from lseg_tpu_torch.ops.head1_correlate import head1_correlate_wup_fused

    return _read_head_timeline(
        "b14", lambda xq, x, sx, w1q, s1, b1, txt: head1_correlate_wup_fused(
            xq, sx, w1q, s1, b1, txt, 1.0 / 0.07), ("logits_us", "out_us"))


def read_b5_timeline() -> dict:
    """B5's CTAs on bf16 path1: their steps' wait for the quantized codes,
    and the rest of each step (embed, correlate, keys, labels)."""
    from lseg_tpu_torch.ops.head1_correlate import (
        head1_correlate_argmax_fused,
    )

    return _read_head_timeline(
        "b5", lambda xq, x, sx, w1q, s1, b1, txt:
        head1_correlate_argmax_fused(x, sx, w1q, s1, b1, txt),
        ("codes_wait_us", "step_us"))


def _b19_operands(shape, int8):
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    c = shape[-1]
    x = torch.randn(shape, device=dev, generator=g).to(torch.bfloat16)
    wq = torch.randint(-127, 128, (c, c), device=dev, generator=g,
                       dtype=torch.int8)
    sw = 0.01 * torch.rand(c, device=dev, generator=g) + 1e-3
    b = 0.1 * torch.randn(c, device=dev, generator=g)
    return (x, wq, sw, b, x.float().abs().amax() / 127.0,
            torch.tensor(0.05, device=dev) if int8 else None)


# B19's two shapes: refinenet1's int8 hand-off and refinenet2 to bf16
B19_TIMELINE_SHAPES = (("handoff", (8, 120, 120, 256), True),
                       ("r2", (8, 60, 60, 256), False))


def read_b19_timeline() -> dict:
    """Run this checkout's B19 (a `b19_timeline` copy) at its two shapes
    on the card; per shape, the median over the consumer warpgroups of the
    microseconds of the walk and of its summed phases: waiting for source
    rows (`wait_us`), the H-blend of a tile's strip (`hblend_us`), the
    W-blend and codes (`wblend_us`), the product (`mma_us`), the epilogue
    with its staged stores (`epilogue_us`); and the median tiles a
    warpgroup."""
    import ctypes

    import torch

    from lseg_tpu_torch.ops._build import load_kernels
    from lseg_tpu_torch.ops.decoder import fused_upsample_outconv

    out = {}
    for name, shape, int8 in B19_TIMELINE_SHAPES:
        ops = _b19_operands(shape, int8)
        for _ in range(3):
            fused_upsample_outconv(*ops)
        torch.cuda.synchronize()
        raw = torch.zeros(1024 * 4 * 7, dtype=torch.int64)
        rc = load_kernels().lseg_b19_timeline(
            ctypes.c_void_p(raw.data_ptr()))
        if rc != 0:
            raise RuntimeError(f"lseg_b19_timeline: cudaError {rc}")
        t = raw.view(-1, 7)
        t = t[t[:, 6] > 0].double()
        med = t.median(0).values / 1e3
        out[name] = {"warpgroups": int(t.shape[0]),
                     **{f"{k}_us": float(v) for k, v in zip(
                         ("walk", "wait", "hblend", "wblend", "mma",
                          "epilogue"), med[:6])},
                     "tiles": float(t[:, 6].median())}
    return out


def read_b11_timeline() -> dict:
    """Run this checkout's B11 (a `b11_timeline` copy) at the streamed
    head's (8, 240, 240, 150) logits in fp32 and bf16; per dtype, the
    median over the consumer groups of the microseconds of the walk and
    of its summed phases: waiting for the two source rows (`wait_us`),
    the H-blend into the group's buffer with its barrier (`hblend_us`),
    the W-blend and argmax of a row with its barrier (`wblend_us`); and
    the median output rows a group."""
    import ctypes

    import torch

    from lseg_tpu_torch.ops._build import load_kernels
    from lseg_tpu_torch.ops.upsample_argmax import upsample2x_argmax

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 240, 240, 150, device="cuda", generator=g)
    out = {}
    for name, lg in (("fp32", x), ("bf16", x.to(torch.bfloat16))):
        for _ in range(3):
            upsample2x_argmax(lg)
        torch.cuda.synchronize()
        raw = torch.zeros(512 * 2 * 5, dtype=torch.int64)
        rc = load_kernels().lseg_b11_timeline(
            ctypes.c_void_p(raw.data_ptr()))
        if rc != 0:
            raise RuntimeError(f"lseg_b11_timeline: cudaError {rc}")
        t = raw.view(-1, 5)
        t = t[t[:, 4] > 0].double()
        med = t.median(0).values / 1e3
        out[name] = {"groups": int(t.shape[0]),
                     **{f"{k}_us": float(v) for k, v in zip(
                         ("walk", "wait", "hblend", "wblend"), med[:4])},
                     "rows": float(t[:, 4].median())}
    return out


def read_b1_timeline() -> dict:
    """Run this checkout's B1 (a `b1_timeline` copy) at the flagship (8,
    480, 480, 3) -> (8, 900, 1024) and at ViT-B/32's (8, 480, 480, 3) ->
    (8, 225, 768) (the stamps read, then zeroed, after each); per shape,
    the median over the CTAs of the microseconds of the first consumer
    warpgroup from its first wait to its stores (`cta_us`), of its waits
    for converted stages (`consumer_wait_us`), its main loop
    (`mainloop_us`) and its epilogue with the wait for its stage
    (`epilogue_us`); of the first converter thread's waits for a chunk's
    fp32 segments and a free stage (`converter_wait_us`) and the rest of
    its walk (`convert_us`: rounding them into the stage's A, the fence
    and the arrivals); and of the weight loader's waits for free stages
    (`producer_wait_us`)."""
    import ctypes

    import torch

    from lseg_tpu_torch.ops._build import load_kernels
    from lseg_tpu_torch.ops.patch_embed import patch_embed

    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(8, 480, 480, 3, device="cuda", generator=g)
    out = {}
    for name, p, d in (("flagship", 16, 1024), ("b32", 32, 768)):
        w = (0.05 * torch.randn(p * p * 3, d, device="cuda", generator=g)
             ).to(torch.bfloat16)
        b = torch.randn(d, device="cuda", generator=g)
        for _ in range(3):
            patch_embed(x, w, b, p)
        torch.cuda.synchronize()
        raw = torch.zeros(1024 * 8, dtype=torch.int64)
        rc = load_kernels().lseg_b1_timeline(ctypes.c_void_p(raw.data_ptr()))
        if rc != 0:
            raise RuntimeError(f"lseg_b1_timeline: cudaError {rc}")
        t = raw.view(1024, 8)
        t = t[t[:, 4] > 0].double()
        med = t.median(0).values / 1e3
        out[name] = {"ctas": int(t.shape[0]), **{
            f"{k}_us": float(v) for k, v in zip(
                ("cta", "converter_wait", "convert", "consumer_wait",
                 "mainloop", "epilogue", "producer_wait"), med)}}
    return out


def read_b19_wide_timeline() -> dict:
    """Run this checkout's earlier B19 kernel (a `b19_wide_timeline` copy
    of fused_upsample_outconv_wide.cu, called at Co = 256 through its
    entry point) at B19's two shapes; per shape, the median over the CTAs
    of the microseconds of a CTA, of its tiles' blend and codes, and of
    their products and epilogues, and the median tiles a CTA."""
    import ctypes

    import torch

    from lseg_tpu_torch.ops._build import load_kernels
    from lseg_tpu_torch.ops.decoder import _scales, interp_taps

    lib = load_kernels()
    out = {}
    for name, shape, int8 in B19_TIMELINE_SHAPES:
        x, wq, sw, b, s_in, out_scale = _b19_operands(shape, int8)
        n, h, w, c = shape
        th, tw = interp_taps(h, x.device), interp_taps(w, x.device)
        inv_in, sc, inv_out = _scales(s_in, sw, out_scale)
        y = torch.empty((n, 2 * h, 2 * w, c), device=x.device,
                        dtype=torch.int8 if int8 else torch.bfloat16)
        for _ in range(3):
            rc = lib.lseg_fused_upsample_outconv_wide(
                x.data_ptr(), th.data_ptr(), tw.data_ptr(), wq.data_ptr(),
                sc.data_ptr(), b.data_ptr(), inv_in.data_ptr(),
                inv_out.data_ptr(), y.data_ptr(), n, h, w, c, c, int(int8),
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"lseg_fused_upsample_outconv_wide: "
                                   f"cudaError {rc}")
        torch.cuda.synchronize()
        raw = torch.zeros(1024 * 4, dtype=torch.int64)
        rc = lib.lseg_b19_wide_timeline(ctypes.c_void_p(raw.data_ptr()))
        if rc != 0:
            raise RuntimeError(f"lseg_b19_wide_timeline: cudaError {rc}")
        t = raw.view(1024, 4)
        t = t[t[:, 3] > 0].double()
        med = t.median(0).values / 1e3
        out[name] = {"ctas": int(t.shape[0]), "cta_us": float(med[0]),
                     "blend_us": float(med[1]),
                     "product_epilogue_us": float(med[2]),
                     "tiles": float(t[:, 3].median())}
    return out


def make(name: str, dest: Path) -> None:
    """Copy the checkout to `dest` and apply variant `name`; raises
    KeyError for an unknown variant, ValueError for a substitution that
    matches nothing."""
    source, subs = VARIANTS[name]
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(ROOT, dest, ignore=shutil.ignore_patterns(
        ".git", "build", "chiprun_out", "__pycache__"))
    path = dest / "lseg_tpu_torch" / "csrc" / source
    text = path.read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"variant {name}: {old!r} not in {source}")
        text = text.replace(old, new)
    path.write_text(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("name", nargs="?", choices=sorted(VARIANTS))
    ap.add_argument("dest", nargs="?", type=Path)
    ap.add_argument("--timeline", nargs="?", const="b16",
                    choices=("b16", "b18", "b13", "b14", "b5", "b19",
                             "b19_wide", "b11", "b1"),
                    help="B16's (B18's, B13's, B14's, B5's, B19's) phase "
                         "times, run from a b16_timeline (b18_timeline, "
                         "...) copy")
    args = ap.parse_args(argv)
    if args.timeline:
        import json

        read = {"b16": read_timeline, "b18": read_b18_timeline,
                "b13": read_b13_timeline, "b14": read_b14_timeline,
                "b5": read_b5_timeline, "b19": read_b19_timeline,
                "b19_wide": read_b19_wide_timeline,
                "b11": read_b11_timeline,
                "b1": read_b1_timeline}[args.timeline]
        print(json.dumps(read()), flush=True)
        return 0
    if args.name is None or args.dest is None:
        ap.error("a variant NAME and a DIR are needed")
    try:
        make(args.name, args.dest.resolve())
    except ValueError as e:
        print(e, file=sys.stderr)
        return 1
    print(f"{args.name}: {args.dest}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
