// The whole int8 attention half-block for Hopper (sm_90a), kernel B15:
// int8 qkv projection + flash attention + per-(row, head pair) int8
// requantize + int8 output projection + bias + residual.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · flash_attention_qkvp_fused
// (Pallas TPU; body _kernel_qkvp).
//
// Input: the per-row int8 codes xq (N, T, D) of the LayerNorm-1 output and
// their fp32 row scales sx (N, T), the int8 qkv weight (3D, D) and proj
// weight (D, D) (the port's (out, in) storage), their fp32 per-output-
// channel scales and biases, and the bf16 residual stream (N, T, D).
// Output: resid + proj(attn(qkv(x))), (N, T, D) bf16. Keys at or past
// `valid_len` are masked out of the softmax.
//
// Rounding points, in order, as in the TPU kernel:
//   1. acc = xq . wq^T exact in int32, ((acc * sx) * sw) + b in fp32 (no FMA
//      contraction), cast to bf16;
//   2. per head, fp32 scores times `scale`, exp(s - m) in fp32, P cast to
//      bf16 for P.V with fp32 accumulation, divided by the fp32 row sum and
//      kept in fp32 (not rounded to bf16);
//   3. per row and head pair p (128 columns), sa = max(max|o|, 1e-8) / 127
//      and codes round-half-even(o / sa) clipped to +-127;
//   4. part_p = (int32 (aq_p . wp[:, p*128 : (p+1)*128]^T) * sa) * sp in
//      fp32; acc = (part_0 + bp) + resid, then acc += part_p for p = 1 ..
//      P - 1 in that order; cast to bf16.
// Two differences, as in B6: the online softmax rounds P relative to the
// running row maximum, where the TPU kernel uses the maximum of the row;
// and the exponent is ex2.approx of one FMA.
//
// What bounds it on the card: at the flagship (8, 901, 1024) with 16
// heads, 22.7 G int8 MAC of qkv and 7.6 G of proj (60.4 GOP, ~0.031 ms at
// 1979 TOP/s) and 26.6 GFLOP of attention products (~0.027 ms at 989
// TFLOP/s), against ~36 MB of codes, weights, residual and output: the
// operations bound it (~0.057 ms).
//
// Design: a chain of three launches on one stream.
//   (a) the s8 wgmma + TMA qkv GEMM with its dequant epilogue
//       (qkv_wgmma.cuh, shared with B2, B8 and B9) -> bf16 qkv (N*T, 3D);
//   (b) the head-pair attention of pair_attention.cuh in its pair mode: a
//       block per (64 query rows, head pair, image), two warpgroups on the
//       wgmma + TMA interior of B6, the fp32 (64, 128) output quantized
//       per row over the pair -> int8 codes aq (N*T, D) and one fp32
//       scale per (row, pair);
//   (c) the projection on s8 warpgroup products: a persistent kernel over
//       128 x 128 output tiles, one producer thread keeping a four-stage TMA
//       ring of aq's and wp's 128-byte k-chunks full (one chunk is one
//       head pair: K = 128), two consumer warpgroups of 64 rows each
//       running four m64n128k32 products a pair into an int32
//       accumulator, then flushing it into an fp32 one as (acc *
//       sa[row, p]) * sp[col] in the TPU kernel's order, because each pair
//       has its own row scale. The TPU's pair-minor grid axis with a VMEM
//       accumulator becomes this loop inside one warpgroup: nothing
//       carries over between blocks, and no atomics reorder the sum. 64
//       int32 and 64 fp32 accumulators a thread. The producer also loads
//       each tile's residual by TMA (two 64-column boxes, rows past M
//       zero-filled) into a stage of its own, read by the first flush;
//       the bf16 output leaves through a shared-memory stage by TMA. The
//       consumers hold the tile's column scales in registers too (the
//       flush costs most of the projection: PERF.md).
// Unlike the TPU kernel, the bf16 qkv (44 MB written and read at the
// flagship, as B2 and B8 pay) and the int8 codes with their pair scales
// (7.4 MB + 0.2 MB) pass through device memory between the launches:
// keeping them on chip is the lead for a fused redesign.

#include "pair_attention.cuh"
#include "qkv_wgmma.cuh"

namespace {

namespace wg = lseg::wg;
namespace gm = lseg::gemm;
namespace pa = lseg::pair_attn;

// ---- (b) the pair interior ----
__global__ void __launch_bounds__(pa::THREADS, 2) pair_attention_kernel(
    const __grid_constant__ CUtensorMap map, int8_t* __restrict__ aq,
    float* __restrict__ sa, int T, int D, int valid_len, float scale) {
  pa::run<false>(map, aq, sa, T, D, valid_len, scale);
}

// ---- (c) the projection of scaled pair partials + bias + residual ----

// The int32 sum of one pair (|x| <= 128^3 < 2^22) as fp32, exactly, by
// the fp32 adder: 1.5 * 2^23 + x holds x in its low mantissa bits. The
// conversion unit (__int2float_rn, the same value) runs at a quarter of
// the adder's rate, and each output takes D / 128 conversions.
__device__ __forceinline__ float exact_float(int x) {
  return __fsub_rn(__int_as_float(0x4B400000 + x), 12582912.0f);
}
constexpr int BM = 128;  // rows of a tile: two consumer warpgroups of 64
constexpr int BN = 128;  // output columns of a tile
constexpr int BK = 128;  // k bytes a stage: one head pair
constexpr int STAGES = 4;
constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;  // 2 consumers + producer
constexpr int A_BYTES = BM * BK;
constexpr int B_BYTES = BN * BK;
constexpr int STAGE = A_BYTES + B_BYTES;

constexpr int RES_BYTES = BM * 64 * 2;   // a 128 x 64 bf16 residual box

constexpr int OUT_BOX = 64 * 64 * 2;     // a 64 x 64 bf16 output box

struct ProjSmem {
  uint8_t ring[STAGES * STAGE];
  uint8_t res[BN / 64][RES_BYTES];  // the tile's residual, 128-byte swizzled
  uint8_t out[2][BN / 64][OUT_BOX];  // each consumer's bf16 output stage
  gm::Ring<STAGES> r;
  uint64_t res_full, res_empty;     // the residual's stage
};
constexpr int PROJ_SMEM = sizeof(ProjSmem) + 1024;  // + alignment slack

__global__ void __launch_bounds__(THREADS, 1) pair_proj_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_r,
    const __grid_constant__ CUtensorMap map_o, const float* __restrict__ sa,
    const float* __restrict__ sp, const float* __restrict__ bp, int M,
    int D) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  ProjSmem& sm = *reinterpret_cast<ProjSmem*>(
      smem_raw + ((1024 - wg::smem_addr(smem_raw) % 1024) % 1024));
  const int tiles_n = D / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int pairs = D / BK;
  const int c = threadIdx.x / WG_THREADS;  // consumer: its 64 rows
  const int tid = threadIdx.x % WG_THREADS;

  if (threadIdx.x == 0) {
    wg::bar_init(&sm.res_full, 1);
    wg::bar_init(&sm.res_empty, 2);
    sm.r.init(2);  // fences the barriers' init for TMA
  }
  __syncthreads();

  if (c == 2) {  // the producer warpgroup: one thread issues the loads
    gm::regs_dec<40>();
    if (tid == 0) {
      uint32_t it = 0, k = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        // the residual tile, once the consumers are done with the last
        wg::bar_wait(&sm.res_empty, (k & 1) ^ 1);
        wg::bar_expect_tx(&sm.res_full, BN / 64 * RES_BYTES);
        for (int b = 0; b < BN / 64; ++b)
          gm::tma_load_2d(sm.res[b], &map_r, &sm.res_full, n0 + 64 * b, m0);
        for (int p = 0; p < pairs; ++p, ++it) {
          const int s = sm.r.acquire(it, STAGE);
          uint8_t* st = sm.ring + s * STAGE;
          gm::tma_load_2d(st, &map_a, &sm.r.full[s], p * BK, m0);
          gm::tma_load_2d(st + A_BYTES, &map_w, &sm.r.full[s], p * BK, n0);
        }
      }
    }
    return;
  }

  // room for the tile's column scales beside the int32 and fp32
  // accumulators: a flush loads nothing but its two row scales
  gm::regs_inc<232>();
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  int acc[BN / 8][4];
  float f[BN / 8][4];
  gm::zero(acc);
  uint32_t it = 0, k = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
    const int r0 = m0 + c * 64 + warp * 16 + g;  // rows r0 and r0 + 8
    float2 s2[BN / 8];  // the tile's column scales
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
      s2[nt] = __ldg(reinterpret_cast<const float2*>(sp + n0 + nt * 8 +
                                                     2 * t4));
    for (int p = 0; p < pairs; ++p, ++it) {
      // the rows' scales of pair p, loaded under its products
      float sr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        sr[h] = r0 + 8 * h < M
                    ? sa[static_cast<long long>(r0 + 8 * h) * pairs + p]
                    : 0.0f;
      const int s = sm.r.wait(it);
      const uint8_t* st = sm.ring + s * STAGE;
      gm::fence_acc(acc);
      wg::fence();
      const uint64_t da = wg::desc(st + c * (A_BYTES / 2));
      const uint64_t db = wg::desc(st + A_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        gm::MmaS8<BN>::ss(acc, wg::desc_kstep(da, kk),
                          wg::desc_kstep(db, kk), kk > 0);
      wg::commit();
      wg::wait<0>();
      gm::fence_acc(acc);
      if (tid == 0) sm.r.release(it);

      // part_p = (acc * sa[row, p]) * sp[col]; (part_0 + bp) + resid, then
      // += part_p in pair order
      if (p == 0) wg::bar_wait(&sm.res_full, k & 1);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int col = n0 + nt * 8 + 2 * t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2;
          const float part =
              __fmul_rn(__fmul_rn(exact_float(acc[nt][e]), sr[h]),
                        e % 2 ? s2[nt].y : s2[nt].x);
          if (p == 0) {
            const int lr = c * 64 + warp * 16 + g + 8 * h;  // row of the tile
            const __nv_bfloat16 res = reinterpret_cast<const __nv_bfloat16*>(
                sm.res[nt / 8] + gm::swizzled_offset(lr, nt % 8 * 8 +
                                                         2 * t4))[e % 2];
            f[nt][e] = __fadd_rn(__fadd_rn(part, __ldg(bp + col + e % 2)),
                                 __bfloat162float(res));
          } else {
            f[nt][e] = __fadd_rn(f[nt][e], part);
          }
        }
      }
      if (p == 0) {  // every warp of the group has read the residual
        wg::named_sync(1 + c, WG_THREADS);
        if (tid == 0)
          asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                           wg::smem_addr(&sm.res_empty))
                       : "memory");
      }
    }

    // one cast to bf16 into the stage, once the last tile's store has
    // read it; then stored by TMA (rows past M are not written)
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    wg::named_sync(1 + c, WG_THREADS);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(
            sm.out[c][nt / 8] +
            gm::swizzled_offset(warp * 16 + g + 8 * h, nt % 8 * 8 + 2 * t4)) =
            __floats2bfloat162_rn(f[nt][2 * h], f[nt][2 * h + 1]);
    gm::fence_proxy_async();  // the stage's writes before the TMA store
    wg::named_sync(1 + c, WG_THREADS);
    if (tid == 0) {
      for (int b = 0; b < BN / 64; ++b)
        gm::tma_store_2d(&map_o, sm.out[c][b], n0 + 64 * b, m0 + 64 * c);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // the last stores are complete before the block's shared memory goes
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// The projection's launch: one block an SM (or one a tile, if fewer).
int launch_proj(const void* aq, const void* sa, const void* wp,
                const void* sp, const void* bp, const void* resid, void* out,
                int m, int dim, cudaStream_t st) {
  static const int attr = wg::allow_smem(pair_proj_wgmma_kernel, PROJ_SMEM);
  if (attr != 0) return attr;
  CUtensorMap map_a, map_w, map_r, map_o;
  int rc = gm::make_map_2d(&map_a, aq, 1, dim, m, BK, BM, true);
  if (rc == 0) rc = gm::make_map_2d(&map_w, wp, 1, dim, dim, BK, BN, true);
  if (rc == 0) rc = gm::make_map_2d(&map_r, resid, 2, dim, m, 64, BM, true);
  if (rc == 0) rc = gm::make_map_2d(&map_o, out, 2, dim, m, 64, 64, true);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (rc != 0) return rc;
  const int tiles = (m + BM - 1) / BM * (dim / BN);
  pair_proj_wgmma_kernel<<<tiles < sms ? tiles : sms, THREADS, PROJ_SMEM,
                           st>>>(
      map_a, map_w, map_r, map_o, static_cast<const float*>(sa),
      static_cast<const float*>(sp), static_cast<const float*>(bp), m, dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the three-step chain on `stream`; returns the first non-zero
// CUDA error code (0 on success). qkv (N*T, 3D) bf16, aq (N*T, D) int8
// and sa (N*T, D / 128) fp32 are scratch buffers allocated by the wrapper.
// Requires dim % 128 == 0, 1 <= valid_len <= t, 16-byte aligned tensors
// (checked by the wrapper).
extern "C" int lseg_flash_attention_qkvp_fused(
    const void* xq, const void* sx, const void* wq, const void* sw,
    const void* bias, const void* wp, const void* sp, const void* bp,
    const void* resid, void* qkv, void* aq, void* sa, void* out, int n,
    int t, int dim, int valid_len, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = n * t;
  int rc = lseg::qkv_wg::launch(xq, sx, wq, sw, bias, qkv, rows, 3 * dim,
                                dim, st);
  if (rc != 0) return rc;

  static const int attr = wg::allow_smem(pair_attention_kernel, pa::SMEM);
  if (attr != 0) return attr;
  CUtensorMap map;
  rc = wg::make_map(&map, qkv, 3 * dim, t, n);
  if (rc != 0) return rc;
  const dim3 agrid(dim / pa::PW, (t + pa::BQ - 1) / pa::BQ, n);
  pair_attention_kernel<<<agrid, pa::THREADS, pa::SMEM, st>>>(
      map, static_cast<int8_t*>(aq), static_cast<float*>(sa), t, dim,
      valid_len, scale);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;

  return launch_proj(aq, sa, wp, sp, bp, resid, out, rows, dim, st);
}
