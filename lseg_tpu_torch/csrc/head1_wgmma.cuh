// The int8 head1 tile of kernel B13 (head1_correlate_upsample_argmax.cu) on
// the Hopper engines, written so that B4, B5 and B14 can move onto it: a
// step takes 128 pixels, 64 a consumer warpgroup, and gives each pixel's
// normalized logits against up to KG = 152 labels in registers, with the
// bits of B4's tile (head1_tile.cuh) for the same inputs.
//
//   embed      e = (codes . w^T) * sc + b in fp32, one quarter of 128 head1
//              channels at a time: s8 wgmma m64n128k32 (IGMMA, exact
//              int32), codes and weight both by TMA, K-major with the
//              128-byte swizzle (two 128-byte k-chunks: C <= 256, columns
//              past C zero-filled by TMA, so their products add 0);
//   dequant    e per element as B4 rounds it, the row sums of e^2 in B4's
//              order, and bf16(e) packed straight into mma.sync A
//              fragments: the wgmma accumulator of a warp's 16 rows is
//              mma.sync's m16n8 C layout, so e never goes to shared memory;
//   correlate  bf16(e) . tn^T on mma.sync m16n8k16 bf16 -> fp32, the text
//              quarter (152 labels x 128 channels, two TMA boxes of 64
//              channels, rows past K zero-filled) read from its swizzled
//              stage, 19 label tiles of 8 in registers;
//   logits     bf16(acc * rsqrt(max(sum e^2, 1e-24))).
//
// Why the bits are B4's: the int32 sums are exact in any order; e is the
// same `_rn` steps; a thread (g, t4) of warp w holds, in each quarter e0,
// the columns e0 + 64 wc + 8 nt + 2 t4 + {0, 1} (wc = nt' / 8 of the
// wgmma layout's nt' = 0..15), the columns B4's warp (w, wc) lane (g, t4)
// holds, so its partial sums of e^2 per column half run over the same
// values in the same order (`add_sq2`, no contraction in either), and are
// joined as B4 joins them: lanes t4 ^ 1, then t4 ^ 2, then half 0 + half
// 1; the correlate accumulates each logit over the k16 steps of E in
// ascending order into one fp32 accumulator on the same mma.sync
// instruction; the norm and the last product round as B4's. wgmma
// m64nNk16 bf16 for the correlate is not used: nothing here shows that it
// sums a k16 step to the same bits as mma.sync.

#pragma once

#include "head1_tile.cuh"
#include "wgmma_gemm.cuh"

namespace lseg {
namespace {
namespace head1w {

constexpr int ROWS = 128;                // pixels a step: 2 x 64
constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;  // producer + 2 consumers
constexpr int EQ = 128;                  // head1 channels a quarter
constexpr int KT = 19;                   // label tiles of 8 a thread holds
constexpr int KG = 8 * KT;               // 152 labels at most
constexpr int MAX_C = 256;
constexpr int KCH = MAX_C / 128;         // 128-byte k-chunks of the codes
constexpr int CODES_BOX = 64 * 128;      // a warpgroup's 64 pixels, 128 B
constexpr int CODES_BYTES = KCH * 2 * CODES_BOX;  // 32 KB
constexpr int W_BOX = EQ * 128;          // 128 channels x 128 code bytes
constexpr int W_BYTES = KCH * W_BOX;     // 32 KB
constexpr int T_BOX = KG * 128;          // 152 labels x 64 bf16: 19 KB
constexpr int STAGE = W_BYTES + 2 * T_BOX;  // a quarter's weight and text

// acc = this warpgroup's 64 pixels (codes box cw of each k-chunk) . the
// quarter's 128 weight rows^T, waited for.
__device__ __forceinline__ void embed(int (&acc)[16][4], const uint8_t* codes,
                                      const uint8_t* wst, int cw) {
  gemm::zero(acc);
  gemm::fence_acc(acc);
  wg::fence();
#pragma unroll
  for (int kc = 0; kc < KCH; ++kc) {
    const uint64_t da = wg::desc(codes + (kc * 2 + cw) * CODES_BOX);
    const uint64_t db = wg::desc(wst + kc * W_BOX);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      gemm::MmaS8<EQ>::ss(acc, wg::desc_kstep(da, kk), wg::desc_kstep(db, kk),
                          1);
  }
  wg::commit();
  wg::wait<0>();
  gemm::fence_acc(acc);
}

// e = acc * sc + b for the quarter's channels e0 .. e0 + 127: the row sums
// of e^2 per column half ss[wc][h] (h: rows g, g + 8), and bf16(e) as the
// A fragments of the quarter's eight k16 steps.
__device__ __forceinline__ void dequant(const int (&acc)[16][4],
                                        const float* __restrict__ sc,
                                        const float* __restrict__ b1, int e0,
                                        float (&ss)[2][2],
                                        uint32_t (&af)[8][4]) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int nt = 2 * kk + p;
      const int col = e0 + nt * 8 + 2 * t4;
      const float s0 = __ldg(sc + col), s1 = __ldg(sc + col + 1);
      const float c0 = __ldg(b1 + col), c1 = __ldg(b1 + col + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 =
            __fadd_rn(__fmul_rn(__int2float_rn(acc[nt][2 * h]), s0), c0);
        const float v1 =
            __fadd_rn(__fmul_rn(__int2float_rn(acc[nt][2 * h + 1]), s1), c1);
        ss[nt / 8][h] = head1::add_sq2(ss[nt / 8][h], v0, v1);
        af[kk][2 * p + h] = pack_f32(v0, v1);
      }
    }
}

// acc[lt] += bf16(e) . tn^T over the quarter's eight k16 steps, labels
// 8 lt .. 8 lt + 7, the text read from its two swizzled boxes at `tst`.
__device__ __forceinline__ void correlate(float (&acc)[KT][4],
                                          const uint32_t (&af)[8][4],
                                          const uint8_t* tst) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint8_t* tb = tst + (kk / 4) * T_BOX + g * 128 + 4 * t4;
    const int c0 = ((2 * (kk % 4)) ^ g) * 16;
    const int c1 = ((2 * (kk % 4) + 1) ^ g) * 16;
#pragma unroll
    for (int lt = 0; lt < KT; ++lt)
      mma_bf16_16816(acc[lt], af[kk], ld_u32(tb + lt * 1024 + c0),
                     ld_u32(tb + lt * 1024 + c1));
  }
}

// The normalized logits of rows g (h = 0) and g + 8 (h = 1), labels
// 8 lt + 2 t4 + {0, 1}, packed as bf16 pairs: ss joined as B4 joins it.
__device__ __forceinline__ void logits(const float (&acc)[KT][4],
                                       float (&ss)[2][2],
                                       uint32_t (&out)[2][KT]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int wc = 0; wc < 2; ++wc) {
      ss[wc][h] += __shfl_xor_sync(0xffffffffu, ss[wc][h], 1);
      ss[wc][h] += __shfl_xor_sync(0xffffffffu, ss[wc][h], 2);
    }
    const float inv = rsqrtf(fmaxf(ss[0][h] + ss[1][h], 1e-24f));
#pragma unroll
    for (int lt = 0; lt < KT; ++lt)
      out[h][lt] = pack_f32(__fmul_rn(acc[lt][2 * h], inv),
                            __fmul_rn(acc[lt][2 * h + 1], inv));
  }
}

}  // namespace head1w
}  // namespace
}  // namespace lseg
