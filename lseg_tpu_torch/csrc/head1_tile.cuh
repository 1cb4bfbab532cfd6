// The int8 head1 tile shared by kernels B4 (head1_correlate.cu) and B5
// (head1_correlate_argmax.cu): one 256-thread block per 64-pixel tile.
//
//   stage_codes  the tile's path1 rows into shared memory as int8 codes:
//                int8 input as it is; bf16 input quantized on the way,
//                clip(rint(x / sx), -127, 127) with IEEE division, so the
//                codes are those of quantizing first;
//   embed        e = (codes . w^T) * sc + b in fp32 (int32 accumulation on
//                mma.sync m16n8k32 s8, 128 output channels of the weight
//                staged at a time), written as bf16(e) into a (64, E)
//                shared tile, with the fp32 row sums of e^2;
//   correlate    bf16(e) . tn^T for 32 labels (rows past K zero-filled)
//                on mma.sync m16n8k16 bf16 into fp32.
//
// Warp layout: 8 warps as 4 (16-row bands) x 2 (column halves). In a
// correlate chunk, lane (g, t4) of warp (wr, wc) holds rows wr + g and
// wr + g + 8 at labels k0 + 16 wc + 8 j + 2 t4 + {0, 1}, j in {0, 1}.

#pragma once

#include "lseg_common.cuh"

namespace lseg {
namespace {
namespace head1 {

constexpr int BM = 64;         // pixels per block
constexpr int THREADS = 256;   // 8 warps: 4 (rows) x 2 (columns)
constexpr int ECH = 128;       // head1 output channels per staged chunk
constexpr int KCH = 32;        // labels per staged chunk

struct Layout {
  int ldx;       // bytes per int8 row (codes and weight chunk)
  int lde;       // bf16 elements per e / text row
  size_t stage;  // bytes of the staging buffer
  size_t total;  // bytes of dynamic shared memory
};

__host__ __device__ inline Layout layout(int c, int e) {
  Layout l;
  l.ldx = c + 16;
  l.lde = e + 8;
  const size_t w_bytes = static_cast<size_t>(ECH) * l.ldx;
  const size_t t_bytes = static_cast<size_t>(KCH) * l.lde * 2;
  l.stage = w_bytes > t_bytes ? w_bytes : t_bytes;
  l.total = static_cast<size_t>(BM) * l.ldx +
            static_cast<size_t>(BM) * l.lde * 2 + l.stage + 2 * BM * 4;
  return l;
}

struct Tile {
  Layout L;
  int8_t* Xs;            // BM x ldx codes
  __nv_bfloat16* Es;     // BM x lde bf16(e)
  unsigned char* stage;  // weight or text chunk
  float* ssq;            // 2 x BM partial row sums of e^2
};

__device__ inline Tile carve(unsigned char* smem, int c, int e) {
  Tile t;
  t.L = layout(c, e);
  t.Xs = reinterpret_cast<int8_t*>(smem);
  t.Es = reinterpret_cast<__nv_bfloat16*>(smem + BM * t.L.ldx);
  t.stage = reinterpret_cast<unsigned char*>(t.Es + BM * t.L.lde);
  t.ssq = reinterpret_cast<float*>(t.stage + t.L.stage);
  return t;
}

// int8 codes, rows past M zero-filled
__device__ inline void stage_codes(const Tile& t, const int8_t* xq, float,
                                   int m0, int M, int C) {
  const int xchunks = C / 16;
  for (int i = threadIdx.x; i < BM * xchunks; i += THREADS) {
    const int r = i / xchunks;
    const int c = (i % xchunks) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) {
      v = *reinterpret_cast<const uint4*>(
          xq + static_cast<long long>(m0 + r) * C + c);
    }
    *reinterpret_cast<uint4*>(t.Xs + r * t.L.ldx + c) = v;
  }
}

// bf16 path1 quantized on the grid sx, rows past M zero-filled
__device__ inline void stage_codes(const Tile& t, const __nv_bfloat16* x,
                                   float sx, int m0, int M, int C) {
  const int xchunks = C / 16;
  for (int i = threadIdx.x; i < BM * xchunks; i += THREADS) {
    const int r = i / xchunks;
    const int c = (i % xchunks) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M) {
      const uint4* p = reinterpret_cast<const uint4*>(
          x + static_cast<long long>(m0 + r) * C + c);
      float a[8], b[8];
      unpack8(p[0], a);
      unpack8(p[1], b);
      v = make_uint4(pack_codes(a[0], a[1], a[2], a[3], sx),
                     pack_codes(a[4], a[5], a[6], a[7], sx),
                     pack_codes(b[0], b[1], b[2], b[3], sx),
                     pack_codes(b[4], b[5], b[6], b[7], sx));
    }
    *reinterpret_cast<uint4*>(t.Xs + r * t.L.ldx + c) = v;
  }
}

// head1: Es = bf16(e), e = (codes . w^T) * sc + b; ssq = row sums of e^2
__device__ inline void embed(const Tile& t, const int8_t* __restrict__ w,
                             const float* __restrict__ sc,
                             const float* __restrict__ b1, int C, int E) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wr = (warp % 4) * 16;  // this warp's 16 rows
  const int wc = warp / 4;         // and its column half
  const int xchunks = C / 16;
  const int ldx = t.L.ldx;
  const int lde = t.L.lde;
  const int8_t* Ws = reinterpret_cast<const int8_t*>(t.stage);
  float ss[2] = {0.0f, 0.0f};
  for (int e0 = 0; e0 < E; e0 += ECH) {
    __syncthreads();  // codes staged; previous chunk's readers are done
    for (int i = tid; i < ECH * xchunks; i += THREADS) {
      const int r = i / xchunks;
      const int c = (i % xchunks) * 16;
      *reinterpret_cast<uint4*>(t.stage + r * ldx + c) =
          *reinterpret_cast<const uint4*>(
              w + static_cast<long long>(e0 + r) * C + c);
    }
    __syncthreads();
    int acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
    for (int kk = 0; kk < C; kk += 32) {
      const int8_t* p = t.Xs + (wr + g) * ldx + kk + t4 * 4;
      const uint32_t af[4] = {ld_u32(p), ld_u32(p + 8 * ldx),
                              ld_u32(p + 16), ld_u32(p + 8 * ldx + 16)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int8_t* q = Ws + (wc * 64 + nt * 8 + g) * ldx + kk + t4 * 4;
        mma_s8_16832(acc[nt], af, ld_u32(q), ld_u32(q + 16));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = e0 + wc * 64 + nt * 8 + 2 * t4;
      const float s0 = sc[col], s1 = sc[col + 1];
      const float c0 = b1[col], c1 = b1[col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float v0 = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[nt][2 * half]), s0), c0);
        const float v1 = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[nt][2 * half + 1]), s1), c1);
        ss[half] += v0 * v0 + v1 * v1;
        *reinterpret_cast<__nv_bfloat162*>(
            t.Es + (wr + g + 8 * half) * lde + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    ss[half] += __shfl_xor_sync(0xffffffffu, ss[half], 1);
    ss[half] += __shfl_xor_sync(0xffffffffu, ss[half], 2);
    if (t4 == 0) t.ssq[wc * BM + wr + g + 8 * half] = ss[half];
  }
}

// acc = bf16(e) . tn[k0 : k0 + 32]^T for this lane's rows and labels
__device__ inline void correlate(const Tile& t,
                                 const __nv_bfloat16* __restrict__ tn,
                                 int k0, int K, int E, float (&acc)[2][4]) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wr = (warp % 4) * 16;
  const int wc = warp / 4;
  const int lde = t.L.lde;
  const __nv_bfloat16* Ts = reinterpret_cast<const __nv_bfloat16*>(t.stage);
  const int tchunks = E / 8;
  __syncthreads();  // Es / ssq complete; previous text chunk consumed
  for (int i = tid; i < KCH * tchunks; i += THREADS) {
    const int r = i / tchunks;
    const int c = (i % tchunks) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (k0 + r < K) {
      v = *reinterpret_cast<const uint4*>(
          tn + static_cast<long long>(k0 + r) * E + c);
    }
    *reinterpret_cast<uint4*>(t.stage + (r * lde + c) * 2) = v;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  for (int kk = 0; kk < E; kk += 16) {
    const __nv_bfloat16* p = t.Es + (wr + g) * lde + kk + 2 * t4;
    const uint32_t af[4] = {ld_u32(p), ld_u32(p + 8 * lde), ld_u32(p + 8),
                            ld_u32(p + 8 * lde + 8)};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const __nv_bfloat16* q =
          Ts + (wc * 16 + j * 8 + g) * lde + kk + 2 * t4;
      mma_bf16_16816(acc[j], af, ld_u32(q), ld_u32(q + 8));
    }
  }
}

}  // namespace head1
}  // namespace
}  // namespace lseg
