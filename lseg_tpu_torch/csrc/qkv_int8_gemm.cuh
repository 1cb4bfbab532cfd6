// The int8 GEMM tile of the port and the qkv projection built on it.
//
// `mainloop` accumulates one 128 x 128 output tile of
//
//   acc (M, N) int32 = a (M, K) int8 . w (N, K)^T int8, exact
//
// over a range of K: a 256-thread block walks K in slices of 64 bytes
// staged in shared memory (rows padded by 16 bytes against bank
// conflicts); eight warps as 2 (rows) x 4 (columns) run mma.sync m16n8k32
// s8 into int32. w is the port's (out, in) weight storage, the
// column-major B operand. Kernels B2 (flash_attention_ln_qkv_q8.cu), B8
// (flash_attention_qkv_fused.cu), B9 (flash_attention_ln_qkv_fused.cu),
// B15 (flash_attention_qkvp_fused.cu) and B16 (mlp_fused.cu) put their
// own epilogue behind it.
//
// `qkv_int8_gemm_kernel` is the qkv projection with its dequant epilogue:
//
//   out (M, N) bf16 = bf16(((acc * sa[row]) * sw[col]) + bias[col])
//
// Products and sums are rounded one by one (no FMA contraction), as the
// TPU kernels' `_dequant_qkv_parts` computes them.
// Requires N % 128 == 0, K % 64 == 0 and 16-byte aligned rows.

#pragma once

#include "lseg_common.cuh"

namespace lseg {
namespace {
namespace qkv_gemm {

constexpr int BM = 128;          // rows per block
constexpr int BN = 128;          // output channels per block
constexpr int BK = 64;           // k bytes per step
constexpr int LD = BK + 16;      // smem row stride in bytes (conflict-free)
constexpr int THREADS = 256;     // 8 warps: 2 (rows) x 4 (columns)

// Per-thread accumulator of the block tile: warp (warp % 2, warp / 2) owns
// rows wm .. wm + 63 and columns wn .. wn + 31; element [mt][nt][e] is row
// wm + mt*16 + g + 8*(e/2), column wn + nt*8 + 2*t4 + (e%2) (mma.sync's C
// layout, g = lane / 4, t4 = lane % 4).
using Acc = int[4][4][4];

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;
}

// acc += a[m0 : m0+128, k_begin : k_end] . w[n0 : n0+128, k_begin : k_end]^T
// with rows of a at or past M read as zero. As and Bs are BM * LD and
// BN * LD bytes of shared memory; every thread of the block must call it.
__device__ __forceinline__ void mainloop(const int8_t* __restrict__ a,
                                         const int8_t* __restrict__ w,
                                         int M, int K, int m0, int n0,
                                         int k_begin, int k_end, int8_t* As,
                                         int8_t* Bs, Acc& acc) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wm = (warp % 2) * 64;  // this warp's 64 rows
  const int wn = (warp / 2) * 32;  // and 32 columns

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * (BK / 16); i += THREADS) {
      const int r = i / (BK / 16);
      const int c = (i % (BK / 16)) * 16;
      uint4 va = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) {
        va = *reinterpret_cast<const uint4*>(
            a + static_cast<long long>(m0 + r) * K + k0 + c);
      }
      *reinterpret_cast<uint4*>(As + r * LD + c) = va;
      *reinterpret_cast<uint4*>(Bs + r * LD + c) =
          *reinterpret_cast<const uint4*>(
              w + static_cast<long long>(n0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int8_t* p = As + (wm + mt * 16 + g) * LD + kk + t4 * 4;
        af[mt][0] = ld_u32(p);
        af[mt][1] = ld_u32(p + 8 * LD);
        af[mt][2] = ld_u32(p + 16);
        af[mt][3] = ld_u32(p + 8 * LD + 16);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int8_t* p = Bs + (wn + nt * 8 + g) * LD + kk + t4 * 4;
        const uint32_t b0 = ld_u32(p);
        const uint32_t b1 = ld_u32(p + 16);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_s8_16832(acc[mt][nt], af[mt], b0,
                                                    b1);
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS) qkv_int8_gemm_kernel(
    const int8_t* __restrict__ a, const float* __restrict__ sa,
    const int8_t* __restrict__ w, const float* __restrict__ sw,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M,
    int N, int K) {
  __shared__ __align__(16) int8_t As[BM * LD];
  __shared__ __align__(16) int8_t Bs[BN * LD];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp % 2) * 64;
  const int wn = (warp / 2) * 32;

  Acc acc;
  zero(acc);
  mainloop(a, w, M, K, m0, n0, 0, K, As, Bs, acc);

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = n0 + wn + nt * 8 + 2 * t4;
    const float s0 = sw[c], s1 = sw[c + 1];
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mt * 16 + g + 8 * half;
        if (r >= M) continue;
        const float sr = sa[r];
        const float v0 = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half]), sr),
                      s0), b0);
        const float v1 = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mt][nt][2 * half + 1]),
                                sr), s1), b1);
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(r) * N + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

// Launch on `st`; returns cudaGetLastError() (0 on success).
inline int launch(const void* a, const void* sa, const void* w,
                  const void* sw, const void* bias, void* out, int M, int N,
                  int K, cudaStream_t st) {
  const dim3 grid(N / BN, (M + BM - 1) / BM);
  qkv_int8_gemm_kernel<<<grid, THREADS, 0, st>>>(
      static_cast<const int8_t*>(a), static_cast<const float*>(sa),
      static_cast<const int8_t*>(w), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), M,
      N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qkv_gemm
}  // namespace
}  // namespace lseg
