// Int8 product with three summed 128-wide scale slices for Hopper
// (sm_90a), kernel B20.
//
// Replaces: scripts/mosaic_probe.py · main (Pallas TPU; body kernel), the
// probe of the Mosaic toolchain regression that rejected a lane-offset
// slice of a one-row scale block broadcast against an accumulator. The
// function it compiles, for each of its four variants:
//
//   acc (M, 128) = int32(x (M, K) int8 . w (K, 128) int8), as fp32 (exact:
//                  |acc| <= K * 128^2 <= 2^24 for K <= 1024)
//   out (M, 128) bf16 = bf16(((0 + acc * s0) + acc * s1) + acc * s2)
//
// s_i the i-th 128-wide slice of 384 fp32 scales, each broadcast along the
// rows; the leading 0 is Python's `sum(parts)` start. The variants differ
// only in how the TPU block holds the 384 scales ((1, 1, 384) or (3, 128))
// and indexes them; the floats, and so this kernel, are the same for all
// four. Every product and sum is an `_rn` intrinsic in the reference's
// order (no FMA contraction), so the result equals the plain version bit
// for bit.
//
// What bounds it on the card: at the reference's x (2, 904, 1024), w
// (1024, 128) the product is 0.47 GOP of int8 (~0.24 us at 1979 TOP/s)
// against ~1.9 MB moved (~0.57 us): bytes, and a launch costs more than
// either. Design: the int8 GEMM tile of `qkv_int8_gemm.cuh` (`mainloop`,
// one 128 x 128 int32 tile per 256-thread block, mma.sync m16n8k32 s8)
// with this epilogue; the scales sit in shared memory. The wrapper hands
// w transposed, (128, K), the tile's column-major B operand.

#include "qkv_int8_gemm.cuh"

namespace {

namespace q = lseg::qkv_gemm;

constexpr int SLICE = 128;  // output columns, and the width of each slice

__global__ void __launch_bounds__(q::THREADS) int8_sliced_scale_kernel(
    const int8_t* __restrict__ x, const int8_t* __restrict__ w_t,
    const float* __restrict__ sw, __nv_bfloat16* __restrict__ out, int M,
    int K) {
  __shared__ __align__(16) int8_t As[q::BM * q::LD];
  __shared__ __align__(16) int8_t Bs[q::BN * q::LD];
  __shared__ float s[3 * SLICE];

  for (int i = threadIdx.x; i < 3 * SLICE; i += q::THREADS) s[i] = sw[i];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int m0 = blockIdx.x * q::BM;
  const int wm = (warp % 2) * 64;
  const int wn = (warp / 2) * 32;

  q::Acc acc;
  q::zero(acc);
  q::mainloop(x, w_t, M, K, m0, 0, 0, K, As, Bs, acc);  // syncs s as well

#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = wn + nt * 8 + 2 * t4;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wm + mt * 16 + g + 8 * half;
        if (r >= M) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float a = __int2float_rn(acc[mt][nt][2 * half + e]);
          float t = __fadd_rn(0.0f, __fmul_rn(a, s[c + e]));
          t = __fadd_rn(t, __fmul_rn(a, s[SLICE + c + e]));
          v[e] = __fadd_rn(t, __fmul_rn(a, s[2 * SLICE + c + e]));
        }
        *reinterpret_cast<__nv_bfloat162*>(
            out + static_cast<long long>(r) * SLICE + c) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x (m, k) int8, w_t (128, k) int8, sw 384 fp32, out (m, 128) bf16.
// Requires k % 64 == 0 and 16-byte aligned tensors (checked by the
// wrapper).
extern "C" int lseg_int8_sliced_scale(const void* x, const void* w_t,
                                      const void* sw, void* out, int m,
                                      int k, void* stream) {
  int8_sliced_scale_kernel<<<(m + q::BM - 1) / q::BM, q::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w_t),
      static_cast<const float*>(sw), static_cast<__nv_bfloat16*>(out), m, k);
  return static_cast<int>(cudaGetLastError());
}
