// LayerNorm in fp32 + per-row symmetric int8 quantize, one warp per row.
// B3 (`ln_quantize_rows.cu`) launches it on its own; B2
// (`flash_attention_ln_qkv_q8.cu`) and B9 (`flash_attention_ln_qkv_fused.cu`)
// launch it as the first step of their chains, so the kernels share one
// copy of the rounding.
//
// Rounding follows the TPU kernel (lseg_tpu/ops/pallas_ln.py:30-39):
//   mu = sum(x) / D; var = sum((x - mu)^2) / D;
//   xn = ((x - mu) * rsqrt(var + eps)) * g + b;
//   s = max(max|xn|, 1e-8) / 127;  q = clip(round_half_even(xn / s), +-127)
// Products and sums are written with the _rn intrinsics so nvcc does not
// contract them into FMAs (the plain PyTorch version rounds each step),
// and xn / s is a true IEEE division. The sums are taken in another order
// than PyTorch's, so an int8 code can sit one level off at a bin edge.

#pragma once

#include "lseg_common.cuh"

namespace lseg {
namespace {

// CH bf16 values from `p` (16 bytes for CH = 8, 8 bytes for CH = 4).
template <int CH>
__device__ __forceinline__ void load_chunk(const __nv_bfloat16* p,
                                           float (&v)[CH]) {
  if constexpr (CH == 8) {
    unpack8(*reinterpret_cast<const uint4*>(p), v);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int j = 0; j < CH / 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
}

// One warp per row of D = 32 * CH * VPL bf16 values: each lane holds VPL
// chunks of CH values (CH = 8: 16-byte loads, D a multiple of 256; CH = 4
// for the odd multiples of 128) in registers across the whole routine.
template <int VPL, int CH = 8>
__global__ void __launch_bounds__(256) ln_quantize_rows_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ b, int8_t* __restrict__ q,
    float* __restrict__ s, int rows, float eps) {
  constexpr int D = 32 * CH * VPL;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + static_cast<long long>(row) * D;

  float v[VPL][CH];
#pragma unroll
  for (int i = 0; i < VPL; ++i) load_chunk<CH>(xr + (i * 32 + lane) * CH, v[i]);
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int j = 0; j < CH; ++j) acc = __fadd_rn(acc, v[i][j]);
  const float mu = __fdiv_rn(warp_sum(acc), static_cast<float>(D));
  acc = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      v[i][j] = __fsub_rn(v[i][j], mu);
      acc = __fadd_rn(acc, __fmul_rn(v[i][j], v[i][j]));
    }
  const float var = __fdiv_rn(warp_sum(acc), static_cast<float>(D));
  const float r = rsqrtf(__fadd_rn(var, eps));
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c0 = (i * 32 + lane) * CH;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      v[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], r), g[c0 + j]),
                          b[c0 + j]);
      amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
  const float sc = __fdiv_rn(fmaxf(warp_max(amax), 1e-8f), 127.0f);
  int8_t* qr = q + static_cast<long long>(row) * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const uint32_t lo = pack_codes(v[i][0], v[i][1], v[i][2], v[i][3], sc);
    if constexpr (CH == 8) {
      uint2 out;
      out.x = lo;
      out.y = pack_codes(v[i][4], v[i][5], v[i][6], v[i][7], sc);
      *reinterpret_cast<uint2*>(qr + (i * 32 + lane) * CH) = out;
    } else {
      *reinterpret_cast<uint32_t*>(qr + (i * 32 + lane) * CH) = lo;
    }
  }
  if (lane == 0) s[row] = sc;
}

// Launch the LN + quantize kernel over `rows` rows of width `dim` (a
// multiple of 128, dim <= 2048); 8 rows (warps) per block.
inline int launch_ln_quantize_rows(const void* x, const void* g,
                                   const void* b, void* q, void* s, int rows,
                                   int dim, float eps, cudaStream_t stream) {
  const dim3 grid((rows + 7) / 8);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* gp = static_cast<const float*>(g);
  const auto* bp = static_cast<const float*>(b);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  const int key = dim % 256 == 0 ? dim / 256 : dim % 128 == 0 ? -dim / 128
                                                              : 0;
  switch (key) {
#define LSEG_LNQ_CASE(K, V, CH)                                             \
  case K:                                                                   \
    ln_quantize_rows_kernel<V, CH><<<grid, 256, 0, stream>>>(xp, gp, bp, qp, \
                                                            sp, rows, eps); \
    break;
    LSEG_LNQ_CASE(1, 1, 8)
    LSEG_LNQ_CASE(2, 2, 8)
    LSEG_LNQ_CASE(3, 3, 8)
    LSEG_LNQ_CASE(4, 4, 8)
    LSEG_LNQ_CASE(5, 5, 8)
    LSEG_LNQ_CASE(6, 6, 8)
    LSEG_LNQ_CASE(7, 7, 8)
    LSEG_LNQ_CASE(8, 8, 8)
    // the odd multiples of 128 up to 1024 (B2's widths), 4 values a chunk
    LSEG_LNQ_CASE(-1, 1, 4)
    LSEG_LNQ_CASE(-3, 3, 4)
    LSEG_LNQ_CASE(-5, 5, 4)
    LSEG_LNQ_CASE(-7, 7, 4)
#undef LSEG_LNQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace lseg
