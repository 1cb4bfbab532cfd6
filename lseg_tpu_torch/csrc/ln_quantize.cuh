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

// One warp per row of D = 256 * VPL bf16 values: each lane holds VPL
// 16-byte chunks (8 values each) in registers across the whole routine.
template <int VPL>
__global__ void __launch_bounds__(256) ln_quantize_rows_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ b, int8_t* __restrict__ q,
    float* __restrict__ s, int rows, float eps) {
  constexpr int D = 256 * VPL;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const __nv_bfloat16* xr = x + static_cast<long long>(row) * D;

  float v[VPL][8];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    unpack8(*reinterpret_cast<const uint4*>(xr + (i * 32 + lane) * 8), v[i]);
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = __fadd_rn(acc, v[i][j]);
  const float mu = __fdiv_rn(warp_sum(acc), static_cast<float>(D));
  acc = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[i][j] = __fsub_rn(v[i][j], mu);
      acc = __fadd_rn(acc, __fmul_rn(v[i][j], v[i][j]));
    }
  const float var = __fdiv_rn(warp_sum(acc), static_cast<float>(D));
  const float r = rsqrtf(__fadd_rn(var, eps));
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c0 = (i * 32 + lane) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      v[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], r), g[c0 + j]),
                          b[c0 + j]);
      amax = fmaxf(amax, fabsf(v[i][j]));
    }
  }
  const float sc = __fdiv_rn(fmaxf(warp_max(amax), 1e-8f), 127.0f);
  int8_t* qr = q + static_cast<long long>(row) * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    uint2 out;
    out.x = pack_codes(v[i][0], v[i][1], v[i][2], v[i][3], sc);
    out.y = pack_codes(v[i][4], v[i][5], v[i][6], v[i][7], sc);
    *reinterpret_cast<uint2*>(qr + (i * 32 + lane) * 8) = out;
  }
  if (lane == 0) s[row] = sc;
}

// Launch the LN + quantize kernel over `rows` rows of width `dim`
// (dim % 256 == 0, dim <= 2048); 8 rows (warps) per block.
inline int launch_ln_quantize_rows(const void* x, const void* g,
                                   const void* b, void* q, void* s, int rows,
                                   int dim, float eps, cudaStream_t stream) {
  const dim3 grid((rows + 7) / 8);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* gp = static_cast<const float*>(g);
  const auto* bp = static_cast<const float*>(b);
  auto* qp = static_cast<int8_t*>(q);
  auto* sp = static_cast<float*>(s);
  switch (dim / 256) {
#define LSEG_LNQ_CASE(V)                                                   \
  case V:                                                                  \
    ln_quantize_rows_kernel<V><<<grid, 256, 0, stream>>>(xp, gp, bp, qp, sp, \
                                                        rows, eps);        \
    break;
    LSEG_LNQ_CASE(1)
    LSEG_LNQ_CASE(2)
    LSEG_LNQ_CASE(3)
    LSEG_LNQ_CASE(4)
    LSEG_LNQ_CASE(5)
    LSEG_LNQ_CASE(6)
    LSEG_LNQ_CASE(7)
    LSEG_LNQ_CASE(8)
#undef LSEG_LNQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace lseg
