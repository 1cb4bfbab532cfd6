// LayerNorm in fp32 + per-row symmetric int8 quantize, a warp a row.
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
// contract them into FMAs (the plain PyTorch version rounds each step).
// The codes are the IEEE division's: each group of CH values takes the
// reciprocal's product (`code_bits_fast`, lseg_common.cuh) and the division
// itself only where one of them lies within 1e-4 of a half-integer. The
// sums are taken in another order than PyTorch's, so an int8 code can sit
// one level off at a bin edge.
//
// What bounds it on the card: bytes (at B2's flagship, 7208 rows of 1024,
// 14.8 MB in, 7.4 MB of codes and 29 KB of scales out: 6.6 us at 3.35
// TB/s), against ~15 operations a value. Design: a persistent grid of
// 8-warp CTAs, as many as fit on the card; warp gw of TW takes rows gw,
// gw + TW, gw + 2 TW, ... Each warp keeps NS of its rows in flight in a
// ring of shared-memory slots, each filled by one cp.async.bulk of the
// row (2 KB at D = 1024) on its own mbarrier, and refills a slot with the
// row NS ahead as soon as it holds this row in registers, so the next
// rows' loads overlap this row's reductions. g and b are staged once a
// CTA and read as 16-byte vectors; a row's codes go to one of two staging
// rows of the warp and out by one bulk copy, its scale by one lane.

#pragma once

#include "wgmma.cuh"

namespace lseg {
namespace {
namespace lnq {

constexpr int WARPS = 8;

// row slots a warp keeps in flight: three up to D = 1024, two above
template <int D>
__host__ __device__ constexpr int slots() {
  return D <= 1024 ? 3 : 2;
}

// dynamic shared memory of a CTA: g and b (fp32), then per warp its ring
// (NS rows of bf16) and two staging rows of codes, then the barriers
template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * D * 4 + WARPS * (slots<D>() * D * 2 + 2 * D) +
         WARPS * slots<D>() * 8;
}

// CH bf16 values from shared memory at `p` (16 bytes for CH = 8, 8 bytes
// for CH = 4).
template <int CH>
__device__ __forceinline__ void load_chunk(const uint8_t* p,
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

template <int CH>
__device__ __forceinline__ void load_params(const float* p, float (&v)[CH]) {
#pragma unroll
  for (int j = 0; j < CH; j += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + j);
    v[j] = f.x;
    v[j + 1] = f.y;
    v[j + 2] = f.z;
    v[j + 3] = f.w;
  }
}

// lane 0: a row of x (`bytes` of bf16 at `src`) into the slot at `dst`,
// completing `bar`; the slot's earlier reads come first
__device__ __forceinline__ void load_row(uint8_t* dst, const void* src,
                                         int bytes, uint64_t* bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  wg::bar_expect_tx(bar, bytes);
  wg::bulk_load(dst, src, bytes, bar);
}

// One warp per row of D = 32 * CH * VPL bf16 values: each lane holds VPL
// chunks of CH values (CH = 8: D a multiple of 256; CH = 4 for the odd
// multiples of 128), chunk i of lane l at values (32 i + l) CH.
template <int VPL, int CH>
__global__ void __launch_bounds__(WARPS * 32) ln_quantize_ring_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
    const float* __restrict__ b, int8_t* __restrict__ q,
    float* __restrict__ s, int rows, float eps) {
  constexpr int D = 32 * CH * VPL;
  constexpr int NS = slots<D>();
  extern __shared__ __align__(16) uint8_t smem[];
  float* gs = reinterpret_cast<float*>(smem);
  float* bs = gs + D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint8_t* ring = smem + 2 * D * 4 + warp * (NS * D * 2 + 2 * D);
  uint8_t* cst = ring + NS * D * 2;  // two staging rows of codes
  uint64_t* bars = reinterpret_cast<uint64_t*>(
                       smem + 2 * D * 4 + WARPS * (NS * D * 2 + 2 * D)) +
                   warp * NS;
  for (int i = threadIdx.x; i < D / 4; i += blockDim.x) {
    reinterpret_cast<float4*>(gs)[i] = reinterpret_cast<const float4*>(g)[i];
    reinterpret_cast<float4*>(bs)[i] = reinterpret_cast<const float4*>(b)[i];
  }
  const int tw = gridDim.x * WARPS;
  const int gw = blockIdx.x * WARPS + warp;
  if (lane == 0) {
    for (int k = 0; k < NS; ++k) wg::bar_init(bars + k, 1);
    wg::bar_init_fence();
    for (int k = 0; k < NS && gw + k * tw < rows; ++k)
      load_row(ring + k * D * 2,
               x + static_cast<long long>(gw + k * tw) * D, D * 2, bars + k);
  }
  __syncthreads();  // g and b staged, the barriers set

  for (int k = 0; gw + k * tw < rows; ++k) {
    const int row = gw + k * tw;
    const int slot = k % NS;
    wg::bar_wait(bars + slot, (k / NS) & 1);
    float v[VPL][CH];
#pragma unroll
    for (int i = 0; i < VPL; ++i)
      load_chunk<CH>(ring + slot * D * 2 + (i * 32 + lane) * CH * 2, v[i]);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < VPL; ++i)
#pragma unroll
      for (int j = 0; j < CH; ++j) acc = __fadd_rn(acc, v[i][j]);
    const float mu = __fdiv_rn(warp_sum(acc), static_cast<float>(D));
    // every lane holds its values: the slot takes the row NS ahead
    __syncwarp();
    if (lane == 0 && row + NS * tw < rows)
      load_row(ring + slot * D * 2,
               x + static_cast<long long>(row + NS * tw) * D, D * 2,
               bars + slot);
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
      float gv[CH], bv[CH];
      load_params<CH>(gs + c0, gv);
      load_params<CH>(bs + c0, bv);
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        v[i][j] = __fadd_rn(__fmul_rn(__fmul_rn(v[i][j], r), gv[j]), bv[j]);
        amax = fmaxf(amax, fabsf(v[i][j]));
      }
    }
    const float sc = __fdiv_rn(fmaxf(warp_max(amax), 1e-8f), 127.0f);
    const float inv = __frcp_rn(sc);
    // the staging row of two rows back has been read by its copy
    if (lane == 0)
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncwarp();
    uint8_t* st = cst + (k & 1) * D;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      bool near = false;
      uint32_t w0 = pack_codes_fast(v[i][0], v[i][1], v[i][2], v[i][3], inv,
                                    near);
      uint32_t w1 = 0;
      if constexpr (CH == 8)
        w1 = pack_codes_fast(v[i][4], v[i][5], v[i][6], v[i][7], inv, near);
      if (__builtin_expect(near, 0)) {
        w0 = pack_codes(v[i][0], v[i][1], v[i][2], v[i][3], sc);
        if constexpr (CH == 8)
          w1 = pack_codes(v[i][4], v[i][5], v[i][6], v[i][7], sc);
      }
      if constexpr (CH == 8)
        *reinterpret_cast<uint2*>(st + (i * 32 + lane) * CH) =
            make_uint2(w0, w1);
      else
        *reinterpret_cast<uint32_t*>(st + (i * 32 + lane) * CH) = w0;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) {
      wg::bulk_store(q + static_cast<long long>(row) * D, st, D);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      s[row] = sc;
    }
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int VPL, int CH>
int launch(const void* x, const void* g, const void* b, void* q, void* s,
           int rows, float eps, cudaStream_t stream) {
  constexpr int D = 32 * CH * VPL;
  // the attribute, the SM count and the occupancy, once a process
  static const int per_card = [] {
    if (cudaFuncSetAttribute(ln_quantize_ring_kernel<VPL, CH>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<D>()) != cudaSuccess)
      return 0;
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ln_quantize_ring_kernel<VPL, CH>, WARPS * 32,
        smem_bytes<D>());
    return sms * per_sm;
  }();
  if (per_card <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = min((rows + WARPS - 1) / WARPS, per_card);
  ln_quantize_ring_kernel<VPL, CH><<<grid, WARPS * 32, smem_bytes<D>(),
                                     stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
      static_cast<const float*>(b), static_cast<int8_t*>(q),
      static_cast<float*>(s), rows, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lnq

// Launch the LN + quantize kernel over `rows` rows of width `dim` (a
// multiple of 256 up to 2048, or an odd multiple of 128 up to 896), on a
// persistent grid of 8-warp CTAs. x, g and b 16-byte aligned.
inline int launch_ln_quantize_rows(const void* x, const void* g,
                                   const void* b, void* q, void* s, int rows,
                                   int dim, float eps, cudaStream_t stream) {
  if (rows <= 0) return 0;
  const int key = dim % 256 == 0 ? dim / 256 : dim % 128 == 0 ? -dim / 128
                                                              : 0;
  switch (key) {
#define LSEG_LNQ_CASE(K, V, CH) \
  case K:                       \
    return lnq::launch<V, CH>(x, g, b, q, s, rows, eps, stream);
    LSEG_LNQ_CASE(1, 1, 8)
    LSEG_LNQ_CASE(2, 2, 8)
    LSEG_LNQ_CASE(3, 3, 8)
    LSEG_LNQ_CASE(4, 4, 8)
    LSEG_LNQ_CASE(5, 5, 8)
    LSEG_LNQ_CASE(6, 6, 8)
    LSEG_LNQ_CASE(7, 7, 8)
    LSEG_LNQ_CASE(8, 8, 8)
    // the odd multiples of 128 up to 896 (B2's widths), 4 values a chunk
    LSEG_LNQ_CASE(-1, 1, 4)
    LSEG_LNQ_CASE(-3, 3, 4)
    LSEG_LNQ_CASE(-5, 5, 4)
    LSEG_LNQ_CASE(-7, 7, 4)
#undef LSEG_LNQ_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace lseg
