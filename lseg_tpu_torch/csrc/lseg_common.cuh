// Shared device helpers of the kernels: warp reductions, the (value,
// index) argmax order of jnp.argmax, the hardware exp2, fragment packing,
// the mma.sync wrappers (bf16 m16n8k16 and s8 m16n8k32, both with 32-bit
// accumulators) and the int8 quantize of one value (round half to even,
// clip to +-127, true IEEE division).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Internal linkage: every source that includes this header gets its own
// copy, so the separately compiled objects link without clashes.
namespace lseg {
namespace {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// (v, i) beats (bv, bi) in jnp.argmax's order: the larger value, NaN
// above every number, ties to the smaller index (the first occurrence)
__device__ __forceinline__ bool argmax_better(float v, int i, float bv,
                                              int bi) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || i < bi);
  return v > bv || (v == bv && i < bi);
}

// one butterfly step of an (value, index) argmax across lanes `o` apart
__device__ __forceinline__ void argmax_xor(float& v, int& i, int o) {
  const float ov = __shfl_xor_sync(0xffffffffu, v, o);
  const int oi = __shfl_xor_sync(0xffffffffu, i, o);
  if (argmax_better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

// 2^x by the ex2.approx.ftz instruction (about 2 ulp; a result below
// 2^-126 flushes to zero, 2^-inf is 0). exp2f without -ftz wraps the same
// instruction in a rescale for subnormal results.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32, row) * b (32x8, col); s8 in, s32 accumulate (exact)
__device__ __forceinline__ void mma_s8_16832(int (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// round half to even, clip to +-127 (the reference's jnp.round + clip)
__device__ __forceinline__ int quantize_code(float v, float s) {
  const float r = rintf(__fdiv_rn(v, s));
  return static_cast<int>(fminf(fmaxf(r, -127.0f), 127.0f));
}

__device__ __forceinline__ uint32_t pack_codes(float a, float b, float c,
                                               float d, float s) {
  return (static_cast<uint32_t>(quantize_code(a, s)) & 0xffu) |
         ((static_cast<uint32_t>(quantize_code(b, s)) & 0xffu) << 8) |
         ((static_cast<uint32_t>(quantize_code(c, s)) & 0xffu) << 16) |
         ((static_cast<uint32_t>(quantize_code(d, s)) & 0xffu) << 24);
}

__device__ __forceinline__ void unpack8(const uint4& raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

}  // namespace
}  // namespace lseg
