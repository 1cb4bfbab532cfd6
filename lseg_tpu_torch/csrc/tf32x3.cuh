// Split-TF32 products: fp32-accurate matrix products on Hopper's tensor
// cores, shared by the fp32 modes of kernels B17 (dense_residual.cu, on
// wgmma) and B7 (flash_attention_flat_bwd_fp32.cu, on mma.sync).
//
// One TF32 product rounds each operand to 10 mantissa bits (about 1e-3
// relative), which no fp32 gate of the port tolerates. A split product
// keeps about 21 bits of each operand: write x = hi + lo with hi = x
// rounded to TF32 and lo = x - hi (exact in fp32; the tensor cores read
// it truncated to TF32), and sum
//   a . b ~= a_lo . b_hi + a_hi . b_lo + a_hi . b_hi
// in the fp32 accumulator; the dropped a_lo . b_lo term is below 2^-21 of
// |a| |b|. The split is an integer add, a mask and one subtraction: on
// an H100, cvt.rna.tf32.f32 compiles to a compare-and-select sequence,
// and B7's fp32 mode ran 2.72 ms with it against 2.05 ms with the integer
// split (PERF.md).
//
// The tensor cores' fp32 accumulation truncates: on an H100 a first B17
// kernel that took all of K = 4096 into one accumulator (1,536 truncating
// adds an output) missed the fp32 gate (atol 1e-4 + rtol 1e-5) by up to
// 1.9e-4. So B17 sums each 32-deep k-chunk into a fresh partial and
// folds it into the running sum with round-to-nearest adds (`fold`); B7's
// sums take at most 180 truncating adds (its source says why that is
// inside its gate). A numpy emulation of that arithmetic at B17's probe inputs,
// (256, 4096) . (4096, 128), x ~ randn, w ~ randn K^-1/2, each product
// summed exactly and added with truncation
// (`tests/test_torch_probe.py::test_split_tf32_emulation_against_the_
// fp32_gate`), stays within the gate; one accumulator, one TF32 product
// (10 bits, ~1e-3) or the split without x_lo . w_hi fail it. The two small
// terms go first and the large one last, as CUTLASS's
// OpMultiplyAddFastF32 orders them; in the emulation the other order
// passes the gate as well, so no gate needs the order.
//
// The card runs TF32 at 495 TFLOP/s dense against 67 TFLOP/s of fp32
// FMAs, so three TF32 products still cost 0.41x of one fp32 FMA product.

#pragma once

#include "wgmma.cuh"

namespace lseg {
namespace {
namespace tf32x3 {

// x = hi + lo to ~21 bits: hi = x rounded to TF32 (to nearest, ties
// away, as cvt.rna.tf32.f32 rounds a finite x) by an integer add and a
// mask, lo = x - hi (exact) as it is: the tensor cores read the top 19
// bits of a TF32 operand, so they truncate lo to TF32 themselves, which
// keeps |x - hi - lo_tf32| below 2^-21 |x|. Three instructions a value.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi)));
}

// In place over a float4 of shared memory: hi written back, lo to `lo`.
__device__ __forceinline__ void split4(float4* p, float4* lo) {
  const float4 v = *p;
  uint32_t h[4], l[4];
  split(v.x, h[0], l[0]);
  split(v.y, h[1], l[1]);
  split(v.z, h[2], l[2]);
  split(v.w, h[3], l[3]);
  *p = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                   __uint_as_float(h[2]), __uint_as_float(h[3]));
  *lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// ---- mma.sync m16n8k8 tf32 --------------------------------------------------
// A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); B (8 x 8, col): b0 (k = t, n = g), b1 (k = t + 4, n = g);
// C: c0, c1 (g, 2t + {0, 1}), c2, c3 (g + 8, 2t + {0, 1}); g = lane / 4,
// t = lane % 4.

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An operand fragment split once: hi and lo of each register.
template <int R>
struct Frag {
  uint32_t hi[R], lo[R];
  __device__ __forceinline__ void set(int i, float x) {
    split(x, hi[i], lo[i]);
  }
};

// d += a . b in split TF32: a_lo . b_hi, a_hi . b_lo, then a_hi . b_hi.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a,
                                     const Frag<2>& b) {
  mma(d, a.lo, b.hi[0], b.hi[1]);
  mma(d, a.hi, b.lo[0], b.lo[1]);
  mma(d, a.hi, b.hi[0], b.hi[1]);
}

// ---- wgmma m64n128k8 tf32, both operands K-major in shared memory -----------
// tf32 wgmma reads only K-major operands (the transpose flags exist for
// 16-bit types alone). The accumulator is wgmma.cuh's layout over 16
// column tiles: float acc[16][4]. scale_d = 0 overwrites d.

__device__ __forceinline__ void wgmma_128(float (&d)[16][4], uint64_t da,
                                          uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (+)= A . B over one k-step of 8 in split TF32, A and B each given by
// the descriptors of its hi and lo tiles; scale_d = 0 starts d afresh.
// Issued, not waited for.
__device__ __forceinline__ void wgmma3_128(float (&d)[16][4], uint64_t a_hi,
                                           uint64_t a_lo, uint64_t b_hi,
                                           uint64_t b_lo, int scale_d) {
  wgmma_128(d, a_lo, b_hi, scale_d);
  wgmma_128(d, a_hi, b_lo, 1);
  wgmma_128(d, a_hi, b_hi, 1);
}

// d += p, each sum rounded to nearest: a partial sum of the tensor cores
// (whose accumulation truncates) folded into the running fp32 sum.
template <int NT>
__device__ __forceinline__ void fold(float (&d)[NT][4],
                                     const float (&p)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = __fadd_rn(d[i][e], p[i][e]);
}

}  // namespace tf32x3
}  // namespace
}  // namespace lseg
