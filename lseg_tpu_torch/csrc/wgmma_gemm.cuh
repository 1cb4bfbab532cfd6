// The Hopper GEMM engine of kernels B17 (dense_residual.cu, bf16 mode), B10
// (fused_correlate.cu, both modes), B16 (mlp_fused.cu), the int8 qkv
// projection of B2, B8, B9 and B15 (qkv_wgmma.cuh) and B15's output
// projection, beside the tile engine of wgmma.cuh, whose descriptors,
// barriers and tensor-map encoder it uses.
//
// A GEMM here is a ring of shared-memory stages that TMA fills, each
// stage completed on its own `full` mbarrier and handed back on its own
// `empty` mbarrier; a producer warp issues the loads (one elected thread),
// consumer warpgroups run the products (warp specialisation). Iteration
// `it` of either side uses stage it % STAGES with parity (it / STAGES) & 1;
// the producer waits on `empty` with the opposite parity, so its first
// pass over the ring does not wait.
//
// Products: m64nNk16 bf16 -> fp32 for N = 72, 80 and 256, both operands
// from shared memory (SS). The accumulator of one warpgroup is
// `float acc[N / 8][4]` per thread, mma.sync's m16n8 C layout repeated
// over N / 8 column tiles, as in wgmma.cuh: warp w of the group owns rows
// 16w..16w+15, lane holds rows g = lane / 4 and g + 8 and columns
// nt * 8 + 2 * (lane % 4) + {0, 1}. Operand tiles are 128-byte swizzled
// rows of 64 bf16 (one swizzle atom wide), 1024-byte aligned:
//   - K-major (rows contiguous along the reduced dim, A always, and B
//     stored as N rows): 8-row groups 1024 bytes apart, k-step kk 32 bytes
//     along the row (wg::desc, wg::desc_kstep);
//   - MN-major B (K rows contiguous along N, read transposed): N wider
//     than 64 is held as N / 64 boxes of 64 columns, `box_stride` bytes
//     apart (the descriptor's leading byte offset), 8-row groups of K 1024
//     bytes apart (its stride byte offset), k-step kk 2048 bytes
//     (desc_mn, wg::desc_rowstep).
// Integer products: m64nNk32 s8 -> s32 for N = 64, 128, 192 and 256 (MmaS8), both
// operands K-major from shared memory, as 8-bit wgmma requires (or, for
// N = 64, A from registers: `MmaS8<64>::rs`, fed by `ldsm_x4`): a
// 128-byte swizzled row holds 128 codes, so a k-step of 32 is the same
// 32 bytes along the row as a bf16 k-step of 16 (wg::desc_kstep). The
// accumulator `int acc[N / 8][4]` has the fp32 layout above; its sums are
// exact.

#pragma once

#include "wgmma.cuh"

namespace lseg {
namespace {
namespace gemm {

// ---- descriptors ------------------------------------------------------------

// MN-major operand of several 64-column boxes `box_stride` bytes apart.
__device__ __forceinline__ uint64_t desc_mn(const void* p, int box_stride) {
  const uint64_t a = wg::smem_addr(p);
  return ((a & 0x3FFFFull) >> 4) |
         (static_cast<uint64_t>(box_stride >> 4) << 16) |
         ((1024ull >> 4) << 32) | (1ull << 62);
}

template <int NT>
__device__ __forceinline__ void fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
template <int NT>
__device__ __forceinline__ void fence_acc(int (&d)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[i][e])::"memory");
}

template <typename T, int NT>
__device__ __forceinline__ void zero(T (&d)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) d[i][e] = T(0);
}

// wgmma.wait_group with a count known only at run time (0..7)
__device__ __forceinline__ void wait_dyn(int n) {
  switch (n) {
    case 0: wg::wait<0>(); break;
    case 1: wg::wait<1>(); break;
    case 2: wg::wait<2>(); break;
    case 3: wg::wait<3>(); break;
    case 4: wg::wait<4>(); break;
    case 5: wg::wait<5>(); break;
    case 6: wg::wait<6>(); break;
    default: wg::wait<7>(); break;
  }
}

// ---- products: d (+)= A . B, m64nNk16, A K-major, B K-major (TB = 0) or
// MN-major (TB = 1); scale_d = 0 overwrites d ---------------------------------

template <int N>
struct Mma;

template <>
struct Mma<72> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[9][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35"
        "}, %36, %37, p, 1, 1, 0, %39;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Mma<80> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[10][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39"
        "}, %40, %41, p, 1, 1, 0, %43;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
          "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
          "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
          "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
          "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
          "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
          "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
          "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
          "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
          "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};


template <>
struct Mma<256> {
  template <int TB>
  static __device__ __forceinline__ void ss(float (&d)[32][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
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
          "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
          "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
          "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
          "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
          "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
          "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
          "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
          "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
          "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3]),
          "+f"(d[24][0]), "+f"(d[24][1]), "+f"(d[24][2]), "+f"(d[24][3]),
          "+f"(d[25][0]), "+f"(d[25][1]), "+f"(d[25][2]), "+f"(d[25][3]),
          "+f"(d[26][0]), "+f"(d[26][1]), "+f"(d[26][2]), "+f"(d[26][3]),
          "+f"(d[27][0]), "+f"(d[27][1]), "+f"(d[27][2]), "+f"(d[27][3]),
          "+f"(d[28][0]), "+f"(d[28][1]), "+f"(d[28][2]), "+f"(d[28][3]),
          "+f"(d[29][0]), "+f"(d[29][1]), "+f"(d[29][2]), "+f"(d[29][3]),
          "+f"(d[30][0]), "+f"(d[30][1]), "+f"(d[30][2]), "+f"(d[30][3]),
          "+f"(d[31][0]), "+f"(d[31][1]), "+f"(d[31][2]), "+f"(d[31][3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

// One 64-deep k-chunk: four k-steps of 16, A K-major at `da`, B at `db`
// (K-major: k-step 32 bytes; MN-major: 2048 bytes); issued, not waited
// for, and not committed.
template <int N, int TB>
__device__ __forceinline__ void mma_chunk(float (&d)[N / 8][4], uint64_t da,
                                          uint64_t db) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Mma<N>::template ss<TB>(d, wg::desc_kstep(da, kk),
                            TB ? wg::desc_rowstep(db, kk)
                               : wg::desc_kstep(db, kk),
                            1);
}

// ---- integer products: d (+)= A . B, m64nNk32 s8 -> s32, both K-major;
// scale_d = 0 overwrites d --------------------------------------------------

template <int N>
struct MmaS8;

template <>
struct MmaS8<64> {
  static __device__ __forceinline__ void ss(int (&d)[8][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // A (64 x 32 codes) from registers: each warp's 16 rows as mma.sync's
  // m16n8k32 A fragment (ldsm_x4 loads it), B K-major from shared memory
  static __device__ __forceinline__ void rs(int (&d)[8][4],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct MmaS8<128> {
  static __device__ __forceinline__ void ss(int (&d)[16][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
          "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
          "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
          "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
          "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
          "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
          "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
          "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
          "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct MmaS8<192> {
  static __device__ __forceinline__ void ss(int (&d)[24][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
          "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
          "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
          "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
          "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
          "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
          "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
          "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
          "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]),
          "+r"(d[16][0]), "+r"(d[16][1]), "+r"(d[16][2]), "+r"(d[16][3]),
          "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]), "+r"(d[17][3]),
          "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]),
          "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3]),
          "+r"(d[20][0]), "+r"(d[20][1]), "+r"(d[20][2]), "+r"(d[20][3]),
          "+r"(d[21][0]), "+r"(d[21][1]), "+r"(d[21][2]), "+r"(d[21][3]),
          "+r"(d[22][0]), "+r"(d[22][1]), "+r"(d[22][2]), "+r"(d[22][3]),
          "+r"(d[23][0]), "+r"(d[23][1]), "+r"(d[23][2]), "+r"(d[23][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct MmaS8<256> {
  static __device__ __forceinline__ void ss(int (&d)[32][4], uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p;\n}\n"
        : "+r"(d[0][0]), "+r"(d[0][1]), "+r"(d[0][2]), "+r"(d[0][3]),
          "+r"(d[1][0]), "+r"(d[1][1]), "+r"(d[1][2]), "+r"(d[1][3]),
          "+r"(d[2][0]), "+r"(d[2][1]), "+r"(d[2][2]), "+r"(d[2][3]),
          "+r"(d[3][0]), "+r"(d[3][1]), "+r"(d[3][2]), "+r"(d[3][3]),
          "+r"(d[4][0]), "+r"(d[4][1]), "+r"(d[4][2]), "+r"(d[4][3]),
          "+r"(d[5][0]), "+r"(d[5][1]), "+r"(d[5][2]), "+r"(d[5][3]),
          "+r"(d[6][0]), "+r"(d[6][1]), "+r"(d[6][2]), "+r"(d[6][3]),
          "+r"(d[7][0]), "+r"(d[7][1]), "+r"(d[7][2]), "+r"(d[7][3]),
          "+r"(d[8][0]), "+r"(d[8][1]), "+r"(d[8][2]), "+r"(d[8][3]),
          "+r"(d[9][0]), "+r"(d[9][1]), "+r"(d[9][2]), "+r"(d[9][3]),
          "+r"(d[10][0]), "+r"(d[10][1]), "+r"(d[10][2]), "+r"(d[10][3]),
          "+r"(d[11][0]), "+r"(d[11][1]), "+r"(d[11][2]), "+r"(d[11][3]),
          "+r"(d[12][0]), "+r"(d[12][1]), "+r"(d[12][2]), "+r"(d[12][3]),
          "+r"(d[13][0]), "+r"(d[13][1]), "+r"(d[13][2]), "+r"(d[13][3]),
          "+r"(d[14][0]), "+r"(d[14][1]), "+r"(d[14][2]), "+r"(d[14][3]),
          "+r"(d[15][0]), "+r"(d[15][1]), "+r"(d[15][2]), "+r"(d[15][3]),
          "+r"(d[16][0]), "+r"(d[16][1]), "+r"(d[16][2]), "+r"(d[16][3]),
          "+r"(d[17][0]), "+r"(d[17][1]), "+r"(d[17][2]), "+r"(d[17][3]),
          "+r"(d[18][0]), "+r"(d[18][1]), "+r"(d[18][2]), "+r"(d[18][3]),
          "+r"(d[19][0]), "+r"(d[19][1]), "+r"(d[19][2]), "+r"(d[19][3]),
          "+r"(d[20][0]), "+r"(d[20][1]), "+r"(d[20][2]), "+r"(d[20][3]),
          "+r"(d[21][0]), "+r"(d[21][1]), "+r"(d[21][2]), "+r"(d[21][3]),
          "+r"(d[22][0]), "+r"(d[22][1]), "+r"(d[22][2]), "+r"(d[22][3]),
          "+r"(d[23][0]), "+r"(d[23][1]), "+r"(d[23][2]), "+r"(d[23][3]),
          "+r"(d[24][0]), "+r"(d[24][1]), "+r"(d[24][2]), "+r"(d[24][3]),
          "+r"(d[25][0]), "+r"(d[25][1]), "+r"(d[25][2]), "+r"(d[25][3]),
          "+r"(d[26][0]), "+r"(d[26][1]), "+r"(d[26][2]), "+r"(d[26][3]),
          "+r"(d[27][0]), "+r"(d[27][1]), "+r"(d[27][2]), "+r"(d[27][3]),
          "+r"(d[28][0]), "+r"(d[28][1]), "+r"(d[28][2]), "+r"(d[28][3]),
          "+r"(d[29][0]), "+r"(d[29][1]), "+r"(d[29][2]), "+r"(d[29][3]),
          "+r"(d[30][0]), "+r"(d[30][1]), "+r"(d[30][2]), "+r"(d[30][3]),
          "+r"(d[31][0]), "+r"(d[31][1]), "+r"(d[31][2]), "+r"(d[31][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// Four 8 x 16-byte matrices of shared memory into registers (ldmatrix):
// lane i gives the address of row i % 8 of matrix i / 8, and register j
// receives matrix j, lane (g, t4) its row g, bytes 4 t4 .. 4 t4 + 3. With
// matrices (rows 0-7, bytes 0-15), (rows 8-15, bytes 0-15), (rows 0-7,
// bytes 16-31), (rows 8-15, bytes 16-31) of a 16-row, 32-byte operand that
// is mma.sync's m16n8k32 A fragment of 8-bit codes.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// ---- the ring ---------------------------------------------------------------

template <int STAGES>
struct Ring {
  uint64_t full[STAGES];
  uint64_t empty[STAGES];

  // one thread, before the block's first sync: `consumers` arrivals free
  // a stage; `producers` arrivals (the one that announces the TMA bytes,
  // and each `fill`) and the bytes complete it
  __device__ __forceinline__ void init(int consumers, int producers = 1) {
    for (int s = 0; s < STAGES; ++s) {
      wg::bar_init(&full[s], producers);
      wg::bar_init(&empty[s], consumers);
    }
    wg::bar_init_fence();
  }
  // producer: wait until the consumers are done with stage it % STAGES
  // (the stage iteration it would fill); returns the stage
  __device__ __forceinline__ int wait_free(uint32_t it) {
    const int s = it % STAGES;
    wg::bar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    return s;
  }
  // producer: wait_free, then announce `bytes` of TMA loads on the
  // stage's full barrier; returns the stage
  __device__ __forceinline__ int acquire(uint32_t it, int bytes) {
    const int s = wait_free(it);
    wg::bar_expect_tx(&full[s], bytes);
    return s;
  }
  // producer thread that wrote part of iteration it's stage with generic
  // stores, then fence_proxy_async: its arrival on the stage's full
  // barrier
  __device__ __forceinline__ void fill(uint32_t it) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     wg::smem_addr(&full[it % STAGES]))
                 : "memory");
  }
  // consumer: wait until the loads of iteration it have landed
  __device__ __forceinline__ int wait(uint32_t it) {
    const int s = it % STAGES;
    wg::bar_wait(&full[s], (it / STAGES) & 1);
    return s;
  }
  // consumer (one thread of each consuming warpgroup or block): the
  // products that read iteration it's stage are complete
  __device__ __forceinline__ void release(uint32_t it) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     wg::smem_addr(&empty[it % STAGES]))
                 : "memory");
  }
};

// ---- TMA and proxies --------------------------------------------------------

// A box of a 2-D map at column c, row r into `dst`, counted on `bar`;
// rows and columns past the map's end are zero-filled (and counted).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(wg::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(wg::smem_addr(bar)), "r"(c),
      "r"(r)
      : "memory");
}

// A box of shared memory at `src` into a 2-D map at column c, row r
// (rows and columns past the map's end are not written), as one bulk
// group of this thread.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c, int r) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(wg::smem_addr(src)), "r"(c), "r"(r)
      : "memory");
}

// Commit this thread's bulk stores and wait until they have read their
// shared memory (which may then be reused or released).
__device__ __forceinline__ void tma_store_drain() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Byte offset of the bf16 pair at (row, col) of a 64 x 64 bf16 box laid
// out by TMA's 128-byte swizzle (col even).
__device__ __forceinline__ int swizzled_offset(int row, int col) {
  const int cb = col * 2;
  return row * 128 + (((cb >> 4) ^ (row & 7)) << 4) + (cb & 15);
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (wgmma operand reads, TMA writes) of the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Registers per thread of this warpgroup (warp specialisation).
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---- host: 2-D tensor maps --------------------------------------------------

// A 2-D map over a row-major (rows, cols) array of 1-byte (int8 codes),
// 2-byte (bf16) or 4-byte (fp32) elements with (box_cols, box_rows) boxes, the 128-byte
// swizzle or none, zero fill past the edges. Needs a 16-byte aligned base
// and rows of a multiple of 16 bytes. Returns 0 or a CUDA error code; binds
// the array's device's primary context where the calling thread has none
// (wg::make_map).
inline int make_map_2d(CUtensorMap* map, const void* base, int elem_bytes,
                       long long cols, long long rows, int box_cols,
                       int box_rows, bool swizzle) {
  const wg::EncodeTiled enc = wg::encoder();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  auto encode = [&] {
    return enc(map,
               elem_bytes == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
               : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
               2, const_cast<void*>(base), dims, strides, box, elem,
               CU_TENSOR_MAP_INTERLEAVE_NONE,
               swizzle ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  };
  CUresult r = encode();
  if (r == CUDA_ERROR_INVALID_CONTEXT) {
    cudaPointerAttributes at;
    if (cudaPointerGetAttributes(&at, base) == cudaSuccess &&
        cudaSetDevice(at.device) == cudaSuccess)
      r = encode();
  }
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace gemm
}  // namespace
}  // namespace lseg
