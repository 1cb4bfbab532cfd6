// The tile helpers of the fp32 modes of flat flash attention, kernels B6
// (flash_attention_flat_fp32.cu) and B7 (flash_attention_flat_bwd_fp32.cu),
// both on split-TF32 mma.sync products (tf32x3.cuh).
//
// A tile is 64 rows of one head's 64 fp32 columns of the flat (T, ld)
// rows, staged by cp.async into shared memory with rows padded to 68
// floats, so every fragment load of a warp (8 rows x 4 columns, or 4 rows
// x 8 columns) hits 32 distinct banks. Fragments are read from a tile in
// either orientation (the transpose is free at the load) and split into
// TF32 hi and lo in registers.

#pragma once

#include "tf32x3.cuh"

namespace lseg {
namespace {
namespace flash_tf32x3 {

constexpr int HD = 64;      // head_dim (the kernels are specialised)
constexpr int BT = 64;      // rows of every tile
constexpr int LD = HD + 4;  // padded row stride of a staged tile, floats
constexpr int TILE_FLOATS = BT * LD;

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// ---- staging by cp.async ----------------------------------------------------

// 16 bytes global -> shared, zero-filled where !valid (nothing is read)
__device__ __forceinline__ void cp16(float* dst, const float* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   wg::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying 64 rows of 64 fp32 (columns col..col+63 of rows row0.. of
// one image's (T, ld) rows) into a padded tile, by the block's THREADS
// threads; rows >= T are zero.
template <int THREADS>
__device__ __forceinline__ void stage(float* dst, const float* base,
                                      long long ld, int col, int row0,
                                      int T) {
  for (int i = threadIdx.x; i < BT * (HD / 4); i += THREADS) {
    const int r = i / (HD / 4);
    const int c = (i % (HD / 4)) * 4;
    const bool in = row0 + r < T;
    cp16(dst + r * LD + c, base + (in ? row0 + r : 0) * ld + col + c, in);
  }
}

// ---- split-TF32 products on padded tiles ------------------------------------
// g = lane / 4, t = lane % 4; a warp's accumulator tiles `float c[NJ][4]`
// are in the C layout over NJ column tiles of 8.

// c += P . B: P a C-layout tile in registers (16 rows x 8NJ columns), B
// a staged tile whose rows c0.. run along P's columns, c over B's 64
// columns. Column 2t (2t + 1) of P's column tile j is the A fragment's
// column t (t + 4), so the B fragment reads rows c0 + 8j + 2t and
// c0 + 8j + 2t + 1.
template <int NJ>
__device__ __forceinline__ void acc_pb(float (&c)[8][4],
                                       const float (&p)[NJ][4],
                                       const float* b, int c0, int g,
                                       int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    tf32x3::Frag<4> fa;
    fa.set(0, p[j][0]);
    fa.set(1, p[j][2]);
    fa.set(2, p[j][1]);
    fa.set(3, p[j][3]);
    const float* pb = b + (c0 + 8 * j + 2 * t) * LD + g;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      tf32x3::Frag<2> fb;
      fb.set(0, pb[8 * n]);
      fb.set(1, pb[LD + 8 * n]);
      tf32x3::mma3(c[n], fa, fb);
    }
  }
}

}  // namespace flash_tf32x3
}  // namespace
}  // namespace lseg
