// The fp32 tile helpers of the fp32 mode of kernel B6
// (flash_attention_flat_fp32.cu): staging a 64 x 64 fp32 tile of the flat
// (T, 3D) rows into shared memory, rows padded to 65 floats so a column
// walk hits 32 distinct banks, and the 4 x 4 register tiles of a 16 x 16
// thread grid over two such tiles. (B7's fp32 mode runs split-TF32
// products, tf32x3.cuh.)

#pragma once

#include "lseg_common.cuh"
#include "wgmma.cuh"  // wg::allow_smem

namespace lseg {
namespace {
namespace flash_fp32 {

constexpr int HD = 64;        // head_dim (the kernel is specialised)
constexpr int BT = 64;        // rows of every tile
constexpr int LD = HD + 1;    // padded row stride of a staged tile, floats
constexpr int THREADS = 256;  // 16 x 16
constexpr int TILE_FLOATS = BT * LD;

__device__ __forceinline__ float pos_inf() {
  return __int_as_float(0x7f800000);
}

// Stage 64 rows of 64 fp32 (columns col..col+63 of rows row0.. of one
// image's (T, ld) rows) into a padded tile; rows >= T are zero.
__device__ __forceinline__ void stage(float* dst, const float* base,
                                      long long ld, int col, int row0,
                                      int T) {
  for (int i = threadIdx.x; i < BT * (HD / 4); i += THREADS) {
    const int r = i / (HD / 4);
    const int c = (i % (HD / 4)) * 4;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < T)
      v = *reinterpret_cast<const float4*>(base + (row0 + r) * ld + col + c);
    float* d = dst + r * LD + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// c[i][j] = sum_d a[r_i][d] * b[c_j][d] over the 64 columns of two padded
// tiles, rows r_i = ty + 16 i of a and c_j = tx + 16 j of b.
__device__ __forceinline__ void dot_abt(float (&c)[4][4], const float* a,
                                        const float* b, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.0f;
#pragma unroll 8
  for (int d = 0; d < HD; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(av[i], bv[j], c[i][j]);
  }
}

// c[i][j] += sum_k p[r_i][k] * b[k][d_j] over 64 k, p and b padded tiles,
// d_j = tx + 16 j.
__device__ __forceinline__ void acc_pb(float (&c)[4][4], const float* p,
                                       const float* b, int ty, int tx) {
#pragma unroll 8
  for (int k = 0; k < BT; ++k) {
    float pv[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pv[i] = p[(ty + 16 * i) * LD + k];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[k * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = fmaf(pv[i], bv[j], c[i][j]);
  }
}

}  // namespace flash_fp32
}  // namespace
}  // namespace lseg
