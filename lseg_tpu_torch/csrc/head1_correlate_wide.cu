// Kernel B4 for C > 256, and its mma.sync yardstick: the fused int8 head1
// projection + image-text correlation for Hopper (sm_90a) on the
// SIMT-staged head1 tile of head1_tile.cuh.
//
// Replaces: lseg_tpu/ops/pallas_correlation.py · head1_correlate_fused
// (Pallas TPU; body _head1_kernel), where path1 is wider than the wgmma +
// TMA kernel of head1_correlate.cu takes (C > 256: no registered config,
// `features` is 256). Its wrapper (ops/head1_correlate.py) routes there
// by C; `head1_correlate_fused_mma` calls it at any C, as the independent
// yardstick the checks hold the wgmma head kernels (B4, B13, B14) against
// bit for bit. Input, output and rounding points are head1_correlate.cu's
// (its header); the e^2 sums and the dot products are taken in another
// order than the plain version's.
//
// What bounds it on the card: at the lowres flagship shape (8, 120, 120,
// 256) -> K = 150 the head1 product is 15.1 G int8 MAC and the text
// product 8.8 G bf16 MAC, against 29.5 MB of codes in and 34.6 MB of
// logits out. Design: the (M, 512) embedding map never reaches device
// memory. One 256-thread block per 64-pixel tile: the tile's codes sit in
// shared memory; head1's weight is staged 128 output channels at a time
// and multiplied on mma.sync m16n8k32 s8 into int32; the dequant epilogue
// writes bf16(e) into a (64, E) shared tile (66 KB at E = 512) and keeps
// the fp32 row sums of e^2; the text matrix is then staged 32 labels at a
// time (rows past K zero-filled) and multiplied on mma.sync m16n8k16 bf16
// into fp32; only columns k < K are written. The tile code (codes, head1,
// text chunks) lives in head1_tile.cuh, shared with B5's and B14's C >
// 256 kernels.

#include "head1_tile.cuh"

namespace {

namespace h1 = lseg::head1;

__global__ void __launch_bounds__(h1::THREADS) head1_correlate_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
    const float* __restrict__ sc, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ tn, __nv_bfloat16* __restrict__ out,
    int M, int C, int E, int K, int normalize) {
  extern __shared__ __align__(16) unsigned char smem[];
  const h1::Tile t = h1::carve(smem, C, E);
  const int m0 = blockIdx.x * h1::BM;
  h1::stage_codes(t, xq, 0.0f, m0, M, C);
  h1::embed(t, w, sc, b1, C, E);

  // correlation: out = bf16(e) . tn^T, 32 labels at a time
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wr = (warp % 4) * 16;
  const int wc = warp / 4;
  for (int k0 = 0; k0 < K; k0 += h1::KCH) {
    float acc[2][4];
    h1::correlate(t, tn, k0, K, E, acc);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = wr + g + 8 * half;
      const int row = m0 + lr;
      if (row >= M) continue;
      const float inv = normalize
          ? rsqrtf(fmaxf(t.ssq[lr] + t.ssq[h1::BM + lr], 1e-24f))
          : 1.0f;
      __nv_bfloat16* op = out + static_cast<long long>(row) * K;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k = k0 + wc * 16 + j * 8 + 2 * t4;
        float v0 = acc[j][2 * half], v1 = acc[j][2 * half + 1];
        if (normalize) {
          v0 = __fmul_rn(v0, inv);
          v1 = __fmul_rn(v1, inv);
        }
        if (k < K) op[k] = __float2bfloat16_rn(v0);
        if (k + 1 < K) op[k + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// Requires c % 32 == 0, e % 128 == 0, k >= 1, 16-byte aligned tensors
// (checked by the wrapper).
extern "C" int lseg_head1_correlate_wide(const void* xq, const void* w,
                                         const void* sc, const void* b1,
                                         const void* tn, void* out, int m,
                                         int c, int e, int k, int normalize,
                                         void* stream) {
  const size_t smem = h1::layout(c, e).total;
  int rc = static_cast<int>(cudaFuncSetAttribute(
      head1_correlate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc != 0) return rc;
  const dim3 grid((m + h1::BM - 1) / h1::BM);
  head1_correlate_kernel<<<grid, h1::THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
      static_cast<const float*>(sc), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(tn), static_cast<__nv_bfloat16*>(out),
      m, c, e, k, normalize);
  return static_cast<int>(cudaGetLastError());
}
