// Fused int8 head1 projection + image-text correlation + argmax over K for
// Hopper (sm_90a), kernel B5 (and B12, its row-major form).
//
// Replaces: lseg_tpu/ops/pallas_correlation.py ·
// head1_correlate_argmax_fused_t (Pallas TPU; body _head1_argmax_t_kernel)
// and head1_correlate_argmax_fused (_head1_argmax_kernel). The two TPU
// kernels differ only in how they lay the logits over the TPU's (8, 128)
// tiles; on this card they are one kernel.
//
// Input: path1 x (M, C) as int8 codes, or bf16 quantized here on the
// grid sx (clip(rint(x / sx), -127, 127), IEEE division, so the label
// map is the one of quantizing first); head1's int8 1x1 kernel w (E, C);
// sc (E,) = sx * s1; the fp32 bias (E,); the text matrix tn (K, E) bf16,
// L2-normalised without the temperature. Output: (M,) int32 labels:
//   e     = acc * sc + b                 (int32 acc; fp32, no contraction)
//   lo    = bf16(e) . tn^T               (fp32 accumulation)
//   label = first k < K of the largest lo (jnp.argmax order)
// The per-pixel norm and the temperature are positive per-row factors, to
// which the argmax is blind: neither is computed. Labels past K never
// compete (masked), so an all-negative row cannot lose to K padding.
//
// What bounds it on the card: at the flagship (8, 240, 240, 256) -> K =
// 150 the head1 product is 60.4 G int8 MAC (121 GOP, ~0.061 ms at 1979
// TOP/s) and the correlation 35.4 G bf16 MAC (71 GFLOP, ~0.072 ms at 989
// TFLOP/s), against 236 MB of bf16 path1 in (~0.07 ms) and 1.8 MB out:
// the tensor-core operations bound it (~0.13 ms). Design: the tile code of
// kernel B4 (head1_tile.cuh): neither the (M, 512) embedding map nor the
// (M, K) logits nor, from bf16, the int8 codes reach device memory. Each
// lane keeps a running (value, index) best over its labels as the text
// chunks go by; a two-step butterfly joins the four lanes of a row, and
// shared memory joins the two column-half warps.

#include "head1_tile.cuh"

namespace {

namespace h1 = lseg::head1;

template <typename T>
__global__ void __launch_bounds__(h1::THREADS) head1_correlate_argmax_kernel(
    const T* __restrict__ x, const float* __restrict__ sxp,
    const int8_t* __restrict__ w, const float* __restrict__ sc,
    const float* __restrict__ b1, const __nv_bfloat16* __restrict__ tn,
    int* __restrict__ out, int M, int C, int E, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float best_v[2][h1::BM];
  __shared__ int best_i[2][h1::BM];
  const h1::Tile t = h1::carve(smem, C, E);
  const int m0 = blockIdx.x * h1::BM;
  h1::stage_codes(t, x, *sxp, m0, M, C);
  h1::embed(t, w, sc, b1, C, E);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wr = (warp % 4) * 16;
  const int wc = warp / 4;
  float bv[2] = {-INFINITY, -INFINITY};
  int bi[2] = {0x7fffffff, 0x7fffffff};
  for (int k0 = 0; k0 < K; k0 += h1::KCH) {
    float acc[2][4];
    h1::correlate(t, tn, k0, K, E, acc);
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int k = k0 + wc * 16 + j * 8 + 2 * t4 + q;
          const float v = acc[j][2 * half + q];
          if (k < K && lseg::argmax_better(v, k, bv[half], bi[half])) {
            bv[half] = v;
            bi[half] = k;
          }
        }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    lseg::argmax_xor(bv[half], bi[half], 1);
    lseg::argmax_xor(bv[half], bi[half], 2);
    if (t4 == 0) {
      best_v[wc][wr + g + 8 * half] = bv[half];
      best_i[wc][wr + g + 8 * half] = bi[half];
    }
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r < h1::BM && m0 + r < M) {
    const bool right = lseg::argmax_better(best_v[1][r], best_i[1][r],
                                           best_v[0][r], best_i[0][r]);
    out[m0 + r] = right ? best_i[1][r] : best_i[0][r];
  }
}

template <typename T>
int launch(const void* x, const void* sx, const void* w, const void* sc,
           const void* b1, const void* tn, void* out, int m, int c, int e,
           int k, cudaStream_t stream) {
  const size_t smem = h1::layout(c, e).total;
  int rc = static_cast<int>(cudaFuncSetAttribute(
      head1_correlate_argmax_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (rc != 0) return rc;
  const dim3 grid((m + h1::BM - 1) / h1::BM);
  head1_correlate_argmax_kernel<T><<<grid, h1::THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w), static_cast<const float*>(sc),
      static_cast<const float*>(b1), static_cast<const __nv_bfloat16*>(tn),
      static_cast<int*>(out), m, c, e, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x_bf16 selects path1's dtype (1 bf16 quantized on the grid *sx, 0 int8
// codes; sx is a device fp32 scalar). Requires c % 32 == 0, e % 128 ==
// 0, k >= 1, 16-byte aligned tensors (checked by the wrapper).
extern "C" int lseg_head1_correlate_argmax(const void* x, const void* sx,
                                           const void* w, const void* sc,
                                           const void* b1, const void* tn,
                                           void* out, int m, int c, int e,
                                           int k, int x_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16
      ? launch<__nv_bfloat16>(x, sx, w, sc, b1, tn, out, m, c, e, k, s)
      : launch<int8_t>(x, sx, w, sc, b1, tn, out, m, c, e, k, s);
}
