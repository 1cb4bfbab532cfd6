// Fused int8 head1 projection + normalized image-text correlation + the x2
// align-corners W-interp for Hopper (sm_90a), kernel B14.
//
// Replaces: lseg_tpu/ops/pallas_correlation.py · head1_correlate_wup_fused
// (Pallas TPU; body _head1_wup_kernel).
//
// Input: the int8 path1 codes xq (N, H, W, C), head1's int8 1x1 kernel w
// (E, C), sc (E,) = sx * s1, the fp32 bias (E,), and the text matrix tn
// (K, E) bf16, L2-normalised and multiplied by the temperature. Output:
// (N, H, 2W, K) bf16, the logits upsampled along W only (the caller's
// H-interp finishes the x2 upsample).
//
// Rounding points, as in the TPU kernel:
//   e   = acc * sc + b                  (int32 acc; fp32, no contraction)
//   lo  = bf16((bf16(e) . tn^T) * rsqrt(max(sum(e^2), 1e-24)))
//   out = bf16(a0 * lo[c] + a1 * lo[c + 1])   (fp32)
// where (a0, a1) are the two non-zero entries of the output column's row
// of the (2W, W) align-corners interp operator (lseg_tpu/ops/resize.py ·
// _interp_matrix: float64 source position, weights rounded to fp32, then
// to bf16). Each product of two bf16 values is exact in fp32, so the sum
// rounds once, as the TPU kernel's (2W, W) @ (W, K) product with fp32
// accumulation rounds it; the zeros of that operator add exactly 0.
//
// What bounds it on the card: at the flagship (8, 240, 240, 256) -> K =
// 150 the head1 product is 60.4 G int8 MAC (121 GOP) and the correlation
// 35.4 G bf16 MAC (71 GFLOP), ~0.13 ms at the tensor cores' peaks,
// against 118 MB of codes in (~0.035 ms) and 276 MB of logits out
// (~0.082 ms): the operations bound it, the output bytes close behind.
// Design: one 256-thread block per source row (image, h), so that the
// W-interp never needs a neighbour's logits. The block runs B4's tile code
// (head1_tile.cuh) over the row's W pixels, 64 at a time, and keeps the
// row's (W, K) bf16 logits in shared memory (72 KB at W = 240, K = 150,
// beside the tile's 117 KB); then each warp takes output columns in turn,
// its lanes striding over K, and writes the row's (2W, K) outputs. Neither
// the (M, 512) embedding map nor the (N, H, W, K) logits reach device
// memory. The last 64-pixel tile of a row is partly empty (W = 240 uses
// 240 of 256 slots).

#include "head1_tile.cuh"

namespace {

namespace h1 = lseg::head1;

// the W operator of _interp_matrix (align_corners, in -> 2 in) for output
// column ow: lower source column and its two weights, rounded to bf16
__device__ __forceinline__ void w_taps_bf16(int ow, int W, int& lo,
                                            float& a0, float& a1) {
  if (W == 1) {
    lo = 0;
    a0 = 1.0f;
    a1 = 0.0f;
    return;
  }
  const double src = static_cast<double>(ow) * (W - 1) / (2 * W - 1);
  lo = min(max(static_cast<int>(floor(src)), 0), W - 2);
  const double frac = src - lo;
  a0 = __bfloat162float(__float2bfloat16_rn(static_cast<float>(1.0 - frac)));
  a1 = __bfloat162float(__float2bfloat16_rn(static_cast<float>(frac)));
}

__global__ void __launch_bounds__(h1::THREADS) head1_wup_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
    const float* __restrict__ sc, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ tn, __nv_bfloat16* __restrict__ out,
    int W, int C, int E, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const h1::Tile t = h1::carve(smem, C, E);
  __nv_bfloat16* Ls = reinterpret_cast<__nv_bfloat16*>(smem + t.L.total);

  const long long row = blockIdx.x;  // n * H + h
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wr = (warp % 4) * 16;
  const int wc = warp / 4;
  const int row_end = static_cast<int>((row + 1) * W);  // fits: M < 2^31

  for (int p0 = 0; p0 < W; p0 += h1::BM) {
    h1::stage_codes(t, xq, 0.0f, static_cast<int>(row * W) + p0, row_end,
                    C);
    h1::embed(t, w, sc, b1, C, E);
    for (int k0 = 0; k0 < K; k0 += h1::KCH) {
      float acc[2][4];
      h1::correlate(t, tn, k0, K, E, acc);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = wr + g + 8 * half;
        const int p = p0 + lr;
        if (p >= W) continue;
        const float inv =
            rsqrtf(fmaxf(t.ssq[lr] + t.ssq[h1::BM + lr], 1e-24f));
        __nv_bfloat16* lp = Ls + static_cast<long long>(p) * K;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = k0 + wc * 16 + j * 8 + 2 * t4;
          if (k < K)
            lp[k] = __float2bfloat16_rn(__fmul_rn(acc[j][2 * half], inv));
          if (k + 1 < K)
            lp[k + 1] =
                __float2bfloat16_rn(__fmul_rn(acc[j][2 * half + 1], inv));
        }
      }
    }
  }
  __syncthreads();

  // x2 W-interp of the row: output column ow blends source columns lo and
  // lo + 1 with the bf16 weights of the interp operator
  __nv_bfloat16* orow = out + row * 2 * W * K;
  for (int ow = warp; ow < 2 * W; ow += h1::THREADS / 32) {
    int lo;
    float a0, a1;
    w_taps_bf16(ow, W, lo, a0, a1);
    const __nv_bfloat16* x0 = Ls + static_cast<long long>(lo) * K;
    const __nv_bfloat16* x1 = Ls + static_cast<long long>(min(lo + 1, W - 1)) *
                                       K;
    __nv_bfloat16* op = orow + static_cast<long long>(ow) * K;
    for (int k = lane; k < K; k += 32) {
      op[k] = __float2bfloat16_rn(
          __fadd_rn(__fmul_rn(a0, __bfloat162float(x0[k])),
                    __fmul_rn(a1, __bfloat162float(x1[k]))));
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// Requires c % 32 == 0, e % 128 == 0, k >= 1, the tile plus w * k bf16
// logits within the 227 KB of shared memory, 16-byte aligned tensors
// (checked by the wrapper).
extern "C" int lseg_head1_correlate_wup(const void* xq, const void* w,
                                        const void* sc, const void* b1,
                                        const void* tn, void* out, int n,
                                        int h, int wd, int c, int e, int k,
                                        void* stream) {
  const size_t smem = h1::layout(c, e).total +
                      static_cast<size_t>(wd) * k * sizeof(__nv_bfloat16);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      head1_wup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc != 0) return rc;
  head1_wup_kernel<<<n * h, h1::THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
      static_cast<const float*>(sc), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(tn), static_cast<__nv_bfloat16*>(out),
      wd, c, e, k);
  return static_cast<int>(cudaGetLastError());
}
