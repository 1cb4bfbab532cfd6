// Fused x2 bilinear (align_corners=True) upsample + argmax over K for
// Hopper (sm_90a), kernel B11.
//
// Replaces: lseg_tpu/ops/pallas_upsample_argmax.py · upsample2x_argmax
// (Pallas TPU; body _kernel) and its transpose-free twin
// upsample2x_argmax_v2 (_kernel_v2), which compute the same function.
//
// Input: logits (N, H, W, K) in fp32 or bf16 (the template's T). Output:
// (N, 2H, 2W) int32 labels. Rounding points, as in the TPU kernel:
//   H taps:  src = o * ((H-1)/(2H-1))  in fp32; row i weighs
//            max(0, 1 - |src - i|) (two rows at most), the weight rounded
//            to T;
//   hb     = T(w0 * x[i0] + w1 * x[i1])           (fp32 sum, rounded to T)
//   W taps:  the host operator of lseg_tpu/ops/resize.py · _interp_matrix
//            (float64 source position, weights 1 - frac and frac rounded
//            to fp32, then to T);
//   up     = a0 * hb[lo] + a1 * hb[lo + 1]        (fp32, not rounded)
//   label  = the first k of the largest up (jnp.argmax: ties to the
//            smallest index, NaN above every number), k < K only.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn, no
// FMA contraction), as the plain version computes it, so the two agree
// bit for bit.
//
// What bounds it on the card: the bytes. At the flagship (8, 240, 240,
// 150) fp32 the kernel must read 276 MB and write 7.4 MB (~0.085 ms at
// 3.35 TB/s); its ~0.3 GFLOP are nothing. Design: the full-resolution
// (N, 2H, 2W, K) logits (1.1 GB in fp32) never exist. One 256-thread
// block per (image, output row, 64 output columns): it blends the row's
// two source rows over the <= 34 source columns that its 64 columns need
// into shared memory (coalesced, contiguous (columns x K) slabs), then
// each warp takes 8 output pixels: the lanes stride over K, interpolate
// along W from the shared rows and keep a running (value, index) best,
// and a butterfly reduction across the warp picks the winner. Each
// source row is read by about four blocks, most of it from L2.

#include "lseg_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CW = 64;               // output columns per block
constexpr int SRC_COLS = CW / 2 + 2;  // source columns they can need

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a weight rounded to the logits' type, back in fp32
template <typename T>
__device__ __forceinline__ float weight(float w) {
  return to_f32(from_f32<T>(w));
}

// the W operator of _interp_matrix (align_corners, in -> 2 in): lower
// source column and its two weights
__device__ __forceinline__ void w_taps(int ow, int W, int& lo, float& a0,
                                       float& a1) {
  if (W == 1) {
    lo = 0;
    a0 = 1.0f;
    a1 = 0.0f;
    return;
  }
  const double src = static_cast<double>(ow) * (W - 1) / (2 * W - 1);
  lo = min(max(static_cast<int>(floor(src)), 0), W - 2);
  const double frac = src - lo;
  a0 = static_cast<float>(1.0 - frac);
  a1 = static_cast<float>(frac);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) upsample2x_argmax_kernel(
    const T* __restrict__ x, int* __restrict__ out, int H, int W, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* hb = reinterpret_cast<T*>(smem);  // SRC_COLS x K blended source row

  const int ow0 = blockIdx.x * CW;
  const int o = blockIdx.y;
  const int n = blockIdx.z;
  const int OW = 2 * W;
  const int ow_end = min(ow0 + CW, OW);

  // H taps of output row o
  const float ratio = static_cast<float>(H - 1) / static_cast<float>(2 * H - 1);
  const float src = __fmul_rn(static_cast<float>(o), ratio);
  const int i0 = min(static_cast<int>(floorf(src)), H - 1);
  const float w0 = weight<T>(fmaxf(
      0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(src, static_cast<float>(i0))))));
  const int i1 = min(i0 + 1, H - 1);
  const float w1 = i0 + 1 < H
      ? weight<T>(fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(
            src, static_cast<float>(i0 + 1))))))
      : 0.0f;

  // source columns [c_lo, c_lo + ncols) of this block's output columns
  int c_lo, c_hi;
  float a0, a1;
  w_taps(ow0, W, c_lo, a0, a1);
  w_taps(ow_end - 1, W, c_hi, a0, a1);
  c_hi = min(c_hi + 1, W - 1);
  const int ncols = c_hi - c_lo + 1;

  const long long img = static_cast<long long>(n) * H * W * K;
  const T* r0 = x + img + (static_cast<long long>(i0) * W + c_lo) * K;
  const T* r1 = x + img + (static_cast<long long>(i1) * W + c_lo) * K;
  for (int j = threadIdx.x; j < ncols * K; j += THREADS) {
    const float v = __fadd_rn(__fmul_rn(w0, to_f32(r0[j])),
                              __fmul_rn(w1, to_f32(r1[j])));
    hb[j] = from_f32<T>(v);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int* orow = out + (static_cast<long long>(n) * 2 * H + o) * OW;
  for (int ow = ow0 + warp; ow < ow_end; ow += THREADS / 32) {
    int lo;
    w_taps(ow, W, lo, a0, a1);
    a0 = weight<T>(a0);
    a1 = weight<T>(a1);
    const T* h0 = hb + (lo - c_lo) * K;
    const T* h1 = hb + (min(lo + 1, W - 1) - c_lo) * K;
    float best = -INFINITY;
    int arg = 0x7fffffff;
    for (int k = lane; k < K; k += 32) {
      const float v = __fadd_rn(__fmul_rn(a0, to_f32(h0[k])),
                                __fmul_rn(a1, to_f32(h1[k])));
      if (lseg::argmax_better(v, k, best, arg)) {
        best = v;
        arg = k;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) lseg::argmax_xor(best, arg, s);
    if (lane == 0) orow[ow] = arg;
  }
}

template <typename T>
int launch(const void* x, void* out, int n, int h, int w, int k,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(SRC_COLS) * k * sizeof(T);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      upsample2x_argmax_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  if (rc != 0) return rc;
  const dim3 grid((2 * w + CW - 1) / CW, 2 * h, n);
  upsample2x_argmax_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<int*>(out), h, w, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x_bf16 selects the logits' dtype (1 bf16, 0 fp32). Requires k <= 1536
// (the blended source columns fit in shared memory) and 2h <= 65535
// (checked by the wrapper).
extern "C" int lseg_upsample2x_argmax(const void* x, void* out, int n, int h,
                                      int w, int k, int x_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? launch<__nv_bfloat16>(x, out, n, h, w, k, s)
                : launch<float>(x, out, n, h, w, k, s);
}
