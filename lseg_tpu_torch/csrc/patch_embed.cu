// Fused patchify + patch-embedding matmul for Hopper (sm_90a).
//
// Replaces: lseg_tpu/ops/pallas_patch.py · patch_embed_fused (Pallas TPU).
//
// Computes, for an NHWC fp32 image x (N, H, W, C) and a bf16 weight
// matrix w (P*P*C, D) whose rows are ordered (patch row, patch column,
// channel) — the HWIO flattening of the reference's (P, P, C, D) kernel:
//
//   out[n, r*gw + c, :] = bf16( sum_k bf16(A[tok, k]) * w[k, :] + bias )
//
// where row tok of A is the 16x16x3 patch at grid cell (r, c), read
// straight from the NHWC image. Operands are rounded to bf16, products
// accumulate in fp32 and the fp32 bias is added before the final cast,
// the rounding points of the TPU kernel (pallas_patch.py:40-46).
//
// Input layout: the NHWC image that DenseViT receives (the port keeps the
// reference's NHWC boundary). Output: (N, gh*gw, D) bf16, row-major.
//
// What bounds it on the card: bytes. At the flagship shape
// (8, 480, 480, 3) -> (8, 900, 1024) it reads 22 MB of image and 1.5 MB
// of weights and writes 15 MB, against 11 GFLOP: at 3.35 TB/s and
// 989 TFLOP/s both floors are ~11 us, so the kernel must not add traffic.
// Design: no patchified copy of the image ever goes to device memory.
// Each 128-thread block gathers a 64-token x 32-k slice of the patches
// directly from the image into shared memory (converting to bf16 on the
// way), stages the matching 32 x 64 weight slice, and runs bf16 wmma
// 16x16x16 fragments with fp32 accumulators; the epilogue adds the bias
// and writes bf16. A simple, correct first kernel: no cp.async/TMA
// pipelining yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // tokens per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // k slice per step
constexpr int LDA = BK + 8;   // padded smem strides (wmma: multiple of 8)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // fp32 epilogue tile (multiple of 4)
constexpr int THREADS = 128;  // 4 warps, each a 32 x 32 quadrant

__global__ void __launch_bounds__(THREADS) patch_embed_kernel(
    const float* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    int H, int W, int C, int P, int D, int gw, int tokens_per_image,
    int M, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int wm = (warp / 2) * 32;
  const int wn = (warp % 2) * 32;
  const int row_len = P * C;  // contiguous floats of one patch row

  // Each thread loads A column `lane` for rows warp + 4*i, i < 16: keep
  // the image offset of those 16 patches (-1 past the last token).
  long long patch_base[BM / 4];
#pragma unroll
  for (int i = 0; i < BM / 4; ++i) {
    const int m = m0 + warp + 4 * i;
    if (m < M) {
      const int img = m / tokens_per_image;
      const int r = m % tokens_per_image;
      const int pr = r / gw;
      const int pc = r % gw;
      patch_base[i] =
          ((static_cast<long long>(img) * H + pr * P) * W + pc * P) * C;
    } else {
      patch_base[i] = -1;
    }
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A: patches -> bf16, gathered straight from the NHWC image
    const int k = k0 + lane;
    const long long k_off =
        k < K ? static_cast<long long>(k / row_len) * W * C + k % row_len
              : 0;
#pragma unroll
    for (int i = 0; i < BM / 4; ++i) {
      float v = 0.0f;
      if (k < K && patch_base[i] >= 0) v = x[patch_base[i] + k_off];
      As[(warp + 4 * i) * LDA + lane] = __float2bfloat16(v);
    }
    // B: the (BK, BN) weight slice
#pragma unroll
    for (int i = 0; i < (BK * BN) / THREADS; ++i) {
      const int idx = tid + i * THREADS;
      const int kr = idx / BN;
      const int col = idx % BN;
      Bs[kr * LDB + col] = (k0 + kr < K)
          ? w[static_cast<long long>(k0 + kr) * D + n0 + col]
          : __float2bfloat16(0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm + 16 * i) * LDA + ks, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + ks * LDB + wn + 16 * j, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: fp32 accumulators + fp32 bias -> bf16
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm + 16 * i) * LDC + wn + 16 * j,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < (BM * BN) / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / BN;
    const int col = idx % BN;
    const int m = m0 + r;
    if (m < M) {
      out[static_cast<long long>(m) * D + n0 + col] =
          __float2bfloat16(Cs[r * LDC + col] + bias[n0 + col]);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// Requires D % 64 == 0 and H, W multiples of P (checked by the wrapper).
extern "C" int lseg_patch_embed(const void* x, const void* w,
                                const void* bias, void* out, int n, int h,
                                int w_img, int c, int patch, int dim,
                                void* stream) {
  const int gh = h / patch;
  const int gw = w_img / patch;
  const int tokens = gh * gw;
  const int M = n * tokens;
  const int K = patch * patch * c;
  const dim3 grid((M + BM - 1) / BM, dim / BN);
  patch_embed_kernel<<<grid, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out), h,
      w_img, c, patch, dim, gw, tokens, M, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* lseg_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
