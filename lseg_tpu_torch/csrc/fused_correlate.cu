// Fused L2 normalisation + image-text correlation for Hopper (sm_90a),
// kernel B10.
//
// Replaces: lseg_tpu/ops/pallas_correlation.py · fused_correlate (Pallas
// TPU; body _kernel), the use_pallas=True serving head's correlation.
//
// Input: pixel embeddings x (M, C) in bf16 or fp32 (M = N*H*W), raw text
// features t (K, C) fp32. Output: (M, K) fp32 logits, K unpadded:
//   xn  = x * rsqrt(max(sum(x^2), 1e-24))        (fp32, per pixel row)
//   tn  = t * rsqrt(max(sum(t^2), 1e-24))        (fp32, per label row)
//   out = scale * (xn . tn^T)                    (fp32 FMAs)
// Zero rows keep norm 0 through the max guard and give logits of 0. The
// product is taken in full fp32 on the FMA units, as the reference's
// fp32 mm_dtype on this path: TF32 tensor cores would round the operands
// to 10 mantissa bits. The sums run in another order than the plain
// version's.
//
// What bounds it on the card: at the flagship (8, 240, 240, 512) bf16
// against K = 150 the product is 70.8 GFLOP at the ~67 TFLOP/s fp32 rate
// without tensor cores (~1.06 ms), against 472 MB in and 276 MB out
// (~0.22 ms): the fp32 FMAs bound it. Design: a classic register-tiled
// SGEMM. A first small launch normalises the text once into a transposed,
// zero-padded (C, Kp) fp32 matrix (Kp a multiple of the 160-label tile);
// the main launch gives each 256-thread block 128 pixels x 160 labels:
// the block first takes the inverse norms of its 128 rows (one warp per
// row, fp32 sums), then walks C in chunks of 32, normalising the pixel
// chunk in fp32 as it stages it (transposed) in shared memory beside the
// text chunk; each thread accumulates an 8 x 10 outer-product tile, so
// every shared-memory load feeds 4-5 FMAs. The normalised pixel map never
// reaches device memory.

#include "lseg_common.cuh"

namespace {

constexpr int BM = 128;       // pixels per block
constexpr int BN = 160;       // labels per block
constexpr int BK = 32;        // channels per staged chunk
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 10 outputs each
constexpr int TM = 8;
constexpr int TN = 10;
constexpr int PAD = 4;        // keeps the transposed stores off one bank

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// 8 consecutive values (16-byte aligned) as fp32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  lseg::unpack8(*reinterpret_cast<const uint4*>(p), v);
}
__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// tnT (C, Kp) = (t / |t|)^T, columns k >= K zero; one warp per label
__global__ void __launch_bounds__(THREADS) normalize_text_kernel(
    const float* __restrict__ t, float* __restrict__ tnT, int K, int Kp,
    int C) {
  const int warp = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= Kp) return;
  if (warp >= K) {
    for (int c = lane; c < C; c += 32)
      tnT[static_cast<long long>(c) * Kp + warp] = 0.0f;
    return;
  }
  const float* row = t + static_cast<long long>(warp) * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += row[c] * row[c];
  const float inv = rsqrtf(fmaxf(lseg::warp_sum(s), 1e-24f));
  for (int c = lane; c < C; c += 32)
    tnT[static_cast<long long>(c) * Kp + warp] = __fmul_rn(row[c], inv);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_correlate_kernel(
    const T* __restrict__ x, const float* __restrict__ tnT,
    float* __restrict__ out, int M, int C, int K, int Kp, float scale) {
  __shared__ __align__(16) float As[BK][BM + PAD];  // normalised pixels^T
  __shared__ __align__(16) float Bs[BK][BN];        // normalised text^T
  __shared__ float inv_x[BM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * BM;
  const int k0 = blockIdx.y * BN;

  // inverse norms of the block's pixel rows, one warp per row
  for (int r = warp; r < BM; r += THREADS / 32) {
    float s = 0.0f;
    if (m0 + r < M) {
      const T* row = x + static_cast<long long>(m0 + r) * C;
      for (int c = lane; c < C; c += 32) {
        const float v = to_f32(row[c]);
        s += v * v;
      }
    }
    s = lseg::warp_sum(s);
    if (lane == 0) inv_x[r] = rsqrtf(fmaxf(s, 1e-24f));
  }

  const int tx = tid % 16;  // label group: columns tx + 16 j
  const int ty = tid / 16;  // pixel group: rows ty + 16 i
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += BK) {
    __syncthreads();  // inv_x ready; previous chunk consumed
    // pixels: thread -> (row, 8 channels); consecutive threads take
    // consecutive rows so the transposed shared stores do not conflict
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i % BM;
      const int c = (i / BM) * 8;
      float v[8];
      if (m0 + r < M) {
        load8(x + static_cast<long long>(m0 + r) * C + c0 + c, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.0f;
      }
      const float s = inv_x[r];
#pragma unroll
      for (int j = 0; j < 8; ++j) As[c + j][r] = __fmul_rn(v[j], s);
    }
    // text: rows of the transposed matrix are contiguous in k
    for (int i = tid; i < BK * (BN / 4); i += THREADS) {
      const int c = i / (BN / 4);
      const int k = (i % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(&Bs[c][k]) =
          *reinterpret_cast<const float4*>(
              tnT + static_cast<long long>(c0 + c) * Kp + k0 + k);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    float* op = out + static_cast<long long>(m) * K;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < K) op[k] = __fmul_rn(scale, acc[i][j]);
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x_bf16 selects the pixel dtype (1 bf16, 0 fp32). tnT is the wrapper's
// (C, kp) fp32 scratch, kp = ceil(k / 160) * 160. Requires c % 32 == 0 and
// 16-byte aligned tensors (checked by the wrapper).
extern "C" int lseg_fused_correlate(const void* x, const void* t, void* tnT,
                                    void* out, int m, int c, int k, int kp,
                                    int x_bf16, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  normalize_text_kernel<<<(kp * 32 + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(t), static_cast<float*>(tnT), k, kp, c);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const dim3 grid((m + BM - 1) / BM, kp / BN);
  if (x_bf16) {
    fused_correlate_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(tnT),
        static_cast<float*>(out), m, c, k, kp, scale);
  } else {
    fused_correlate_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(tnT),
        static_cast<float*>(out), m, c, k, kp, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
