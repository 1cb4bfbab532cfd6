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
//
// compute_dtype = bfloat16 (the reference's fast-serving mode, its
// mm_dtype=bf16): both operands are normalised in fp32 as above and
// rounded to bf16, multiplied on the tensor cores (mma.sync m16n8k16 bf16,
// fp32 accumulators), scaled in fp32 and rounded once to bf16:
//   out (M, K) bf16 = bf16(scale * (bf16(xn) . bf16(tn)^T))
// At the streamed head's (8, 240, 240, 512) bf16 against K = 150 the
// product is 70.8 GFLOP of bf16 (~0.07 ms at 989 TFLOP/s) against 472 MB
// in and 138 MB out (~0.18 ms): bytes bound this mode. Design: the text is
// normalised once into a zero-padded (Kp, C) bf16 matrix, the column-major
// B operand as it lies; a 256-thread block takes 128 pixels x 160 labels,
// normalises and rounds each 32-channel pixel chunk as it stages it (rows
// padded to 80 bytes, so the fragment loads hit 32 distinct banks), and
// eight warps (4 x 2) run 32 x 80 tiles of mma.sync. Each pixel row is
// read from device memory once for its norm and once (mostly from L2) for
// the product, and the logits are written once, in bf16.

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

// ---- compute_dtype = bfloat16 ----

constexpr int HM = 128;       // pixels per block
constexpr int HK = 32;        // channels per staged chunk
constexpr int HLD = HK + 8;   // bf16 row stride of the staged tiles
static_assert(HM == BM, "both modes share the launch grid");

// tn (Kp, C) bf16 = bf16(t / |t|), rows k >= K zero; one warp per label
__global__ void __launch_bounds__(THREADS) normalize_text_bf16_kernel(
    const float* __restrict__ t, __nv_bfloat16* __restrict__ tn, int K,
    int Kp, int C) {
  const int warp = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= Kp) return;
  __nv_bfloat16* dst = tn + static_cast<long long>(warp) * C;
  if (warp >= K) {
    for (int c = lane; c < C; c += 32) dst[c] = __float2bfloat16_rn(0.0f);
    return;
  }
  const float* row = t + static_cast<long long>(warp) * C;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += row[c] * row[c];
  const float inv = rsqrtf(fmaxf(lseg::warp_sum(s), 1e-24f));
  for (int c = lane; c < C; c += 32)
    dst[c] = __float2bfloat16_rn(__fmul_rn(row[c], inv));
}

template <typename T>
__global__ void __launch_bounds__(THREADS) fused_correlate_bf16_kernel(
    const T* __restrict__ x, const __nv_bfloat16* __restrict__ tn,
    __nv_bfloat16* __restrict__ out, int M, int C, int K, float scale) {
  __shared__ __align__(16) __nv_bfloat16 As[HM * HLD];  // bf16(xn) chunk
  __shared__ __align__(16) __nv_bfloat16 Bs[BN * HLD];  // bf16(tn) chunk
  __shared__ float inv_x[HM];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int m0 = blockIdx.x * HM;
  const int k0 = blockIdx.y * BN;
  const int wm = (warp % 4) * 32;  // this warp's 32 pixels
  const int wn = (warp / 4) * 80;  // and 80 labels

  for (int r = warp; r < HM; r += THREADS / 32) {
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

  float acc[2][10][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 10; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += HK) {
    __syncthreads();  // inv_x ready; previous chunk consumed
    for (int i = tid; i < HM * (HK / 8); i += THREADS) {
      const int r = i / (HK / 8);
      const int c = (i % (HK / 8)) * 8;
      float v[8];
      if (m0 + r < M) {
        load8(x + static_cast<long long>(m0 + r) * C + c0 + c, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.0f;
      }
      const float s = inv_x[r];
      uint4 packed;
      packed.x = lseg::pack_f32(__fmul_rn(v[0], s), __fmul_rn(v[1], s));
      packed.y = lseg::pack_f32(__fmul_rn(v[2], s), __fmul_rn(v[3], s));
      packed.z = lseg::pack_f32(__fmul_rn(v[4], s), __fmul_rn(v[5], s));
      packed.w = lseg::pack_f32(__fmul_rn(v[6], s), __fmul_rn(v[7], s));
      *reinterpret_cast<uint4*>(As + r * HLD + c) = packed;
    }
    for (int i = tid; i < BN * (HK / 8); i += THREADS) {
      const int r = i / (HK / 8);
      const int c = (i % (HK / 8)) * 8;
      *reinterpret_cast<uint4*>(Bs + r * HLD + c) =
          *reinterpret_cast<const uint4*>(
              tn + static_cast<long long>(k0 + r) * C + c0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < HK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const __nv_bfloat16* p = As + (wm + mt * 16 + g) * HLD + kk + 2 * t4;
        af[mt][0] = lseg::ld_u32(p);
        af[mt][1] = lseg::ld_u32(p + 8 * HLD);
        af[mt][2] = lseg::ld_u32(p + 8);
        af[mt][3] = lseg::ld_u32(p + 8 * HLD + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 10; ++nt) {
        const __nv_bfloat16* p = Bs + (wn + nt * 8 + g) * HLD + kk + 2 * t4;
        const uint32_t b0 = lseg::ld_u32(p);
        const uint32_t b1 = lseg::ld_u32(p + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          lseg::mma_bf16_16816(acc[mt][nt], af[mt], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mt * 16 + g + 8 * half;
      if (m >= M) continue;
      __nv_bfloat16* op = out + static_cast<long long>(m) * K;
#pragma unroll
      for (int nt = 0; nt < 10; ++nt) {
        const int k = k0 + wn + nt * 8 + 2 * t4;
        const float* a = acc[mt][nt] + 2 * half;
        if (k < K) op[k] = __float2bfloat16_rn(__fmul_rn(scale, a[0]));
        if (k + 1 < K) op[k + 1] = __float2bfloat16_rn(__fmul_rn(scale, a[1]));
      }
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x_bf16 selects the pixel dtype (1 bf16, 0 fp32), out_bf16 the mode: 0
// the fp32 product and logits, with tn the wrapper's (C, kp) fp32 scratch;
// 1 compute_dtype = bfloat16, with tn a (kp, C) bf16 scratch and bf16
// logits. kp = ceil(k / 160) * 160. Requires c % 32 == 0 and 16-byte
// aligned tensors (checked by the wrapper).
extern "C" int lseg_fused_correlate(const void* x, const void* t, void* tn,
                                    void* out, int m, int c, int k, int kp,
                                    int x_bf16, int out_bf16, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((m + BM - 1) / BM, kp / BN);
  if (out_bf16) {
    normalize_text_bf16_kernel<<<(kp * 32 + THREADS - 1) / THREADS, THREADS,
                                 0, s>>>(static_cast<const float*>(t),
                                         static_cast<__nv_bfloat16*>(tn), k,
                                         kp, c);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    const __nv_bfloat16* tb = static_cast<const __nv_bfloat16*>(tn);
    if (x_bf16) {
      fused_correlate_bf16_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), tb, o, m, c, k, scale);
    } else {
      fused_correlate_bf16_kernel<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), tb, o, m, c, k, scale);
    }
    return static_cast<int>(cudaGetLastError());
  }
  normalize_text_kernel<<<(kp * 32 + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const float*>(t), static_cast<float*>(tn), k, kp, c);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  if (x_bf16) {
    fused_correlate_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(tn),
        static_cast<float*>(out), m, c, k, kp, scale);
  } else {
    fused_correlate_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(tn),
        static_cast<float*>(out), m, c, k, kp, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
