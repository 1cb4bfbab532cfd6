// Dense product with a bias and residual epilogue for Hopper (sm_90a),
// kernel B17.
//
// Replaces: lseg_tpu/ops/pallas_dense.py · dense_residual (Pallas TPU; body
// _kernel), the row-tiled (M, K) . (K, N) with the weight resident in VMEM
// and the epilogue applied in registers.
//
//   out (M, N) = round_out(((x . w) + b) + r)
//
// x (M, K) bf16 or fp32, w (K, N) in x's dtype (the wrapper casts it), b
// (N,) fp32, r (M, N) bf16 or fp32 or absent, out bf16 or fp32. The product
// accumulates in fp32; the bias and the residual (read in its own dtype)
// are added in fp32, in that order, each sum rounded on its own (`_rn`, no
// contraction), and the result is rounded once to the output dtype. The
// TPU kernel pads M to its row tile and slices the pad away; here every
// block masks its ragged rows and columns (zero-filled copies, guarded
// stores), with no padding copy.
//
// What bounds it on the card: at ViT-L/16's fc2 (7208, 4096) . (4096, 1024)
// bf16 with a bf16 residual the product is 60.5 GFLOP (~0.061 ms at 989
// TFLOP/s) against ~97 MB moved (~0.029 ms): the tensor cores bound it.
// Design, bf16 x: a 256-thread block computes a 128 x 128 output tile; K
// walks in slices of 32, both operands copied by cp.async into a double
// buffer in shared memory (rows padded by 16 bytes, so the 8-row phases of
// ldmatrix hit distinct banks) while the previous slice multiplies; eight
// warps (2 x 4) each run 64 x 32 of mma.sync m16n8k16 bf16 with fp32
// accumulators, A fragments by ldmatrix and the row-major w (K-major B) by
// ldmatrix.trans. fp32 x: full fp32 products on the FMA units (67 TFLOP/s;
// TF32 would round the operands to 10 mantissa bits), a register-tiled
// SGEMM with 128 x 128 tiles and 8 x 8 outputs per thread, as B10's fp32
// tile. Not yet: wgmma and TMA, a persistent tile order.

#include "lseg_common.cuh"

namespace {

constexpr int THREADS = 256;

// the bias, then the residual (resid_kind 0 none, 1 bf16, 2 fp32), each
// added in fp32 and rounded on its own
__device__ __forceinline__ float epilogue(float acc, const float* b,
                                          const void* r, int resid_kind,
                                          long long idx, int col) {
  float v = __fadd_rn(acc, b[col]);
  if (resid_kind == 1) {
    v = __fadd_rn(v, __bfloat162float(
                         static_cast<const __nv_bfloat16*>(r)[idx]));
  } else if (resid_kind == 2) {
    v = __fadd_rn(v, static_cast<const float*>(r)[idx]);
  }
  return v;
}

__device__ __forceinline__ void store(void* out, int out_bf16, long long idx,
                                      float v) {
  if (out_bf16) {
    static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(out)[idx] = v;
  }
}

// ---- bf16 x: mma.sync on the tensor cores ----

constexpr int BM = 128;        // rows per block
constexpr int BN = 128;        // columns per block
constexpr int BK = 32;         // k per slice
constexpr int LDA = BK + 8;    // bf16 row strides in shared memory
constexpr int LDB = BN + 8;

// 16 bytes from global to shared; src_bytes 0 fills the 16 bytes with 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// start the copy of the K slice at k0 into buffers As, Bs; chunks of 8
// values past M, N or K are zero-filled
__device__ __forceinline__ void load_slice(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    int M, int K, int N, int m0, int n0, int k0, __nv_bfloat16* As,
    __nv_bfloat16* Bs) {
  for (int i = threadIdx.x; i < BM * (BK / 8); i += THREADS) {
    const int r = i / (BK / 8);
    const int c = (i % (BK / 8)) * 8;
    const bool ok = m0 + r < M && k0 + c < K;
    const __nv_bfloat16* src =
        ok ? x + static_cast<long long>(m0 + r) * K + k0 + c : x;
    cp_async16(As + r * LDA + c, src, ok ? 16 : 0);
  }
  for (int i = threadIdx.x; i < BK * (BN / 8); i += THREADS) {
    const int r = i / (BN / 8);
    const int c = (i % (BN / 8)) * 8;
    const bool ok = k0 + r < K && n0 + c < N;
    const __nv_bfloat16* src =
        ok ? w + static_cast<long long>(k0 + r) * N + n0 + c : w;
    cp_async16(Bs + r * LDB + c, src, ok ? 16 : 0);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(THREADS) dense_bf16_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b, const void* __restrict__ r,
    void* __restrict__ out, int M, int K, int N, int resid_kind,
    int out_bf16) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM * LDA];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BK * LDB];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int wm = (warp % 2) * 64;  // this warp's 64 rows
  const int wn = (warp / 2) * 32;  // and 32 columns

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  const int slices = (K + BK - 1) / BK;
  load_slice(x, w, M, K, N, m0, n0, 0, As[0], Bs[0]);
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      load_slice(x, w, M, K, N, m0, n0, (s + 1) * BK, As[(s + 1) & 1],
                 Bs[(s + 1) & 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a = As[s & 1];
    const __nv_bfloat16* bs = Bs[s & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // lanes 0-15 address rows 0-15 at k, lanes 16-31 the same rows at
      // k + 8: the four 8 x 8 matrices are the A fragment's registers
      uint32_t af[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldsm_x4(af[mt], a + (wm + mt * 16 + lane % 16) * LDA + kk +
                            (lane / 16) * 8);
      // k rows kk .. kk+15 of two 8-column tiles, transposed: registers
      // 0, 1 are b0, b1 of the first tile, 2, 3 of the second
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, bs + (kk + lane % 16) * LDB + wn + np * 16 +
                              (lane / 16) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          lseg::mma_bf16_16816(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          lseg::mma_bf16_16816(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two slices on
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn + nt * 8 + 2 * t4;
      if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mt * 16 + g + 8 * (e / 2);
        if (row >= M) continue;
        const long long idx = static_cast<long long>(row) * N + col + e % 2;
        store(out, out_bf16, idx,
              epilogue(acc[mt][nt][e], b, r, resid_kind, idx, col + e % 2));
      }
    }
  }
}

// ---- fp32 x: SIMT FMAs ----

constexpr int FM = 128;  // rows per block
constexpr int FN = 128;  // columns per block
constexpr int FK = 16;   // k per staged slice
constexpr int PAD = 4;   // keeps the transposed stores off one bank

__global__ void __launch_bounds__(THREADS) dense_fp32_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ b, const void* __restrict__ r,
    void* __restrict__ out, int M, int K, int N, int resid_kind,
    int out_bf16) {
  __shared__ __align__(16) float As[FK][FM + PAD];  // x^T
  __shared__ __align__(16) float Bs[FK][FN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group: columns tx + 16 j
  const int ty = tid / 16;  // row group: rows ty + 16 i
  const int m0 = blockIdx.y * FM;
  const int n0 = blockIdx.x * FN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FK) {
    // x: thread -> (row, 4 k); consecutive threads take consecutive rows
    // so the transposed shared stores do not conflict
    for (int i = tid; i < FM * (FK / 4); i += THREADS) {
      const int rr = i % FM;
      const int c = (i / FM) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (m0 + rr < M && k0 + c < K)
        v = *reinterpret_cast<const float4*>(
            x + static_cast<long long>(m0 + rr) * K + k0 + c);
      As[c][rr] = v.x;
      As[c + 1][rr] = v.y;
      As[c + 2][rr] = v.z;
      As[c + 3][rr] = v.w;
    }
    for (int i = tid; i < FK * (FN / 4); i += THREADS) {
      const int rr = i / (FN / 4);
      const int c = (i % (FN / 4)) * 4;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k0 + rr < K && n0 + c < N)
        v = *reinterpret_cast<const float4*>(
            w + static_cast<long long>(k0 + rr) * N + n0 + c);
      *reinterpret_cast<float4*>(&Bs[rr][c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      const long long idx = static_cast<long long>(row) * N + col;
      store(out, out_bf16, idx,
            epilogue(acc[i][j], b, r, resid_kind, idx, col));
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x_bf16 selects x's and w's dtype (1 bf16, 0 fp32), resid_kind the
// residual (0 none, 1 bf16, 2 fp32), out_bf16 the output dtype (1 bf16,
// 0 fp32). Requires k % 16 == 0, n % 8 == 0 and 16-byte aligned tensors
// (checked by the wrapper).
extern "C" int lseg_dense_residual(const void* x, const void* w,
                                   const void* b, const void* r, void* out,
                                   int m, int k, int n, int x_bf16,
                                   int resid_kind, int out_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    dense_bf16_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(b),
        r, out, m, k, n, resid_kind, out_bf16);
  } else {
    const dim3 grid((n + FN - 1) / FN, (m + FM - 1) / FM);
    dense_fp32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), r, out, m, k, n, resid_kind, out_bf16);
  }
  return static_cast<int>(cudaGetLastError());
}
