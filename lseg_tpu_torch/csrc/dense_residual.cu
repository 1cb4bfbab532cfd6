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
// Design, bf16 x, on the GEMM engine of wgmma_gemm.cuh: a 384-thread block
// computes a 128 x 256 output tile (57 x 4 tiles at fc2, 1.7 waves on 132
// SMs); warpgroup 0 is the producer, one thread keeping a four-stage TMA
// ring of 64-deep k-chunks full (x as one 128 x 64 box, w as four 64 x 64
// boxes, 48 KB a stage, 128-byte swizzle); warpgroups 1 and 2 each run
// m64n256k16 wgmma on their 64 rows, x K-major and the row-major w read
// MN-major, and hand a stage back once the products that read it are
// done, with one chunk's products in flight under the next wait.
// setmaxnreg gives the producer 40 registers and the consumers 232 (128
// accumulators each). TMA zero-fills the ragged row edge (M = 7208) and a
// ragged last k-chunk. With a bf16 output and a bf16 (or no) residual,
// the residual tile (64 KB) arrives by TMA into the w boxes of two stages
// that the last chunks no longer use, the epilogue adds bias and residual
// in shared memory (the 128-byte swizzle keeps the 8 rows of a warp's
// pairs on distinct banks) and the tile leaves by TMA store, rows past M
// clipped: an epilogue that reads the residual from device memory pair by
// pair after the main loop leaves the latency of every load exposed.
// Otherwise the epilogue reads the residual and stores pairs from
// registers. fp32 x: full fp32 products on the FMA units (67 TFLOP/s;
// TF32 would round the operands to 10 mantissa bits), a register-tiled
// SGEMM with 128 x 128 tiles and 8 x 8 outputs per thread, as B10's fp32
// tile. Not yet: a persistent tile order that overlaps one tile's
// epilogue with the next tile's loads.

#include "lseg_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace wg = lseg::wg;

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

// ---- bf16 x: wgmma from a TMA ring (wgmma_gemm.cuh) ----

constexpr int BM = 128;            // rows per block: two consumer warpgroups
constexpr int BN = 256;            // columns per block
constexpr int BK = 64;             // k per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int WG_THREADS = 128;
constexpr int GEMM_THREADS = 3 * WG_THREADS;  // producer + 2 consumers
constexpr int A_BYTES = BM * BK * 2;          // 16 KB
constexpr int BOX = 64 * 64;                  // a 64 x 64 bf16 box
constexpr int BOX_BYTES = BOX * 2;            // 8 KB
constexpr int B_BYTES = (BN / 64) * BOX_BYTES;  // also 64 rows of output

struct GemmSmem {
  __nv_bfloat16 a[STAGES][BM * BK];
  __nv_bfloat16 b[STAGES][BK * BN];
  float bias[2][BN];
  lseg::gemm::Ring<STAGES> ring;
  uint64_t c_bar;
};
constexpr int GEMM_SMEM = sizeof(GemmSmem) + 1024;  // + alignment slack

// The bias, then the residual (resid_kind 0 none, 1 bf16, 2 fp32), on two
// adjacent columns, each sum rounded on its own.
__device__ __forceinline__ float2 add_pair(float a0, float a1, float b0,
                                           float b1, const void* r,
                                           int resid_kind, long long idx) {
  float v0 = __fadd_rn(a0, b0), v1 = __fadd_rn(a1, b1);
  if (resid_kind == 1) {
    const float2 rv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(
            static_cast<const __nv_bfloat16*>(r) + idx));
    v0 = __fadd_rn(v0, rv.x);
    v1 = __fadd_rn(v1, rv.y);
  } else if (resid_kind == 2) {
    const float2 rv =
        *reinterpret_cast<const float2*>(static_cast<const float*>(r) + idx);
    v0 = __fadd_rn(v0, rv.x);
    v1 = __fadd_rn(v1, rv.y);
  }
  return make_float2(v0, v1);
}

// One 128 x 256 output tile a block: warpgroup 0 is the producer (one
// thread issues every TMA load), warpgroups 1 and 2 each take 64 rows of
// the tile through m64n256k16 products, x read K-major and w (K, N) read
// MN-major as four 64-column boxes; each releases a stage once the
// products that read it are complete. `staged` (bf16 output, bf16 or no
// residual): the w boxes of the two stages after the last chunk's hold the
// output tile, 64 rows a warpgroup; the producer loads the residual tile
// there by TMA once both warpgroups are done with those stages (during
// the last chunks' products), the epilogue sums in shared memory and the
// tile leaves by TMA store. Otherwise the epilogue reads the residual and
// writes pairs from registers.
__global__ void __launch_bounds__(GEMM_THREADS, 1) dense_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_r,
    const __grid_constant__ CUtensorMap map_o, const float* __restrict__ b,
    const void* __restrict__ r, void* __restrict__ out, int M, int K, int N,
    int resid_kind, int out_bf16, int staged) {
  namespace gm = lseg::gemm;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  GemmSmem& sm = *reinterpret_cast<GemmSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int wg_id = threadIdx.x / WG_THREADS;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int n_k = (K + BK - 1) / BK;  // TMA zero-fills a ragged last chunk
  const bool load_c = staged && resid_kind == 1;

  if (threadIdx.x == 0) {
    sm.ring.init(2);
    wg::bar_init(&sm.c_bar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  if (wg_id == 0) {
    gm::regs_dec<40>();
    if (threadIdx.x == 0) {
      for (int kc = 0; kc < n_k; ++kc) {
        const int s = sm.ring.acquire(kc, A_BYTES + B_BYTES);
        gm::tma_load_2d(sm.a[s], &map_x, &sm.ring.full[s], kc * BK, m0);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          gm::tma_load_2d(sm.b[s] + j * BOX, &map_w, &sm.ring.full[s],
                          n0 + 64 * j, kc * BK);
      }
      // the output tile's stages, once both warpgroups are done with them
      int cs[2];
      for (int h = 0; h < 2; ++h) cs[h] = sm.ring.wait_free(n_k + h);
      if (load_c) {
        wg::bar_expect_tx(&sm.c_bar, 2 * B_BYTES);
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            gm::tma_load_2d(sm.b[cs[h]] + j * BOX, &map_r, &sm.c_bar,
                            n0 + 64 * j, m0 + 64 * h);
      } else {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                         wg::smem_addr(&sm.c_bar))
                     : "memory");
      }
    }
    return;
  }

  gm::regs_inc<232>();
  const int c = wg_id - 1;  // this warpgroup's 64 rows
  const int tid = threadIdx.x % WG_THREADS;
  for (int i = tid; i < BN; i += WG_THREADS)
    sm.bias[c][i] = n0 + i < N ? b[n0 + i] : 0.0f;
  float acc[BN / 8][4];
  gm::zero(acc);
  for (int kc = 0; kc < n_k; ++kc) {
    const int s = sm.ring.wait(kc);
    gm::fence_acc(acc);
    wg::fence();
    gm::mma_chunk<BN, 1>(acc, wg::desc(sm.a[s] + c * 64 * BK),
                         gm::desc_mn(sm.b[s], BOX_BYTES));
    wg::commit();
    wg::wait<1>();  // the previous chunk's products are complete
    gm::fence_acc(acc);
    if (kc > 0 && tid == 0) sm.ring.release(kc - 1);
  }
  wg::wait<0>();
  gm::fence_acc(acc);
  wg::named_sync(2 + c, WG_THREADS);  // the bias is in shared memory

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  if (staged) {
    wg::bar_wait(&sm.c_bar, 0);  // the output stage is free (and filled)
    __nv_bfloat16* ct = sm.b[(n_k + c) % STAGES];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = warp * 16 + g + 8 * half;  // of this warpgroup's 64
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
            reinterpret_cast<uint8_t*>(ct + (col / 64) * BOX) +
            gm::swizzled_offset(row, col % 64));
        float v0 = __fadd_rn(acc[nt][2 * half], sm.bias[c][col]);
        float v1 = __fadd_rn(acc[nt][2 * half + 1], sm.bias[c][col + 1]);
        if (load_c) {
          const float2 rv = __bfloat1622float2(*p);
          v0 = __fadd_rn(v0, rv.x);
          v1 = __fadd_rn(v1, rv.y);
        }
        *p = __floats2bfloat162_rn(v0, v1);
      }
    }
    gm::fence_proxy_async();  // the tile's writes before the TMA store
    wg::named_sync(2 + c, WG_THREADS);
    if (tid == 0) {
#pragma unroll
      for (int j = 0; j < BN / 64; ++j)
        gm::tma_store_2d(&map_o, ct + j * BOX, n0 + 64 * j, m0 + 64 * c);
      gm::tma_store_drain();
    }
    return;
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + c * 64 + warp * 16 + g + 8 * half;
    if (row >= M) continue;
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int cl = nt * 8 + 2 * t4;
      const int col = n0 + cl;
      if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
      const long long idx = static_cast<long long>(row) * N + col;
      const float2 v =
          add_pair(acc[nt][2 * half], acc[nt][2 * half + 1],
                   sm.bias[c][cl], sm.bias[c][cl + 1], r, resid_kind, idx);
      if (out_bf16) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                           idx) =
            __floats2bfloat162_rn(v.x, v.y);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = v;
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
// (checked by the wrapper; TMA needs rows of a multiple of 16 bytes).
extern "C" int lseg_dense_residual(const void* x, const void* w,
                                   const void* b, const void* r, void* out,
                                   int m, int k, int n, int x_bf16,
                                   int resid_kind, int out_bf16,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    static const int attr = wg::allow_smem(dense_wgmma_kernel, GEMM_SMEM);
    if (attr != 0) return attr;
    namespace gm = lseg::gemm;
    const int staged = out_bf16 && resid_kind != 2;
    CUtensorMap map_x, map_w, map_r, map_o;
    int rc = gm::make_map_2d(&map_x, x, 2, k, m, BK, BM, true);
    if (rc == 0) rc = gm::make_map_2d(&map_w, w, 2, n, k, 64, BK, true);
    // unused maps are encoded over the output, which is always valid
    if (rc == 0)
      rc = gm::make_map_2d(&map_r, resid_kind == 1 ? r : out, 2, n, m, 64,
                           64, true);
    if (rc == 0) rc = gm::make_map_2d(&map_o, out, 2, n, m, 64, 64, true);
    if (rc != 0) return rc;
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    dense_wgmma_kernel<<<grid, GEMM_THREADS, GEMM_SMEM, s>>>(
        map_x, map_w, map_r, map_o, static_cast<const float*>(b), r, out, m,
        k, n, resid_kind, out_bf16, staged);
  } else {
    const dim3 grid((n + FN - 1) / FN, (m + FM - 1) / FM);
    dense_fp32_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(b), r, out, m, k, n, resid_kind, out_bf16);
  }
  return static_cast<int>(cudaGetLastError());
}
