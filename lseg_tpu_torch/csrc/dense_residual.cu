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
// registers.
//
// fp32 x: split-TF32 products on the same engine (tf32x3.cuh: three TF32
// products of each operand's hi and lo keep ~21 bits of each, well inside
// the fp32 gate, where one TF32 product would round the operands to 10
// bits and fail it). At fc2 that is 3 x 60.5 GFLOP at 495 TFLOP/s, 0.367
// ms, against 0.90 ms of fp32 FMAs at 67 TFLOP/s; ~193 MB move (0.058
// ms). tf32 wgmma reads only K-major operands and w (K, N) is N-major, so
// a pre-pass of the same launch sequence (split_transpose_kernel, 32 x 32
// tiles through shared memory) writes w's split transposed into the
// wrapper's scratch, w_hi^T and w_lo^T (N, K), 32 MB at fc2. The main
// kernel keeps the producer warpgroup and the two consumer warpgroups on
// a 128 x 128 tile (57 x 8 tiles at fc2, 3.5 waves) and a three-stage TMA
// ring of 32-deep k-chunks (one 128-byte swizzle row of fp32): x's
// 128 x 32 box, the w_hi^T and w_lo^T 128 x 32 boxes and a buffer for x's
// lo, 64 KB a stage. Each consumer warpgroup rewrites its 64 rows of x in
// place to hi and writes lo beside them, fences the generic-proxy writes
// (fence.proxy.async) before a warpgroup barrier, and issues per k-step
// of 8 three SS m64n128k8 tf32 products, x_lo . w_hi, x_hi . w_lo,
// x_hi . w_hi. The tensor cores' accumulation truncates, and 1,536
// truncating adds an output at K = 4096 drift past the gate: each chunk's
// products go to a fresh partial sum, folded into the running sum with
// round-to-nearest adds once complete (64 registers each; at 256 columns
// the two would need 256 of the 168 registers a thread the kernel
// compiles to, so the tile is 128 wide). A warpgroup splits the next
// chunk while the products of the last run, and the other warpgroup's
// products fill the gap while it folds. The epilogue is the register
// epilogue above: bias, then residual, each `_rn`, one rounding. TMA
// zero-fills the ragged row edge, the columns past N and a ragged last
// k-chunk, and zero splits into zeros. Not yet: a persistent tile order
// that overlaps one tile's epilogue with the next tile's loads (for both
// modes).

#include "lseg_common.cuh"
#include "tf32x3.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace wg = lseg::wg;

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

// The register epilogue of one consumer warpgroup's 64 rows from row0:
// bias and residual on each pair of accumulators (add_pair), one rounding
// to the output dtype; rows past M and columns past N are not stored.
template <int NT>
__device__ __forceinline__ void store_pairs(const float (&acc)[NT][4],
                                            const float* bias, const void* r,
                                            void* out, int row0, int n0,
                                            int M, int N, int resid_kind,
                                            int out_bf16) {
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + warp * 16 + g + 8 * half;
    if (row >= M) continue;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int cl = nt * 8 + 2 * t4;
      const int col = n0 + cl;
      if (col >= N) continue;  // N % 8 == 0: col + 1 < N as well
      const long long idx = static_cast<long long>(row) * N + col;
      const float2 v =
          add_pair(acc[nt][2 * half], acc[nt][2 * half + 1], bias[cl],
                   bias[cl + 1], r, resid_kind, idx);
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
  store_pairs(acc, sm.bias[c], r, out, m0 + c * 64, n0, M, N, resid_kind,
              out_bf16);
}

// ---- fp32 x: split-TF32 wgmma from a TMA ring (tf32x3.cuh) ----

constexpr int TN = 128;                // columns per block
constexpr int TK = 32;                 // fp32 k per stage: one swizzle row
constexpr int TSTAGES = 3;
constexpr int TA_BYTES = BM * TK * 4;  // 16 KB: x
constexpr int TB_BYTES = TN * TK * 4;  // 16 KB: each of w_hi^T, w_lo^T

struct Tf32Smem {
  float a[TSTAGES][BM * TK];     // x, rewritten in place to its hi
  float a_lo[TSTAGES][BM * TK];  // x's lo, the same swizzled layout
  float b_hi[TSTAGES][TN * TK];
  float b_lo[TSTAGES][TN * TK];
  float bias[2][TN];
  lseg::gemm::Ring<TSTAGES> ring;
};
constexpr int TF32_SMEM = sizeof(Tf32Smem) + 1024;  // + alignment slack

// The pre-pass: w (K, N) -> its split transposed, hi and lo (N, K), the
// K-major operands of tf32 wgmma; one 32 x 32 tile a block through
// shared memory (rows padded to 33 floats), coalesced on both sides.
__global__ void __launch_bounds__(256) split_transpose_kernel(
    const float* __restrict__ w, float* __restrict__ hi,
    float* __restrict__ lo, int K, int N) {
  __shared__ float tile[32][33];
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int n0 = blockIdx.x * 32, k0 = blockIdx.y * 32;
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const int k = k0 + ty + j, n = n0 + tx;
    tile[ty + j][tx] =
        k < K && n < N ? w[static_cast<long long>(k) * N + n] : 0.0f;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 32; j += 8) {
    const int n = n0 + ty + j, k = k0 + tx;
    if (n < N && k < K) {
      uint32_t h, l;
      lseg::tf32x3::split(tile[tx][ty + j], h, l);
      const long long i = static_cast<long long>(n) * K + k;
      hi[i] = __uint_as_float(h);
      lo[i] = __uint_as_float(l);
    }
  }
}

// One 128 x 128 output tile a block: warpgroup 0 the producer (x, w_hi^T
// and w_lo^T boxes a stage), warpgroups 1 and 2 the consumers of 64 rows
// each. The tensor cores' fp32 accumulation truncates, and over K = 4096
// (1,536 products an output) that drifts past the fp32 gate, so each
// chunk's products go to a fresh partial sum, folded into the running sum
// with round-to-nearest adds once complete. A warpgroup splits chunk kc
// while chunk kc - 1's products run, then waits for them, folds, and
// issues kc; the other warpgroup's products keep the tensor cores busy
// across that gap.
__global__ void __launch_bounds__(GEMM_THREADS, 1) dense_tf32x3_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_wh,
    const __grid_constant__ CUtensorMap map_wl, const float* __restrict__ b,
    const void* __restrict__ r, void* __restrict__ out, int M, int K, int N,
    int resid_kind, int out_bf16) {
  namespace gm = lseg::gemm;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Tf32Smem& sm = *reinterpret_cast<Tf32Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int wg_id = threadIdx.x / WG_THREADS;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * TN;
  const int n_k = (K + TK - 1) / TK;  // TMA zero-fills a ragged last chunk

  if (threadIdx.x == 0) sm.ring.init(2);
  __syncthreads();

  if (wg_id == 0) {
    gm::regs_dec<40>();
    if (threadIdx.x == 0) {
      for (int kc = 0; kc < n_k; ++kc) {
        const int s = sm.ring.acquire(kc, TA_BYTES + 2 * TB_BYTES);
        gm::tma_load_2d(sm.a[s], &map_x, &sm.ring.full[s], kc * TK, m0);
        gm::tma_load_2d(sm.b_hi[s], &map_wh, &sm.ring.full[s], kc * TK, n0);
        gm::tma_load_2d(sm.b_lo[s], &map_wl, &sm.ring.full[s], kc * TK, n0);
      }
    }
    return;
  }

  gm::regs_inc<232>();
  namespace t3 = lseg::tf32x3;
  const int c = wg_id - 1;  // this warpgroup's 64 rows
  const int tid = threadIdx.x % WG_THREADS;
  for (int i = tid; i < TN; i += WG_THREADS)
    sm.bias[c][i] = n0 + i < N ? b[n0 + i] : 0.0f;
  float acc[TN / 8][4], part[TN / 8][4];
  gm::zero(acc);
  for (int kc = 0; kc < n_k; ++kc) {
    const int s = sm.ring.wait(kc);
    float* xh = sm.a[s] + c * 64 * TK;
    float* xl = sm.a_lo[s] + c * 64 * TK;
    // the split is elementwise, so the swizzled layout needs no index
    // arithmetic: lo lands at the offset of its hi
#pragma unroll
    for (int i = 0; i < 64 * TK / 4 / WG_THREADS; ++i) {
      const int j = tid + i * WG_THREADS;
      t3::split4(reinterpret_cast<float4*>(xh) + j,
                 reinterpret_cast<float4*>(xl) + j);
    }
    gm::fence_proxy_async();  // the split's writes before wgmma reads
    wg::named_sync(2 + c, WG_THREADS);
    if (kc > 0) {
      wg::wait<0>();  // the previous chunk's products are complete
      gm::fence_acc(part);
      if (tid == 0) sm.ring.release(kc - 1);
      t3::fold(acc, part);
    }
    gm::fence_acc(part);
    wg::fence();
    const uint64_t ah = wg::desc(xh), al = wg::desc(xl);
    const uint64_t bh = wg::desc(sm.b_hi[s]), bl = wg::desc(sm.b_lo[s]);
#pragma unroll
    for (int kk = 0; kk < TK / 8; ++kk)
      t3::wgmma3_128(part, wg::desc_kstep(ah, kk), wg::desc_kstep(al, kk),
                     wg::desc_kstep(bh, kk), wg::desc_kstep(bl, kk),
                     kk > 0);
    wg::commit();
  }
  wg::wait<0>();
  gm::fence_acc(part);
  t3::fold(acc, part);
  wg::named_sync(2 + c, WG_THREADS);  // the bias is in shared memory
  store_pairs(acc, sm.bias[c], r, out, m0 + c * 64, n0, M, N, resid_kind,
              out_bf16);
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x_bf16 selects x's and w's dtype (1 bf16, 0 fp32), resid_kind the
// residual (0 none, 1 bf16, 2 fp32), out_bf16 the output dtype (1 bf16,
// 0 fp32). fp32 x also takes `w_split`, fp32 scratch of 2 * n * k floats
// for w's split transposed (unused for bf16 x). Requires k % 16 == 0,
// n % 8 == 0 and 16-byte aligned tensors (checked by the wrapper; TMA
// needs rows of a multiple of 16 bytes).
extern "C" int lseg_dense_residual(const void* x, const void* w,
                                   const void* b, const void* r,
                                   void* w_split, void* out, int m, int k,
                                   int n, int x_bf16, int resid_kind,
                                   int out_bf16, void* stream) {
  namespace gm = lseg::gemm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    static const int attr = wg::allow_smem(dense_wgmma_kernel, GEMM_SMEM);
    if (attr != 0) return attr;
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
    static const int attr =
        wg::allow_smem(dense_tf32x3_kernel, TF32_SMEM);
    if (attr != 0) return attr;
    float* hi = static_cast<float*>(w_split);
    float* lo = hi + static_cast<long long>(n) * k;
    split_transpose_kernel<<<dim3((n + 31) / 32, (k + 31) / 32), 256, 0,
                             s>>>(static_cast<const float*>(w), hi, lo, k,
                                  n);
    int rc = static_cast<int>(cudaGetLastError());
    CUtensorMap map_x, map_wh, map_wl;
    if (rc == 0) rc = gm::make_map_2d(&map_x, x, 4, k, m, TK, BM, true);
    if (rc == 0) rc = gm::make_map_2d(&map_wh, hi, 4, k, n, TK, TN, true);
    if (rc == 0) rc = gm::make_map_2d(&map_wl, lo, 4, k, n, TK, TN, true);
    if (rc != 0) return rc;
    dense_tf32x3_kernel<<<dim3((n + TN - 1) / TN, (m + BM - 1) / BM),
                          GEMM_THREADS, TF32_SMEM, s>>>(
        map_x, map_wh, map_wl, static_cast<const float*>(b), r, out, m, k,
        n, resid_kind, out_bf16);
  }
  return static_cast<int>(cudaGetLastError());
}
