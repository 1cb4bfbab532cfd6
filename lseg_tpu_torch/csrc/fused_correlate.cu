// Fused L2 normalisation + image-text correlation for Hopper (sm_90a),
// kernel B10.
//
// Replaces: lseg_tpu/ops/pallas_correlation.py · fused_correlate (Pallas
// TPU; body _kernel), the use_pallas=True serving head's correlation.
//
// Input: pixel embeddings x (M, C) in bf16 or fp32 (M = N*H*W), raw text
// features t (K, C) fp32. Output: (M, K) logits, K unpadded:
//   xn  = x * rsqrt(max(sum(x^2), 1e-24))        (fp32, per pixel row)
//   tn  = t * rsqrt(max(sum(t^2), 1e-24))        (fp32, per label row)
//   out = scale * (xn . tn^T)
// Zero rows keep norm 0 through the max guard and give logits of 0. The
// text is normalised once, by a first small launch, into a zero-padded
// scratch; the normalised pixel map never reaches device memory.
//
// compute_dtype = float32 (the streamed head, one launch a request): the
// product in full fp32 on the FMA units, as the reference's fp32 mm_dtype
// on this path (TF32 tensor cores would round the operands to 10 mantissa
// bits), fp32 logits. The pixel norm is applied in the epilogue,
//   out = scale * (inv_x * (x . tn^T)),
// which differs from normalising first at fp32 rounding; the sums run in
// another order than the plain version's. What bounds it: at the flagship
// (8, 240, 240, 512) bf16 against K = 150 the product is 70.8 GFLOP at the
// ~67 TFLOP/s fp32 rate (~1.06 ms), against 472 MB in and 276 MB out
// (~0.22 ms): the fp32 FMAs. Design (a SIMT redesign on the TMA ring of
// wgmma_gemm.cuh): a 256-thread block takes 128 pixels x 160 labels and
// walks C in chunks of 32; one thread keeps a three-stage ring full by
// TMA (the pixel chunk, 128 x 32 as it lies, and the transposed text chunk,
// 32 x 160 fp32), each stage on its own mbarrier, so every pixel is read
// from device memory once and the next chunks land under this one's
// products; each thread accumulates 8 pixels x 10 labels (5 label pairs,
// 2 k a step: 18 shared loads feed 160 FMAs; a bf16 pixel value is
// widened to fp32 in registers) and, from the same staged chunk, a share
// of its pixel rows' sums of squares (each row's half-chunk walked from a
// rotated start, so the column reads spread over the banks). Two blocks
// share an SM (128 registers a thread, no spills). On an H100 three other
// schedules ran slower: a bf16 chunk converted to an fp32 copy in shared
// memory first (an extra barrier a chunk), 4 k a step and labels loaded
// as quads (both against the 128-register cap).
//
// compute_dtype = bfloat16 (the reference's fast-serving mode, its
// mm_dtype=bf16): both operands normalised in fp32 and rounded to bf16,
// multiplied with fp32 accumulators, scaled in fp32 and rounded once:
//   out (M, K) bf16 = bf16(scale * (bf16(xn) . bf16(tn)^T))
// At the flagship the product is 70.8 GFLOP of bf16 (~0.07 ms at 989
// TFLOP/s) against 472 MB in and 138 MB out (~0.18 ms): bytes bound it.
// Design for bf16 pixels with C % 64 == 0 and C <= 512, on the GEMM engine
// of wgmma_gemm.cuh: a persistent block (one an SM) keeps its 152 labels
// of the normalised bf16 text resident in shared memory (152 KB at C =
// 512; 152 = 150 rounded up to wgmma's multiple of 8; the alternative,
// 128-pixel tiles beside a streamed text ring, re-reads the text from L2
// for every tile and leaves no room to double-buffer the pixels), and
// walks 64-pixel tiles. A producer warp keeps a ring of nine 64 x 64 bf16
// slots full by TMA (128-byte swizzle), one C-chunk of one tile a slot;
// two consumer warpgroups wait for a tile's C / 64 chunks, take each
// row's fp32 norm from shared memory (four threads a row; the swizzle
// permutes 16-byte units within a row, so a row's values and a per-row
// scale commute with it), write bf16(x * r) back in place, order those
// generic-proxy writes before the async proxy (fence.proxy.async), and
// run wgmma against the resident text, warpgroup 0 on labels 0-79
// (m64n80k16), warpgroup 1 on labels 80-151 (m64n72k16), one commit group
// a chunk (two warpgroups halve each tile's norm and products against one
// on m64n152k16); each hands a slot back as soon as its products on it
// are done, so the next tile's loads run under this tile's products and
// epilogue. Each pixel row
// is read from device memory once; the logits are stored from registers,
// in pairs where K is even, with guards: rows of 150 bf16 are 300 bytes,
// no multiple of 16, so TMA cannot store them. The reference's rounding
// point bf16(xn) . bf16(tn) is kept. fp32 pixels in this mode (and C that
// does not fit) take a simpler kernel: mma.sync m16n8k16 from a 128 x 160
// block tile, each 32-channel pixel chunk normalised and rounded as it is
// staged, each pixel row read twice (once for its norm).

#include "lseg_common.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace wg = lseg::wg;
namespace gm = lseg::gemm;

constexpr int THREADS = 256;  // the text launches and the SIMT tiles
constexpr int BN = 160;       // labels per block of the fp32 mode

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

// two consecutive values (8- or 4-byte aligned) as fp32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
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


// ---- compute_dtype = float32: SIMT FMAs on a TMA ring ----

constexpr int FM = 128;     // pixels per block
constexpr int FK = 32;      // channels per chunk
constexpr int FSTAGES = 3;  // ring depth
constexpr int T_BYTES = FK * BN * 4;  // a text chunk, 20 KB

template <typename T>
struct FSmem {
  T x[FSTAGES][FM * FK];         // pixel chunks as they lie: [row][c]
  float t[FSTAGES][FK * BN];     // text chunks: [c][label]
  float ss[2][FM];               // halves of each row's sum of squares
  uint64_t full[FSTAGES];
};

// acc[i][.] += x[ty + 16 i][kq + kk] * t[kq + kk][labels] for kk < 2: the
// labels of thread tx are 2 tx + 32 j + {0, 1}, j < 5 (accumulator
// columns 2 j and 2 j + 1); 8 + 10 shared loads feed 160 FMAs
template <typename T>
__device__ __forceinline__ void products(float (&acc)[8][10], const T* xs,
                                         const float* ts, int kq, int tx,
                                         int ty) {
  float2 a[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = load2(xs + (ty + 16 * i) * FK + kq);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    float2 b[5];
#pragma unroll
    for (int j = 0; j < 5; ++j)
      b[j] = *reinterpret_cast<const float2*>(ts + (kq + kk) * BN + 2 * tx +
                                              32 * j);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float av = kk ? a[i].y : a[i].x;
#pragma unroll
      for (int j = 0; j < 5; ++j) {
        acc[i][2 * j] = fmaf(av, b[j].x, acc[i][2 * j]);
        acc[i][2 * j + 1] = fmaf(av, b[j].y, acc[i][2 * j + 1]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) fused_correlate_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_t, float* __restrict__ out,
    int M, int C, int K, float scale) {
  constexpr int X_BYTES = FM * FK * static_cast<int>(sizeof(T));
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  FSmem<T>& sm = *reinterpret_cast<FSmem<T>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // labels 2 tx + 32 j + {0, 1}, j < 5
  const int ty = tid / 16;  // pixels ty + 16 i, i < 8
  const int m0 = blockIdx.x * FM;
  const int k0 = blockIdx.y * BN;
  const int n_c = C / FK;

  auto issue = [&](int c) {
    const int s = c % FSTAGES;
    wg::bar_expect_tx(&sm.full[s], X_BYTES + T_BYTES);
    gm::tma_load_2d(sm.x[s], &map_x, &sm.full[s], c * FK, m0);
    gm::tma_load_2d(sm.t[s], &map_t, &sm.full[s], k0, c * FK);
  };
  if (tid == 0) {
    for (int s = 0; s < FSTAGES; ++s) wg::bar_init(&sm.full[s], 1);
    wg::bar_init_fence();
    for (int c = 0; c < FSTAGES && c < n_c; ++c) issue(c);
  }
  __syncthreads();

  // sums of squares: row nr, half `part` of each chunk
  const int nr = tid % FM, part = tid / FM;
  float ss = 0.0f;
  float acc[8][10];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 10; ++j) acc[i][j] = 0.0f;

  for (int c = 0; c < n_c; ++c) {
    const int s = c % FSTAGES;
    wg::bar_wait(&sm.full[s], (c / FSTAGES) & 1);
    const T* xs = sm.x[s];
    const float* ts = sm.t[s];
    // each row's half-chunk from a rotated start, so the column reads of
    // 32 consecutive rows spread over the banks (2-way conflicts at most
    // for fp32, 4-way for bf16 pairs)
#pragma unroll
    for (int j = 0; j < FK / 4; ++j) {
      const int col = part * (FK / 2) + 2 * ((j + nr) % (FK / 4));
      const float2 v = load2(xs + nr * FK + col);
      ss = fmaf(v.x, v.x, ss);
      ss = fmaf(v.y, v.y, ss);
    }
    // not unrolled, which keeps the kernel within 128 registers (two
    // blocks an SM) unspilled
#pragma unroll 1
    for (int kq = 0; kq < FK; kq += 2) products(acc, xs, ts, kq, tx, ty);
    __syncthreads();  // every thread is done with stage s: refill it
    if (tid == 0 && c + FSTAGES < n_c) issue(c + FSTAGES);
  }
  sm.ss[part][nr] = ss;
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = ty + 16 * i;
    const int m = m0 + r;
    if (m >= M) continue;
    const float inv = rsqrtf(fmaxf(sm.ss[0][r] + sm.ss[1][r], 1e-24f));
    float* op = out + static_cast<long long>(m) * K;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int k = k0 + 2 * tx + 32 * j;
      const float v0 = __fmul_rn(scale, __fmul_rn(inv, acc[i][2 * j]));
      const float v1 = __fmul_rn(scale, __fmul_rn(inv, acc[i][2 * j + 1]));
      if (k + 1 < K && (K % 2) == 0) {
        *reinterpret_cast<float2*>(op + k) = make_float2(v0, v1);
      } else {
        if (k < K) op[k] = v0;
        if (k + 1 < K) op[k + 1] = v1;
      }
    }
  }
}

// ---- compute_dtype = bfloat16 ----

constexpr int HM = 128;       // pixels per block of the mma.sync kernel
constexpr int HK = 32;        // channels per staged chunk
constexpr int HLD = HK + 8;   // bf16 row stride of the staged tiles

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


// -- bf16 pixels: wgmma against the resident text (wgmma_gemm.cuh) --

constexpr int CM = 64;          // pixels per tile
constexpr int CN = 152;         // labels per block
constexpr int CK = 64;          // channels per chunk: one 128-byte row
constexpr int MAX_CHUNKS = 8;   // C <= 512
constexpr int SLOTS = 9;        // one tile's chunks and one more
constexpr int SLOT_BYTES = CM * CK * 2;       // 8 KB
constexpr int TEXT_CHUNK_BYTES = CN * CK * 2;  // 19 KB
constexpr int CORR_CONSUMERS = 256;  // two warpgroups; a producer warp

struct CorrSmem {
  __nv_bfloat16 text[MAX_CHUNKS][CN * CK];
  __nv_bfloat16 slot[SLOTS][CM * CK];
  float ssq[2][CM];  // halves of each row's sum of squares
  gm::Ring<SLOTS> ring;
  uint64_t text_bar;
};
constexpr int CORR_SMEM = sizeof(CorrSmem) + 1024;  // + alignment slack

// The consumer side: warpgroup 0 takes labels [0, 80) of the block's 152,
// warpgroup 1 labels [80, 152), against every tile's 64 pixels.
template <int NW, int COL>
__device__ __forceinline__ void correlate_tiles(
    CorrSmem& sm, __nv_bfloat16* __restrict__ out, int M, int K, int k0,
    int n_chunks, int n_tiles, float scale) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wtid = tid % 128, wwarp = wtid / 32;
  const int g = lane / 4, t4 = lane % 4;
  // the norm: four threads a row (lanes l and l + 16 of warps w and
  // w + 4), each taking two of the eight 16-byte units of every chunk, so
  // the 8 threads of a shared-memory phase read 8 distinct swizzled units
  constexpr int UNITS = 2;
  const int nrow = (warp % 4) * 16 + (lane & 15);
  const int part = (warp / 4) * 2 + (lane >> 4);
  wg::bar_wait(&sm.text_bar, 0);
  uint32_t it = 0;
  float acc[NW / 8][4];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float ssq = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = sm.ring.wait(it + c);
      const uint8_t* row = reinterpret_cast<const uint8_t*>(sm.slot[s]) +
                           nrow * 128;
#pragma unroll
      for (int u = UNITS * part; u < UNITS * part + UNITS; ++u) {
        float v[8];
        lseg::unpack8(*reinterpret_cast<const uint4*>(
                          row + 16 * (u ^ (nrow & 7))), v);
#pragma unroll
        for (int e = 0; e < 8; ++e) ssq = fmaf(v[e], v[e], ssq);
      }
    }
    ssq += __shfl_xor_sync(0xffffffffu, ssq, 16);
    if (lane < 16) sm.ssq[warp / 4][nrow] = ssq;
    wg::named_sync(1, CORR_CONSUMERS);
    ssq = sm.ssq[0][nrow] + sm.ssq[1][nrow];
    const float inv = rsqrtf(fmaxf(ssq, 1e-24f));
    for (int c = 0; c < n_chunks; ++c) {
      uint8_t* row = reinterpret_cast<uint8_t*>(
                         sm.slot[(it + c) % SLOTS]) + nrow * 128;
#pragma unroll
      for (int u = UNITS * part; u < UNITS * part + UNITS; ++u) {
        uint4* p = reinterpret_cast<uint4*>(row + 16 * (u ^ (nrow & 7)));
        float v[8];
        lseg::unpack8(*p, v);
        uint4 w;
        w.x = lseg::pack_f32(__fmul_rn(v[0], inv), __fmul_rn(v[1], inv));
        w.y = lseg::pack_f32(__fmul_rn(v[2], inv), __fmul_rn(v[3], inv));
        w.z = lseg::pack_f32(__fmul_rn(v[4], inv), __fmul_rn(v[5], inv));
        w.w = lseg::pack_f32(__fmul_rn(v[6], inv), __fmul_rn(v[7], inv));
        *p = w;
      }
    }
    gm::fence_proxy_async();  // the bf16(x * r) writes before wgmma reads
    wg::named_sync(1, CORR_CONSUMERS);

    gm::zero(acc);
    gm::fence_acc(acc);
    wg::fence();
    for (int c = 0; c < n_chunks; ++c) {
      gm::mma_chunk<NW, 0>(acc, wg::desc(sm.slot[(it + c) % SLOTS]),
                           wg::desc(sm.text[c] + COL * CK));
      wg::commit();
    }
    // hand each slot back as soon as the products that read it are done
    for (int c = 0; c < n_chunks; ++c) {
      gm::wait_dyn(n_chunks - 1 - c);
      if (wtid == 0) sm.ring.release(it + c);
    }
    gm::fence_acc(acc);
    it += n_chunks;

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = tile * CM + wwarp * 16 + g + 8 * h;
      if (m >= M) continue;
      __nv_bfloat16* op = out + static_cast<long long>(m) * K;
#pragma unroll
      for (int nt = 0; nt < NW / 8; ++nt) {
        const int k = k0 + COL + nt * 8 + 2 * t4;
        const float v0 = __fmul_rn(scale, acc[nt][2 * h]);
        const float v1 = __fmul_rn(scale, acc[nt][2 * h + 1]);
        if (k + 1 < K && (K % 2) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(op + k) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (k < K) op[k] = __float2bfloat16_rn(v0);
          if (k + 1 < K) op[k + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(CORR_CONSUMERS + 32, 1)
    fused_correlate_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                                 const __grid_constant__ CUtensorMap map_t,
                                 __nv_bfloat16* __restrict__ out, int M,
                                 int C, int K, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  CorrSmem& sm = *reinterpret_cast<CorrSmem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int n_chunks = C / CK;
  const int k0 = blockIdx.y * CN;
  const int n_tiles = (M + CM - 1) / CM;

  if (tid == 0) {
    sm.ring.init(2);
    wg::bar_init(&sm.text_bar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();

  if (tid >= CORR_CONSUMERS) {  // the producer warp
    if (tid == CORR_CONSUMERS) {
      wg::bar_expect_tx(&sm.text_bar, n_chunks * TEXT_CHUNK_BYTES);
      for (int c = 0; c < n_chunks; ++c)
        gm::tma_load_2d(sm.text[c], &map_t, &sm.text_bar, c * CK, k0);
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        for (int c = 0; c < n_chunks; ++c, ++it) {
          const int s = sm.ring.acquire(it, SLOT_BYTES);
          gm::tma_load_2d(sm.slot[s], &map_x, &sm.ring.full[s], c * CK,
                          tile * CM);
        }
    }
    return;
  }
  if (tid < 128) {
    correlate_tiles<80, 0>(sm, out, M, K, k0, n_chunks, n_tiles, scale);
  } else {
    correlate_tiles<72, 80>(sm, out, M, K, k0, n_chunks, n_tiles, scale);
  }
}

// -- fp32 pixels (or C the resident text cannot hold): mma.sync --

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

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 132;
  }();
  return n;
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// x_bf16 selects the pixel dtype (1 bf16, 0 fp32), out_bf16 the mode: 0
// the fp32 product and logits, with tn the wrapper's (C, kp) fp32 scratch
// and kp a multiple of 160; 1 compute_dtype = bfloat16, with tn a (kp, C)
// bf16 scratch and bf16 logits, kp a multiple of 152 for bf16 pixels with
// c % 64 == 0 and c <= 512 (the wgmma kernel), else of 160. Requires
// c % 32 == 0 and 16-byte aligned tensors (checked by the wrapper).
extern "C" int lseg_fused_correlate(const void* x, const void* t, void* tn,
                                    void* out, int m, int c, int k, int kp,
                                    int x_bf16, int out_bf16, float scale,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int text_blocks = (kp * 32 + THREADS - 1) / THREADS;
  int rc;
  if (out_bf16) {
    const bool engine = x_bf16 && c % CK == 0 && c <= MAX_CHUNKS * CK;
    if (kp % (engine ? CN : BN) != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    normalize_text_bf16_kernel<<<text_blocks, THREADS, 0, s>>>(
        static_cast<const float*>(t), static_cast<__nv_bfloat16*>(tn), k, kp,
        c);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
    const __nv_bfloat16* tb = static_cast<const __nv_bfloat16*>(tn);
    if (engine) {
      CUtensorMap map_x, map_t;
      rc = gm::make_map_2d(&map_x, x, 2, c, m, CK, CM, true);
      if (rc != 0) return rc;
      rc = gm::make_map_2d(&map_t, tn, 2, c, kp, CK, CN, true);
      if (rc != 0) return rc;
      const int tiles = (m + CM - 1) / CM;
      const dim3 grid(tiles < sm_count() ? tiles : sm_count(), kp / CN);
      static const int attr =
          wg::allow_smem(fused_correlate_wgmma_kernel, CORR_SMEM);
      if (attr != 0) return attr;
      fused_correlate_wgmma_kernel<<<grid, CORR_CONSUMERS + 32, CORR_SMEM,
                                     s>>>(map_x, map_t, o, m, c, k, scale);
    } else if (x_bf16) {
      const dim3 grid((m + HM - 1) / HM, kp / BN);
      fused_correlate_bf16_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), tb, o, m, c, k, scale);
    } else {
      const dim3 grid((m + HM - 1) / HM, kp / BN);
      fused_correlate_bf16_kernel<float><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(x), tb, o, m, c, k, scale);
    }
    return static_cast<int>(cudaGetLastError());
  }
  if (kp % BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  normalize_text_kernel<<<text_blocks, THREADS, 0, s>>>(
      static_cast<const float*>(t), static_cast<float*>(tn), k, kp, c);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  CUtensorMap map_x, map_t;
  rc = gm::make_map_2d(&map_x, x, x_bf16 ? 2 : 4, c, m, FK, FM, false);
  if (rc != 0) return rc;
  rc = gm::make_map_2d(&map_t, tn, 4, kp, c, BN, FK, false);
  if (rc != 0) return rc;
  const dim3 grid((m + FM - 1) / FM, kp / BN);
  if (x_bf16) {
    constexpr int bytes = sizeof(FSmem<__nv_bfloat16>) + 1024;
    static const int attr =
        wg::allow_smem(fused_correlate_kernel<__nv_bfloat16>, bytes);
    if (attr != 0) return attr;
    fused_correlate_kernel<__nv_bfloat16><<<grid, THREADS, bytes, s>>>(
        map_x, map_t, static_cast<float*>(out), m, c, k, scale);
  } else {
    constexpr int bytes = sizeof(FSmem<float>) + 1024;
    static const int attr =
        wg::allow_smem(fused_correlate_kernel<float>, bytes);
    if (attr != 0) return attr;
    fused_correlate_kernel<float><<<grid, THREADS, bytes, s>>>(
        map_x, map_t, static_cast<float*>(out), m, c, k, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
