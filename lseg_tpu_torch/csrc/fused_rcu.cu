// Fused int8 ResidualConvUnit for Hopper (sm_90a), kernel B18.
//
// Replaces: lseg_tpu/ops/pallas_qconv.py · fused_rcu (Pallas TPU; body
// _rcu_kernel).
//
// Input: x (N, H, W, C) bf16; the int8 3x3 kernels w1, w2 as (C, 9C), K
// ordered (row, column, input channel) (ops/qconv.py · rcu_weight); the
// folded per-channel affines d1, e1, d2, e2 (C,) fp32 (ops/qconv.py ·
// fold_bn_affine); the fp32 scalar inverse activation scales s1_inv and
// s2_inv. Output (N, H, W, C) bf16:
//   q1  = clip(rint(max(x, 0) * s1_inv), +-127)     (0 outside the image)
//   h   = float(conv3x3(q1, w1)) * d1 + e1          (exact int32; no FMA)
//   q2  = clip(rint(max(h, 0) * s2_inv), +-127), and 0 outside the image:
//         conv2's own zero padding, NOT conv1 of the zero-padded border
//   out = bf16(float(conv3x3(q2, w2)) * d2 + e2 + x)
// Both int32 sums are exact, so the result is the plain twin's bit for bit
// whatever the tiling.
//
// What bounds it on the card: at refinenet1 ((8, 120, 120, 256)) the two
// convolutions are 2 x 9 x 256 x 256 x 2 x 115,200 = 272 GOP (0.137 ms at
// 1979 TOP/s), against 118 MB of x read and out written (0.035 ms at
// 3.35 TB/s): the operations bound it.
//
// Design. The TPU kernel keeps a full-width row band in VMEM; a band is
// beyond an SM's shared memory, so the image is cut into TR x TC output
// tiles (the wrapper picks them, `ops/qconv.py` · rcu_tile: TR TC <= 192,
// (TR + 2)(TC + 2) <= 256). One thread-block cluster of S = C / 64 CTAs
// takes a tile; CTA `rank` owns output channels 64 rank .. + 63 of both
// convolutions, so each CTA streams only its 64 rows of w1 and w2 and the
// small shapes (15 x 15 and 30 x 30, one and two tiles an image) still
// fill the card. Each CTA:
//   - stages q1 of the (TR + 4) x (TC + 4) halo into shared memory (all C
//     channels, C + 16 bytes a pixel so ldmatrix reads no bank twice),
//     zero outside the image: it reads and quantizes its own 64 channels
//     of x and writes their codes into every peer's tile too (DSM);
//   - conv1 over the (TR + 2) x (TC + 2) pixels that conv2 reads, as an
//     implicit GEMM: 4 m-blocks of 64 rows (two a consumer warpgroup,
//     padded rows repeat the last pixel and are dropped), 9C deep, the A
//     operand a shifted view of the q1 tile, loaded per k-step of 32 with
//     one ldmatrix.x4 a warp and m-block (each lane one pixel's row
//     address: no im2col buffer), the B operand the CTA's 64 rows of the
//     weight, 128 k-bytes a stage, by TMA (128-byte swizzle, K-major)
//     into an eight-stage mbarrier ring that one producer thread keeps
//     full; products on s8 wgmma m64n64k32 in the RS form (IGMMA, A from
//     registers, exact int32), two chunks' fragments loaded, their 16
//     products issued, then drained before the next loads (`conv`);
//   - requantizes its 64 channels of h into its q2 tile, then copies that
//     slice into every peer's q2 tile over distributed shared memory
//     (16-byte st.shared::cluster), and a cluster barrier makes every
//     CTA's q2 whole;
//   - conv2 the same way over the TR x TC outputs (3 m-blocks: two for the
//     first consumer warpgroup, one for the second), then the epilogue:
//     affine, residual x read from global, bf16 out, in the plain twin's
//     order of `_rn` steps.
// The weights' next conv's first stages load under conv1's epilogue and
// the exchange. Why RS and not three column-shifted copies of the tile in
// the SS layout: a copy of the q1 halo is 80 KB at C = 256, and three do
// not fit beside q2; with RS the tile is staged once and any tile shape
// works. Budgets: 219 KB of shared memory at C = 256 (one CTA an SM);
// setmaxnreg gives the producer warpgroup 40 registers, the consumers 232.

#include "cluster.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace wg = lseg::wg;
namespace gm = lseg::gemm;
namespace cl = lseg::cluster;

constexpr int NS = 64;                   // output channels a CTA owns
constexpr int BK = 128;                  // k bytes a ring stage
constexpr int STAGES = 8;
constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;  // producer + 2 consumers
constexpr int B_BYTES = NS * BK;         // 8 KB: 64 weight rows
constexpr int M1_ROWS = 256;             // conv1 rows: 4 m-blocks
constexpr int M2_ROWS = 192;             // conv2 rows: 3 m-blocks
constexpr int MAX_Q1 = 320;              // (TR + 4)(TC + 4) pixels at most

struct Smem {
  uint8_t ring[STAGES * B_BYTES];
  gm::Ring<STAGES> r;
  float d1[NS], e1[NS], d2[NS], e2[NS];
};
// the q1 and q2 tiles follow `Smem`, 16-byte aligned
constexpr int SMEM_FIXED = (sizeof(Smem) + 15) / 16 * 16;

template <int C>
constexpr int smem_bytes() {
  return SMEM_FIXED + (MAX_Q1 + M1_ROWS) * (C + 16) + 1024;
}

__device__ __forceinline__ uint32_t code(float v, float inv) {
  const float r = rintf(__fmul_rn(v, inv));
  return static_cast<uint32_t>(static_cast<int>(
             fminf(fmaxf(r, -127.0f), 127.0f))) & 0xffu;
}

// The A fragments of ring chunk kc (four k-steps of 32, fewer where 9C is
// not a multiple of 128) for each of MB m-blocks: `abase` is this lane's
// pixel row of the m-block (tap (0, 0), k-byte 16 (lane / 16)), a tap
// (dy, dx) is dy rows of `cols` pixels and dx pixels further.
template <int C, int MB>
__device__ __forceinline__ void load_a(uint32_t (&af)[4][MB][4],
                                       const uint32_t (&abase)[MB], int cols,
                                       int kc) {
  constexpr int LD = C + 16;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int step = kc * 4 + kk;
    if (step >= 9 * C / 32) break;
    const int tap = step * 32 / C, ch = step * 32 % C;
    const uint32_t off = ((tap / 3) * cols + tap % 3) * LD + ch;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) gm::ldsm_x4(af[kk][mb], abase[mb] + off);
  }
}

// The products of ring chunk kc from stage s.
template <int C, int MB>
__device__ __forceinline__ void mma_chunk(const Smem& sm,
                                          int (&acc)[MB][8][4],
                                          const uint32_t (&af)[4][MB][4],
                                          int s, int kc) {
  const uint64_t db = wg::desc(sm.ring + s * B_BYTES);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kc * 4 + kk >= 9 * C / 32) break;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
      gm::MmaS8<NS>::rs(acc[mb], af[kk][mb], wg::desc_kstep(db, kk), 1);
  }
}

// A whole convolution (ring iterations it0 .. it0 + NK - 1) into acc, two
// ring chunks at a time: wait for both weight slices, load both chunks' A
// fragments, issue their products and wait for all of them. A register
// that wgmma reads may not be rewritten while any product is in flight
// (ptxas serializes every product otherwise), so the loads of the next
// pair wait; the other consumer warpgroup's products fill the gap. The
// loop is unrolled whole, so every branch is settled at compile time.
template <int C, int MB>
__device__ __forceinline__ void conv(Smem& sm, int (&acc)[MB][8][4],
                                     const uint32_t (&abase)[MB], int cols,
                                     uint32_t it0, int tid) {
  constexpr int NK = (9 * C + BK - 1) / BK;
  uint32_t af[2][4][MB][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) gm::zero(acc[mb]);
#pragma unroll
  for (int kc = 0; kc < NK; kc += 2) {
    const bool two = kc + 1 < NK;
    const int s0 = sm.r.wait(it0 + kc);
    const int s1 = two ? sm.r.wait(it0 + kc + 1) : 0;
    load_a<C, MB>(af[0], abase, cols, kc);
    if (two) load_a<C, MB>(af[1], abase, cols, kc + 1);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) gm::fence_acc(acc[mb]);
    wg::fence();
    mma_chunk<C, MB>(sm, acc, af[0], s0, kc);
    if (two) mma_chunk<C, MB>(sm, acc, af[1], s1, kc + 1);
    wg::commit();
    wg::wait<0>();
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) gm::fence_acc(acc[mb]);
    if (tid == 0) {
      sm.r.release(it0 + kc);
      if (two) sm.r.release(it0 + kc + 1);
    }
  }
}

struct Args {
  const __nv_bfloat16* x;
  const float* d1;
  const float* e1;
  const float* d2;
  const float* e2;
  const float* s1_inv;
  const float* s2_inv;
  __nv_bfloat16* out;
  int H, W, TR, TC;
};

// conv1's epilogue for this warpgroup's m-blocks: q2 codes of the CTA's
// 64 channels at the conv1 pixels (0 outside the image), into the local
// q2 tile.
__device__ __forceinline__ void conv1_epilogue(const Args& a, const Smem& sm,
                                               int8_t* q2s, int ld,
                                               const int (&acc)[2][8][4],
                                               int c, int ch0, int r0, int c0,
                                               float s2_inv) {
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int q2c = a.TC + 2, m1 = (a.TR + 2) * q2c;
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 64 * (2 * c + b) + 16 * warp + g + 8 * h;
      if (m >= m1) continue;
      const int rr = r0 - 1 + m / q2c, cc = c0 - 1 + m % q2c;
      const bool inside = rr >= 0 && rr < a.H && cc >= 0 && cc < a.W;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        uint32_t q = 0u;
        if (inside) {
          const float h0 = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[b][nt][2 * h]), sm.d1[col]),
              sm.e1[col]);
          const float h1 = __fadd_rn(
              __fmul_rn(__int2float_rn(acc[b][nt][2 * h + 1]),
                        sm.d1[col + 1]),
              sm.e1[col + 1]);
          q = code(fmaxf(h0, 0.0f), s2_inv) |
              (code(fmaxf(h1, 0.0f), s2_inv) << 8);
        }
        *reinterpret_cast<uint16_t*>(q2s + m * ld + ch0 + col) =
            static_cast<uint16_t>(q);
      }
    }
}

// conv2's epilogue for MB m-blocks from m-block mb0: affine, residual,
// bf16 out.
template <int MB>
__device__ __forceinline__ void conv2_epilogue(const Args& a, const Smem& sm,
                                               const int (&acc)[MB][8][4],
                                               int mb0, int C, int ch0,
                                               int r0, int c0,
                                               long long img) {
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int m2 = a.TR * a.TC;
#pragma unroll
  for (int b = 0; b < MB; ++b)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = 64 * (mb0 + b) + 16 * warp + g + 8 * h;
      if (m >= m2) continue;
      const int rr = r0 + m / a.TC, cc = c0 + m % a.TC;
      if (rr >= a.H || cc >= a.W) continue;
      const long long px = (img + static_cast<long long>(rr) * a.W + cc) * C;
      // the row's residuals first, all in flight together (x and out may
      // alias for the compiler, which would wait out each load)
      __nv_bfloat162 xr[8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        xr[nt] = __ldg(reinterpret_cast<const __nv_bfloat162*>(
            a.x + px + ch0 + nt * 8 + 2 * t4));
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = nt * 8 + 2 * t4;
        const long long off = px + ch0 + col;
        const float2 res = __bfloat1622float2(xr[nt]);
        const float y0 = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[b][nt][2 * h]), sm.d2[col]),
            sm.e2[col]);
        const float y1 = __fadd_rn(
            __fmul_rn(__int2float_rn(acc[b][nt][2 * h + 1]), sm.d2[col + 1]),
            sm.e2[col + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.out + off) =
            __floats2bfloat162_rn(__fadd_rn(y0, res.x), __fadd_rn(y1, res.y));
      }
    }
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1) fused_rcu_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_w1,
    const __grid_constant__ CUtensorMap map_w2, Args a) {
  constexpr int S = C / NS;  // CTAs of the cluster
  constexpr int LD = C + 16;
  constexpr int NK = (9 * C + BK - 1) / BK;  // ring chunks a convolution
  constexpr int TOTAL = 2 * NK;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // aligned by an offset from the shared array itself, so the compiler
  // keeps every access of `sm` a shared-memory instruction
  uint8_t* base = smem_raw + ((1024 - wg::smem_addr(smem_raw) % 1024) % 1024);
  Smem& sm = *reinterpret_cast<Smem*>(base);
  int8_t* q1s = reinterpret_cast<int8_t*>(base + SMEM_FIXED);
  int8_t* q2s = q1s + MAX_Q1 * LD;

  const int rank = S > 1 ? cl::rank() : 0;
  const int ch0 = rank * NS;
  const int n = blockIdx.z;
  const int r0 = blockIdx.y * a.TR, c0 = (blockIdx.x / S) * a.TC;
  const int q1c = a.TC + 4, q2c = a.TC + 2;
  const long long img = static_cast<long long>(n) * a.H * a.W;
  const int wg_id = threadIdx.x / WG_THREADS;
  const int tid = threadIdx.x % WG_THREADS;

  // producer: ring iteration it is conv it / NK's chunk it % NK
  auto load_b = [&](uint32_t it) {
    const int s = sm.r.acquire(it, B_BYTES);
    gm::tma_load_2d(sm.ring + s * B_BYTES, it < NK ? &map_w1 : &map_w2,
                    &sm.r.full[s], (it % NK) * BK, ch0);
  };

  const float s1_inv = *a.s1_inv;
  if (threadIdx.x == 0) sm.r.init(2);
  if (threadIdx.x < NS) {
    sm.d1[threadIdx.x] = a.d1[ch0 + threadIdx.x];
    sm.e1[threadIdx.x] = a.e1[ch0 + threadIdx.x];
    sm.d2[threadIdx.x] = a.d2[ch0 + threadIdx.x];
    sm.e2[threadIdx.x] = a.e2[ch0 + threadIdx.x];
  }
  cl::sync();  // the barriers are set and every CTA of the cluster runs
  if (threadIdx.x == 0)
    for (int it = 0; it < STAGES && it < TOTAL; ++it) load_b(it);

  // q1: relu + quantize of the (TR + 4) x (TC + 4) halo, 0 outside. Each
  // CTA of the cluster reads its 64 channels of x (each thread keeping
  // Q1_LOADS 16-byte loads in flight) and writes their codes into its own
  // q1 tile and every peer's: read whole by every CTA, x took a quarter
  // of a CTA's time
  {
    constexpr int Q1_LOADS = 8;
    constexpr int groups = NS / 8;
    const int total = (a.TR + 4) * q1c * groups;
    for (int i0 = threadIdx.x; i0 < total; i0 += THREADS * Q1_LOADS) {
      uint4 raw[Q1_LOADS];
#pragma unroll
      for (int u = 0; u < Q1_LOADS; ++u) {
        const int i = i0 + u * THREADS;
        const int pix = i / groups, cg = (i % groups) * 8;
        const int rr = r0 - 2 + pix / q1c, cc = c0 - 2 + pix % q1c;
        raw[u] = make_uint4(0u, 0u, 0u, 0u);
        if (i < total && rr >= 0 && rr < a.H && cc >= 0 && cc < a.W)
          raw[u] = __ldg(reinterpret_cast<const uint4*>(
              a.x + (img + static_cast<long long>(rr) * a.W + cc) * C +
              ch0 + cg));
      }
#pragma unroll
      for (int u = 0; u < Q1_LOADS; ++u) {
        const int i = i0 + u * THREADS;
        if (i >= total) break;
        float v[8];
        lseg::unpack8(raw[u], v);
        uint32_t q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) q[k] = code(fmaxf(v[k], 0.0f), s1_inv);
        int8_t* dst = q1s + (i / groups) * LD + ch0 + (i % groups) * 8;
        const uint32_t lo = q[0] | (q[1] << 8) | (q[2] << 16) | (q[3] << 24);
        const uint32_t hi = q[4] | (q[5] << 8) | (q[6] << 16) | (q[7] << 24);
        *reinterpret_cast<uint2*>(dst) = make_uint2(lo, hi);
#pragma unroll
        for (int peer = 0; peer < S; ++peer)
          if (peer != rank) cl::st_peer(cl::peer_addr(dst, peer), lo, hi);
      }
    }
  }
  cl::sync();  // every CTA's q1 is whole

  if (wg_id == 0) {
    gm::regs_dec<40>();
    // conv1's chunks and conv2's first STAGES: each waits only on a
    // conv1 stage, which the consumers free before the exchange
    if (tid == 0)
      for (int it = STAGES; it < NK + STAGES && it < TOTAL; ++it) load_b(it);
    __syncwarp();
    cl::sync();  // the q2 slices are exchanged
    if (tid == 0)
      for (int it = NK + STAGES; it < TOTAL; ++it) load_b(it);
    return;
  }

  gm::regs_inc<232>();
  const int c = wg_id - 1;  // this consumer warpgroup
  const int warp = tid / 32, lane = tid % 32;
  // this lane's row of an m-block's ldmatrix, and its k-byte offset
  const int lrow = 16 * warp + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t kb = (lane >> 4) * 16;

  // ---- conv1: m-blocks 2c and 2c + 1 of the (TR + 2) x (TC + 2) pixels
  {
    const int m1 = (a.TR + 2) * q2c;
    uint32_t abase[2];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int m = min(64 * (2 * c + b) + lrow, m1 - 1);
      abase[b] = wg::smem_addr(q1s) + ((m / q2c) * q1c + m % q2c) * LD + kb;
    }
    int acc[2][8][4];
    conv<C, 2>(sm, acc, abase, q1c, 0, tid);
    conv1_epilogue(a, sm, q2s, LD, acc, c, ch0, r0, c0, *a.s2_inv);
  }
  // this warpgroup's q2 rows, this CTA's 64 channels, into every peer
  wg::named_sync(1 + c, WG_THREADS);
  if (S > 1) {
    const int m1 = (a.TR + 2) * q2c;
    const int lo = 128 * c, hi = min(lo + 128, m1);
    for (int i = tid; i < (hi - lo) * (NS / 16); i += WG_THREADS) {
      const int8_t* p = q2s + (lo + i / (NS / 16)) * LD + ch0 +
                        16 * (i % (NS / 16));
      const uint4 v = *reinterpret_cast<const uint4*>(p);
#pragma unroll
      for (int peer = 0; peer < S; ++peer)
        if (peer != rank) cl::st_peer(cl::peer_addr(p, peer), v);
    }
  }
  cl::sync();  // the q2 slices are exchanged

  // ---- conv2 over the TR x TC outputs: m-blocks 0, 1 and 2
  const int m2 = a.TR * a.TC;
  auto abase2 = [&](int mb) {
    const int m = min(64 * mb + lrow, m2 - 1);
    return wg::smem_addr(q2s) + ((m / a.TC) * q2c + m % a.TC) * LD + kb;
  };
  if (c == 0) {
    const uint32_t abase[2] = {abase2(0), abase2(1)};
    int acc[2][8][4];
    conv<C, 2>(sm, acc, abase, q2c, NK, tid);
    conv2_epilogue<2>(a, sm, acc, 0, C, ch0, r0, c0, img);
  } else {
    const uint32_t abase[1] = {abase2(2)};
    int acc[1][8][4];
    conv<C, 1>(sm, acc, abase, q2c, NK, tid);
    conv2_epilogue<1>(a, sm, acc, 2, C, ch0, r0, c0, img);
  }
}

template <int C>
int launch(const void* w1, const void* w2, const Args& a, int n,
           cudaStream_t st) {
  static const int attr =
      wg::allow_smem(fused_rcu_wgmma_kernel<C>, smem_bytes<C>());
  if (attr != 0) return attr;
  CUtensorMap map_w1, map_w2;
  int rc = gm::make_map_2d(&map_w1, w1, 1, 9 * C, C, BK, NS, true);
  if (rc == 0) rc = gm::make_map_2d(&map_w2, w2, 1, 9 * C, C, BK, NS, true);
  if (rc != 0) return rc;
  const dim3 grid(C / NS * ((a.W + a.TC - 1) / a.TC),
                  (a.H + a.TR - 1) / a.TR, n);
  cl::Launch l(grid, THREADS, smem_bytes<C>(), C / NS, st);
  const cudaError_t e = cudaLaunchKernelEx(&l.cfg, fused_rcu_wgmma_kernel<C>,
                                           map_w1, map_w2, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the launch's error code (0 on success).
// Requires C in {64, 128, 256}, tr tc <= 192, (tr + 2)(tc + 2) <= 256,
// (tr + 4)(tc + 4) <= 320 and 16-byte aligned tensors (the wrapper checks
// them and picks the tile).
extern "C" int lseg_fused_rcu(const void* x, const void* w1, const void* d1,
                              const void* e1, const void* s1_inv,
                              const void* w2, const void* d2, const void* e2,
                              const void* s2_inv, void* out, int n, int h,
                              int w, int c, int tr, int tc, void* stream) {
  if (tr < 1 || tc < 1 || tr * tc > M2_ROWS ||
      (tr + 2) * (tc + 2) > M1_ROWS || (tr + 4) * (tc + 4) > MAX_Q1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const __nv_bfloat16*>(x),
               static_cast<const float*>(d1), static_cast<const float*>(e1),
               static_cast<const float*>(d2), static_cast<const float*>(e2),
               static_cast<const float*>(s1_inv),
               static_cast<const float*>(s2_inv),
               static_cast<__nv_bfloat16*>(out), h, w, tr, tc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (c) {
    case 64: return launch<64>(w1, w2, a, n, st);
    case 128: return launch<128>(w1, w2, a, n, st);
    case 256: return launch<256>(w1, w2, a, n, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
