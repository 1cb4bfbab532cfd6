// Fused int8 transformer MLP for Hopper (sm_90a), kernel B16.
//
// Replaces: lseg_tpu/ops/pallas_mlp.py · mlp_fused (Pallas TPU; body
// _kernel).
//
// Input: the per-row int8 codes xq (M, D) of the LayerNorm-2 output and
// their fp32 row scales sx (M,), the bf16 residual stream (M, D), the int8
// fc1 weight (H, D) and fc2 weight (D, H) (the port's (out, in) storage),
// their fp32 per-output-channel scales and biases. Output: resid + mlp(x),
// (M, D) bf16. M = N * T rows; any M.
//
// Rounding points, in order, as in the TPU kernel:
//   1. acc1 = xq . w1^T exact in int32; h = ((acc1 * sx) * s1) + b1 in fp32
//      (no FMA contraction);
//   2. the tanh GELU of h in fp32 (tanhf, not tanh.approx), with no bf16
//      rounding before it;
//   3. per row, sh = max(max|gelu(h)| over all H, 1e-8) / 127 and codes
//      round-half-even(g / sh) clipped to +-127, a true IEEE division;
//   4. acc2 = hq . w2^T exact in int32; y = ((acc2 * sh) * s2) + b2;
//   5. out = bf16(y + resid) in fp32.
//
// What bounds it on the card: at the flagship (8 x 901 rows, D = 1024,
// H = 4096) the two int8 products are 2 x 30.2 G MAC (121 GOP, ~0.061 ms
// at 1979 TOP/s) against ~45 MB of codes, weights, residual and output
// (~0.013 ms at 3.35 TB/s): the operations bound it.
//
// Design: one launch, a thread-block cluster per 64-row tile, the hidden
// kept on chip as the TPU kernel keeps it in VMEM. The requantize needs
// each row's amax over all H hidden values before fc2 can start, and a
// 64-row fp32 hidden tile (1 MB at H = 4096) fits no SM. So the cluster's
// C = D / 128 CTAs (8 at ViT-L/16, 6 at ViT-B) each own H / C = 512
// hidden columns and D / C = 128 output columns, and share the row maxima
// and the codes through distributed shared memory (DSM, cluster.cuh):
//   fc1: a producer warpgroup keeps a three-stage TMA ring of 128-deep
//     k-chunks full (xq's 64 x 128 box and w1's 512 rows, 72 KB a stage,
//     128-byte swizzle); two consumer warpgroups each run s8 warpgroup
//     products m64n256k32 (IGMMA, exact int32) on 256 of the columns, 128
//     accumulators a thread;
//   epilogue in registers: ((acc * sx) * s1) + b1 and the GELU in fp32,
//     each g left in its accumulator register; each CTA reduces its
//     slice's row maxima and stores them into every peer's shared memory
//     (st.shared::cluster at mapa addresses), then a cluster barrier
//     (release / acquire). Each CTA takes the maximum of the C partials:
//     max is exact and order-free, so sh is bit-identical to one taken
//     over the whole row;
//   quantize the CTA's slice from registers into its shared memory (64 x
//     512 codes, 32 KB, as four 128-byte swizzled k-chunks, in the fc1
//     ring's last 72 KB), then a second cluster barrier;
//   fc2: each CTA sums its 64 x 128 outputs over all K = H. The fc2 ring
//     (six 24 KB stages in the fc1 ring's first 144 KB; its first w2
//     boxes load under the GELU) takes w2's 128 x 128 box by TMA and the
//     matching 64 x 128 chunk of codes, copied verbatim (the swizzle is
//     the same in both CTAs) from the owner's shared memory by the
//     producer warpgroup (ld.shared::cluster), since wgmma reads only
//     this CTA's shared memory. Each of its warps copies every fourth
//     chunk, so four peer round trips are in flight: copied by the whole
//     warpgroup, chunk after chunk, the chunks arrived a round trip
//     (~0.6 us) apart. Each CTA starts at its own chunks, so the cluster
//     reads from different peers at a time. The consumers run m64n64k32
//     on their 64 output columns. Gathering the codes rather than
//     splitting K over the slices: both move 7/8 of 256 KB a CTA through DSM, but the gather
//     reduces nothing across CTAs and feeds a plain ring. Either order of
//     the int32 sums is exact;
//   epilogue: ((acc2 * sh) * s2) + b2 + resid, one cast to bf16, stored
//     from registers; rows past M (TMA zero-fills them) are not stored;
//   a last cluster barrier keeps every CTA's codes alive until its peers
//     have read them.
// The hidden, fp32 or int8, never touches device memory, and fc1 runs
// once. Where the time goes (PERF.md, from the phase timeline of
// `engine/variant_tree.py`): a CTA spends about as long on the GELU and
// the requantize (128 tanhf and 128 IEEE divisions a thread) as on fc1
// and fc2 together, and the card holds 15 clusters of 8, so 113 row tiles
// take 7.5 waves. Budgets: 225 KB of shared memory a CTA (one CTA an SM);
// setmaxnreg gives the producer warpgroup 88 registers and the consumers
// 208.

#include "cluster.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace wg = lseg::wg;
namespace gm = lseg::gemm;
namespace cl = lseg::cluster;
using cl::ld_peer;
using cl::peer_addr;
using cl::st_peer;

constexpr int BM = 64;          // rows of a cluster's tile
constexpr int BK = 128;         // k a stage: one 128-byte swizzle row
constexpr int HC = 512;         // hidden columns a CTA owns
constexpr int DC = 128;         // output columns a CTA owns
constexpr int MAX_CLUSTER = 8;  // the portable cluster size: D <= 1024
constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;  // producer + 2 consumers
constexpr int S1 = 3;                    // fc1 stages
constexpr int S2 = 6;                    // fc2 stages
constexpr int A_BYTES = BM * BK;         // 8 KB: 64 rows of codes
constexpr int W1_BYTES = HC * BK;        // 64 KB: w1's 512 rows
constexpr int W2_BYTES = DC * BK;        // 16 KB: w2's 128 rows
constexpr int STAGE1 = A_BYTES + W1_BYTES;
constexpr int STAGE2 = A_BYTES + W2_BYTES;
constexpr int CHUNKS = HC / BK;  // fc2 k-chunks a CTA's codes hold
// fc1's stages, then fc2's stages and this CTA's codes in the same bytes
constexpr int CODES = S2 * STAGE2;  // offset of the codes in the ring
constexpr int RING = S1 * STAGE1 > CODES + BM * HC ? S1 * STAGE1
                                                   : CODES + BM * HC;

struct Smem {
  uint8_t ring[RING];  // the codes: CHUNKS chunks from ring + CODES
  float amax[MAX_CLUSTER][BM];  // each CTA's row maxima, by its rank
  float wmax[2][BM];            // each consumer warpgroup's row maxima
  float s1[HC], b1[HC], s2[DC], b2[DC], sx[BM];
  gm::Ring<S1> r1;
  gm::Ring<S2> r2;
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + alignment slack

// tanh GELU as PyTorch writes it, each step rounded on its own
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float cube = __fmul_rn(__fmul_rn(x, x), x);
  const float inner = __fmul_rn(kBeta, __fadd_rn(x, __fmul_rn(kKappa, cube)));
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, tanhf(inner)));
}

// ---- the kernel -------------------------------------------------------------

// One CTA of the cluster of a 64-row tile: warpgroup 0 the producer (one
// thread issues every TMA load; all of it copies the peers' codes for
// fc2), warpgroups 1 and 2 the consumers of 256 hidden and 64 output
// columns each.
__global__ void __launch_bounds__(THREADS, 1) mlp_fused_cluster_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w1,
    const __grid_constant__ CUtensorMap map_w2, const float* __restrict__ sx,
    const float* __restrict__ s1, const float* __restrict__ b1,
    const float* __restrict__ s2, const float* __restrict__ b2,
    const __nv_bfloat16* __restrict__ resid,
    __nv_bfloat16* __restrict__ out, int M, int D) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // aligned by an offset from the shared array itself, so the compiler
  // keeps every access of `sm` a shared-memory instruction
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - wg::smem_addr(smem_raw) % 1024) % 1024));
  const int C = D / DC;  // CTAs of the cluster
  const int rank = cl::rank();
  const int m0 = (blockIdx.x / C) * BM;
  const int h0 = rank * HC, d0 = rank * DC;
  const int n_k1 = D / BK;        // fc1 k-chunks
  const int n_k2 = C * CHUNKS;    // fc2 k-chunks over H
  const int wg_id = threadIdx.x / WG_THREADS;
  const int tid = threadIdx.x % WG_THREADS;
  // fc2 iteration it's k-chunk: each CTA starts at its own
  auto chunk2 = [&](int it) { return (CHUNKS * rank + it) % n_k2; };

  if (threadIdx.x == 0) {
    sm.r1.init(2);
    sm.r2.init(2, 2);  // the w2 box's bytes and one copier warp
  }
  cl::sync();  // the barriers are set and every CTA of the cluster runs

  if (wg_id == 0) {
    gm::regs_dec<88>();
    if (tid == 0) {
      for (int kc = 0; kc < n_k1; ++kc) {
        const int s = sm.r1.acquire(kc, STAGE1);
        uint8_t* st = sm.ring + s * STAGE1;
        gm::tma_load_2d(st, &map_x, &sm.r1.full[s], kc * BK, m0);
        for (int h = 0; h < 2; ++h)
          gm::tma_load_2d(st + A_BYTES + h * (W1_BYTES / 2), &map_w1,
                          &sm.r1.full[s], kc * BK, h0 + h * (HC / 2));
      }
      // fc2's ring takes fc1's memory once every fc1 stage is free; its
      // first w2 boxes load under fc1's epilogue
      for (int i = 0; i < S1; ++i) sm.r1.wait_free(n_k1 + i);
      for (int it = 0; it < S2 && it < n_k2; ++it) {
        const int s = sm.r2.acquire(it, W2_BYTES);
        gm::tma_load_2d(sm.ring + s * STAGE2 + A_BYTES, &map_w2,
                        &sm.r2.full[s], chunk2(it) * BK, d0);
      }
    }
    __syncwarp();
    cl::sync();  // the row maxima are exchanged
    cl::sync();  // the codes are written
    // each warp copies every fourth chunk, so four chunks' peer round
    // trips are in flight at once; a lane moves 256 bytes a chunk in one
    // round of sixteen 16-byte loads
    const int warp = tid / 32, lane = tid % 32;
    for (int it = warp; it < n_k2; it += WG_THREADS / 32) {
      const bool tma = lane == 0 && it >= S2;
      const int s = tma ? sm.r2.acquire(it, W2_BYTES) : sm.r2.wait_free(it);
      uint4* st = reinterpret_cast<uint4*>(sm.ring + s * STAGE2);
      const int c = chunk2(it);
      if (tma)
        gm::tma_load_2d(st + A_BYTES / 16, &map_w2, &sm.r2.full[s], c * BK,
                        d0);
      const uint32_t src =
          peer_addr(sm.ring + CODES + (c % CHUNKS) * A_BYTES, c / CHUNKS);
      uint4 v[A_BYTES / 16 / 32];
#pragma unroll
      for (int j = 0; j < A_BYTES / 16 / 32; ++j)
        v[j] = ld_peer(src + 16 * (lane + 32 * j));
#pragma unroll
      for (int j = 0; j < A_BYTES / 16 / 32; ++j) st[lane + 32 * j] = v[j];
      gm::fence_proxy_async();  // the copy's writes before wgmma reads
      __syncwarp();
      if (lane == 0) sm.r2.fill(it);
    }
    cl::sync();  // no CTA leaves while a peer may read its codes
    return;
  }

  gm::regs_inc<208>();
  const int c = wg_id - 1;  // this warpgroup's half of the columns
  for (int i = tid; i < HC / 2; i += WG_THREADS) {
    sm.s1[c * (HC / 2) + i] = s1[h0 + c * (HC / 2) + i];
    sm.b1[c * (HC / 2) + i] = b1[h0 + c * (HC / 2) + i];
  }
  if (tid < DC / 2) {
    sm.s2[c * (DC / 2) + tid] = s2[d0 + c * (DC / 2) + tid];
    sm.b2[c * (DC / 2) + tid] = b2[d0 + c * (DC / 2) + tid];
  }
  if (c == 0 && tid < BM) sm.sx[tid] = m0 + tid < M ? sx[m0 + tid] : 0.0f;
  wg::named_sync(1, 2 * WG_THREADS);  // the parameters are in place

  // ---- fc1: 64 rows x 256 hidden columns a warpgroup ----
  int acc[HC / 2 / 8][4];
  gm::zero(acc);
  for (int kc = 0; kc < n_k1; ++kc) {
    const int s = sm.r1.wait(kc);
    const uint8_t* st = sm.ring + s * STAGE1;
    gm::fence_acc(acc);
    wg::fence();
    const uint64_t da = wg::desc(st);
    const uint64_t db = wg::desc(st + A_BYTES + c * (W1_BYTES / 2));
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      gm::MmaS8<HC / 2>::ss(acc, wg::desc_kstep(da, kk),
                            wg::desc_kstep(db, kk), 1);
    wg::commit();
    wg::wait<1>();  // the previous chunk's products are complete
    gm::fence_acc(acc);
    if (kc > 0 && tid == 0) sm.r1.release(kc - 1);
  }
  wg::wait<0>();
  gm::fence_acc(acc);
  if (tid == 0) sm.r1.release(n_k1 - 1);

  // ---- dequant + GELU in registers, the slice's row maxima ----
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row[2] = {16 * warp + g, 16 * warp + g + 8};  // of the 64
  float rmax[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float sr = sm.sx[row[h]];
#pragma unroll
    for (int nt = 0; nt < HC / 2 / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c * (HC / 2) + nt * 8 + 2 * t4 + e;
        const float v = gelu_tanh(__fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[nt][2 * h + e]), sr),
                      sm.s1[col]),
            sm.b1[col]));
        acc[nt][2 * h + e] = __float_as_int(v);
        rmax[h] = fmaxf(rmax[h], fabsf(v));
      }
    rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 1));
    rmax[h] = fmaxf(rmax[h], __shfl_xor_sync(0xffffffffu, rmax[h], 2));
    if (t4 == 0) sm.wmax[c][row[h]] = rmax[h];
  }
  wg::named_sync(1, 2 * WG_THREADS);
  if (c == 0 && tid < BM) {  // the slice's maxima into every CTA's amax
    const float v = fmaxf(sm.wmax[0][tid], sm.wmax[1][tid]);
    for (int p = 0; p < C; ++p) st_peer(peer_addr(&sm.amax[rank][tid], p), v);
  }
  cl::sync();  // the row maxima are exchanged

  // ---- requantize into this CTA's codes ----
  float sh[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = 0.0f;
    for (int p = 0; p < C; ++p) mx = fmaxf(mx, sm.amax[p][row[h]]);
    sh[h] = __fdiv_rn(fmaxf(mx, 1e-8f), 127.0f);
#pragma unroll
    for (int nt = 0; nt < HC / 2 / 8; ++nt) {
      const int cc = c * (HC / 2) + nt * 8 + 2 * t4;  // even
      const int cb = cc % BK, r = row[h];
      const uint16_t codes = static_cast<uint16_t>(
          (static_cast<uint32_t>(lseg::quantize_code(
               __int_as_float(acc[nt][2 * h]), sh[h])) & 0xffu) |
          ((static_cast<uint32_t>(lseg::quantize_code(
                __int_as_float(acc[nt][2 * h + 1]), sh[h])) & 0xffu)
           << 8));
      *reinterpret_cast<uint16_t*>(
          sm.ring + CODES + (cc / BK) * A_BYTES + r * BK +
          (((cb >> 4) ^ (r & 7)) << 4) + (cb & 15)) = codes;
    }
  }
  cl::sync();  // the codes are written

  // ---- fc2: 64 rows x 64 output columns a warpgroup over all of H ----
  int acc2[DC / 2 / 8][4];
  gm::zero(acc2);
  for (int it = 0; it < n_k2; ++it) {
    const int s = sm.r2.wait(it);
    const uint8_t* st = sm.ring + s * STAGE2;
    gm::fence_acc(acc2);
    wg::fence();
    const uint64_t da = wg::desc(st);
    const uint64_t db = wg::desc(st + A_BYTES + c * (W2_BYTES / 2));
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk)
      gm::MmaS8<DC / 2>::ss(acc2, wg::desc_kstep(da, kk),
                            wg::desc_kstep(db, kk), 1);
    wg::commit();
    wg::wait<1>();  // the previous chunk's products are complete
    gm::fence_acc(acc2);
    if (it > 0 && tid == 0) sm.r2.release(it - 1);
  }
  wg::wait<0>();
  gm::fence_acc(acc2);

  // ---- ((acc2 * sh) * s2) + b2 + resid, one cast to bf16 ----
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + row[h];
    if (r >= M) continue;
#pragma unroll
    for (int nt = 0; nt < DC / 2 / 8; ++nt) {
      const int col = c * (DC / 2) + nt * 8 + 2 * t4;
      const long long off = static_cast<long long>(r) * D + d0 + col;
      const float2 res = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(resid + off));
      const float y0 = __fadd_rn(
          __fmul_rn(__fmul_rn(__int2float_rn(acc2[nt][2 * h]), sh[h]),
                    sm.s2[col]),
          sm.b2[col]);
      const float y1 = __fadd_rn(
          __fmul_rn(__fmul_rn(__int2float_rn(acc2[nt][2 * h + 1]), sh[h]),
                    sm.s2[col + 1]),
          sm.b2[col + 1]);
      *reinterpret_cast<__nv_bfloat162*>(out + off) =
          __floats2bfloat162_rn(__fadd_rn(y0, res.x), __fadd_rn(y1, res.y));
    }
  }
  cl::sync();  // no CTA leaves while a peer may read its codes
}

}  // namespace

// Launch on `stream`; returns the launch's error code (0 on success): a
// cluster launch the card refuses returns it, with no other route.
// Requires hidden == 4 * dim, dim % 128 == 0, dim <= 1024 and 16-byte
// aligned tensors (checked by the wrapper). With `clusters` not null the
// call launches nothing and writes there the most clusters of width
// `dim` the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int lseg_mlp_fused(const void* xq, const void* sx,
                              const void* resid, const void* w1,
                              const void* s1, const void* b1, const void* w2,
                              const void* s2, const void* b2, void* out,
                              int m, int dim, int hidden, int* clusters,
                              void* stream) {
  static const int attr = wg::allow_smem(mlp_fused_cluster_kernel, SMEM);
  if (attr != 0) return attr;
  if (clusters != nullptr) {
    cl::Launch l(dim3(dim / DC), THREADS, SMEM, dim / DC, nullptr);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(
        clusters, mlp_fused_cluster_kernel, &l.cfg));
  }
  CUtensorMap map_x, map_w1, map_w2;
  int rc = gm::make_map_2d(&map_x, xq, 1, dim, m, BK, BM, true);
  if (rc == 0)
    rc = gm::make_map_2d(&map_w1, w1, 1, dim, hidden, BK, HC / 2, true);
  if (rc == 0) rc = gm::make_map_2d(&map_w2, w2, 1, hidden, dim, BK, DC, true);
  if (rc != 0) return rc;
  cl::Launch l(dim3(dim / DC * ((m + BM - 1) / BM)), THREADS, SMEM, dim / DC,
               static_cast<cudaStream_t>(stream));
  const cudaError_t e = cudaLaunchKernelEx(
      &l.cfg, mlp_fused_cluster_kernel, map_x, map_w1, map_w2,
      static_cast<const float*>(sx), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const float*>(s2),
      static_cast<const float*>(b2), static_cast<const __nv_bfloat16*>(resid),
      static_cast<__nv_bfloat16*>(out), m, dim);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
