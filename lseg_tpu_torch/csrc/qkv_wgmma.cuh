// The int8 qkv projection of kernels B2 (flash_attention_ln_qkv_q8.cu), B8
// (flash_attention_qkv_fused.cu), B9 (flash_attention_ln_qkv_fused.cu) and
// B15 (flash_attention_qkvp_fused.cu), with its dequant epilogue:
//
//   acc (M, N) int32 = a (M, K) int8 . w (N, K)^T int8, exact;
//   out (M, N) bf16 = bf16(((acc * sa[row]) * sw[col]) + bias[col])
//
// Products and sums of the epilogue are rounded one by one (no FMA
// contraction), as the TPU kernels' `_dequant_qkv_parts` computes them;
// the int32 sums are exact, so the output equals the plain version's bit
// for bit.
//
// What bounds it on the card: at the flagship (M = 8 x 901, K = 1024, N =
// 3072) the 22.7 G int8 MAC (45.4 GOP, 0.023 ms at 1979 TOP/s) against
// 7.4 MB of codes, 3 MB of weight and the 44 MB bf16 output (0.016 ms at
// 3.35 TB/s): the operations.
//
// Design, on the GEMM engine of wgmma_gemm.cuh: a persistent kernel, one
// block an SM, walking 128 x 192 output tiles (m-major, so the blocks in
// flight share rows of a); one producer thread keeps a four-stage ring of
// 128-deep k-chunks full by TMA (a's 128 x 128 box and w's 192 x 128,
// both K-major with the 128-byte swizzle, as 8-bit wgmma reads them;
// rows of a past M are zero-filled), and runs on into the next tile while
// the consumers finish this one; two consumer warpgroups each run s8
// warpgroup products m64n192k32 (IGMMA, 96 int32 accumulators a thread)
// on 64 of the rows, then dequantize in registers into a 64 x 192 bf16
// stage of their own (three 128-byte swizzled boxes) that one thread
// stores by TMA (rows past M are not written) while the warpgroup goes
// on to its next tile: stored from registers, 4 bytes a thread, the
// epilogue took as long as the products (0.030 of 0.071 ms at the
// flagship, PERF.md). N = 192 divides 3D for every D that is a multiple
// of 64, and keeps the accumulators at 96 registers.
//
// Requires N % 192 == 0, K % 128 == 0, M >= 1, 16-byte aligned rows.

#pragma once

#include "wgmma_gemm.cuh"

namespace lseg {
namespace {
namespace qkv_wg {

constexpr int BM = 128;   // rows of a tile: two consumer warpgroups of 64
constexpr int BN = 192;   // output channels of a tile
constexpr int BK = 128;   // k bytes a stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int WG_THREADS = 128;
constexpr int THREADS = 3 * WG_THREADS;  // producer + 2 consumers
constexpr int A_BYTES = BM * BK;          // 16 KB
constexpr int B_BYTES = BN * BK;          // 24 KB
constexpr int STAGE = A_BYTES + B_BYTES;
constexpr int BOX = 64 * 64 * 2;          // a 64 x 64 bf16 output box

struct Smem {
  uint8_t ring[STAGES * STAGE];
  uint8_t out[2][BN / 64][BOX];  // each consumer's bf16 output stage
  gemm::Ring<STAGES> r;
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + alignment slack

__global__ void __launch_bounds__(THREADS, 1) qkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_o, const float* __restrict__ sa,
    const float* __restrict__ sw, const float* __restrict__ bias, int M,
    int N, int K) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - wg::smem_addr(smem_raw) % 1024) % 1024));
  const int tiles_n = N / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int n_k = K / BK;
  const int wg_id = threadIdx.x / WG_THREADS;
  const int tid = threadIdx.x % WG_THREADS;

  if (threadIdx.x == 0) sm.r.init(2);
  __syncthreads();

  if (wg_id == 0) {
    gemm::regs_dec<40>();
    if (tid == 0) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int kc = 0; kc < n_k; ++kc, ++it) {
          const int s = sm.r.acquire(it, STAGE);
          uint8_t* st = sm.ring + s * STAGE;
          gemm::tma_load_2d(st, &map_a, &sm.r.full[s], kc * BK, m0);
          gemm::tma_load_2d(st + A_BYTES, &map_w, &sm.r.full[s], kc * BK,
                            n0);
        }
      }
    }
    return;
  }

  gemm::regs_inc<232>();
  const int c = wg_id - 1;  // this warpgroup's 64 rows of the tile
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  int acc[BN / 8][4];
  gemm::zero(acc);
  uint32_t it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
    // the rows' scales, loaded under the products
    const int r0 = m0 + c * 64 + warp * 16 + g;  // rows r0 and r0 + 8
    const float sr[2] = {r0 < M ? sa[r0] : 0.0f,
                         r0 + 8 < M ? sa[r0 + 8] : 0.0f};
    for (int kc = 0; kc < n_k; ++kc, ++it) {
      const int s = sm.r.wait(it);
      const uint8_t* st = sm.ring + s * STAGE;
      gemm::fence_acc(acc);
      wg::fence();
      const uint64_t da = wg::desc(st + c * (A_BYTES / 2));
      const uint64_t db = wg::desc(st + A_BYTES);
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)
        gemm::MmaS8<BN>::ss(acc, wg::desc_kstep(da, kk),
                            wg::desc_kstep(db, kk), kc > 0 || kk > 0);
      wg::commit();
      wg::wait<1>();  // the previous chunk's products are complete
      gemm::fence_acc(acc);
      if (kc > 0 && tid == 0) sm.r.release(it - 1);
    }
    wg::wait<0>();
    gemm::fence_acc(acc);
    if (tid == 0) sm.r.release(it - 1);

    // ((acc * sa) * sw) + b in fp32, one cast to bf16, into the stage
    // once the last tile's store has read it; then stored by TMA
    if (tid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    wg::named_sync(1 + c, WG_THREADS);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt) {
      const int col = n0 + nt * 8 + 2 * t4;
      const float2 s2 = __ldg(reinterpret_cast<const float2*>(sw + col));
      const float2 b2 = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[nt][2 * h]), sr[h]), s2.x),
            b2.x);
        const float v1 = __fadd_rn(
            __fmul_rn(__fmul_rn(__int2float_rn(acc[nt][2 * h + 1]), sr[h]),
                      s2.y),
            b2.y);
        *reinterpret_cast<__nv_bfloat162*>(
            sm.out[c][nt / 8] +
            gemm::swizzled_offset(warp * 16 + g + 8 * h, nt % 8 * 8 + 2 * t4)) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    gemm::fence_proxy_async();  // the stage's writes before the TMA store
    wg::named_sync(1 + c, WG_THREADS);
    if (tid == 0) {
      for (int b = 0; b < BN / 64; ++b)
        gemm::tma_store_2d(&map_o, sm.out[c][b], n0 + 64 * b, m0 + 64 * c);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // the last stores are complete before the block's shared memory goes
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Launch on `st`: one block an SM (or one a tile, if fewer). Returns 0 or
// a CUDA error code.
inline int launch(const void* a, const void* sa, const void* w,
                  const void* sw, const void* bias, void* out, int M, int N,
                  int K, cudaStream_t st) {
  static const int attr = wg::allow_smem(qkv_wgmma_kernel, SMEM);
  if (attr != 0) return attr;
  CUtensorMap map_a, map_w, map_o;
  int rc = gemm::make_map_2d(&map_a, a, 1, K, M, BK, BM, true);
  if (rc == 0) rc = gemm::make_map_2d(&map_w, w, 1, K, N, BK, BN, true);
  if (rc == 0) rc = gemm::make_map_2d(&map_o, out, 2, N, M, 64, 64, true);
  if (rc != 0) return rc;
  int dev = 0, sms = 0;
  rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (rc != 0) return rc;
  const int tiles = (M + BM - 1) / BM * (N / BN);
  qkv_wgmma_kernel<<<tiles < sms ? tiles : sms, THREADS, SMEM, st>>>(
      map_a, map_w, map_o, static_cast<const float*>(sa),
      static_cast<const float*>(sw), static_cast<const float*>(bias), M, N,
      K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace qkv_wg
}  // namespace
}  // namespace lseg
