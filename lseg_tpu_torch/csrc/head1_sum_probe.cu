// A probe, not a kernel of a path: does wgmma m64n64k16 bf16 -> fp32 sum
// the correlate of the head kernels to the same bits as mma.sync
// m16n8k16? Both take bf16(e) . tn^T of the same operands, k16 step by k16
// step in ascending order into one fp32 accumulator, from the same
// 128-byte-swizzled shared tiles; the probe writes both sums so the caller
// can compare them bit for bit (`ops.head1_correlate.correlate_sum_probe`).
// If they are equal on the flagship's operands, the head kernels' correlate
// could move onto wgmma without losing B4's bits.
//
// One warpgroup a CTA, a 64 x 64 tile of (pixel, label) sums; the
// accumulator of a wgmma warp's 16 rows is mma.sync's m16n8 C layout, so a
// thread holds the same (row, label) entries from both.

#include "wgmma_gemm.cuh"

namespace {

namespace wg = lseg::wg;
namespace gm = lseg::gemm;

struct alignas(1024) ProbeSmem {
  uint8_t a[wg::TILE_BYTES];  // 64 pixels x 64 channels
  uint8_t b[wg::TILE_BYTES];  // 64 labels x 64 channels
};

__global__ void __launch_bounds__(128) head1_sum_probe_kernel(
    const __nv_bfloat16* __restrict__ ef, const __nv_bfloat16* __restrict__ tn,
    float* __restrict__ out_wgmma, float* __restrict__ out_mma, int M, int K,
    int E) {
  __shared__ ProbeSmem sm;
  const int m0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  float dw[8][4], dm[8][4];
  gm::zero(dw);
  gm::zero(dm);
  for (int e0 = 0; e0 < E; e0 += 64) {
    __syncthreads();  // the previous block's products have read the tiles
    for (int i = tid; i < 64 * 32; i += 128) {
      const int r = i / 32, col = (i % 32) * 2;
      uint32_t va = 0u, vb = 0u;
      if (m0 + r < M)
        va = *reinterpret_cast<const uint32_t*>(
            ef + static_cast<long long>(m0 + r) * E + e0 + col);
      if (k0 + r < K)
        vb = *reinterpret_cast<const uint32_t*>(
            tn + static_cast<long long>(k0 + r) * E + e0 + col);
      *reinterpret_cast<uint32_t*>(sm.a + gm::swizzled_offset(r, col)) = va;
      *reinterpret_cast<uint32_t*>(sm.b + gm::swizzled_offset(r, col)) = vb;
    }
    gm::fence_proxy_async();
    __syncthreads();
    // wgmma: four k16 steps
    wg::fence_acc(dw);
    wg::fence();
    const uint64_t da = wg::desc(sm.a), db = wg::desc(sm.b);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg::mma_ss<0>(dw, wg::desc_kstep(da, kk), wg::desc_kstep(db, kk), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(dw);
    // mma.sync: the same four k16 steps
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int r = 16 * warp + g, c = 16 * kk + 2 * t4;
      const uint32_t af[4] = {
          lseg::ld_u32(sm.a + gm::swizzled_offset(r, c)),
          lseg::ld_u32(sm.a + gm::swizzled_offset(r + 8, c)),
          lseg::ld_u32(sm.a + gm::swizzled_offset(r, c + 8)),
          lseg::ld_u32(sm.a + gm::swizzled_offset(r + 8, c + 8))};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        lseg::mma_bf16_16816(dm[nt], af,
                             lseg::ld_u32(sm.b + gm::swizzled_offset(
                                                     8 * nt + g, c)),
                             lseg::ld_u32(sm.b + gm::swizzled_offset(
                                                     8 * nt + g, c + 8)));
    }
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + 16 * warp + g + 8 * (e / 2);
      const int k = k0 + 8 * nt + 2 * t4 + e % 2;
      if (r < M && k < K) {
        out_wgmma[static_cast<long long>(r) * K + k] = dw[nt][e];
        out_mma[static_cast<long long>(r) * K + k] = dm[nt][e];
      }
    }
}

}  // namespace

// Launch on `stream`; returns the launch's error code (0 on success).
// ef (m, e) and tn (k, e) bf16, e % 64 == 0, 4-byte aligned rows; out_*
// (m, k) fp32.
extern "C" int lseg_head1_sum_probe(const void* ef, const void* tn,
                                    void* out_wgmma, void* out_mma, int m,
                                    int k, int e, void* stream) {
  if (e % 64 || m < 1 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + 63) / 64, (k + 63) / 64);
  head1_sum_probe_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(ef),
      static_cast<const __nv_bfloat16*>(tn), static_cast<float*>(out_wgmma),
      static_cast<float*>(out_mma), m, k, e);
  return static_cast<int>(cudaGetLastError());
}
