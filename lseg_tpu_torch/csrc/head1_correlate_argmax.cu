// Fused int8 head1 projection + image-text correlation + argmax over K for
// Hopper (sm_90a), kernel B5 (and B12, its row-major form).
//
// Replaces: lseg_tpu/ops/pallas_correlation.py ·
// head1_correlate_argmax_fused_t (Pallas TPU; body _head1_argmax_t_kernel)
// and head1_correlate_argmax_fused (_head1_argmax_kernel). The two TPU
// kernels differ only in how they lay the logits over the TPU's (8, 128)
// tiles; on this card they are one kernel.
//
// Input: path1 x (M, C) as int8 codes, or bf16 quantized here on the
// grid sx (clip(rint(x / sx), -127, 127), IEEE division, so the label
// map is the one of quantizing first); head1's int8 1x1 kernel w (E, C);
// sc (E,) = sx * s1; the fp32 bias (E,); the text matrix tn (K, E) bf16,
// L2-normalised without the temperature. Output: (M,) int32 labels:
//   e     = acc * sc + b                 (int32 acc; fp32, no contraction)
//   lo    = bf16(e) . tn^T               (fp32 accumulation)
//   label = first k < K of the largest lo (jnp.argmax order)
// The per-pixel norm and the temperature are positive per-row factors, to
// which the argmax is blind: neither is computed. Labels past K never
// compete (masked), so an all-negative row cannot lose to K padding.
//
// What bounds it on the card: at the flagship (8, 240, 240, 256) -> K =
// 150 the head1 product is 60.4 G int8 MAC (121 GOP, ~0.061 ms at 1979
// TOP/s) and the correlation 35.4 G bf16 MAC (71 GFLOP, ~0.072 ms at 989
// TFLOP/s), against 236 MB of bf16 path1 in (~0.07 ms) and 1.8 MB out:
// the tensor-core operations bound it (~0.13 ms).
//
// Design: the tile of kernel B13 (head1_wgmma.cuh) on a persistent grid of
// 128-pixel steps (one CTA an SM, steps blockIdx.x, + gridDim.x, ...):
//   - the step's codes land in one of two buffers, so that the next
//     step's are written while this step's are read: by TMA from the
//     producer thread (int8 input), or (bf16 input) by the producer
//     warpgroup's other three warps, which quantize the step's rows into
//     the codes' layout (128-byte swizzled, K-major, as TMA would have
//     written them; `code_bits_fast`: the IEEE division only where the
//     reciprocal's product falls near a rounding boundary), then
//     fence.proxy.async, so that the wgmma that reads
//     them sees the generic-proxy writes, and arrive on the buffer's
//     barrier. They read the rows with 16-byte global loads, four groups
//     of 16 channels in flight a thread, that hit L2: the producer thread
//     prefetches the rows (cp.async.bulk.prefetch.L2) two steps ahead. A
//     TMA copy of the bf16 rows into shared memory would need 64 KB
//     beside the ring's 140 KB and the codes' 64 KB;
//   - the producer thread loads, per label chunk of up to KG = 152 labels
//     and quarter of 128 head1 channels, that quarter's weight rows and
//     the chunk's text columns into the two-stage mbarrier ring;
//   - two consumer warpgroups, 64 pixels each, run the embed on s8 wgmma
//     and the correlate on wgmma m64n152k16 in the RS form, A the
//     dequantized bf16(e) in registers (head1_wgmma.cuh), and keep a
//     running (value, index) key for each of a thread's two pixels across
//     the chunks' labels; a two-step butterfly joins a row's four lanes.
// Neither the (M, 512) embedding map nor the (M, K) logits nor, from
// bf16, the int8 codes reach device memory. More than 152 labels rerun
// the embed of the step for each chunk. Budgets: 208 KB of shared memory;
// setmaxnreg gives the producer warpgroup 56 registers, the consumers 224
// (the 64,512 of 384 threads at 168, which the launch holds).
// Limits: C <= 256, C % 32 == 0, E % 128 == 0, K >= 1.

#include "head1_wgmma.cuh"

namespace {

namespace hw = lseg::head1w;
namespace wg = lseg::wg;
namespace gm = lseg::gemm;

using Pipe = hw::Pipe<2>;  // two codes buffers: the next step's lands early
constexpr int SMEM = sizeof(Pipe) + 1024;  // + alignment slack
constexpr int QUANTIZERS = hw::WG_THREADS - 32;  // warps 1-3 of the producer
constexpr int UNROLL = 4;  // a quantizer's 16-channel groups in flight

struct Args {
  const __nv_bfloat16* x;  // bf16 path1, or null for int8 codes
  const float* sx;
  const float* sc;
  const float* b1;
  int* out;
  int M, C, K, E;
};

// the codes of 16 bf16 values (two uint4 of path1), first in the low byte:
// by `code_bits_fast`, or by the division where one of them lies near a
// rounding boundary
__device__ __forceinline__ uint4 codes16(const uint4 (&raw)[2], float s,
                                         float inv) {
  float v[2][8];
  lseg::unpack8(raw[0], v[0]);
  lseg::unpack8(raw[1], v[1]);
  bool near = false;
  uint32_t w[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float* q = v[j / 2] + 4 * (j % 2);
    w[j] = lseg::pack_codes_fast(q[0], q[1], q[2], q[3], inv, near);
  }
  if (__builtin_expect(near, 0)) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* q = v[j / 2] + 4 * (j % 2);
      w[j] = lseg::pack_codes(q[0], q[1], q[2], q[3], s);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bf16 rows m0 .. m0 + 127 (zeros past M) as int8 codes into the step's
// codes, in the 128-byte swizzle TMA writes: thread qt of the quantizers.
__device__ __forceinline__ void quantize_step(uint8_t* codes,
                                              const __nv_bfloat16* x,
                                              float sx, float inv, int m0,
                                              int M, int C, int qt) {
  const int cg = C / 16;  // 16-channel groups a row
  const int n = hw::ROWS * cg;
  // UNROLL groups' loads in flight, then their codes
  for (int i0 = qt; i0 < n; i0 += UNROLL * QUANTIZERS) {
    uint4 raw[UNROLL][2];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * QUANTIZERS, p = i / cg, c = (i % cg) * 16;
      raw[u][0] = raw[u][1] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n && m0 + p < M) {
        const uint4* src = reinterpret_cast<const uint4*>(
            x + static_cast<long long>(m0 + p) * C + c);
        raw[u][0] = __ldg(src);
        raw[u][1] = __ldg(src + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int i = i0 + u * QUANTIZERS, p = i / cg, c = (i % cg) * 16;
      if (i >= n) break;
      const uint4 v = codes16(raw[u], sx, inv);
      const int r = p % 64, b = c % 128;
      *reinterpret_cast<uint4*>(
          codes + ((c / 128) * 2 + p / 64) * hw::CODES_BOX + r * 128 +
          (((b / 16) ^ (r & 7)) * 16)) = v;
    }
  }
}

// a step's bf16 rows into L2 (one bulk prefetch)
__device__ __forceinline__ void prefetch_rows(const __nv_bfloat16* x, int m0,
                                              int M, int C) {
  if (m0 >= M) return;
  const int bytes = min(hw::ROWS, M - m0) * C * 2;
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(
                   x + static_cast<long long>(m0) * C),
               "r"(bytes)
               : "memory");
}

__global__ void __launch_bounds__(hw::THREADS, 1) head1_argmax_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_t, Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Pipe& sm = *reinterpret_cast<Pipe*>(
      smem_raw + ((1024 - wg::smem_addr(smem_raw) % 1024) % 1024));
  const int stride = gridDim.x * hw::ROWS;  // pixels a round of steps
  const int steps = (a.M - blockIdx.x * hw::ROWS + stride - 1) / stride;
  const int chunks = (a.K + hw::KG - 1) / hw::KG;
  const int nq = a.E / hw::EQ;
  const int kcl = (a.C + 127) / 128;  // k-chunks the codes fill
  const bool from_bf16 = a.x != nullptr;

  hw::zero_unloaded(sm, kcl, hw::THREADS);
  if (threadIdx.x == 0) hw::init_pipe(sm, from_bf16 ? QUANTIZERS / 32 : 1);
  __syncthreads();

  const int wg_id = threadIdx.x / hw::WG_THREADS;
  if (wg_id == 0) {
    gm::regs_dec<56>();
    if (threadIdx.x == 0) {
      uint32_t it = 0;
      // the quantizers run a step ahead of the consumers: rows two steps
      // ahead into L2
      for (int ls = 0; from_bf16 && ls < 2; ++ls)
        prefetch_rows(a.x, blockIdx.x * hw::ROWS + ls * stride, a.M, a.C);
      for (int ls = 0; ls < steps; ++ls) {
        const int m0 = blockIdx.x * hw::ROWS + ls * stride;
        if (from_bf16) prefetch_rows(a.x, m0 + 2 * stride, a.M, a.C);
        hw::load_step(sm, &map_x, &map_w, &map_t, ls, m0, kcl, nq, 0, chunks,
                      !from_bf16, it);
      }
    } else if (from_bf16 && threadIdx.x >= 32) {
      const float sx = *a.sx, inv = __frcp_rn(sx);
      for (int ls = 0; ls < steps; ++ls) {
        const int m0 = blockIdx.x * hw::ROWS + ls * stride;
        uint8_t* const codes = hw::codes_free(sm, ls);
        quantize_step(codes, a.x, sx, inv, m0, a.M, a.C, threadIdx.x - 32);
        gm::fence_proxy_async();  // before the wgmma that reads them
        __syncwarp();
        if (threadIdx.x % 32 == 0)
          asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                           wg::smem_addr(&sm.cfull[ls % 2]))
                       : "memory");
      }
    }
    return;
  }

  gm::regs_inc<224>();
  const int ct = threadIdx.x - hw::WG_THREADS;  // 0 .. 255
  const int cw = ct / hw::WG_THREADS;
  const int warp = (ct / 32) % 4;
  const int lane = ct % 32, g = lane / 4, t4 = lane % 4;
  const int pix[2] = {64 * cw + 16 * warp + g, 64 * cw + 16 * warp + g + 8};
  uint32_t it = 0;
  for (int ls = 0; ls < steps; ++ls) {
    const int m0 = blockIdx.x * hw::ROWS + ls * stride;
    float bv[2] = {-INFINITY, -INFINITY};
    int bi[2] = {0x7fffffff, 0x7fffffff};
    hw::codes_full(sm, ls);
    for (int ch = 0; ch < chunks; ++ch) {
      float ss[2][2];
      float cacc[hw::KT][4];
      hw::step_sums(sm, a.sc, a.b1, nq, ls, ch + 1 == chunks, cw, it, ss,
                    cacc);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int lt = 0; lt < hw::KT; ++lt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = ch * hw::KG + 8 * lt + 2 * t4 + e;
            const float v = cacc[lt][2 * h + e];
            if (k < a.K && lseg::argmax_better(v, k, bv[h], bi[h])) {
              bv[h] = v;
              bi[h] = k;
            }
          }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lseg::argmax_xor(bv[h], bi[h], 1);
      lseg::argmax_xor(bv[h], bi[h], 2);
      if (t4 == 0 && m0 + pix[h] < a.M) a.out[m0 + pix[h]] = bi[h];
    }
  }
}

}  // namespace

// Launch on `stream`; returns the launch's error code (0 on success).
// x_bf16 selects path1's dtype (1 bf16 quantized on the grid *sx, 0 int8
// codes; sx is a device fp32 scalar). Requires c % 32 == 0, c <= 256,
// e % 128 == 0, k >= 1, 16-byte aligned tensors (checked by the wrapper);
// `ctas` caps the persistent grid (the card's SMs).
extern "C" int lseg_head1_correlate_argmax(const void* x, const void* sx,
                                           const void* w, const void* sc,
                                           const void* b1, const void* tn,
                                           void* out, int m, int c, int e,
                                           int k, int x_bf16, int ctas,
                                           void* stream) {
  if (c % 32 || c > hw::MAX_C || e % hw::EQ || k < 1 || m < 1 || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int attr = wg::allow_smem(head1_argmax_wgmma_kernel, SMEM);
  if (attr != 0) return attr;
  CUtensorMap map_x, map_w, map_t;
  // bf16 path1 is read by the quantizers: the codes map is unused
  int rc = gm::make_map_2d(&map_x, x_bf16 ? w : x, 1, c, x_bf16 ? e : m, 128,
                           64, true);
  if (rc == 0) rc = gm::make_map_2d(&map_w, w, 1, c, e, 128, hw::EQ, true);
  if (rc == 0) rc = gm::make_map_2d(&map_t, tn, 2, e, k, 64, hw::KG, true);
  if (rc != 0) return rc;
  const int grid = min(ctas, (m + hw::ROWS - 1) / hw::ROWS);
  const Args a{x_bf16 ? static_cast<const __nv_bfloat16*>(x) : nullptr,
               static_cast<const float*>(sx), static_cast<const float*>(sc),
               static_cast<const float*>(b1), static_cast<int*>(out),
               m, c, k, e};
  head1_argmax_wgmma_kernel<<<grid, hw::THREADS, SMEM,
                              static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, map_t, a);
  return static_cast<int>(cudaGetLastError());
}
