// Fused int8 head1 projection + image-text correlation for Hopper
// (sm_90a), kernel B4.
//
// Replaces: lseg_tpu/ops/pallas_correlation.py · head1_correlate_fused
// (Pallas TPU; body _head1_kernel).
//
// Input: the int8 path1 codes xq (M, C) (M = N*H*W pixels), head1's int8
// 1x1 kernel w (E, C) (the port's (out, in) storage), sc (E,) = sx * s1
// (activation scale times the per-channel weight scales, one fp32 product
// taken by the wrapper), the fp32 bias (E,), and the text matrix tn (K, E)
// bf16, already L2-normalised and multiplied by the temperature. Output:
// (M, K) bf16 logits, K unpadded.
//
// Rounding points, as in the TPU kernel:
//   e = acc * sc + b      (int32 acc, exact; fp32, no FMA contraction)
//   inv = rsqrt(max(sum(e^2), 1e-24))            (only when `normalize`)
//   out = bf16((bf16(e) . tn^T) [* inv])         (fp32 accumulation)
// The logits are those of the mma.sync kernel (head1_correlate_wide.cu)
// bit for bit, in both modes and at every K: the tile of head1_wgmma.cuh sums
// each of them in that kernel's order (its header says why).
//
// What bounds it on the card: the operations. At the lowres flagship
// (8, 120, 120, 256) -> K = 150 (normalize off: LSegNet.forward's head
// under fast_serving 'static_cal') the head1 product is 15.1 G int8 MAC
// and the correlation 8.8 G bf16 MAC (0.033 ms at the tensor cores'
// peaks) against 29.5 MB of codes in and 34.6 MB of logits out (0.019
// ms); at H/2 (8, 240, 240, 256) with the norm (`model(x, txt)` of the
// fast int8 configs, the TTA crop forward) four times that: 0.133 ms,
// against 138 MB of logits out (0.041 ms).
//
// Design: B5's int8 route (head1_correlate_argmax.cu) with the logits
// written out. A persistent grid of 128-pixel steps (one CTA an SM,
// steps blockIdx.x, + gridDim.x, ...):
//   - a producer thread loads the step's codes (two 64-pixel boxes a
//     128-byte k-chunk) by TMA into the one codes buffer, freed by the
//     last embed of the step, and, per label chunk of up to KG = 152
//     labels and quarter of 128 head1 channels, that quarter's weight rows
//     and the chunk's text columns into the two-stage mbarrier ring;
//   - two consumer warpgroups, 64 pixels each, run the embed on s8 wgmma
//     m64n128k32, the dequant in registers and the correlate on wgmma
//     m64n152k16 in the RS form (head1_wgmma.cuh), then round the step's
//     logits, with the norm (`logits`) or without (`logits_raw`);
//   - each warp stages its 16 rows' logits of the chunk in its own area of
//     shared memory, laid out as they lie in the output (the first byte at
//     the output's address mod 16, rows at a pitch congruent to the
//     output's row pitch mod 16), and copies them out by cp.async.bulk:
//     with one chunk (K <= 152) the 16 rows are one contiguous range of
//     16 * 2K bytes, 16-byte aligned (38,400 bytes a step at K = 150);
//     past 152 labels a chunk's columns of a row are not contiguous with
//     the next row's, and each row goes as its own range. A range's
//     16-byte aligned middle is one bulk copy and its ends 2-byte stores
//     (`put_range`); rows past M are neither copied nor stored.
// Neither the (M, 512) embedding map nor, from one chunk to the next, the
// codes reach device memory twice; more than 152 labels rerun the embed
// of the step for each chunk. Budgets: 217 KB of shared memory (the codes
// buffer 32 KB, the ring 140 KB, the staging areas 41 KB); setmaxnreg
// gives the producer warpgroup 40 registers, the consumers 232. Limits:
// C <= 256, C % 32 == 0, E % 128 == 0, K >= 1; wider path1 takes
// head1_correlate_wide.cu.

#include "head1_wgmma.cuh"

namespace {

namespace hw = lseg::head1w;
namespace wg = lseg::wg;
namespace gm = lseg::gemm;

constexpr int CONSUMERS = 2 * hw::WG_THREADS;
constexpr int CWARPS = CONSUMERS / 32;
constexpr int WROWS = hw::ROWS / CWARPS;    // a warp's rows of a step: 16
constexpr int PITCH_MAX = 2 * hw::KG + 16;  // a staged row's bytes at most
constexpr int REGION = WROWS * PITCH_MAX + 16;  // a warp's staging area

struct Smem {
  hw::Pipe<1> p;
  uint8_t stage[CWARPS][REGION];
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + alignment slack
static_assert(REGION % 16 == 0, "staging areas stay 16-byte aligned");
static_assert(SMEM <= 232448, "one CTA an SM");

struct Args {
  const float* sc;
  const float* b1;
  __nv_bfloat16* out;
  int M, C, K, E;
};

template <bool NORM>
__global__ void __launch_bounds__(hw::THREADS, 1) head1_correlate_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_t, Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - wg::smem_addr(smem_raw) % 1024) % 1024));
  const int K = a.K;
  const int stride = gridDim.x * hw::ROWS;  // pixels a round of steps
  const int steps = (a.M - blockIdx.x * hw::ROWS + stride - 1) / stride;
  const int chunks = (K + hw::KG - 1) / hw::KG;
  const int nq = a.E / hw::EQ;
  const int kcl = (a.C + 127) / 128;  // k-chunks the codes fill

  hw::zero_unloaded(sm.p, kcl, hw::THREADS);
  if (threadIdx.x == 0) hw::init_pipe(sm.p, 1);
  __syncthreads();

  if (threadIdx.x / hw::WG_THREADS == 0) {
    gm::regs_dec<40>();
    if (threadIdx.x == 0) {
      uint32_t it = 0;
      for (int ls = 0; ls < steps; ++ls)
        hw::load_step(sm.p, &map_x, &map_w, &map_t, ls,
                      blockIdx.x * hw::ROWS + ls * stride, kcl, nq, 0, chunks,
                      true, it);
    }
    return;
  }

  gm::regs_inc<232>();
  const int ct = threadIdx.x - hw::WG_THREADS;  // 0 .. 255
  const int cw = ct / hw::WG_THREADS;
  const int cwarp = ct / 32;  // rows 16 cwarp .. 16 cwarp + 15 of a step
  const int lane = ct % 32, g = lane / 4, t4 = lane % 4;
  uint8_t* const region = sm.stage[cwarp];
  uint32_t it = 0;
  for (int ls = 0; ls < steps; ++ls) {
    const int r0 = blockIdx.x * hw::ROWS + ls * stride + WROWS * cwarp;
    const int rows = max(0, min(WROWS, a.M - r0));  // the warp's rows < M
    hw::codes_full(sm.p, ls);
    for (int ch = 0; ch < chunks; ++ch) {
      const int kt0 = ch * hw::KG, kc = min(hw::KG, K - kt0);
      float ss[2][2];
      float cacc[hw::KT][4];
      hw::step_sums(sm.p, a.sc, a.b1, nq, ls, ch + 1 == chunks, cw, it, ss,
                    cacc);
      uint32_t lo[2][hw::KT];
      if constexpr (NORM) {
        hw::logits(cacc, ss, lo);
      } else {
        hw::logits_raw(cacc, lo);
      }
      // the warp's first output element of the chunk and its staged copy
      __nv_bfloat16* const gout =
          a.out + static_cast<long long>(r0) * K + kt0;
      uint8_t* const s0 = region + reinterpret_cast<uintptr_t>(gout) % 16;
      const int pitch = kc == K ? 2 * K : 2 * kc + (2 * (K - kc)) % 16;
      // the previous chunk's bulk copies have read the area
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint8_t* const dst = s0 + (g + 8 * h) * pitch + 4 * t4;
#pragma unroll
        for (int w = 0; w < hw::KT; ++w) {
          const int k = 8 * w + 2 * t4;  // the pair's first label
          if (k + 1 < kc && K % 2 == 0) {
            *reinterpret_cast<uint32_t*>(dst + 16 * w) = lo[h][w];
          } else {
            if (k < kc)
              *reinterpret_cast<uint16_t*>(dst + 16 * w) =
                  static_cast<uint16_t>(lo[h][w] & 0xffffu);
            if (k + 1 < kc)
              *reinterpret_cast<uint16_t*>(dst + 16 * w + 2) =
                  static_cast<uint16_t>(lo[h][w] >> 16);
          }
        }
      }
      gm::fence_proxy_async();  // before the bulk copies read the area
      __syncwarp();
      if (kc == K) {  // one chunk: the warp's rows are one range
        if (lane == 0 && rows > 0)
          hw::put_range(reinterpret_cast<uint8_t*>(gout), s0, rows * 2 * K);
      } else if (lane < rows) {  // a range a row
        hw::put_range(reinterpret_cast<uint8_t*>(gout + lane * K),
                      s0 + lane * pitch, 2 * kc);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // the last bulk copies have written their outputs
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// Launch on `stream`; returns the launch's error code (0 on success).
// Requires c % 32 == 0, c <= 256, e % 128 == 0, k >= 1, 16-byte aligned
// tensors (checked by the wrapper); `ctas` caps the persistent grid (the
// card's SMs).
extern "C" int lseg_head1_correlate(const void* xq, const void* w,
                                    const void* sc, const void* b1,
                                    const void* tn, void* out, int m, int c,
                                    int e, int k, int normalize, int ctas,
                                    void* stream) {
  if (c % 32 || c > hw::MAX_C || e % hw::EQ || k < 1 || m < 1 || ctas < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int attr = [] {
    const int r = wg::allow_smem(head1_correlate_wgmma_kernel<true>, SMEM);
    return r != 0 ? r
                  : wg::allow_smem(head1_correlate_wgmma_kernel<false>, SMEM);
  }();
  if (attr != 0) return attr;
  CUtensorMap map_x, map_w, map_t;
  int rc = gm::make_map_2d(&map_x, xq, 1, c, m, 128, 64, true);
  if (rc == 0) rc = gm::make_map_2d(&map_w, w, 1, c, e, 128, hw::EQ, true);
  if (rc == 0) rc = gm::make_map_2d(&map_t, tn, 2, e, k, 64, hw::KG, true);
  if (rc != 0) return rc;
  const int grid = min(ctas, (m + hw::ROWS - 1) / hw::ROWS);
  const Args a{static_cast<const float*>(sc), static_cast<const float*>(b1),
               static_cast<__nv_bfloat16*>(out), m, c, k, e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (normalize)
    head1_correlate_wgmma_kernel<true><<<grid, hw::THREADS, SMEM, s>>>(
        map_x, map_w, map_t, a);
  else
    head1_correlate_wgmma_kernel<false><<<grid, hw::THREADS, SMEM, s>>>(
        map_x, map_w, map_t, a);
  return static_cast<int>(cudaGetLastError());
}
