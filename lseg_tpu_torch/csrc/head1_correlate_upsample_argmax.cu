// Fused int8 head1 projection + normalized image-text correlation + x2
// align-corners bilinear upsample + argmax over K for Hopper (sm_90a),
// kernel B13.
//
// Replaces: lseg_tpu/ops/pallas_correlation.py ·
// head1_correlate_upsample_argmax (Pallas TPU; body
// _head1_up_argmax_kernel).
//
// Input: the int8 path1 codes xq (N, H, W, C), head1's int8 1x1 kernel w
// (E, C), sc (E,) = sx * s1, the fp32 bias (E,), and the text matrix tn
// (K, E) bf16, L2-normalised and multiplied by the temperature. Output:
// (N, 2H, 2W) int32 labels.
//
// Rounding points, as in the TPU kernel:
//   e     = acc * sc + b                 (int32 acc; fp32, no contraction)
//   lo    = bf16((bf16(e) . tn^T) * rsqrt(max(sum(e^2), 1e-24)))
//   hb    = bf16(lo[ho] * (1 - f) + lo[ho + 1] * f)        (fp32)
//   up    = bf16(a0 * hb[c] + a1 * hb[c + 1])               (fp32)
//   label = the first k of the largest up (jnp.argmax order)
// (ho, f) are the TPU kernel's H taps: ho the first source row with a
// positive weight in the output row's line of the align-corners interp
// operator (lseg_tpu/ops/resize.py · _interp_matrix: float64 source
// position, weights rounded to fp32), f = 1 - that weight in fp32; row
// ho + 1 is clamped to H - 1, where f is 0. (a0, a1) are the two non-zero
// entries of the output column's line of the same operator along W,
// rounded to bf16: each product of two bf16 values is exact in fp32, so
// the sum rounds once, as the TPU kernel's (2W, W) @ (W, K) product with
// fp32 accumulation rounds it. Every other product and sum is rounded on
// its own (__fmul_rn / __fadd_rn). The logits lo are kernel B4's bits for
// the same inputs (head1_wgmma.cuh says why), so the labels equal the
// plain tail of B4's logits everywhere.
//
// What bounds it on the card: at the flagship (8, 240, 240, 256) -> K =
// 150 the head work of kernel B14 (121 GOP int8, 71 GFLOP bf16), ~0.13 ms
// at the tensor cores' peaks, plus ~1.7 GFLOP of fp32 blending, against
// 118 MB of codes in and 7.4 MB of labels out (~0.037 ms): the operations
// bound it.
//
// Design: every source pixel's logits once, or nearly. A CTA owns a strip
// of 127 source columns (128 with the one it shares with the next strip)
// and a segment of source rows, and walks down the segment one source row
// (a step of 128 pixels) at a time:
//   - a producer thread loads the row's codes (two 64-pixel boxes a
//     128-byte k-chunk) and, per quarter of 128 head1 channels, that
//     quarter's weight rows and text columns into a two-stage mbarrier
//     ring, all by TMA (head1_wgmma.cuh's layout);
//   - two consumer warpgroups, 64 pixels each, run the embed on s8 wgmma,
//     the dequant in registers and the correlate on wgmma m64n152k16
//     (RS), and hold the row's normalized logits in registers, 38 labels
//     of 2 pixels a thread;
//   - the output rows whose first H tap is the previous row are blended
//     along H once per (output row, source column, label) from the
//     previous row's logits (kept in shared memory by the thread that
//     computed them) and this row's; the W-interp then needs a pixel's
//     right neighbour, which is the lane 4 over (rotated, so the eighth
//     pixel's neighbour is the first lane's second row), or (once a
//     warp) the next warp's first pixel, handed over in shared memory
//     behind one barrier a row; each thread takes the
//     output columns whose left tap is its pixel, reduces its 38 labels
//     and joins its
//     quad's four partial (value, index) maxima in two shuffles;
//   - this row's logits become the previous row's.
// Strips overlap by one source column and segments by one source row, so
// at the flagship (two strips, eight segments of 30 rows, 128 CTAs) the
// logits of 1.07 x 1.03 the source pixels are computed (the grid is
// chosen by the wrapper, `ops/head1_correlate.py` · b13_grid). Only the
// (N, 2H, 2W) int32 labels reach device memory. Budgets: 220 KB of shared
// memory (one CTA an SM); setmaxnreg gives the producer warpgroup 40
// registers, the consumers 232. Limits: C <= 256, C % 32 == 0, E % 128 ==
// 0, K <= 65535 (a label fits the key's 16 bits), segments of at most 64
// rows.
//
// More than KG = 152 labels: the walk runs once a chunk of up to 152
// labels (the embed again each time; a second instance of the kernel, so
// that K <= 152 runs the one-chunk code). The H-blend and the W-interp are
// linear per label, so each chunk's outputs are the full map's for its
// labels, and a chunked argmax is exact. A thread emits the same output
// pixels in every chunk, so it keeps each pixel's running key in the
// label map itself: after chunk 0 it stores the key, after a later one the
// larger of the stored key and its own (keys of different labels never
// tie; on equal values the smaller label wins, as in one pass), after the
// last one the label. K <= 152 is one pass, as before.

#include "head1_wgmma.cuh"

namespace {

namespace hw = lseg::head1w;
namespace wg = lseg::wg;
namespace gm = lseg::gemm;

constexpr int STRIP = hw::ROWS - 1;      // source columns a strip owns
constexpr int MAX_SEG = 64;              // source rows a segment owns
constexpr int NR = 2 * MAX_SEG + 8;      // output rows a segment can own
constexpr int NJ = 2 * STRIP + 8;        // output columns a strip can own
constexpr int CONSUMERS = 2 * hw::WG_THREADS;
constexpr int CWARPS = CONSUMERS / 32;
constexpr int WORDS = 2 * hw::KT;        // bf16 pairs of a thread's logits

struct Smem {
  hw::Pipe<1> p;
  uint32_t prev[WORDS][CONSUMERS];  // the previous row's logits, by thread
  uint32_t edge[2][CWARPS][4][hw::KT];  // each warp's first pixel's blend
  int row_ho[NR];
  float row_f[NR];
  int col_lo[NJ];
  float col_a0[NJ], col_a1[NJ];
  int pix_j[hw::ROWS][2];  // the output columns a pixel owns: first, last
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + alignment slack

// the TPU kernel's H taps of output row o: first source row with a
// positive weight, and f = 1 - its weight (fp32)
__device__ __forceinline__ void h_taps(int o, int H, int& ho, float& f) {
  int lo;
  float a0, a1;
  hw::taps(o, H, lo, a0, a1);
  if (a0 > 0.0f) {
    ho = lo;
    f = __fsub_rn(1.0f, a0);
  } else {
    ho = lo + 1;
    f = __fsub_rn(1.0f, a1);
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// bf16(p0 * fa + p1 * fb) of both halves of a pair
__device__ __forceinline__ uint32_t blend(uint32_t p0, uint32_t p1, float fa,
                                          float fb) {
  return lseg::pack_f32(
      __fadd_rn(__fmul_rn(bf_lo(p0), fa), __fmul_rn(bf_lo(p1), fb)),
      __fadd_rn(__fmul_rn(bf_hi(p0), fa), __fmul_rn(bf_hi(p1), fb)));
}

// An order-preserving key of (bf16 value b, label k): the larger value
// first, NaN above every number, equal values (-0 and +0 among them) to
// the smaller k, as jnp.argmax orders them: 0x8000 +- |b| (a conditional
// negate: -0 and +0 meet) in the high half, 0xffff - k in the low half.
// No branch: written with ternaries over key parts, ptxas branched on
// each label's sign and lanes diverged.
__device__ __forceinline__ uint32_t label_key(uint32_t b, uint32_t k) {
  const uint32_t mag = b & 0x7fffu, neg = (b >> 15) & 1u;
  uint32_t v = 0x8000u + ((mag ^ (0u - neg)) + neg);
  v = mag > 0x7f80u ? 0xffffu : v;  // NaN
  return (v << 16) | (0xffffu - k);
}

struct Args {
  const float* sc;
  const float* b1;
  int* out;
  int H, W, C, K, E, seg;
};

// MULTI: more than one label chunk (the keys kept in the label map)
template <bool MULTI>
__global__ void __launch_bounds__(hw::THREADS, 1) head1_up_argmax_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_t, Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - wg::smem_addr(smem_raw) % 1024) % 1024));
  const int H = a.H, W = a.W;
  const int c0 = blockIdx.x * STRIP;
  const int ra = blockIdx.y * a.seg, rb = min(ra + a.seg, H);
  const int n = blockIdx.z;
  const int steps = min(rb, H - 1) - ra + 1;
  const int nq = a.E / hw::EQ;
  const int o0 = max(0, 2 * ra - 3), j0 = max(0, 2 * c0 - 3);
  const int kcl = (a.C + 127) / 128;  // k-chunks TMA loads
  const int chunks = MULTI ? (a.K + hw::KG - 1) / hw::KG : 1;

  hw::zero_unloaded(sm.p, kcl, hw::THREADS);

  // the taps of the output rows and columns this CTA may own
  if (threadIdx.x == 0) hw::init_pipe(sm.p, 1);
  for (int t = threadIdx.x; t < NR; t += hw::THREADS) {
    int ho = -1;
    float f = 0.0f;
    if (o0 + t < 2 * H) h_taps(o0 + t, H, ho, f);
    sm.row_ho[t] = ho;
    sm.row_f[t] = f;
  }
  for (int t = threadIdx.x; t < NJ; t += hw::THREADS) {
    int lo = -1;
    float a0 = 0.0f, a1 = 0.0f;
    if (j0 + t < 2 * W) hw::taps(j0 + t, W, lo, a0, a1);
    sm.col_lo[t] = lo;
    sm.col_a0[t] = round_bf16(a0);
    sm.col_a1[t] = round_bf16(a1);
  }
  __syncthreads();
  // pixel p of the strip owns the output columns whose left tap it is
  if (threadIdx.x < hw::ROWS) {
    const int p = threadIdx.x, c = c0 + p;
    int first = 0, last = -1;
    if (p < STRIP && c <= max(W - 2, 0)) {
      for (int t = 0; t < NJ; ++t)
        if (sm.col_lo[t] == c) {
          if (last < first) first = j0 + t;
          last = j0 + t;
        }
    }
    sm.pix_j[p][0] = first;
    sm.pix_j[p][1] = last;
  }
  __syncthreads();

  const int wg_id = threadIdx.x / hw::WG_THREADS;
  if (wg_id == 0) {
    gm::regs_dec<40>();
    if (threadIdx.x == 0) {
      uint32_t it = 0;
      for (int ls = 0; ls < chunks * steps; ++ls) {
        const int ch = MULTI ? ls / steps : 0;
        const int step = MULTI ? ls % steps : ls;
        hw::load_step(sm.p, &map_x, &map_w, &map_t, ls,
                      (n * H + ra + step) * W + c0, kcl, nq, ch * hw::KG, 1,
                      true, it);
      }
    }
    return;
  }

  gm::regs_inc<232>();
  const int ct = threadIdx.x - hw::WG_THREADS;  // 0 .. 255
  const int cw = ct / hw::WG_THREADS;
  const int warp = (ct / 32) % 4, cwarp = ct / 32;
  const int lane = ct % 32, g = lane / 4, t4 = lane % 4;
  const int pix[2] = {64 * cw + 16 * warp + g, 64 * cw + 16 * warp + g + 8};
  int tp0 = 0;  // the first output row of the table to emit
  while (tp0 < NR && sm.row_ho[tp0] >= 0 && sm.row_ho[tp0] < ra) ++tp0;
  int tp = tp0;  // the next output row of the table to emit
  uint32_t it = 0;
  for (int ls = 0; ls < chunks * steps; ++ls) {
    const int ch = MULTI ? ls / steps : 0;
    const int step = MULTI ? ls % steps : ls;
    const int kt0 = ch * hw::KG;  // the chunk's first label
    if (MULTI && step == 0) tp = tp0;
    const int r = ra + step;
    // ---- the row's normalized logits ----
    float ss[2][2];
    float cacc[hw::KT][4];
    hw::codes_full(sm.p, ls);
    hw::step_sums(sm.p, a.sc, a.b1, nq, ls, true, cw, it, ss, cacc);
    uint32_t cur[2][hw::KT];
    hw::logits(cacc, ss, cur);

    // ---- the output rows whose taps are rows r - 1 and r (or r, r) ----
    const bool last = r == H - 1 && r < rb;
    while (tp < NR) {
      const int ho = sm.row_ho[tp];
      const bool from_prev = r > ra && ho == r - 1;
      if (ho < 0 || !(from_prev || (last && ho == r))) break;
      const int o = o0 + tp;
      const float fb = sm.row_f[tp];
      const float fa = __fsub_rn(1.0f, fb);
      const int buf = tp & 1;
      uint32_t hb[2][hw::KT];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int w = 0; w < hw::KT; ++w)
          hb[h][w] = blend(from_prev ? sm.prev[h * hw::KT + w][ct] : cur[h][w],
                           cur[h][w], fa, fb);
      if (g == 0)
#pragma unroll
        for (int w = 0; w < hw::KT; ++w) sm.edge[buf][cwarp][t4][w] = hb[0][w];
      wg::named_sync(3, CONSUMERS);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the blend of the right neighbour pixel, same labels: pixel
        // p + 1 is lane + 4's of the same row (g < 7); for the last row g
        // = 7 of the first half (h = 0), pixel 8 of the warp, lane t4's
        // second row, which a rotation by 4 lanes brings too; of the
        // second half, the next warp's first pixel
        uint32_t nb[hw::KT];
#pragma unroll
        for (int w = 0; w < hw::KT; ++w) {
          const uint32_t next = __shfl_sync(
              0xffffffffu, h == 0 && lane < 4 ? hb[1][w] : hb[h][w],
              (lane + 4) & 31);
          nb[w] = g < 7 || h == 0 ? next
                  : cwarp + 1 < CWARPS ? sm.edge[buf][cwarp + 1][t4][w]
                                       : hb[1][w];
          if (W == 1) nb[w] = hb[h][w];
        }
        const int jf = sm.pix_j[pix[h]][0], jl = sm.pix_j[pix[h]][1];
        const int cnt = jl - jf + 1;
        const int jmax = __reduce_max_sync(0xffffffffu, max(cnt, 0));
        for (int jj = 0; jj < jmax; ++jj) {
          const bool valid = jj < cnt;
          const int t = valid ? jf + jj - j0 : 0;
          const float a0 = sm.col_a0[t], a1 = sm.col_a1[t];
          // the largest (bf16 value, first label) as one unsigned key
          uint32_t best = 0u;
#pragma unroll
          for (int w = 0; w < hw::KT; ++w) {
            const uint32_t up = lseg::pack_f32(
                __fadd_rn(__fmul_rn(a0, bf_lo(hb[h][w])),
                          __fmul_rn(a1, bf_lo(nb[w]))),
                __fadd_rn(__fmul_rn(a0, bf_hi(hb[h][w])),
                          __fmul_rn(a1, bf_hi(nb[w]))));
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const uint32_t k = kt0 + 8 * w + 2 * t4 + e;
              // labels past K (zero-filled text rows) take key 0
              best = max(best, label_key(e ? up >> 16 : up & 0xffffu, k) &
                                   (0u - static_cast<uint32_t>(
                                            k < static_cast<uint32_t>(a.K))));
            }
          }
          best = max(best, __shfl_xor_sync(0xffffffffu, best, 1));
          best = max(best, __shfl_xor_sync(0xffffffffu, best, 2));
          if (valid && t4 == 0) {
            int* op = a.out + (static_cast<long long>(n) * 2 * H + o) * 2 * W +
                      jf + jj;
            if (MULTI && ch > 0)
              best = max(best, static_cast<uint32_t>(*op));
            *op = MULTI && ch + 1 < chunks
                      ? static_cast<int>(best)
                      : 0xffff - static_cast<int>(best & 0xffffu);
          }
        }
      }
      ++tp;
    }
    // this row's logits become the previous row's (this thread's own)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int w = 0; w < hw::KT; ++w) sm.prev[h * hw::KT + w][ct] = cur[h][w];
  }
}

}  // namespace

// Launch on `stream`; returns the launch's error code (0 on success).
// Requires c % 32 == 0, c <= 256, e % 128 == 0, 1 <= k <= 65535,
// 1 <= seg <= 64 and 16-byte aligned tensors (checked by the wrapper,
// which picks seg).
extern "C" int lseg_head1_correlate_upsample_argmax(
    const void* xq, const void* w, const void* sc, const void* b1,
    const void* tn, void* out, int n, int h, int wd, int c, int e, int k,
    int seg, void* stream) {
  if (c % 32 || c > hw::MAX_C || e % hw::EQ || k < 1 || k > 0xffff ||
      seg < 1 || seg > MAX_SEG)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int attr =
      max(wg::allow_smem(head1_up_argmax_wgmma_kernel<false>, SMEM),
          wg::allow_smem(head1_up_argmax_wgmma_kernel<true>, SMEM));
  if (attr != 0) return attr;
  CUtensorMap map_x, map_w, map_t;
  int rc = gm::make_map_2d(&map_x, xq, 1, c,
                           static_cast<long long>(n) * h * wd, 128, 64, true);
  if (rc == 0) rc = gm::make_map_2d(&map_w, w, 1, c, e, 128, hw::EQ, true);
  if (rc == 0) rc = gm::make_map_2d(&map_t, tn, 2, e, k, 64, hw::KG, true);
  if (rc != 0) return rc;
  const dim3 grid(max(1, (wd - 1 + STRIP - 1) / STRIP), (h + seg - 1) / seg,
                  n);
  const Args a{static_cast<const float*>(sc), static_cast<const float*>(b1),
               static_cast<int*>(out), h, wd, c, k, e, seg};
  auto* kernel = k > hw::KG ? head1_up_argmax_wgmma_kernel<true>
                            : head1_up_argmax_wgmma_kernel<false>;
  kernel<<<grid, hw::THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      map_x, map_w, map_t, a);
  return static_cast<int>(cudaGetLastError());
}
