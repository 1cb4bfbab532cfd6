// Fused int8 head1 projection + normalized image-text correlation + the x2
// align-corners W-interp for Hopper (sm_90a), kernel B14.
//
// Replaces: lseg_tpu/ops/pallas_correlation.py · head1_correlate_wup_fused
// (Pallas TPU; body _head1_wup_kernel).
//
// Input: the int8 path1 codes xq (N, H, W, C), head1's int8 1x1 kernel w
// (E, C), sc (E,) = sx * s1, the fp32 bias (E,), and the text matrix tn
// (K, E) bf16, L2-normalised and multiplied by the temperature. Output:
// (N, H, 2W, K) bf16, the logits upsampled along W only (the caller's
// H-interp finishes the x2 upsample).
//
// Rounding points, as in the TPU kernel:
//   e   = acc * sc + b                  (int32 acc; fp32, no contraction)
//   lo  = bf16((bf16(e) . tn^T) * rsqrt(max(sum(e^2), 1e-24)))
//   out = bf16(a0 * lo[c] + a1 * lo[c + 1])   (fp32)
// where (a0, a1) are the two non-zero entries of the output column's row
// of the (2W, W) align-corners interp operator (lseg_tpu/ops/resize.py ·
// _interp_matrix: float64 source position, weights rounded to fp32, then
// to bf16). Each product of two bf16 values is exact in fp32, so the sum
// rounds once, as the TPU kernel's (2W, W) @ (W, K) product with fp32
// accumulation rounds it; the zeros of that operator add exactly 0. The
// logits lo are kernel B4's bits for the same inputs (head1_wgmma.cuh says
// why), so the output is the W-interp of B4's logits bit for bit.
//
// What bounds it on the card: at the flagship (8, 240, 240, 256) -> K =
// 150 the head1 product is 60.4 G int8 MAC (121 GOP) and the correlation
// 35.4 G bf16 MAC (71 GFLOP), ~0.13 ms at the tensor cores' peaks,
// against 118 MB of codes in (~0.035 ms) and 276 MB of logits out
// (~0.082 ms): the operations bound it, the output bytes close behind.
//
// Design: the tile of kernel B13 (head1_wgmma.cuh) on a persistent grid.
// A step is a strip of 127 source columns of one source row (128 pixels
// with the column it shares with the next strip) against a chunk of up to
// KG = 152 labels; the steps run chunk by chunk, row by row, strip by
// strip, and a CTA keeps one strip (the grid is a multiple of the strips),
// so the taps of its output columns are tabled once.
//   - A producer thread loads the step's codes (two 64-pixel boxes a
//     128-byte k-chunk) and, per quarter of 128 head1 channels, that
//     quarter's weight rows and the chunk's text columns into a two-stage
//     mbarrier ring, all by TMA;
//   - two consumer warpgroups, 64 pixels each, run the embed on s8 wgmma,
//     the dequant in registers and the correlate on wgmma m64n152k16
//     (RS), and hold the step's normalized logits in registers, 38 labels
//     of 2 pixels a thread;
//   - the W-interp needs a pixel's right neighbour, the lane 4 over
//     (rotated, so the eighth pixel's neighbour is the first lane's second
//     row), or (once a warp) the next warp's first pixel, handed over in
//     shared memory behind one barrier a step (B13's hand-off);
//   - each warp writes the outputs of its pixels in two passes of 8 pixels
//     (the rows g, then g + 8 of its lanes): each thread blends the output
//     columns whose left tap is its pixel into the warp's staging area in
//     shared memory, laid out as the output lies in device memory (the
//     pass's columns, each of the chunk's labels, at a pitch congruent to
//     the output's row pitch mod 16 bytes), so that the 16-byte aligned
//     middle of each contiguous range goes out by one bulk copy
//     (cp.async.bulk) and only its ends by 2-byte stores. With one chunk
//     (K <= 152) a pass is one contiguous range of (about 17, K) bf16;
//     with more, one range a column.
// Neither the (M, 512) embedding map nor the (N, H, W, K) logits reach
// device memory; the codes of the column two strips share are read twice
// (1/127 more). Labels past 152 run the steps again (the embed too) with
// the next chunk's text: the logits of different labels are independent.
// Budgets: 226 KB of shared memory (one CTA an SM); setmaxnreg gives the
// producer warpgroup 40 registers, the consumers 232. Limits: C <= 256,
// C % 32 == 0, E % 128 == 0, K >= 1.

#include "head1_wgmma.cuh"

namespace {

namespace hw = lseg::head1w;
namespace wg = lseg::wg;
namespace gm = lseg::gemm;

constexpr int STRIP = hw::ROWS - 1;      // source columns a strip owns
constexpr int NJ = 2 * STRIP + 8;        // output columns a strip can own
constexpr int CONSUMERS = 2 * hw::WG_THREADS;
constexpr int CWARPS = CONSUMERS / 32;
constexpr int CAP = 18;                  // output columns a staging pass
constexpr int PITCH_MAX = 2 * hw::KG + 16;  // a staged column's bytes
constexpr int REGION = CAP * PITCH_MAX + 16;  // a warp's staging area

struct Smem {
  hw::Pipe<1> p;
  uint8_t stage[CWARPS][REGION];
  uint32_t edge[2][CWARPS][4][hw::KT];  // each warp's first pixel's logits
  float col_a0[NJ], col_a1[NJ];
  int pix_j[hw::ROWS][2];  // the output columns a pixel owns: first, last
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + alignment slack
static_assert(REGION % 16 == 0, "staging areas stay 16-byte aligned");
static_assert(SMEM <= 232448, "one CTA an SM");

__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// `len` bytes (even) of shared memory at `s` to device memory at `g`, with
// s = g mod 16: the 16-byte aligned middle as one bulk copy of this
// thread's bulk group, the ends as 2-byte stores.
__device__ __forceinline__ void put_range(uint8_t* g, const uint8_t* s,
                                          int len) {
  const uintptr_t ga = reinterpret_cast<uintptr_t>(g);
  int head = static_cast<int>((16 - ga % 16) % 16);
  if (head > len) head = len;
  const int mid = (len - head) / 16 * 16;
  if (mid > 0)
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
            g + head),
        "r"(wg::smem_addr(s + head)), "r"(mid)
        : "memory");
  for (int b = 0; b < head; b += 2)
    *reinterpret_cast<uint16_t*>(g + b) =
        *reinterpret_cast<const uint16_t*>(s + b);
  for (int b = head + mid; b < len; b += 2)
    *reinterpret_cast<uint16_t*>(g + b) =
        *reinterpret_cast<const uint16_t*>(s + b);
}

struct Args {
  const float* sc;
  const float* b1;
  __nv_bfloat16* out;
  int W, C, K, E, strips, rows;  // rows: N x H source rows
};

__global__ void __launch_bounds__(hw::THREADS, 1) head1_wup_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_x,
    const __grid_constant__ CUtensorMap map_w,
    const __grid_constant__ CUtensorMap map_t, Args a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - wg::smem_addr(smem_raw) % 1024) % 1024));
  const int W = a.W, K = a.K;
  // this CTA's steps: its strip of rows row0, row0 + rs, ... (per of
  // them), for each label chunk in turn
  const int rs = gridDim.x / a.strips;
  const int c0 = (blockIdx.x % a.strips) * STRIP;
  const int row0 = blockIdx.x / a.strips;
  const int per = (a.rows - row0 + rs - 1) / rs;
  const int steps = (K + hw::KG - 1) / hw::KG * per;
  const int nq = a.E / hw::EQ;
  const int kcl = (a.C + 127) / 128;  // k-chunks TMA loads
  const int j0 = max(0, 2 * c0 - 3);

  hw::zero_unloaded(sm.p, kcl, hw::THREADS);
  if (threadIdx.x == 0) hw::init_pipe(sm.p, 1);
  // the bf16 weights of the output columns this CTA's strip may own
  for (int t = threadIdx.x; t < NJ; t += hw::THREADS) {
    int lo;
    float a0 = 0.0f, a1 = 0.0f;
    if (j0 + t < 2 * W) hw::taps(j0 + t, W, lo, a0, a1);
    sm.col_a0[t] = __bfloat162float(__float2bfloat16_rn(a0));
    sm.col_a1[t] = __bfloat162float(__float2bfloat16_rn(a1));
  }
  // pixel p of the strip owns the output columns whose left tap it is
  if (threadIdx.x < hw::ROWS) {
    const int p = threadIdx.x, c = c0 + p;
    int first = 0, last = -1;
    if (p < STRIP && c <= max(W - 2, 0)) {
      for (int t = 0; t < NJ && j0 + t < 2 * W; ++t) {
        int lo;
        float a0, a1;
        hw::taps(j0 + t, W, lo, a0, a1);
        if (lo == c) {
          if (last < first) first = j0 + t;
          last = j0 + t;
        }
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
      for (int ls = 0; ls < steps; ++ls) {
        const int ch = ls / per, row = row0 + (ls % per) * rs;
        hw::load_step(sm.p, &map_x, &map_w, &map_t, ls, row * W + c0, kcl,
                      nq, ch * hw::KG, 1, true, it);
      }
    }
    return;
  }

  gm::regs_inc<232>();
  const int ct = threadIdx.x - hw::WG_THREADS;  // 0 .. 255
  const int cw = ct / hw::WG_THREADS;
  const int cwarp = ct / 32;
  const int lane = ct % 32, g = lane / 4, t4 = lane % 4;
  uint8_t* const region = sm.stage[cwarp];
  uint32_t it = 0;
  for (int ls = 0; ls < steps; ++ls) {
    const int ch = ls / per, row = row0 + (ls % per) * rs;
    const int kt0 = ch * hw::KG, kc = min(hw::KG, K - kt0);
    // ---- the step's normalized logits ----
    float ss[2][2];
    float cacc[hw::KT][4];
    hw::codes_full(sm.p, ls);
    hw::step_sums(sm.p, a.sc, a.b1, nq, ls, true, cw, it, ss, cacc);
    uint32_t cur[2][hw::KT];
    hw::logits(cacc, ss, cur);

    // ---- the right neighbours: the next warp's first pixel ----
    const int buf = ls & 1;
    if (g == 0)
#pragma unroll
      for (int w = 0; w < hw::KT; ++w) sm.edge[buf][cwarp][t4][w] = cur[0][w];
    wg::named_sync(3, CONSUMERS);

    // the output's row pitch, and the staging pitch congruent to it mod 16
    const int pitch = kc == K ? 2 * K : 2 * kc + (2 * (K - kc)) % 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t nb[hw::KT];
#pragma unroll
      for (int w = 0; w < hw::KT; ++w) {
        const uint32_t next = __shfl_sync(
            0xffffffffu, h == 0 && lane < 4 ? cur[1][w] : cur[h][w],
            (lane + 4) & 31);
        nb[w] = g < 7 || h == 0 ? next
                : cwarp + 1 < CWARPS ? sm.edge[buf][cwarp + 1][t4][w]
                                     : cur[1][w];
        if (W == 1) nb[w] = cur[h][w];
      }
      // this pass's pixels 16 warp + 8 h .. + 7 own the output columns
      // jp .. jq, contiguous
      const int pix = 64 * cw + 16 * (cwarp % 4) + 8 * h + g;
      const int jf = sm.pix_j[pix][0], jl = sm.pix_j[pix][1];
      const bool owns = jl >= jf;
      const int jp = __reduce_min_sync(0xffffffffu, owns ? jf : 0x7fffffff);
      const int jq = __reduce_max_sync(0xffffffffu, owns ? jl : -1);
      for (int r0 = jp; r0 <= jq; r0 += CAP) {
        const int nr = min(CAP, jq - r0 + 1);
        // the first output element of the range and its staged copy
        __nv_bfloat16* const gout =
            a.out + (static_cast<long long>(row) * 2 * W + r0) * K + kt0;
        uint8_t* const s0 =
            region + reinterpret_cast<uintptr_t>(gout) % 16;
        // the previous pass's bulk copies have read the area
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        __syncwarp();
        for (int j = max(jf, r0); j <= min(jl, r0 + nr - 1); ++j) {
          const float a0 = sm.col_a0[j - j0], a1 = sm.col_a1[j - j0];
          uint8_t* const dst = s0 + (j - r0) * pitch + 4 * t4;
#pragma unroll
          for (int w = 0; w < hw::KT; ++w) {
            const uint32_t up = lseg::pack_f32(
                __fadd_rn(__fmul_rn(a0, bf_lo(cur[h][w])),
                          __fmul_rn(a1, bf_lo(nb[w]))),
                __fadd_rn(__fmul_rn(a0, bf_hi(cur[h][w])),
                          __fmul_rn(a1, bf_hi(nb[w]))));
            const int k = 8 * w + 2 * t4;  // the pair's first label
            if (k + 1 < kc && K % 2 == 0) {
              *reinterpret_cast<uint32_t*>(dst + 16 * w) = up;
            } else {
              if (k < kc)
                *reinterpret_cast<uint16_t*>(dst + 16 * w) =
                    static_cast<uint16_t>(up & 0xffffu);
              if (k + 1 < kc)
                *reinterpret_cast<uint16_t*>(dst + 16 * w + 2) =
                    static_cast<uint16_t>(up >> 16);
            }
          }
        }
        gm::fence_proxy_async();  // before the bulk copies read the area
        __syncwarp();
        if (kc == K) {  // one chunk: the columns are one range
          if (lane == 0)
            put_range(reinterpret_cast<uint8_t*>(gout), s0, nr * 2 * K);
        } else if (lane < nr) {  // a range a column
          put_range(reinterpret_cast<uint8_t*>(gout + lane * K),
                    s0 + lane * pitch, 2 * kc);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
  }
  // the last bulk copies have written their outputs
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace

// Launch on `stream`; returns the launch's error code (0 on success).
// Requires c % 32 == 0, c <= 256, e % 128 == 0, k >= 1, 16-byte aligned
// tensors (checked by the wrapper); `ctas` is the wrapper's grid, a
// multiple of the strips (`wup_grid`).
extern "C" int lseg_head1_correlate_wup(const void* xq, const void* w,
                                        const void* sc, const void* b1,
                                        const void* tn, void* out, int n,
                                        int h, int wd, int c, int e, int k,
                                        int ctas, void* stream) {
  const int strips = max(1, (wd - 1 + STRIP - 1) / STRIP);
  const long long rows = static_cast<long long>(n) * h;
  if (c % 32 || c > hw::MAX_C || e % hw::EQ || k < 1 || ctas < strips ||
      ctas % strips || rows * wd > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int attr = wg::allow_smem(head1_wup_wgmma_kernel, SMEM);
  if (attr != 0) return attr;
  CUtensorMap map_x, map_w, map_t;
  int rc = gm::make_map_2d(&map_x, xq, 1, c,
                           static_cast<long long>(n) * h * wd, 128, 64, true);
  if (rc == 0) rc = gm::make_map_2d(&map_w, w, 1, c, e, 128, hw::EQ, true);
  if (rc == 0) rc = gm::make_map_2d(&map_t, tn, 2, e, k, 64, hw::KG, true);
  if (rc != 0) return rc;
  // a multiple of the strips, at most one step a CTA
  const int grid = static_cast<int>(
      min(static_cast<long long>(ctas), rows * strips));
  const Args a{static_cast<const float*>(sc), static_cast<const float*>(b1),
               static_cast<__nv_bfloat16*>(out), wd, c, k, e, strips,
               static_cast<int>(rows)};
  head1_wup_wgmma_kernel<<<grid, hw::THREADS, SMEM,
                           static_cast<cudaStream_t>(stream)>>>(map_x, map_w,
                                                                map_t, a);
  return static_cast<int>(cudaGetLastError());
}
