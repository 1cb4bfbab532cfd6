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
// its own (__fmul_rn / __fadd_rn).
//
// What bounds it on the card: at the flagship (8, 240, 240, 256) -> K =
// 150 the head work of kernel B14 (121 GOP int8, 71 GFLOP bf16), ~0.13 ms
// at the tensor cores' peaks, plus ~1.7 GFLOP of fp32 blending, against
// 118 MB of codes in and 7.4 MB of labels out (~0.037 ms): the operations
// bound it. Design: the TPU kernel's band of R + 2 source rows x W x K
// logits (432 KB at R = 4, W = 240, K = 150) does not fit the 227 KB of an
// SM's shared memory, so the output is tiled in W too. One 256-thread
// block per (image, 8 output rows, 64 output columns) needs at most 6
// source rows x 34 source columns; it computes their logits with B4's
// tile code (head1_tile.cuh), 64 pixels at a time, into a (pixels, K)
// bf16 buffer in shared memory (60 KB at K = 150, beside the tile's
// 117 KB), recomputing the halo rows and columns that neighbouring blocks
// also compute (at the flagship ~5 x 33 pixels for 4 x 32 source pixels
// of output: x1.3, and x1.5 in 64-pixel tiles). Then each warp takes
// output pixels in turn: its lanes stride over K, blend along H and W from
// the shared buffer and keep a running (value, index) best, which a
// butterfly across the warp joins, first index on ties. Only the (N, 2H,
// 2W) int32 labels reach device memory.

#include "head1_tile.cuh"

namespace {

namespace h1 = lseg::head1;

constexpr int RO = 8;                   // output rows per block
constexpr int CO = 64;                  // output columns per block
constexpr int SRC_ROWS = RO / 2 + 2;    // source rows they can need
constexpr int SRC_COLS = CO / 2 + 2;    // source columns they can need
constexpr int MAX_PIX = SRC_ROWS * SRC_COLS;

// the line of _interp_matrix(in, 2 in, align_corners=True) for output o:
// lower source index and its fp32 weights (1 - frac, frac)
__device__ __forceinline__ void taps(int o, int in, int& lo, float& a0,
                                     float& a1) {
  if (in == 1) {
    lo = 0;
    a0 = 1.0f;
    a1 = 0.0f;
    return;
  }
  const double src = static_cast<double>(o) * (in - 1) / (2 * in - 1);
  lo = min(max(static_cast<int>(floor(src)), 0), in - 2);
  const double frac = src - lo;
  a0 = static_cast<float>(1.0 - frac);
  a1 = static_cast<float>(frac);
}

// the TPU kernel's H taps of output row o: first source row with a
// positive weight, and f = 1 - its weight (fp32)
__device__ __forceinline__ void h_taps(int o, int H, int& ho, float& f) {
  int lo;
  float a0, a1;
  taps(o, H, lo, a0, a1);
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

__global__ void __launch_bounds__(h1::THREADS) head1_up_argmax_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
    const float* __restrict__ sc, const float* __restrict__ b1,
    const __nv_bfloat16* __restrict__ tn, int* __restrict__ out, int H,
    int W, int C, int E, int K) {
  extern __shared__ __align__(16) unsigned char smem[];
  const h1::Tile t = h1::carve(smem, C, E);
  __nv_bfloat16* Ls = reinterpret_cast<__nv_bfloat16*>(smem + t.L.total);
  __shared__ int row_ho[RO];
  __shared__ float row_f[RO];
  __shared__ int col_lo[CO];
  __shared__ float col_a0[CO], col_a1[CO];

  const int n = blockIdx.z;
  const int o0 = blockIdx.y * RO;
  const int ow0 = blockIdx.x * CO;
  const int o_end = min(o0 + RO, 2 * H);
  const int ow_end = min(ow0 + CO, 2 * W);
  const int tid = threadIdx.x;

  // the source window [r_lo, r_hi] x [c_lo, c_hi] of the block's outputs
  int r_lo, r_hi, c_lo, c_hi;
  {
    float f, a0, a1;
    h_taps(o0, H, r_lo, f);
    h_taps(o_end - 1, H, r_hi, f);
    r_hi = min(r_hi + 1, H - 1);
    taps(ow0, W, c_lo, a0, a1);
    taps(ow_end - 1, W, c_hi, a0, a1);
    c_hi = min(c_hi + 1, W - 1);
  }
  const int nc = c_hi - c_lo + 1;
  const int npix = (r_hi - r_lo + 1) * nc;
  if (tid < RO && o0 + tid < o_end) {
    h_taps(o0 + tid, H, row_ho[tid], row_f[tid]);
  } else if (tid >= 32 && tid < 32 + CO && ow0 + tid - 32 < ow_end) {
    const int j = tid - 32;
    float a0, a1;
    taps(ow0 + j, W, col_lo[j], a0, a1);
    col_a0[j] = round_bf16(a0);
    col_a1[j] = round_bf16(a1);
  }

  // normalized logits of the window's pixels, 64 at a time
  const int xchunks = C / 16;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t4 = lane % 4;
  const int wr = (warp % 4) * 16;
  const int wc = warp / 4;
  for (int p0 = 0; p0 < npix; p0 += h1::BM) {
    for (int i = tid; i < h1::BM * xchunks; i += h1::THREADS) {
      const int r = i / xchunks;
      const int c = (i % xchunks) * 16;
      const int p = p0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (p < npix) {
        const long long m =
            (static_cast<long long>(n) * H + r_lo + p / nc) * W + c_lo +
            p % nc;
        v = *reinterpret_cast<const uint4*>(xq + m * C + c);
      }
      *reinterpret_cast<uint4*>(t.Xs + r * t.L.ldx + c) = v;
    }
    h1::embed(t, w, sc, b1, C, E);
    for (int k0 = 0; k0 < K; k0 += h1::KCH) {
      float acc[2][4];
      h1::correlate(t, tn, k0, K, E, acc);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = wr + g + 8 * half;
        const int p = p0 + lr;
        if (p >= npix) continue;
        const float inv =
            rsqrtf(fmaxf(t.ssq[lr] + t.ssq[h1::BM + lr], 1e-24f));
        __nv_bfloat16* lp = Ls + p * K;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = k0 + wc * 16 + j * 8 + 2 * t4;
          if (k < K)
            lp[k] = __float2bfloat16_rn(__fmul_rn(acc[j][2 * half], inv));
          if (k + 1 < K)
            lp[k + 1] =
                __float2bfloat16_rn(__fmul_rn(acc[j][2 * half + 1], inv));
        }
      }
    }
  }
  __syncthreads();

  // H-blend, W-interp and argmax: one output pixel per warp at a time
  const int ncols = ow_end - ow0;
  for (int q = warp; q < (o_end - o0) * ncols; q += h1::THREADS / 32) {
    const int oi = q / ncols;
    const int j = q % ncols;
    const int ho = row_ho[oi];
    const float fb = row_f[oi];
    const float fa = __fsub_rn(1.0f, fb);
    const int s0 = (ho - r_lo) * nc;
    const int s1 = (min(ho + 1, H - 1) - r_lo) * nc;
    const int lo = col_lo[j];
    const int c0 = lo - c_lo;
    const int c1 = min(lo + 1, W - 1) - c_lo;
    const float a0 = col_a0[j], a1 = col_a1[j];
    const __nv_bfloat16* p00 = Ls + (s0 + c0) * K;
    const __nv_bfloat16* p10 = Ls + (s1 + c0) * K;
    const __nv_bfloat16* p01 = Ls + (s0 + c1) * K;
    const __nv_bfloat16* p11 = Ls + (s1 + c1) * K;
    float best = -INFINITY;
    int arg = 0x7fffffff;
    for (int k = lane; k < K; k += 32) {
      const float hb0 = round_bf16(
          __fadd_rn(__fmul_rn(__bfloat162float(p00[k]), fa),
                    __fmul_rn(__bfloat162float(p10[k]), fb)));
      const float hb1 = round_bf16(
          __fadd_rn(__fmul_rn(__bfloat162float(p01[k]), fa),
                    __fmul_rn(__bfloat162float(p11[k]), fb)));
      const float v =
          round_bf16(__fadd_rn(__fmul_rn(a0, hb0), __fmul_rn(a1, hb1)));
      if (lseg::argmax_better(v, k, best, arg)) {
        best = v;
        arg = k;
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) lseg::argmax_xor(best, arg, s);
    if (lane == 0) {
      out[(static_cast<long long>(n) * 2 * H + o0 + oi) * 2 * W + ow0 + j] =
          arg;
    }
  }
}

}  // namespace

// Launch on `stream`; returns cudaGetLastError() (0 on success).
// Requires c % 32 == 0, e % 128 == 0, k >= 1, the tile plus 204 * k bf16
// logits within the 227 KB of shared memory, 2h / 8 <= 65535 and
// 16-byte aligned tensors (checked by the wrapper).
extern "C" int lseg_head1_correlate_upsample_argmax(
    const void* xq, const void* w, const void* sc, const void* b1,
    const void* tn, void* out, int n, int h, int wd, int c, int e, int k,
    void* stream) {
  const size_t smem = h1::layout(c, e).total +
                      static_cast<size_t>(MAX_PIX) * k * sizeof(__nv_bfloat16);
  int rc = static_cast<int>(cudaFuncSetAttribute(
      head1_up_argmax_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  if (rc != 0) return rc;
  const dim3 grid((2 * wd + CO - 1) / CO, (2 * h + RO - 1) / RO, n);
  head1_up_argmax_kernel<<<grid, h1::THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
      static_cast<const float*>(sc), static_cast<const float*>(b1),
      static_cast<const __nv_bfloat16*>(tn), static_cast<int*>(out), h, wd, c,
      e, k);
  return static_cast<int>(cudaGetLastError());
}
