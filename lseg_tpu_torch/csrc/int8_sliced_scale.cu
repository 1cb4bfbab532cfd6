// Int8 product with three summed 128-wide scale slices for Hopper
// (sm_90a), kernel B20.
//
// Replaces: scripts/mosaic_probe.py · main (Pallas TPU; body kernel), the
// probe of the Mosaic toolchain regression that rejected a lane-offset
// slice of a one-row scale block broadcast against an accumulator. The
// function it compiles, for each of its four variants:
//
//   acc (M, 128) = int32(x (M, K) int8 . w (K, 128) int8), as fp32 (exact:
//                  |acc| <= K * 128^2 <= 2^24 for K <= 1024)
//   out (M, 128) bf16 = bf16(((0 + acc * s0) + acc * s1) + acc * s2)
//
// s_i the i-th 128-wide slice of 384 fp32 scales, each broadcast along the
// rows; the leading 0 is Python's `sum(parts)` start. The variants differ
// only in how the TPU block holds the 384 scales ((1, 1, 384) or (3, 128))
// and indexes them; the floats, and so this kernel, are the same for all
// four. Every product and sum is an `_rn` intrinsic in the reference's
// order (no FMA contraction), so the result equals the plain version bit
// for bit.
//
// What bounds it on the card: at the reference's x (2, 904, 1024), w
// (1024, 128) the product is 0.47 GOP of int8 (~0.24 us at 1979 TOP/s)
// against ~2.4 MB moved (~0.73 us): bytes, and a launch costs more than
// either. So the design spreads the little work over as many SMs as it
// can, each in one shot: M in tiles of 64 rows (29 at M = 1808), K split
// over a cluster of four CTAs (116 CTAs). A CTA loads its 64 rows of x
// over its quarter of K (at most 256 codes, two 128-byte swizzled boxes)
// by TMA, and writes its quarter of w transposed into the K-major layout
// that 8-bit wgmma reads (w (K, 128) is N-major; 4 x 16 byte blocks
// turned by byte permutes, so no transposed copy of w is made in device
// memory), then one warpgroup runs s8 wgmma m64n128k32 into int32. The
// four int32 partials of a tile meet over distributed shared memory:
// warp w of every CTA holds rows 16w .. 16w + 15 of the tile and stores
// them into CTA w's slot of the sender's rank; after a cluster barrier
// each CTA sums its four slots (exact, so in any order) and runs the `_rn`
// epilogue on its 16 rows. Rows past M are zero-filled by TMA and never
// stored. Limits (checked by the wrapper): K % 64 == 0, 0 < K <= 1024.

#include "cluster.cuh"
#include "wgmma_gemm.cuh"

namespace {

namespace wg = lseg::wg;
namespace gm = lseg::gemm;
namespace cl = lseg::cluster;

constexpr int SLICE = 128;    // output columns, and the width of each slice
constexpr int BM = 64;        // rows of a tile: one warpgroup's product
constexpr int SPLIT = 4;      // CTAs of a cluster: each a quarter of K
constexpr int ROWS = BM / SPLIT;  // rows a CTA finishes: 16, one warp's
constexpr int THREADS = 128;  // one warpgroup
constexpr int BOX = 128;      // codes of a 128-byte swizzled row
constexpr int MAX_BOXES = 2;  // a quarter of K <= 1024: at most 256 codes
constexpr int MAX_STEPS = MAX_BOXES * BOX / 32;  // k-steps of 32 a CTA

struct Smem {
  uint8_t a[MAX_BOXES][BM * BOX];     // x: 64 rows, K-major (TMA)
  uint8_t b[MAX_BOXES][SLICE * BOX];  // w^T: 128 rows, K-major (written)
  int part[SPLIT][ROWS][SLICE];       // the cluster's partials of my rows
  uint64_t bar;
};
constexpr int SMEM = sizeof(Smem) + 1024;  // + alignment slack

// Rows k .. k + 3 of w (four 16-byte runs of 16 columns) as the 16 words
// of those columns, each the four codes of its column, first in the low
// byte: a 4 x 16 byte transpose.
__device__ __forceinline__ void transpose4x16(const uint4 (&r)[4],
                                              uint32_t (&col)[16]) {
  const uint32_t* w0 = reinterpret_cast<const uint32_t*>(&r[0]);
  const uint32_t* w1 = reinterpret_cast<const uint32_t*>(&r[1]);
  const uint32_t* w2 = reinterpret_cast<const uint32_t*>(&r[2]);
  const uint32_t* w3 = reinterpret_cast<const uint32_t*>(&r[3]);
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const int q = c / 4, b = c % 4;
    const uint32_t sel = b | ((4 + b) << 4);
    const uint32_t lo = __byte_perm(w0[q], w1[q], sel);
    const uint32_t hi = __byte_perm(w2[q], w3[q], sel);
    col[c] = __byte_perm(lo, hi, 0x5410);
  }
}

__global__ void __launch_bounds__(THREADS, 1) int8_sliced_scale_kernel(
    const __grid_constant__ CUtensorMap map_x, const int8_t* __restrict__ w,
    const float* __restrict__ sw, __nv_bfloat16* __restrict__ out, int M,
    int K) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      smem_raw + ((1024 - wg::smem_addr(smem_raw) % 1024) % 1024));
  const int rank = cl::rank();
  const int m0 = blockIdx.x / SPLIT * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // this CTA's k-steps of 32 codes: [s0, s1) of K / 32
  const int steps = K / 32;
  const int per = (steps + SPLIT - 1) / SPLIT;
  const int s0 = min(rank * per, steps), s1 = min(s0 + per, steps);
  const int k0 = s0 * 32, k1 = s1 * 32;
  const int boxes = (s1 - s0 + 3) / 4;

  cl::arrive();  // waited for before the first store into a peer
  if (tid == 0) {
    wg::bar_init(&sm.bar, 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  if (tid == 0 && boxes > 0) {
    wg::bar_expect_tx(&sm.bar, boxes * BM * BOX);
    for (int j = 0; j < boxes; ++j)
      gm::tma_load_2d(sm.a[j], &map_x, &sm.bar, k0 + j * BOX, m0);
  }
  // w's rows k0 .. k1 - 1 into w^T: item (box j, 16 columns n16), lane a
  // run of four rows; a store a column, the lanes along a swizzled row
  for (int item = warp; item < boxes * (SLICE / 16); item += 4) {
    const int j = item / (SLICE / 16), n16 = item % (SLICE / 16);
    uint4 r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + j * BOX + 4 * lane + i;
      r[i] = k < k1 ? __ldg(reinterpret_cast<const uint4*>(
                          w + static_cast<long long>(k) * SLICE + 16 * n16))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    uint32_t col[16];
    transpose4x16(r, col);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int n = 16 * n16 + c;
      *reinterpret_cast<uint32_t*>(sm.b[j] + n * BOX +
                                   (((lane / 4) ^ (n & 7)) << 4) +
                                   (lane % 4) * 4) = col[c];
    }
  }
  gm::fence_proxy_async();  // w^T's generic writes before wgmma reads them
  __syncthreads();

  int acc[SLICE / 8][4];
  gm::zero(acc);
  if (s1 > s0) {
    wg::bar_wait(&sm.bar, 0);
    gm::fence_acc(acc);
    wg::fence();
#pragma unroll
    for (int s = 0; s < MAX_STEPS; ++s) {
      if (s < s1 - s0)
        gm::MmaS8<SLICE>::ss(acc,
                             wg::desc_kstep(wg::desc(sm.a[s / 4]), s % 4),
                             wg::desc_kstep(wg::desc(sm.b[s / 4]), s % 4), 1);
    }
    wg::commit();
    wg::wait<0>();
    gm::fence_acc(acc);
  }

  // warp w's 16 rows belong to CTA w: into its slot `rank`
  cl::wait();  // every CTA of the cluster has started
  {
    const int g = lane / 4, t4 = lane % 4;
#pragma unroll
    for (int nt = 0; nt < SLICE / 8; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        cl::st_peer(cl::peer_addr(&sm.part[rank][g + 8 * h][nt * 8 + 2 * t4],
                                  warp),
                    static_cast<uint32_t>(acc[nt][2 * h]),
                    static_cast<uint32_t>(acc[nt][2 * h + 1]));
  }
  cl::sync();  // every partial of my rows has landed

  // my 16 rows: warp w rows 4w .. 4w + 3, lane columns 4 lane .. + 3
  const int c = 4 * lane;
  const float4 sc0 = __ldg(reinterpret_cast<const float4*>(sw + c));
  const float4 sc1 = __ldg(reinterpret_cast<const float4*>(sw + SLICE + c));
  const float4 sc2 =
      __ldg(reinterpret_cast<const float4*>(sw + 2 * SLICE + c));
  const float s[3][4] = {{sc0.x, sc0.y, sc0.z, sc0.w},
                         {sc1.x, sc1.y, sc1.z, sc1.w},
                         {sc2.x, sc2.y, sc2.z, sc2.w}};
#pragma unroll
  for (int i = 0; i < ROWS / 4; ++i) {
    const int row = 4 * warp + i;
    const int m = m0 + rank * ROWS + row;
    int sum[4] = {0, 0, 0, 0};
#pragma unroll
    for (int p = 0; p < SPLIT; ++p) {
      const int4 v = *reinterpret_cast<const int4*>(&sm.part[p][row][c]);
      sum[0] += v.x;
      sum[1] += v.y;
      sum[2] += v.z;
      sum[3] += v.w;
    }
    if (m >= M) continue;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float a = __int2float_rn(sum[e]);
      float t = __fadd_rn(0.0f, __fmul_rn(a, s[0][e]));
      t = __fadd_rn(t, __fmul_rn(a, s[1][e]));
      v[e] = __fadd_rn(t, __fmul_rn(a, s[2][e]));
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(out + static_cast<long long>(m) * SLICE + c) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
}

}  // namespace

// Launch on `stream`; returns the launch's error code (0 on success).
// x (m, k) int8, w (k, 128) int8, sw 384 fp32, out (m, 128) bf16.
// Requires k % 64 == 0, 0 < k <= 1024, m >= 1 and 16-byte aligned tensors
// (checked by the wrapper).
extern "C" int lseg_int8_sliced_scale(const void* x, const void* w,
                                      const void* sw, void* out, int m,
                                      int k, void* stream) {
  if (k % 64 || k < 64 || k > 1024 || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  static const int attr = wg::allow_smem(int8_sliced_scale_kernel, SMEM);
  if (attr != 0) return attr;
  CUtensorMap map_x;
  const int rc = gm::make_map_2d(&map_x, x, 1, k, m, BOX, BM, true);
  if (rc != 0) return rc;
  cl::Launch l(dim3((m + BM - 1) / BM * SPLIT), THREADS, SMEM, SPLIT,
               static_cast<cudaStream_t>(stream));
  const cudaError_t e = cudaLaunchKernelEx(
      &l.cfg, int8_sliced_scale_kernel, map_x,
      static_cast<const int8_t*>(w), static_cast<const float*>(sw),
      static_cast<__nv_bfloat16*>(out), m, k);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
