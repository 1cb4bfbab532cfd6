// The fp32 mode of flash attention over the flat fused-qkv layout for
// Hopper (sm_90a), the route of an fp32 model (`train --dtype float32`):
// kernel B7 (the backward); the forward, B6's fp32 mode, is
// flash_attention_flat_fp32.cu.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · _flash_flat_bwd_impl
// (Pallas TPU) for fp32 inputs. The TPU kernel takes any qkv dtype; in
// fp32 the casts of pn and ds are no-ops, so every step below is fp32:
//   pn = exp(s - lse); dv = pn^T . dO; dp = dO . v^T;
//   Dr = rowsum(dO * O); ds = pn * (dp - Dr);
//   dq = (ds . k) * scale; dk = (ds^T . q) * scale
// with s = (q . k^T) * scale. Keys at or past `valid_len` are masked. The
// backward reads the forward's lse instead of recomputing the row
// statistics: it differs from the reference at fp32 rounding.
// Exponentials are expf (full precision).
//
// What bounds it on the card: the products. At the flagship (8, 901,
// 3072) with 16 heads the least work is five products of 2*T*T*64 FLOP
// per head, 66.5 GFLOP: 0.99 ms of fp32 FMAs at 67 TFLOP/s, or 0.403 ms
// as split-TF32 tensor-core products (tf32x3.cuh: three TF32 products of
// each operand's hi and lo keep ~21 bits of each, inside the 1e-4 gate,
// where one TF32 product would round the operands to 10 bits); inputs
// are 89 MB (0.03 ms).
//
// Design: split TF32 on mma.sync m16n8k8 (tf32 wgmma reads only K-major
// operands, and three of the backward's products contract over the rows
// of a staged tile: dV += pn^T . dO, dK += ds^T . Q, dQ += ds . K). One
// 256-thread block per (64-row tile, head, image); warp w takes rows
// 16 (w % 4).. of the block's tile against one half, 32 (w / 4).., of
// the other tile's 64 rows, so each of the two warps of a row group sums
// its rows' dQ (dK, dV) over half of the keys (queries), and the halves
// are added once, through shared memory, at the end. Tiles are staged as
// padded fp32 rows (68 floats, so every fragment load of a warp hits 32
// distinct banks) by cp.async into a two-stage ring, the next tile's
// copies in flight under this tile's products; fragments are read from
// the tiles in either orientation (the transpose is free at the load)
// and split in registers. A score tile in the C layout feeds the product
// over its columns from registers: its columns 2t and 2t + 1 of each 8
// become the A fragment's columns t and t + 4, and the B fragment reads
// the matching rows of the staged tile. The column halves keep a thread
// at 128 registers, so two blocks (16 warps) share an SM.
//   pass 1 (one block per query tile): Dr, then per key tile S and dP,
//     ds in registers, dQ += ds . K;
//   pass 2 (one block per key tile): per query tile S^T and dP^T, pn^T
//     and ds^T in registers, dV += pn^T . dO and dK += ds^T . Q.
// The tensor cores' accumulation truncates (tf32x3.cuh): a half's sum
// over T = 901 takes at most 15 tiles x 4 x 3 = 180 truncating adds,
// ~2e-5 of its magnitude at worst, inside the 1e-4 gate. Nothing is
// summed with atomics, so the result is deterministic. Seven products per
// tile pair, against the least five: S and dP are computed in both
// passes.

#include "flash_tf32x3.cuh"

namespace {

namespace t3 = lseg::tf32x3;
using namespace lseg::flash_tf32x3;

constexpr int THREADS = 256;  // 8 warps: 4 row groups x 2 halves

// ---- a warp's products ------------------------------------------------------
// g = lane / 4, t = lane % 4; a warp owns rows r0..r0+15 of its products
// and columns c0..c0+31 of the score tiles (flash_tf32x3.cuh's acc_pb
// takes them over their columns).

// c = A . B^T over the 64 columns of two tiles: A's rows r0.., B's rows
// c0..c0+8NJ-1 as the columns of c.
template <int NJ>
__device__ __forceinline__ void dot_abt(float (&c)[NJ][4], const float* a,
                                        const float* b, int r0, int c0,
                                        int g, int t) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float* pa = a + (r0 + g) * LD + kk * 8 + t;
    t3::Frag<4> fa;
    fa.set(0, pa[0]);
    fa.set(1, pa[8 * LD]);
    fa.set(2, pa[4]);
    fa.set(3, pa[8 * LD + 4]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* pb = b + (c0 + 8 * j + g) * LD + kk * 8 + t;
      t3::Frag<2> fb;
      fb.set(0, pb[0]);
      fb.set(1, pb[4]);
      t3::mma3(c[j], fa, fb);
    }
  }
}

// The two halves of a row group's sum: the warp of the second half (c0 >
// 0) leaves its tile in `red` (4 x 8 x 4 x 32 floats), the first adds it,
// round to nearest. Call from every thread, after the last products.
__device__ __forceinline__ void add_halves(float (&c)[8][4], float* red,
                                           int r0, int c0, int lane) {
  float* mine = red + (r0 / 16) * 8 * 4 * 32 + lane;
  if (c0 > 0)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) mine[(n * 4 + e) * 32] = c[n][e];
  __syncthreads();
  if (c0 == 0)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        c[n][e] = __fadd_rn(c[n][e], mine[(n * 4 + e) * 32]);
}

// Store a warp's C-layout tile times `mult` at column `col` of rows
// row0.. of one image's (T, ld) rows; rows >= T skipped.
__device__ __forceinline__ void store_tile(float* base, long long ld,
                                           int col, int row0, int T,
                                           const float (&c)[8][4],
                                           float mult, int g, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + g + 8 * h;
    if (row >= T) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(base + row * ld + col + 8 * n + 2 * t) =
          make_float2(c[n][2 * h] * mult, c[n][2 * h + 1] * mult);
  }
}

// ---- backward ---------------------------------------------------------------

struct Args {
  const float* qkv;
  const float* out;
  const float* dout;
  const float* lse;
  float* dqkv;
  float* dr;  // (N, H, T): rowsum(dO * O), written by pass 1
  int T, D, valid_len;
  float scale;
};

struct DqSmem {
  float q[TILE_FLOATS];
  float dout[TILE_FLOATS];
  float k[2][TILE_FLOATS];
  float v[2][TILE_FLOATS];
  float lse[BT];
  float dr[BT];
};

// pass 1: Dr and dQ, one block per 64 queries
__global__ void __launch_bounds__(THREADS, 2) bwd_dq_fp32_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DqSmem& sm = *reinterpret_cast<DqSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (warp % 4) * 16, c0 = (warp / 4) * 32;
  const int head = blockIdx.y, img = blockIdx.z, H = gridDim.y;
  const int T = a.T, D = a.D, vl = a.valid_len;
  const int q0 = blockIdx.x * BT;
  const long long ld = 3LL * D;
  const float* base = a.qkv + static_cast<long long>(img) * T * ld;
  const float* dob = a.dout + static_cast<long long>(img) * T * D;
  const float* ob = a.out + static_cast<long long>(img) * T * D;
  const long long plane = (static_cast<long long>(img) * H + head) * T;
  const int n_kt = (vl + BT - 1) / BT;

  stage<THREADS>(sm.q, base, ld, head * HD, q0, T);
  stage<THREADS>(sm.dout, dob, D, head * HD, q0, T);
  stage<THREADS>(sm.k[0], base, ld, D + head * HD, 0, T);
  stage<THREADS>(sm.v[0], base, ld, 2 * D + head * HD, 0, T);
  cp_commit();
  {
    // Dr = rowsum(dO * O): 4 threads a row, 16 columns each
    const int row = tid / 4, part = tid % 4, grow = q0 + row;
    float acc = 0.0f;
    if (grow < T) {
      const long long off = static_cast<long long>(grow) * D + head * HD +
                            part * 16;
      const float4* d4 = reinterpret_cast<const float4*>(dob + off);
      const float4* o4 = reinterpret_cast<const float4*>(ob + off);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float4 x = d4[c], y = o4[c];
        acc = fmaf(x.x, y.x, acc);
        acc = fmaf(x.y, y.y, acc);
        acc = fmaf(x.z, y.z, acc);
        acc = fmaf(x.w, y.w, acc);
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0) {
      sm.dr[row] = acc;
      sm.lse[row] = grow < T ? a.lse[plane + grow] : pos_inf();
      if (grow < T) a.dr[plane + grow] = acc;
    }
  }
  __syncthreads();
  const float lse[2] = {sm.lse[r0 + g], sm.lse[r0 + g + 8]};
  const float dr[2] = {sm.dr[r0 + g], sm.dr[r0 + g + 8]};
  float dq[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.0f;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    if (it + 1 < n_kt) {  // the next key tile, in flight under this one
      const int k0 = (it + 1) * BT;
      stage<THREADS>(sm.k[st ^ 1], base, ld, D + head * HD, k0, T);
      stage<THREADS>(sm.v[st ^ 1], base, ld, 2 * D + head * HD, k0, T);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_abt(s, sm.q, sm.k[st], r0, c0, g, t);
    dot_abt(dp, sm.dout, sm.v[st], r0, c0, g, t);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = it * BT + c0 + 8 * j + 2 * t + (e & 1);
        const float pn =
            key < vl ? expf(s[j][e] * a.scale - lse[e >> 1]) : 0.0f;
        s[j][e] = pn * (dp[j][e] - dr[e >> 1]);  // ds
      }
    acc_pb(dq, s, sm.k[st], c0, g, t);
    __syncthreads();  // this stage is restaged next tile
  }
  add_halves(dq, &sm.k[0][0], r0, c0, lane);
  if (c0 == 0)
    store_tile(a.dqkv + static_cast<long long>(img) * T * ld, ld,
               head * HD, q0 + r0, T, dq, a.scale, g, t);
}

struct DkvSmem {
  float k[TILE_FLOATS];
  float v[TILE_FLOATS];
  float q[2][TILE_FLOATS];
  float dout[2][TILE_FLOATS];
  float lse[2][BT];
  float dr[2][BT];
};

// pass 2: dK and dV, one block per 64 keys
__global__ void __launch_bounds__(THREADS, 2) bwd_dkdv_fp32_kernel(Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  DkvSmem& sm = *reinterpret_cast<DkvSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = (warp % 4) * 16, c0 = (warp / 4) * 32;
  const int head = blockIdx.y, img = blockIdx.z, H = gridDim.y;
  const int T = a.T, D = a.D, vl = a.valid_len;
  const int k0 = blockIdx.x * BT;
  const long long ld = 3LL * D;
  const float* base = a.qkv + static_cast<long long>(img) * T * ld;
  const float* dob = a.dout + static_cast<long long>(img) * T * D;
  const long long plane = (static_cast<long long>(img) * H + head) * T;
  const int n_qt = (T + BT - 1) / BT;

  // a query tile's row statistics: lse (+inf past T) by threads 0..63,
  // Dr (0 past T) by threads 64..127
  auto stat = [&](int q0) {
    const int row = q0 + tid % BT;
    return tid < BT ? (row < T ? a.lse[plane + row] : pos_inf())
                    : (row < T ? a.dr[plane + row] : 0.0f);
  };
  auto put_stat = [&](int st, float v) {
    if (tid < BT)
      sm.lse[st][tid] = v;
    else if (tid < 2 * BT)
      sm.dr[st][tid - BT] = v;
  };

  stage<THREADS>(sm.k, base, ld, D + head * HD, k0, T);
  stage<THREADS>(sm.v, base, ld, 2 * D + head * HD, k0, T);
  stage<THREADS>(sm.q[0], base, ld, head * HD, 0, T);
  stage<THREADS>(sm.dout[0], dob, D, head * HD, 0, T);
  cp_commit();
  if (tid < 2 * BT) put_stat(0, stat(0));
  const bool key_in[2] = {k0 + r0 + g < vl, k0 + r0 + g + 8 < vl};
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  for (int it = 0; it < n_qt; ++it) {
    const int st = it & 1;
    const bool more = it + 1 < n_qt;
    float next = 0.0f;
    if (more) {  // the next query tile, in flight under this one
      const int q0 = (it + 1) * BT;
      stage<THREADS>(sm.q[st ^ 1], base, ld, head * HD, q0, T);
      stage<THREADS>(sm.dout[st ^ 1], dob, D, head * HD, q0, T);
      cp_commit();
      if (tid < 2 * BT) next = stat((it + 1) * BT);  // stored below
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_abt(s, sm.k, sm.q[st], r0, c0, g, t);      // S^T: keys x queries
    dot_abt(dp, sm.v, sm.dout[st], r0, c0, g, t);  // dP^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = c0 + 8 * j + 2 * t + (e & 1);
        const float pn = key_in[e >> 1]
                             ? expf(s[j][e] * a.scale - sm.lse[st][c])
                             : 0.0f;
        s[j][e] = pn;
        dp[j][e] = pn * (dp[j][e] - sm.dr[st][c]);  // ds^T
      }
    acc_pb(dv, s, sm.dout[st], c0, g, t);
    acc_pb(dk, dp, sm.q[st], c0, g, t);
    if (more) put_stat(st ^ 1, next);
    __syncthreads();  // this stage is restaged next tile
  }
  add_halves(dk, &sm.q[0][0], r0, c0, lane);
  add_halves(dv, &sm.dout[0][0], r0, c0, lane);
  if (c0 > 0) return;
  float* out = a.dqkv + static_cast<long long>(img) * T * ld;
  store_tile(out, ld, D + head * HD, k0 + r0, T, dk, a.scale, g, t);
  store_tile(out, ld, 2 * D + head * HD, k0 + r0, T, dv, 1.0f, g, t);
}

}  // namespace

// Launch the two passes on `stream`; returns the first error code that is
// not 0. `dr` is fp32 scratch of n * (dim / 64) * t floats; `lse` is the
// fp32 forward's statistics output for the same qkv. Requires dim % 64 ==
// 0, 1 <= valid_len <= t and 16-byte aligned fp32 qkv, out, dout and dqkv
// (checked by the wrapper).
extern "C" int lseg_flash_attention_flat_bwd_fp32(
    const void* qkv, const void* out, const void* dout, const void* lse,
    void* dqkv, void* dr, int n, int t, int dim, int valid_len, float scale,
    void* stream) {
  static const int attr_dq =
      lseg::wg::allow_smem(bwd_dq_fp32_kernel, sizeof(DqSmem));
  static const int attr_kv =
      lseg::wg::allow_smem(bwd_dkdv_fp32_kernel, sizeof(DkvSmem));
  if (attr_dq != 0) return attr_dq;
  if (attr_kv != 0) return attr_kv;
  Args a{static_cast<const float*>(qkv), static_cast<const float*>(out),
         static_cast<const float*>(dout), static_cast<const float*>(lse),
         static_cast<float*>(dqkv), static_cast<float*>(dr),
         t, dim, valid_len, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((t + BT - 1) / BT, dim / HD, n);
  bwd_dq_fp32_kernel<<<grid, THREADS, sizeof(DqSmem), s>>>(a);
  const int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_dkdv_fp32_kernel<<<grid, THREADS, sizeof(DkvSmem), s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
