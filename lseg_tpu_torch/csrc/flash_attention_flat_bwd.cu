// Backward of flash attention over the flat fused-qkv layout for Hopper
// (sm_90a): kernel B7.
//
// Replaces: lseg_tpu/ops/pallas_attention.py · _flash_flat_bwd_impl
// (kernel body _bwd_kernel; the custom VJP of flash_attention_flat_vjp).
//
// Inputs: the forward's qkv (N, T, 3D) bf16, its output O (N, T, D) bf16
// and the cotangent dO (N, T, D) bf16. Output: dqkv (N, T, 3D) bf16 in
// the same flat layout, dq in the q columns, dk in the k columns and dv
// in the v columns of each head, so the qkv projection's backward takes
// it as it is. Keys at or past `valid_len` are masked.
//
// Rounding points follow the TPU kernel (pallas_attention.py:557-609):
//   s  = (q . k^T) * scale in fp32;
//   pn = exp(s - rowmax) / rowsum in fp32, normalized BEFORE any cast;
//   dv = bf16(pn)^T . dO, fp32 accumulation;
//   dp = dO . v^T in fp32;
//   Dr = rowsum(dO * O) in fp32 from the bf16 values;
//   ds = bf16(pn * (dp - Dr));
//   dq = (ds . k) * scale, dk = (ds^T . q) * scale, fp32 accumulation,
//   cast to bf16.
// One difference: the row sum is accumulated online (rescaled when the
// running maximum grows), where the TPU kernel sums exp(s - rowmax)
// after taking the whole row's maximum; the two differ at fp32 rounding.
//
// What bounds it on the card: the products. Each (image, head) needs
// five T x T x 64 products (s, dv, dp, dq, dk); this design recomputes s
// in all three passes and dp in two, eight in all: 2*T*T*64*8 FLOP per
// head, 106 GFLOP at the flagship (8, 901, 3072) with 16 heads. Inputs
// and outputs are 132 MB, so it is compute-bound at any sensible rate.
//
// Design. The TPU kernel holds a whole (T, T) fp32 block per head pair
// in VMEM (3.3 MB at T = 904); a Hopper block cannot. No (T, T) tensor
// touches device memory and nothing is summed with atomics, so the
// result is deterministic:
//   1. statistics: one block per (64-query tile, head, image) sweeps all
//      keys for each row's max and sum of exp (as the forward does) and
//      takes Dr; they go to an fp32 (3, N, H, T) scratch;
//   2. dK/dV: one block per (64-key tile, head, image); each warp owns 16
//      keys, keeps their k and v fragments and its dk, dv accumulators in
//      registers, and walks the query tiles (q, dO, stats staged in
//      shared memory), forming s^T and dp^T directly;
//   3. dQ: one block per (64-query tile, head, image); each warp owns 16
//      queries, keeps q, dO, dq in registers and walks the key tiles.
// Products run as bf16 mma.sync m16n8k16 with fp32 accumulators; a
// score fragment's register layout is the A-operand layout of the next
// product, so pn and ds never leave registers. Any T works: the ragged
// tiles are zero-filled and masked.

#include "lseg_common.cuh"

namespace {

using lseg::ld_u32;
using lseg::mma_bf16_16816;
using lseg::pack_bf16;
using lseg::pack_f32;

constexpr int HD = 64;       // head_dim (the kernel is specialised)
constexpr int BT = 64;       // rows per block tile and per inner tile
constexpr int LDS = HD + 8;  // smem row stride in bf16 (144 bytes)
constexpr int THREADS = 128;

struct Args {
  const __nv_bfloat16* qkv;
  const __nv_bfloat16* out;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dqkv;
  float* stats;  // (3, N, H, T): row max, row sum, Dr
  int T, D, H, valid_len;
  float scale;
};

__device__ __forceinline__ float neg_inf() {
  return -__int_as_float(0x7f800000);
}

// A-operand fragments of 16 rows x 64 dims read from global memory
// (row stride `ld` elements); rows at or past `limit` read as zero.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[4][4],
                                             const __nv_bfloat16* base,
                                             long long ld, int row0,
                                             int limit, int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = kk * 16 + 2 * t4 + 8 * half;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + g + 8 * r;
        a[kk][2 * half + r] = row < limit ? ld_u32(base + row * ld + c) : 0u;
      }
    }
  }
}

// Stage a 64 x 64 bf16 tile (rows at or past `limit` zero) into smem.
__device__ __forceinline__ void stage_tile(__nv_bfloat16* s,
                                           const __nv_bfloat16* base,
                                           long long ld, int row0,
                                           int limit, int tid) {
  for (int i = tid; i < BT * (HD / 8); i += THREADS) {
    const int r = i / (HD / 8);
    const int cv = (i % (HD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit)
      v = *reinterpret_cast<const uint4*>(base + (row0 + r) * ld + cv);
    *reinterpret_cast<uint4*>(s + r * LDS + cv) = v;
  }
}

// c[nt] += a (16 x 64) . b^T, where b is a 64-row smem tile whose rows are
// the 64 output columns (row-major, contiguous along the reduced dim).
__device__ __forceinline__ void mma_abt(float (&c)[8][4],
                                        const uint32_t (&a)[4][4],
                                        const __nv_bfloat16* b, int g,
                                        int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const __nv_bfloat16* p = b + (nt * 8 + g) * LDS + kk * 16 + 2 * t4;
      mma_bf16_16816(c[nt], a[kk], ld_u32(p), ld_u32(p + 8));
    }
  }
}

// c[dt] += p (16 x 64, given as C fragments, cast to bf16) . b, where b
// is a 64 x 64 smem tile indexed [reduced row][output column].
__device__ __forceinline__ void mma_pb(float (&c)[8][4],
                                       const float (&p)[8][4],
                                       const __nv_bfloat16* b, int g,
                                       int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {
        pack_f32(p[2 * kk][0], p[2 * kk][1]),
        pack_f32(p[2 * kk][2], p[2 * kk][3]),
        pack_f32(p[2 * kk + 1][0], p[2 * kk + 1][1]),
        pack_f32(p[2 * kk + 1][2], p[2 * kk + 1][3]),
    };
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      const __nv_bfloat16* bp = b + (kk * 16 + 2 * t4) * LDS + dt * 8 + g;
      mma_bf16_16816(c[dt], a, pack_bf16(bp[0], bp[LDS]),
                     pack_bf16(bp[8 * LDS], bp[9 * LDS]));
    }
  }
}

__device__ __forceinline__ void zero(float (&c)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.0f;
}

// Store 16 rows x 64 columns of fp32 accumulators * mult as bf16 at
// column `col` of a row-major (rows, ld) array; rows >= limit skipped.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ld,
                                           int col, int row0, int limit,
                                           const float (&c)[8][4], float mult,
                                           int g, int t4) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= limit) continue;
    __nv_bfloat16* p = base + row * ld + col + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(p + dt * 8) = __floats2bfloat162_rn(
          c[dt][2 * r] * mult, c[dt][2 * r + 1] * mult);
    }
  }
}

// ---- pass 1: row max, row sum of exp, Dr = rowsum(dO * O) ------------
__global__ void __launch_bounds__(THREADS) bwd_stats_kernel(Args a) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BT * LDS];
  const int head = blockIdx.y, img = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int T = a.T, D = a.D;
  const long long ld3 = 3LL * D;
  const __nv_bfloat16* base = a.qkv + static_cast<long long>(img) * T * ld3;
  const int q0 = blockIdx.x * BT + warp * 16;

  uint32_t qa[4][4];
  load_a_frags(qa, base + head * HD, ld3, q0, T, g, t4);

  float m_run[2] = {neg_inf(), neg_inf()};
  float l_run[2] = {0.0f, 0.0f};
  for (int k0 = 0; k0 < a.valid_len; k0 += BT) {
    stage_tile(Ks, base + D + head * HD, ld3, k0, a.valid_len, tid);
    __syncthreads();
    float s[8][4];
    zero(s);
    mma_abt(s, qa, Ks, g, t4);
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        const float v = key < a.valid_len ? s[nt][e] * a.scale : neg_inf();
        s[nt][e] = v;
        mx[e / 2] = fmaxf(mx[e / 2], v);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = expf(m_run[r] - m_new);  // 0 on the first tile
      m_run[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) rs[e / 2] += expf(s[nt][e] - m_run[e / 2]);
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + rs[r];
    __syncthreads();
  }

  // Dr over the 64 dims of each row: 16 per thread, then the quad
  const __nv_bfloat16* ob = a.out + static_cast<long long>(img) * T * D;
  const __nv_bfloat16* db = a.dout + static_cast<long long>(img) * T * D;
  float dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + 8 * r;
    float acc = 0.0f;
    if (row < T) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = head * HD + j * 8 + 2 * t4;
        const float2 o = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ob + row * D + c));
        const float2 d = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(db + row * D + c));
        acc += d.x * o.x + d.y * o.y;
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    dr[r] = acc;
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  if (t4 == 0) {
    const long long plane = static_cast<long long>(gridDim.z) * a.H * T;
    float* st = a.stats + (static_cast<long long>(img) * a.H + head) * T;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + g + 8 * r;
      if (row >= T) continue;
      st[row] = m_run[r];
      st[plane + row] = l_run[r];
      st[2 * plane + row] = dr[r];
    }
  }
}

// ---- pass 2: dK and dV, one block per 64 keys -------------------------
__global__ void __launch_bounds__(THREADS) bwd_dkdv_kernel(Args a) {
  __shared__ __align__(16) __nv_bfloat16 Qs[BT * LDS];
  __shared__ __align__(16) __nv_bfloat16 dOs[BT * LDS];
  __shared__ float Ms[BT], Ls[BT], Ds[BT];
  const int head = blockIdx.y, img = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int T = a.T, D = a.D, vl = a.valid_len;
  const long long ld3 = 3LL * D;
  const __nv_bfloat16* base = a.qkv + static_cast<long long>(img) * T * ld3;
  const __nv_bfloat16* db = a.dout + static_cast<long long>(img) * T * D;
  const long long plane = static_cast<long long>(gridDim.z) * a.H * T;
  const float* st = a.stats + (static_cast<long long>(img) * a.H + head) * T;
  const int k0 = blockIdx.x * BT + warp * 16;  // this warp's 16 keys

  // keys at or past valid_len read as zero: their pn is 0 anyway
  uint32_t ka[4][4], va[4][4];
  load_a_frags(ka, base + D + head * HD, ld3, k0, vl, g, t4);
  load_a_frags(va, base + 2 * D + head * HD, ld3, k0, vl, g, t4);
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);

  for (int q0 = 0; q0 < T; q0 += BT) {
    stage_tile(Qs, base + head * HD, ld3, q0, T, tid);
    stage_tile(dOs, db + head * HD, D, q0, T, tid);
    if (tid < BT) {
      const bool in = q0 + tid < T;
      Ms[tid] = in ? st[q0 + tid] : 0.0f;
      Ls[tid] = in ? st[plane + q0 + tid] : 1.0f;
      Ds[tid] = in ? st[2 * plane + q0 + tid] : 0.0f;
    }
    __syncthreads();

    // s^T (16 keys x 64 queries) and pn^T in place
    float p[8][4];
    zero(p);
    mma_abt(p, ka, Qs, g, t4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + g + 8 * (e / 2);
        const int qi = nt * 8 + 2 * t4 + (e & 1);
        p[nt][e] = (key < vl && q0 + qi < T)
                       ? expf(p[nt][e] * a.scale - Ms[qi]) / Ls[qi]
                       : 0.0f;
      }
    // dv += bf16(pn)^T . dO
    mma_pb(dv, p, dOs, g, t4);
    // dp^T = v . dO^T; ds^T = bf16(pn * (dp - Dr)) in place
    float ds[8][4];
    zero(ds);
    mma_abt(ds, va, dOs, g, t4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nt * 8 + 2 * t4 + (e & 1);
        ds[nt][e] = p[nt][e] * (ds[nt][e] - Ds[qi]);
      }
    // dk += ds^T . q (mma_pb rounds ds to bf16 as it packs)
    mma_pb(dk, ds, Qs, g, t4);
    __syncthreads();
  }
  __nv_bfloat16* ob = a.dqkv + static_cast<long long>(img) * T * ld3;
  store_rows(ob, ld3, D + head * HD, k0, T, dk, a.scale, g, t4);
  store_rows(ob, ld3, 2 * D + head * HD, k0, T, dv, 1.0f, g, t4);
}

// ---- pass 3: dQ, one block per 64 queries -----------------------------
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(Args a) {
  __shared__ __align__(16) __nv_bfloat16 Ks[BT * LDS];
  __shared__ __align__(16) __nv_bfloat16 Vs[BT * LDS];
  const int head = blockIdx.y, img = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int T = a.T, D = a.D, vl = a.valid_len;
  const long long ld3 = 3LL * D;
  const __nv_bfloat16* base = a.qkv + static_cast<long long>(img) * T * ld3;
  const __nv_bfloat16* db = a.dout + static_cast<long long>(img) * T * D;
  const long long plane = static_cast<long long>(gridDim.z) * a.H * T;
  const float* st = a.stats + (static_cast<long long>(img) * a.H + head) * T;
  const int q0 = blockIdx.x * BT + warp * 16;  // this warp's 16 queries

  uint32_t qa[4][4], da[4][4];
  load_a_frags(qa, base + head * HD, ld3, q0, T, g, t4);
  load_a_frags(da, db + head * HD, D, q0, T, g, t4);
  float m[2], l[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + g + 8 * r;
    const bool in = row < T;
    m[r] = in ? st[row] : 0.0f;
    l[r] = in ? st[plane + row] : 1.0f;
    dr[r] = in ? st[2 * plane + row] : 0.0f;
  }
  float dq[8][4];
  zero(dq);

  for (int k0 = 0; k0 < vl; k0 += BT) {
    stage_tile(Ks, base + D + head * HD, ld3, k0, vl, tid);
    stage_tile(Vs, base + 2 * D + head * HD, ld3, k0, vl, tid);
    __syncthreads();

    float p[8][4];
    zero(p);
    mma_abt(p, qa, Ks, g, t4);
    float ds[8][4];
    zero(ds);
    mma_abt(ds, da, Vs, g, t4);  // dp = dO . v^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        const int r = e / 2;
        const float pn = (key < vl && q0 + g + 8 * r < T)
                             ? expf(p[nt][e] * a.scale - m[r]) / l[r]
                             : 0.0f;
        ds[nt][e] = pn * (ds[nt][e] - dr[r]);
      }
    // dq += bf16(ds) . k
    mma_pb(dq, ds, Ks, g, t4);
    __syncthreads();
  }
  __nv_bfloat16* ob = a.dqkv + static_cast<long long>(img) * T * ld3;
  store_rows(ob, ld3, head * HD, q0, T, dq, a.scale, g, t4);
}

}  // namespace

// Launch the three passes on `stream`; returns the first
// cudaGetLastError() that is not 0 (0 on success). `stats` is fp32
// scratch of 3 * n * (dim / 64) * t floats. Requires dim % 64 == 0,
// 1 <= valid_len <= t and 16-byte aligned qkv, out, dout and dqkv
// (checked by the wrapper).
extern "C" int lseg_flash_attention_flat_bwd(const void* qkv, const void* out,
                                             const void* dout, void* dqkv,
                                             void* stats, int n, int t,
                                             int dim, int valid_len,
                                             float scale, void* stream) {
  Args a{static_cast<const __nv_bfloat16*>(qkv),
         static_cast<const __nv_bfloat16*>(out),
         static_cast<const __nv_bfloat16*>(dout),
         static_cast<__nv_bfloat16*>(dqkv),
         static_cast<float*>(stats),
         t, dim, dim / HD, valid_len, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((t + BT - 1) / BT, dim / HD, n);
  bwd_stats_kernel<<<grid, THREADS, 0, s>>>(a);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_dkdv_kernel<<<grid, THREADS, 0, s>>>(a);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  bwd_dq_kernel<<<grid, THREADS, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
