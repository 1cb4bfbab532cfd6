// The flat flash-attention interior shared by kernels B6
// (flash_attention_flat.cu), B8 (flash_attention_qkv_fused.cu) and B9
// (flash_attention_ln_qkv_fused.cu), and, as the device routine `attend`
// of one warpgroup, by the head-pair blocks of B2 and B15
// (pair_attention.cuh). `attend<true>` is B2's int8 Q.K^T mode (the TPU
// kernel's `qk_int8`), described below its bf16 form.
//
// Input: qkv (N, T, 3D) bf16; head h reads q, k and v at column offsets
// h*64, D + h*64 and 2D + h*64 of each row. Output: flat (N, T, D) bf16,
// head h at columns h*64, and, where its pointer is not null, the per-row
// log-sum-exp lse = m + log(l) of the scaled scores, fp32 (N, H, T), which
// the backward (B7) reads instead of recomputing the row statistics. Keys
// at or past `valid_len` are masked out of the softmax.
//
// Rounding points follow the TPU kernels (pallas_attention.py:47-64 and
// `_pair_softmax_attention`): scores q.k accumulate in fp32 and are scaled
// in fp32; P = exp(s - m) in fp32 is summed in fp32 into l; P is cast to
// bf16 for P.V, which accumulates in fp32; the output is divided by l at
// the end and cast to bf16. Two differences: the online softmax rounds P
// relative to the running row maximum (rescaling the accumulator when it
// grows), where the TPU kernels use the maximum of the whole row; and the
// exponent is exp2 of s * (scale * log2 e) - m2, one FMA, so the scale is
// folded into the exponent's argument rather than rounded on its own; the
// exp2 is the bare ex2.approx.ftz instruction: exp2f wraps it in a
// rescale for subnormal results (its cost: the exp2f variant of
// engine/ablate_attention.py), and a P below 2^-126 of the row maximum
// adds nothing to l or O in fp32.
//
// What bounds it on the card: the tensor cores. Per head, q.k^T and P.V
// are 2*T*T*64 FLOP each; at the flagship (8, 901, 3072) with 16 heads
// that is 26.6 GFLOP (0.027 ms at 989 TFLOP/s) and 104 M exponentials,
// against 44 MB of input.
//
// Design, on the wgmma + TMA engine of wgmma.cuh: one block per (64 query
// rows, head, image), one consumer warpgroup. One thread loads the Q tile
// once by TMA and keeps a ring of two K/V stages, each completed on its
// own mbarrier; the stage a tile leaves is refilled with the tile two
// ahead as soon as the warpgroup is done with it, so the next tile's copy
// runs under this tile's products. S = Q.K^T is an SS wgmma (both
// 128-byte-swizzled tiles in shared memory); P stays in registers (the
// accumulator layout is the RS form's A layout) and feeds O += bf16(P).V
// as an RS wgmma, V read through the B-transpose flag. Four blocks share
// an SM (at most 128 registers, 41 KB), so one block's softmax runs under
// the others' products; on an H100 this beat two warpgroups of 64 rows
// sharing a three-stage ring (two blocks an SM). Key tiles of 64
// keep the ragged tail's waste at 6% at T = 901 (15 tiles, the last
// holding 5 keys; tiles of 128 would waste 12%) and the score tile at 32
// registers a thread. Any T works: TMA zero-fills rows past T.

#pragma once

#include "lseg_common.cuh"
#include "wgmma.cuh"
#include "wgmma_gemm.cuh"

namespace lseg {
namespace {
namespace flash_flat {

constexpr int HD = 64;      // head_dim (the kernel is specialised)
constexpr int BKV = 64;     // keys per tile
constexpr int BQ = 64;      // query rows per block: one warpgroup
constexpr int STAGES = 2;   // K/V ring depth
constexpr int THREADS = 128;

// One warpgroup's Q tile and K/V ring (40 KB; each tile 1024-byte
// aligned where the struct is), and the barriers that complete them.
struct Tiles {
  __nv_bfloat16 q[wg::TILE * wg::TILE];
  __nv_bfloat16 k[STAGES][wg::TILE * wg::TILE];
  __nv_bfloat16 v[STAGES][wg::TILE * wg::TILE];
};
struct Bars {
  uint64_t q;
  uint64_t full[STAGES];
};

// One thread, before the warpgroup's first wait: set the barriers.
__device__ __forceinline__ void init_bars(Bars& b) {
  wg::bar_init(&b.q, 1);
  for (int s = 0; s < STAGES; ++s) wg::bar_init(&b.full[s], 1);
  wg::bar_init_fence();
}

// One thread, after every thread of the warpgroup saw the barriers set:
// the Q tile at column q_col and rows q0.. of image img, and the first
// STAGES K/V tiles (of n_kt) at columns k_col and v_col of the 3-D map.
__device__ __forceinline__ void issue_first(Tiles& t, Bars& b,
                                            const CUtensorMap* map,
                                            int q_col, int k_col, int v_col,
                                            int q0, int img, int n_kt) {
  wg::bar_expect_tx(&b.q, wg::TILE_BYTES);
  wg::tma_load(t.q, map, &b.q, q_col, q0, img);
  for (int s = 0; s < STAGES && s < n_kt; ++s) {
    wg::bar_expect_tx(&b.full[s], 2 * wg::TILE_BYTES);
    wg::tma_load(t.k[s], map, &b.full[s], k_col, s * BKV, img);
    wg::tma_load(t.v[s], map, &b.full[s], v_col, s * BKV, img);
  }
}

// B2's int8 Q.K^T mode: quantize one warpgroup's 64 x 64 bf16 tile (the
// 128-byte swizzled layout TMA wrote) per row, in place, into the s8
// K-major operand of an 8-bit wgmma, as the TPU kernel re-quantizes each
// head's q and k rows: s = max(max|x|, 1e-8) / 127 (an IEEE division),
// codes clip(rint(x / s), -127, 127) (by code_bits_fast, with the
// division where the product lies near a half-integer, as B3). Thread
// tid takes row tid / 2, values 32 h..32 h + 31 (h = tid % 2: the row's
// logical 16-byte chunks 4h..4h+3), and writes its 32 codes over the
// first two chunks it read, logical bytes 64 h..64 h + 31 of the row: no
// thread writes a byte that another reads, and k-step kk of 32 codes
// lies 64 kk bytes along each row (descriptor + 4 kk), in the same
// swizzle. out[row] = s * mult (rounded once), from the h = 0 thread.
__device__ __forceinline__ void quantize_rows_s8(void* tile, float* out,
                                                 float mult, int tid) {
  const int r = tid >> 1, h = tid & 1;
  uint8_t* row = static_cast<uint8_t*>(tile) + r * 128;
  uint4 v[4];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = *reinterpret_cast<const uint4*>(row + (((4 * h + k) ^ (r & 7))
                                                  << 4));
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v[k]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(p[i]);
      amax = fmaxf(amax, fmaxf(fabsf(f.x), fabsf(f.y)));
    }
  }
  amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
  const float s = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  const float inv = __frcp_rn(s);
  uint32_t c[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float f[8];
    unpack8(v[k], f);
    bool near = false;  // the product near a half-integer: divide
    c[2 * k] = pack_codes_fast(f[0], f[1], f[2], f[3], inv, near);
    c[2 * k + 1] = pack_codes_fast(f[4], f[5], f[6], f[7], inv, near);
    if (__builtin_expect(near, 0)) {
      c[2 * k] = pack_codes(f[0], f[1], f[2], f[3], s);
      c[2 * k + 1] = pack_codes(f[4], f[5], f[6], f[7], s);
    }
  }
  *reinterpret_cast<uint4*>(row + (((4 * h) ^ (r & 7)) << 4)) =
      make_uint4(c[0], c[1], c[2], c[3]);
  *reinterpret_cast<uint4*>(row + (((4 * h + 1) ^ (r & 7)) << 4)) =
      make_uint4(c[4], c[5], c[6], c[7]);
  if (h == 0) out[r] = __fmul_rn(s, mult);
}

// The interior, run by the 128 threads of one warpgroup (`tid` 0..127 in
// it, named barrier `bar_id` of its own): the online softmax of the Q
// tile's 64 rows against the n_kt key tiles, keys at or past valid_len
// masked, with `c` = scale * log2(e). Returns the unnormalised output o,
// and for each of the thread's two rows the maximum m2 of s * c and the
// sum l of P (reduced over the 4 threads of the row). Thread 0 refills
// each K/V stage two tiles ahead.
//
// QK8 (B2's int8 Q.K^T mode; `fac` 2 * BQ floats of shared memory, `c`
// = log2(e)): the Q tile is quantized in place once (quantize_rows_s8,
// fac[row] = sq * scale), each K tile in place as it lands (fac[BQ +
// key] = sk), and S runs as two s8 wgmma m64n64k32 (IGMMA) with exact
// int32 sums; each score is dequantized as float(acc) * ((sq * scale) *
// sk), rounded in that order as the TPU kernel computes it, before the
// key mask. Everything after the scores (mask, online softmax, bf16 P.V)
// is the bf16 form's. The stage's K codes (generic-proxy writes) are
// fenced for the async proxy before the products read them, and before
// TMA refills the stage.
template <bool QK8 = false>
__device__ __forceinline__ void attend(Tiles& t, Bars& b,
                                       const CUtensorMap* map, int k_col,
                                       int v_col, int img, int n_kt,
                                       int valid_len, float c, int tid,
                                       int bar_id, float (&o)[8][4],
                                       float (&m2)[2], float (&l)[2],
                                       float* fac = nullptr,
                                       float scale = 1.0f) {
  const int t4 = tid % 4;  // columns 2*t4, 2*t4 + 1 of each 8
  const float neg_inf = -__int_as_float(0x7f800000);
  float sc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = sc[i][e] = 0.0f;
  m2[0] = m2[1] = neg_inf;  // running max of s * c
  l[0] = l[1] = 0.0f;       // per-thread partial sums of P
  wg::bar_wait(&b.q, 0);
  const uint64_t dq = wg::desc(t.q);
  float qa[2] = {0.0f, 0.0f};  // QK8: sq * scale of the thread's two rows
  if constexpr (QK8) {
    quantize_rows_s8(t.q, fac, scale, tid);
    gemm::fence_proxy_async();
    wg::named_sync(bar_id, THREADS);
    const int r0 = tid / 32 * 16 + tid % 32 / 4;
    qa[0] = fac[r0];
    qa[1] = fac[r0 + 8];
  }

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES;
    wg::bar_wait(&b.full[s], (j / STAGES) & 1);
    if constexpr (QK8) {
      quantize_rows_s8(t.k[s], fac + BQ, 1.0f, tid);
      gemm::fence_proxy_async();
      wg::named_sync(bar_id, THREADS);  // every code and key scale written
      int acc[8][4];
      gemm::zero(acc);
      gemm::fence_acc(acc);
      wg::fence();
      const uint64_t dk = wg::desc(t.k[s]);
      gemm::MmaS8<64>::ss(acc, dq, dk, 0);
      gemm::MmaS8<64>::ss(acc, dq + 4, dk + 4, 1);
      wg::commit();
      wg::wait<0>();
      gemm::fence_acc(acc);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 sk =
            *reinterpret_cast<const float2*>(fac + BQ + nt * 8 + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[nt][e] = __fmul_rn(__int2float_rn(acc[nt][e]),
                                __fmul_rn(qa[e / 2], (e & 1) ? sk.y : sk.x));
      }
    } else {
      wg::product_abt(sc, dq, wg::desc(t.k[s]));
      wg::wait<0>();
      wg::fence_acc(sc);
    }

    const int k0 = j * BKV;
    if (k0 + BKV > valid_len) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nt * 8 + 2 * t4 + (e & 1) >= valid_len)
            sc[nt][e] = neg_inf;
    }
    float mx[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[nt][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m2[r], mx[r] * c);
      alpha[r] = exp2_approx(m2[r] - m_new);  // 0 on the first tile
      m2[r] = m_new;
    }
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(sc[nt][e], c, -m2[e / 2]));
        sc[nt][e] = p;
        rs[e / 2] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
    wg::fence_acc(o);
#pragma unroll
    for (int dt = 0; dt < 8; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dt][e] *= alpha[e / 2];

    uint32_t pa[4][4];
    wg::pack_a(pa, sc);
    wg::product_pb(o, pa, wg::desc(t.v[s]));
    wg::wait<0>();
    wg::fence_acc(o);

    // the warpgroup is done with stage s: refill it two tiles ahead
    wg::named_sync(bar_id, THREADS);
    if (tid == 0 && j + STAGES < n_kt) {
      const int k1 = (j + STAGES) * BKV;
      wg::bar_expect_tx(&b.full[s], 2 * wg::TILE_BYTES);
      wg::tma_load(t.k[s], map, &b.full[s], k_col, k1, img);
      wg::tma_load(t.v[s], map, &b.full[s], v_col, k1, img);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

struct Smem {
  Tiles t;
  Bars b;
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;  // + alignment slack

__global__ void __launch_bounds__(THREADS, 4) flash_flat_kernel(
    const __grid_constant__ CUtensorMap map, __nv_bfloat16* __restrict__ out,
    float* __restrict__ lse, int T, int D, int valid_len, float scale) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // rows g and g + 8 of the warp's 16
  const int t4 = lane % 4;  // columns 2*t4, 2*t4 + 1 of each 8
  const int head = blockIdx.y;
  const int img = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int n_kt = (valid_len + BKV - 1) / BKV;
  const int k_col = D + head * HD;
  const int v_col = 2 * D + head * HD;

  if (tid == 0) init_bars(sm.b);
  __syncthreads();
  if (tid == 0)
    issue_first(sm.t, sm.b, &map, head * HD, k_col, v_col, q0, img, n_kt);

  float o[8][4], m2[2], l[2];
  attend(sm.t, sm.b, &map, k_col, v_col, img, n_kt, valid_len,
         scale * 1.4426950408889634f, tid, 1, o, m2, l);

  // divide by l, cast, store flat; lse
  const int heads = gridDim.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row >= T) continue;
    __nv_bfloat16* op = out + (static_cast<long long>(img) * T + row) * D +
                        head * HD + 2 * t4;
#pragma unroll
    for (int dt = 0; dt < 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(op + dt * 8) = __floats2bfloat162_rn(
          o[dt][2 * r] / l[r], o[dt][2 * r + 1] / l[r]);
    }
    if (lse != nullptr && t4 == 0) {
      lse[(static_cast<long long>(img) * heads + head) * T + row] =
          (m2[r] + log2f(l[r])) * 0.6931471805599453f;
    }
  }
}

// Launch on `st`; returns 0 or a CUDA error code. `lse` may be null.
// Requires D % 64 == 0, 1 <= valid_len <= T, 16-byte aligned qkv.
inline int launch(const void* qkv, void* out, void* lse, int n, int t,
                  int dim, int valid_len, float scale, cudaStream_t st) {
  static const int attr = wg::allow_smem(flash_flat_kernel, SMEM_BYTES);
  if (attr != 0) return attr;
  CUtensorMap map;
  const int rc = wg::make_map(&map, qkv, 3 * dim, t, n);
  if (rc != 0) return rc;
  const dim3 grid((t + BQ - 1) / BQ, dim / HD, n);
  flash_flat_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      map, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse), t,
      dim, valid_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_flat
}  // namespace
}  // namespace lseg
