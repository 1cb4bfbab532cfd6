// The flat flash-attention interior shared by kernels B6
// (flash_attention_flat.cu), B8 (flash_attention_qkv_fused.cu) and B9
// (flash_attention_ln_qkv_fused.cu).
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

namespace lseg {
namespace {
namespace flash_flat {

constexpr int HD = 64;      // head_dim (the kernel is specialised)
constexpr int BKV = 64;     // keys per tile
constexpr int BQ = 64;      // query rows per block: one warpgroup
constexpr int STAGES = 2;   // K/V ring depth
constexpr int THREADS = 128;

struct Smem {
  __nv_bfloat16 q[wg::TILE * wg::TILE];
  __nv_bfloat16 k[STAGES][wg::TILE * wg::TILE];
  __nv_bfloat16 v[STAGES][wg::TILE * wg::TILE];
  uint64_t q_bar;
  uint64_t full[STAGES];
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

  if (tid == 0) {
    wg::bar_init(&sm.q_bar, 1);
    for (int s = 0; s < STAGES; ++s) wg::bar_init(&sm.full[s], 1);
    wg::bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    wg::bar_expect_tx(&sm.q_bar, wg::TILE_BYTES);
    wg::tma_load(sm.q, &map, &sm.q_bar, head * HD, q0, img);
    for (int s = 0; s < STAGES && s < n_kt; ++s) {
      wg::bar_expect_tx(&sm.full[s], 2 * wg::TILE_BYTES);
      wg::tma_load(sm.k[s], &map, &sm.full[s], k_col, s * BKV, img);
      wg::tma_load(sm.v[s], &map, &sm.full[s], v_col, s * BKV, img);
    }
  }

  const float neg_inf = -__int_as_float(0x7f800000);
  const float c = scale * 1.4426950408889634f;  // scale * log2(e)
  float o[8][4], sc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = sc[i][e] = 0.0f;
  float m2[2] = {neg_inf, neg_inf};  // running max of s * c
  float l[2] = {0.0f, 0.0f};         // per-thread partial sums of P
  wg::bar_wait(&sm.q_bar, 0);
  const uint64_t dq = wg::desc(sm.q);

  for (int j = 0; j < n_kt; ++j) {
    const int s = j % STAGES;
    wg::bar_wait(&sm.full[s], (j / STAGES) & 1);
    wg::product_abt(sc, dq, wg::desc(sm.k[s]));
    wg::wait<0>();
    wg::fence_acc(sc);

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
    wg::product_pb(o, pa, wg::desc(sm.v[s]));
    wg::wait<0>();
    wg::fence_acc(o);

    // the warpgroup is done with stage s: refill it two tiles ahead
    wg::named_sync(1, THREADS);
    if (tid == 0 && j + STAGES < n_kt) {
      const int k1 = (j + STAGES) * BKV;
      wg::bar_expect_tx(&sm.full[s], 2 * wg::TILE_BYTES);
      wg::tma_load(sm.k[s], &map, &sm.full[s], k_col, k1, img);
      wg::tma_load(sm.v[s], &map, &sm.full[s], v_col, k1, img);
    }
  }

  // l over the 4 threads of each row, divide, cast, store flat; lse
  const int heads = gridDim.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
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
